"""A gradient step's work at several samples a pixel: that of
:mod:`.grad`, whose count already scales with the samples. A pass that the
program recomputes in the backward to keep inside its record budget is
the implementation's cost, not work, so each path counts once."""

from .grad import work

__all__ = ["work"]
