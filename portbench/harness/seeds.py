"""Seeds derived from a run's ``--seed``: one stream per use, the same for
the same seed."""

from __future__ import annotations

import hashlib

import torch


def derive(seed: int, label: str, index: int = 0) -> int:
    """A 63-bit seed for use ``label`` (and ``index``) of run ``seed``."""
    h = hashlib.sha256(f"{seed}:{label}:{index}".encode()).digest()
    return int.from_bytes(h[:8], "little") & ((1 << 63) - 1)


def generator(seed: int, label: str, device, index: int = 0
              ) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded by :func:`derive`."""
    g = torch.Generator(device=device)
    g.manual_seed(derive(seed, label, index))
    return g
