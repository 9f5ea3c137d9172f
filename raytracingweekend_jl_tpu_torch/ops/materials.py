"""Per-sphere attribute table and the winner-attribute fetch.

The reference package fetches the winning sphere's attributes with a
bf16-split one-hot matrix product, a form that exists only for the TPU's
matrix unit. On the card it is a plain gather.
"""

from __future__ import annotations

import torch

from ..scene import Scene


def attr_mat(scene: Scene) -> torch.Tensor:
    """``[N, 10]`` float32 per-sphere attributes, columns
    ``center.xyz | radius | albedo.rgb | fuzz | ir | mat``: the interface
    the shade kernels share (reference: materials.attr_mat)."""
    f32 = torch.float32
    return torch.cat([
        scene.center.to(f32), scene.radius[:, None].to(f32),
        scene.albedo.to(f32), scene.fuzz[:, None].to(f32),
        scene.ir[:, None].to(f32), scene.mat[:, None].to(f32)], dim=1)


def fetch_attr_planes(index: torch.Tensor, attr: torch.Tensor) -> torch.Tensor:
    """Winner attributes in ``[10, R]`` plane-major layout: ``attr[index].T``,
    contiguous."""
    return attr.T[:, index.long()].contiguous()
