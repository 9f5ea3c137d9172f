"""Sphere scenes as arrays: each scene is made by a module of its own under
``reference/scenes/``, found by the name a configuration gives."""

from __future__ import annotations

import importlib

import numpy as np
import torch

#: Material codes (src/material.jl).
LAMBERTIAN, METAL, DIELECTRIC = 0, 1, 2

#: Differentiable fields, in the order of the program's ``Scene``.
FLOAT_FIELDS = ("center", "radius", "albedo", "fuzz", "ir")


def lambertian(center, radius, albedo) -> dict:
    return dict(center=center, radius=radius, mat=LAMBERTIAN, albedo=albedo)


def metal(center, radius, albedo, fuzz) -> dict:
    return dict(center=center, radius=radius, mat=METAL, albedo=albedo,
                fuzz=fuzz)


def dielectric(center, radius, ir) -> dict:
    return dict(center=center, radius=radius, mat=DIELECTRIC, ir=ir)


def scene_arrays(spec: dict) -> dict:
    """The float64 / int32 arrays of the scene ``spec`` names (``module``
    and its keyword arguments ``args``): one row per sphere, no padding.
    A dielectric's albedo is (1, 1, 1) (src/material.jl:42)."""
    mod = importlib.import_module(f"portbench.reference.scenes."
                                  f"{spec['module']}")
    spheres = mod.build(**spec.get("args", {}))
    n = len(spheres)
    out = dict(center=np.zeros((n, 3)), radius=np.zeros(n),
               albedo=np.ones((n, 3)), fuzz=np.zeros(n), ir=np.ones(n),
               mat=np.zeros(n, dtype=np.int32))
    for k, s in enumerate(spheres):
        out["center"][k] = s["center"]
        out["radius"][k] = s["radius"]
        out["mat"][k] = s["mat"]
        if s["mat"] != DIELECTRIC:
            out["albedo"][k] = s["albedo"]
        if s["mat"] == METAL:
            out["fuzz"][k] = s["fuzz"]
        if s["mat"] == DIELECTRIC:
            out["ir"][k] = s["ir"]
    return out


def padded(arrays: dict, multiple: int) -> dict:
    """The scene padded to a multiple of ``multiple`` spheres with spheres
    of radius 0, far away, that no ray can hit."""
    n = arrays["radius"].shape[0]
    pad = -n % multiple
    fill = dict(center=1e4, radius=0.0, albedo=1.0, fuzz=0.0, ir=1.0, mat=0)
    return {f: np.concatenate([a, np.full((pad,) + a.shape[1:], fill[f],
                                          dtype=a.dtype)])
            for f, a in arrays.items()}


def scene_tensors(arrays: dict, dtype, device) -> dict:
    """The scene's float fields cast once to ``dtype``, ``mat`` as int32."""
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    out = {f: torch.as_tensor(arrays[f].astype(np_dtype)).to(
        device=device, dtype=dtype) for f in FLOAT_FIELDS}
    out["mat"] = torch.as_tensor(arrays["mat"], dtype=torch.int32).to(device)
    return out
