"""The benchmark's plain reference: a path tracer in plain PyTorch.

It follows RayTracingWeekend.jl's book-1 renderer (src/ray_color.jl,
src/material.jl, src/camera.jl, src/hit.jl) as the port states it, with
its own random numbers (``torch.Generator`` draws). It imports nothing of
the program under test, nor JAX: it judges what the program renders and
differentiates, and it builds the inputs (scenes, cameras, targets) that
the harness hands to both sides.
"""
