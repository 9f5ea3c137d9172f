"""The statistics that decide ``correct``, and the percentile of the
host-clock metrics.

The program and the reference draw their own random numbers, so no image
or gradient of one can equal the other's. What is compared is each side's
mean against the other's, in standard errors of their difference: the
program's images and gradients are judged, never reused.
"""

from __future__ import annotations

import torch


def percentile(values: list[float], q: float) -> float:
    """The ``q``-th percentile (0-100) by linear interpolation between
    order statistics."""
    xs = sorted(values)
    if not xs:
        raise ValueError("no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def block_sums(x: torch.Tensor, W: int, H: int, blocks: tuple) -> torch.Tensor:
    """Sums of ``x`` [W*H, C] over a ``bx x by`` grid of pixel blocks:
    ``[by * bx, C]``. The film's width and height must divide evenly."""
    bx, by = blocks
    if W % bx or H % by:
        raise ValueError(f"a {W}x{H} film does not divide into {bx}x{by} "
                         "blocks")
    c = x.shape[-1]
    g = x.reshape(by, H // by, bx, W // bx, c)
    return g.sum((1, 3)).reshape(by * bx, c)


def image_z(program_sum: torch.Tensor, program_sq: torch.Tensor,
            n_calls: int, n_samples: int, n_unjittered: int, ref: dict,
            W: int, H: int, blocks: tuple) -> torch.Tensor:
    """Per block and channel, the program's mean radiance minus the
    reference's estimate of it, in standard errors of that difference.

    ``program_sum`` [W*H, 3] sums ``n_calls`` calls' sums of every pixel,
    ``n_samples`` samples in all, of which ``n_unjittered`` were the
    unjittered global sample 0; ``program_sq`` sums the squares of those
    calls' sums. The reference (:func:`tracer.render_stats`) gives that
    sample's radiance and the mean and variance of jittered ones; its
    estimate weights them as the program's samples are weighted.

    A pixel's variance, for both kinds of sample and both sides, pools the
    reference's jittered samples' and the program's own (from its calls'
    sums), each by its degrees of freedom, as both sides draw from one law
    where the program is sound. A block whose light comes from rare paths,
    such as a contact shadow lit through glass, draws few of them among the
    reference's samples, and its variance read from those alone would be
    too small just where its mean is farthest off; the program's many more
    samples see them.

    A block's variance is at least ``1 / n_ref^2``, ``n_ref`` the
    reference's samples a pixel: a path that carries up to 1 of radiance
    (the sky's brightest channel times a throughput of at most 1) and that
    none of the reference's ``n_ref`` samples of the block's pixels drew
    would otherwise read as a block of no variance, and one such path in
    the program's samples as infinitely many standard errors. Only blocks
    whose every sample reads the same (a channel that an albedo of 0
    zeroes) come near the floor."""
    f64 = torch.float64
    w = n_unjittered / n_samples
    n_j = ref["paths"] // (W * H) - 1
    total = program_sum.to(f64)
    calls_var = torch.clamp(program_sq.to(f64) - total * total / n_calls,
                            min=0.0) / max(n_calls - 1, 1)
    var_px = (((n_j - 1) * ref["var"]
               + (n_calls - 1) * calls_var * n_calls / n_samples)
              / (n_j + n_calls - 2))
    est = w * ref["centered"] + (1.0 - w) * ref["mean"]
    var_program = var_px / n_samples
    var_ref = var_px * (w * w + (1.0 - w) ** 2 / n_j)
    diff = block_sums(total / n_samples - est, W, H, blocks)
    var = block_sums(var_program + var_ref, W, H, blocks)
    return diff / torch.sqrt(var + 1.0 / (n_j + 1) ** 2)


def welch_z(sum_a: torch.Tensor, sq_a: torch.Tensor, n_a: int,
            sum_b: torch.Tensor, sq_b: torch.Tensor, n_b: int
            ) -> torch.Tensor:
    """Two-sample z of each element: the difference of the two means over
    its standard error, each side's variance its own (Welch), since the
    program's estimator may be more or less noisy than the reference's and
    only their means are held equal. Elements that vary on neither side
    and agree give 0; those that vary on neither and differ, infinity."""
    ma, mb = sum_a / n_a, sum_b / n_b
    va = torch.clamp(sq_a - n_a * ma * ma, min=0.0) / max(n_a - 1, 1)
    vb = torch.clamp(sq_b - n_b * mb * mb, min=0.0) / max(n_b - 1, 1)
    var = va / n_a + vb / n_b
    diff = ma - mb
    z = diff / torch.sqrt(torch.where(var > 0, var, torch.ones_like(var)))
    return torch.where(var > 0, z, torch.where(
        diff == 0, torch.zeros_like(z), torch.full_like(z, float("inf"))))
