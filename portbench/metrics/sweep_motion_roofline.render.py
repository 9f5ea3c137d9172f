"""The moving sweep's share of its roofline: the least time K1m's work in
the traced sub-window could take at the published peaks (its pairs counted
from the cell's inputs, ``sweep_work`` of the loop's roofline module,
``portbench/roofline/render_motion.py``), over the device time of the
kernels the trace names ``sweep_motion_kernel``, in per cent. Nothing where
the trace has no such kernel or the roofline counts no moving sweep."""

from portbench.harness.peaks import least_time

KERNEL = "sweep_motion_kernel"


def read(run):
    if run.kind != "render" or run.traced is None:
        return None
    busy = sum(s for name, s in run.traced.device_ops
               if name.startswith(KERNEL))
    if busy <= 0:
        return None
    sweep_work = getattr(run.roofline, "sweep_work", None)
    if sweep_work is None:
        return None
    return 100.0 * least_time(sweep_work(run.loop, run.traced_paths))[
        "seconds"] / busy
