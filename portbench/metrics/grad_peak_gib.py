"""Peak device memory of the window's gradient steps above what was
allocated before the first of them, in GiB (``max_memory_allocated``
after ``reset_peak_memory_stats``)."""


def read(run):
    if run.kind != "grad" or run.step_peak_bytes <= 0:
        return None
    return run.step_peak_bytes / 2**30
