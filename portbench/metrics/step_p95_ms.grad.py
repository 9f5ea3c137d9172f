"""95th percentile of the host time of each gradient step of the window,
each ending in a synchronise."""

from portbench.harness.stats import percentile


def read(run):
    if run.kind != "grad" or not run.call_s:
        return None
    return percentile(run.call_s, 95) * 1e3
