"""Host syncs (stream and device synchronisations, copies to the host: the
``SYNC_SUMS`` of ``chip_smoke.py``) per million paths of the traced
sub-window, from ``torch.profiler``."""


def read(run):
    if run.kind != "render" or run.traced is None or not run.traced_paths:
        return None
    return sum(run.traced.syncs.values()) / (run.traced_paths / 1e6)
