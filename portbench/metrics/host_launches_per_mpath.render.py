"""Host calls that launch work on the card (``cudaLaunchKernel``,
``cuLaunchKernel``, ``cudaGraphLaunch``, one each) per million paths of
the traced sub-window, from ``torch.profiler``."""


def read(run):
    if run.kind != "render" or run.traced is None or not run.traced_paths:
        return None
    return run.traced.launches / (run.traced_paths / 1e6)
