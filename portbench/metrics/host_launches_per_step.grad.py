"""Host calls that launch work on the card (``cudaLaunchKernel``,
``cuLaunchKernel``, ``cudaGraphLaunch``, one each) per gradient step of the
traced sub-window, from ``torch.profiler``."""


def read(run):
    if run.kind != "grad" or run.traced is None or not run.traced_calls:
        return None
    return run.traced.launches / run.traced_calls
