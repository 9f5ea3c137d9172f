"""Million sample paths per second of a gradient step: pixels x spp of
every step completed in the window, over the window's seconds (host
clock)."""


def read(run):
    if run.kind != "grad":
        return None
    return run.paths / run.window_s / 1e6
