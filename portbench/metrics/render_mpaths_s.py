"""Million sample paths per second of a forward render: every path of the
calls completed in the window, over the window's seconds (host clock)."""


def read(run):
    if run.kind != "render":
        return None
    return run.paths / run.window_s / 1e6
