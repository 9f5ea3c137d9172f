"""The least time the traced sub-window's work could take at the published
peaks (counted from the cell's inputs by ``portbench/roofline/render.py``),
over the time the card was busy in it, in per cent."""


def read(run):
    if run.kind != "render" or run.traced is None or run.traced.busy_s <= 0:
        return None
    return 100.0 * run.least_time_s(run.traced_paths)["seconds"] \
        / run.traced.busy_s
