"""The least time the traced sub-window's work could take at the published
peaks (``portbench/roofline/render.py``), over the sub-window's length: the
whole loop's share of the card's peak, in per cent."""


def read(run):
    if run.kind != "render" or run.traced is None or run.traced.window_s <= 0:
        return None
    return 100.0 * run.least_time_s(run.traced_paths)["seconds"] \
        / run.traced.window_s
