"""The share of the traced sub-window in which no operation ran on the card
(one minus the union of the device's intervals over the sub-window), in per
cent."""


def read(run):
    if run.kind != "grad" or run.traced is None or run.traced.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.traced.busy_s / run.traced.window_s)
