"""Blocking host reads a gradient step, as the program counts them: the
``rtw.sync.*`` counters (the backward's among them) over the count of
``rtw.grad.step`` spans, in the traced sub-window."""

from portbench.harness.spans import program_summary, roots, syncs


def read(run):
    s = program_summary(run, "grad")
    if s is None:
        return None
    return syncs(s) / roots(s, "grad")
