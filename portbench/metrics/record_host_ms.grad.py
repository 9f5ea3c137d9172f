"""Host milliseconds a gradient step spends in its record phases: the
seconds of the program's ``rtw.grad.record`` spans over the count of its
``rtw.grad.step`` spans, in the traced sub-window."""

from portbench.harness.spans import program_summary, roots, total_s


def read(run):
    s = program_summary(run, "grad")
    if s is None:
        return None
    record = total_s(s, "rtw.grad.record")
    if record is None:
        return None
    return record / roots(s, "grad") * 1e3
