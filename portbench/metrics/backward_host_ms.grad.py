"""Host milliseconds a gradient step's caller waits in the backward: the
seconds of the program's ``rtw.grad.backward`` spans (around
``torch.autograd.grad``, on the calling thread) over the count of its
``rtw.grad.step`` spans, in the traced sub-window."""

from portbench.harness.spans import program_summary, roots, total_s


def read(run):
    s = program_summary(run, "grad")
    if s is None:
        return None
    backward = total_s(s, "rtw.grad.backward")
    if backward is None:
        return None
    return backward / roots(s, "grad") * 1e3
