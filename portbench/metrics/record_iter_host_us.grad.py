"""Host microseconds a pass of a gradient step's record phases: the
seconds of the program's ``rtw.grad.record`` spans over its
``rtw.grad.record_iters`` counter (the record loops' passes), in the
traced sub-window. Beside ``record_host_ms.grad`` it tells a longer path
(more passes) from a slower pass."""

from portbench.harness.spans import program_summary, total_s


def read(run):
    s = program_summary(run, "grad")
    if s is None:
        return None
    record = total_s(s, "rtw.grad.record")
    passes = s["counters"].get("rtw.grad.record_iters", 0)
    if record is None or not passes:
        return None
    return record / passes * 1e6
