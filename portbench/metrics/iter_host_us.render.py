"""Host microseconds an iteration of the strided forward loop: the seconds
of the program's ``rtw.render.loop`` spans over its ``rtw.render.iters``
counter (the loop's passes), in the traced sub-window."""

from portbench.harness.spans import program_summary, total_s


def read(run):
    s = program_summary(run, "render")
    if s is None:
        return None
    loop = total_s(s, "rtw.render.loop")
    iters = s["counters"].get("rtw.render.iters", 0)
    if loop is None or not iters:
        return None
    return loop / iters * 1e6
