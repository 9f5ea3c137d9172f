"""Host milliseconds a forward call spends packing a moving scene's tables
(K1m's sphere table and K2m's rows): the seconds of the program's
``rtw.render.motion_table`` spans over the count of its ``rtw.render.call``
spans, in the traced sub-window. Nothing for a program or a scene without
that span."""

from portbench.harness.spans import program_summary, roots, total_s


def read(run):
    s = program_summary(run, "render")
    if s is None:
        return None
    packing = total_s(s, "rtw.render.motion_table")
    if packing is None:
        return None
    return packing / roots(s, "render") * 1e3
