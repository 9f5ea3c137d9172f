"""The share of the strided forward call's host time spent outside its
loop and its result (the film's coordinates, the route, the strided
state, the camera's constants, the sphere tables): 100 x the seconds of
the program's ``rtw.render.call`` spans less those of its
``rtw.render.loop`` and ``rtw.render.result`` spans, over those of its
``rtw.render.call`` spans, in the traced sub-window."""

from portbench.harness.spans import program_summary, total_s


def read(run):
    s = program_summary(run, "render")
    if s is None:
        return None
    call = total_s(s, "rtw.render.call")
    loop = total_s(s, "rtw.render.loop")
    result = total_s(s, "rtw.render.result")
    if loop is None or result is None or not call:
        return None
    return 100.0 * (call - loop - result) / call
