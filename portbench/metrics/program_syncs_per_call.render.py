"""Blocking host reads a forward call, as the program counts them: the
``rtw.sync.*`` counters over the count of ``rtw.render.call`` spans, in
the traced sub-window. Each read is one stream synchronise; a copy to the
host also shows as a ``Memcpy DtoH`` in ``host_syncs_per_mpath.render``."""

from portbench.harness.spans import program_summary, roots, syncs


def read(run):
    s = program_summary(run, "render")
    if s is None:
        return None
    return syncs(s) / roots(s, "render")
