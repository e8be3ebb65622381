"""region.discover.s_per_mread: the self time of the port's
region.discover spans in the window (anchor mask, variant evidence,
the region tracker and process_active_region (germline only)), less
the spans inside them (nested region.score, h2d, d2h), host seconds a
million reads."""
from portbench.core import program
from portbench.metrics._common import per_mread


def read(run):
    s = program.self_s(program.spans(run), "region.discover")
    return None if s is None else per_mread(run, s)
