"""region.pileup.s_per_mread: the self time of the port's region.pileup
spans in the window (the per-sample pileups), less the spans inside
them (nested region.score, h2d, d2h), host seconds a million reads."""
from portbench.core import program
from portbench.metrics._common import per_mread


def read(run):
    s = program.self_s(program.spans(run), "region.pileup")
    return None if s is None else per_mread(run, s)
