"""region.realign.s_per_mread: the self time of the port's region.realign
spans in the window (apply_realignments and the breakpoint clips),
less the spans inside them (nested region.score, h2d, d2h), host
seconds a million reads."""
from portbench.core import program
from portbench.metrics._common import per_mread


def read(run):
    s = program.self_s(program.spans(run), "region.realign")
    return None if s is None else per_mread(run, s)
