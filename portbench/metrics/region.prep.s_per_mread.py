"""region.prep.s_per_mread: the self time of the port's region.prep spans
in the window (reference fetch, error model, read filter and
classification, spliced split, expand_alignments and read-indel
extraction), less the spans inside them (nested region.score, h2d,
d2h), host seconds a million reads."""
from portbench.core import program
from portbench.metrics._common import per_mread


def read(run):
    s = program.self_s(program.spans(run), "region.prep")
    return None if s is None else per_mread(run, s)
