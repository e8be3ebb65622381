"""region.genotype.s_per_mread: the self time of the port's
region.genotype spans in the window (indel and SNV genotyping
(germline, with the forced output) or the somatic SNV model and
indels, with the device entries' host preparation), less the spans
inside them (nested region.score, h2d, d2h), host seconds a million
reads."""
from portbench.core import program
from portbench.metrics._common import per_mread


def read(run):
    s = program.self_s(program.spans(run), "region.genotype")
    return None if s is None else per_mread(run, s)
