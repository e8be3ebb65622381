"""region.candidates.s_per_mread: the self time of the port's
region.candidates spans in the window (external and forced VCF
alleles, ploidy, candidacy, locus formation and the allele selection
of rounds A and B), less the spans inside them (nested region.score,
h2d, d2h), host seconds a million reads."""
from portbench.core import program
from portbench.metrics._common import per_mread


def read(run):
    s = program.self_s(program.spans(run), "region.candidates")
    return None if s is None else per_mread(run, s)
