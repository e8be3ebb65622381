"""region.score.s_per_mread: the self time of the port's region.score
spans in the window (realign_batch.score_loci_batched, wherever it
nests: the read tensors, K1's host packing and launches), less the h2d
and d2h spans inside them, host seconds a million reads."""
from portbench.core import program
from portbench.metrics._common import per_mread


def read(run):
    s = program.self_s(program.spans(run), "region.score")
    return None if s is None else per_mread(run, s)
