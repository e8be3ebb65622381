"""k1_roofline: K1 (ops.score_kernel.score_best_offsets): the bound of the work its calls'
live extents need (core/peaks.py: the larger of its bytes and its operations over
the card's published peaks),
summed over the window's calls, over the summed time of its kernel
(score_best_offsets_tc_kernel) in the profiler's trace, in percent."""
from portbench.metrics._common import roofline_pct


def read(run):
    return roofline_pct(run, "k1")
