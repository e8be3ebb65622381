"""somatic_grid_roofline: KS-G (models.somatic_snv.freq_grid_lhoods): the bound of the work its calls'
live extents need (core/peaks.py: the larger of its bytes and its operations over
the card's published peaks),
summed over the window's calls, over the summed time of its kernel
(somatic_grid_kernel) in the profiler's trace, in percent."""
from portbench.metrics._common import roofline_pct


def read(run):
    return roofline_pct(run, "somatic_grid")
