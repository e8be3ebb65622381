"""snv_tiles_roofline: KG-H's lanes entry (models.snv_digt.call_snv_lanes_tile): the bound of the work its calls'
live extents need (core/peaks.py: the larger of its bytes and its operations over
the card's published peaks),
summed over the window's calls, over the summed time of its kernel
(snv_lanes_tile_kernel) in the profiler's trace, in percent."""
from portbench.metrics._common import roofline_pct


def read(run):
    return roofline_pct(run, "snv_tiles")
