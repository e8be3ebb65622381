"""device_wait.s_per_mread: host seconds in the port's h2d and d2h
spans in the window, a million reads: the host blocked on uploads from
pageable memory, and on pulls, which also wait for the kernels queued
before them."""
from portbench.core import program
from portbench.metrics._common import per_mread


def read(run):
    spans = program.spans(run)
    if not any(s["name"] == "job" for s in spans):
        return None
    return per_mread(run, program.total_s(spans, ("h2d", "d2h")))
