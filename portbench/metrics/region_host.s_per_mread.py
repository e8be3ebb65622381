"""region_host.s_per_mread: host seconds in the region callers
(germline_caller.call_region, somatic_caller.call_somatic_region) less
the host time of the device entries called inside them, a million
reads of the window."""
from portbench.metrics._common import per_mread, span_s


def read(run):
    regions = [s for s in run["spans"] if s[0] == "region"]
    if not regions:
        return None
    inside = 0.0
    for c in run["calls"]:
        if any(t0 <= c["t0"] and c["t1"] <= t1 for _n, t0, t1 in regions):
            inside += c["t1"] - c["t0"]
    return per_mread(run, span_s(run, "region") - inside)
