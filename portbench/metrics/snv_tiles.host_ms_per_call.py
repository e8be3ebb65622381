"""snv_tiles.host_ms_per_call: the mean host time of a call of KG-H's
lanes entry (models.snv_digt.call_snv_lanes_tile), by the wrapper's
host clock, in ms: the launch, the copies and the host work around the
kernel that the host waits for a call. (Host time less stream time
reads below zero on the H100: the call returns before its kernel
ends.)"""


def read(run):
    calls = [c for c in run["calls"] if c["entry"] == "snv_tiles"]
    if not calls:
        return None
    return sum(c["host_ms"] for c in calls) / len(calls)
