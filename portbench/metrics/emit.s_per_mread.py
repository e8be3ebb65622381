"""emit.s_per_mread: host seconds in the output (gvcf.emit_region, the
somatic segment's records, and the merge's concat and bgzf writes of
each output file) a million reads of the window."""
from portbench.metrics._common import per_mread, span_s


def read(run):
    if not any(s[0] == "emit" for s in run["spans"]):
        return None
    return per_mread(run, span_s(run, "emit"))
