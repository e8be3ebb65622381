"""decode.s_per_mread: host seconds in the input decode
(io.bam.read_alignments, read_alignments_regions) a million reads of
the window."""
from portbench.metrics._common import per_mread, span_s


def read(run):
    if not any(s[0] == "decode" for s in run["spans"]):
        return None
    return per_mread(run, span_s(run, "decode"))
