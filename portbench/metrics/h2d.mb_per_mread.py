"""h2d.mb_per_mread: the bytes the port copied from the host to the
card in the window's jobs (its h2d.bytes counters, every site), in MB
(1e6 bytes) a million reads."""
from portbench.core import program
from portbench.metrics._common import per_mread


def read(run):
    got = program.counters(run).get("h2d.bytes")
    return None if not got else per_mread(run, sum(got.values()) / 1e6)
