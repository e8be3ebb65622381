"""job_host.s_per_mread: host seconds of the port's job spans in the
window outside every decode, region, emit and merge span inside them, a
million reads: the CLI's own set-up, depth estimate, segment slicing,
fragment files and run stats."""
from portbench.core import program
from portbench.metrics._common import per_mread


def read(run):
    s = program.outside_s(program.spans(run), "job")
    return None if s is None else per_mread(run, s)
