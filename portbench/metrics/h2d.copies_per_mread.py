"""h2d.copies_per_mread: the port's copies from the host to the card in
the window's jobs (its h2d.copies counters, every site), a million
reads."""
from portbench.core import program
from portbench.metrics._common import per_mread


def read(run):
    got = program.counters(run).get("h2d.copies")
    return None if not got else per_mread(run, sum(got.values()))
