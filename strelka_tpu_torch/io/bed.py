"""BED interval reading (call regions, nocompress tracks).

Reference analog: htsapi/bed_streamer.hh|cpp.
"""
from __future__ import annotations

import gzip
from dataclasses import dataclass


@dataclass(frozen=True)
class BedRecord:
    chrom: str
    begin: int
    end: int
    rest: str = ""


def read_bed(path: str):
    with open(path, "rb") as probe:
        magic = probe.read(2)
    opener = gzip.open if magic == b"\x1f\x8b" else open
    with opener(path, "rt") as f:
        for line in f:
            if line.startswith(("#", "track", "browser")) or not line.strip():
                continue
            fields = line.rstrip("\n").split("\t")
            yield BedRecord(fields[0], int(fields[1]), int(fields[2]),
                            "\t".join(fields[3:]))
