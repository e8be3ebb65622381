"""One configuration's inputs, made from a seed and written to disk."""
from __future__ import annotations

import os
import time

import numpy as np

from . import bamfile, genome

CONTIG = "chr1"


def rng_for(seed: int, stream: int) -> np.random.Generator:
    """The generator of one stream of a run's seed (any whole number)."""
    return np.random.default_rng([int(seed) % (1 << 64), stream])


def make(config: dict, seed: int, workdir: str) -> dict:
    """The reference and one BAM a sample of `config` under `workdir`:
    {"fasta", "bams": {sample: path}, "reads", "genome", "seconds"}."""
    t0 = time.perf_counter()
    g = config["genome"]
    L = int(g["contig_bp"])
    rng = rng_for(seed, 0)
    som = config.get("somatic")
    gen = genome.plant(rng, L, g, som, g["read_len"])
    os.makedirs(workdir, exist_ok=True)
    fasta = os.path.join(workdir, "ref.fa")
    bamfile.write_fasta(fasta, CONTIG, gen.ref)
    bams, reads = {}, 0
    for k, s in enumerate(config["samples"]):
        rs = genome.sample_reads(rng_for(seed, 1 + k), gen, s["depth"],
                                 g["read_len"], g["qual_bins"],
                                 g["qual_shares"], g["mapq"],
                                 bool(s.get("somatic")))
        path = os.path.join(workdir, f"{s['name']}.bam")
        bamfile.write_bam(path, CONTIG, L, rs)
        bams[s["name"]] = path
        reads += len(rs["pos"])
    return {"fasta": fasta, "bams": bams, "reads": reads, "genome": gen,
            "seconds": time.perf_counter() - t0}
