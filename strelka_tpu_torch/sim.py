"""Model-level site simulators for statistical caller validation.

Reference: applications/starling/starling_sim_test.{hh,cpp} and
applications/strelka/strelka_sim_test.{hh,cpp} — generate synthetic
pileups directly from the error model and drive the calling models
without BAMs. Ports: the qval distribution input (qval_distro,
strelka_sim_test.cpp:126-203), the stranded binomial pile generator
(sim_sample_pi :209-247), and the somatic grid-state site simulation
(SIM_RANDOM drawing NOISE/SOMATIC/GERMLINE/REF per site with
purity-adjusted alt frequencies, :295-365). One deliberate divergence:
the reference's SIM_RANDOM loop overwrites sim_opt.mode with the first
non-REF draw and never resets it (strelka_sim_test.cpp:300-316), which
freezes every later site in that state; here the state is drawn
independently per site.

A germline indel locus simulator (model-layer: per-read allele
likelihoods from an indel error rate, driving
models/indel_genotype.genotype_log_lhoods) covers the indel calibration
role the reference leaves to its full-pipeline sims.

Port of strelka_tpu/sim.py: the same simulators, drawing from an
explicit np.random.Generator in the same order, so that one seed gives
the JAX package's draws exactly. Drawing is host work in both packages;
what the draws feed (the SNV tiles, models/snv_digt.call_snv_tile, and
the somatic SNV model, models/somatic_snv) runs on the device of the
tensors it is given. call_simulated_indel_locus drives the port's
models/indel_genotype (host f64).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class SimOptions:
    depth: float = 30.0
    qscore: int = 30
    ref_base: int = 0


class QvalDistro:
    """Basecall quality distribution: constant, or sampled from a
    'qval count' table file ('#' comments allowed) via the discrete
    cdf (qval_distro, strelka_sim_test.cpp:126-203)."""

    def __init__(self, constval: int = 30):
        self._const = int(constval)
        self._ids = None
        self._cdf = None

    @classmethod
    def from_file(cls, path: str) -> "QvalDistro":
        ids: list[int] = []
        weights: list[float] = []
        with open(path) as f:
            for line in f:
                w = line.split()
                if not w or w[0].startswith("#"):
                    continue
                ids.append(int(w[0]))
                weights.append(float(w[1]))
        if not ids:
            raise ValueError(f"empty qval distro file: {path}")
        self = cls()
        self._ids = np.asarray(ids, dtype=np.int32)
        cdf = np.cumsum(np.asarray(weights, dtype=np.float64))
        self._cdf = cdf / cdf[-1]
        return self

    def sample(self, rng: np.random.Generator, n: int) -> np.ndarray:
        if self._ids is None:
            return np.full(n, self._const, dtype=np.int32)
        idx = np.searchsorted(self._cdf, rng.random(n), side="left")
        return self._ids[np.minimum(idx, len(self._ids) - 1)]


def sim_sample_pile(rng: np.random.Generator, cov_mean: float,
                    qdist: QvalDistro, ref_id: int, alt_id: int,
                    alt_freq: float):
    """One stranded pileup (base_ids, quals, is_fwd): Poisson coverage,
    fwd/rev split Binom(cov, 0.5), per-strand alt counts
    Binom(strand_cov, alt_freq), per-call qval from the distro, basecall
    errors at the phred rate mutating to one of the 3 other bases
    (sim_sample_pi, strelka_sim_test.cpp:209-247)."""
    cov = int(rng.poisson(cov_mean))
    fwd_cov = int(rng.binomial(cov, 0.5)) if cov else 0
    rev_cov = cov - fwd_cov
    fwd_alt = int(rng.binomial(fwd_cov, alt_freq)) if alt_freq > 0 else 0
    rev_alt = int(rng.binomial(rev_cov, alt_freq)) if alt_freq > 0 else 0

    true_ids = np.full(cov, ref_id, dtype=np.int32)
    true_ids[:fwd_alt] = alt_id
    true_ids[fwd_cov:fwd_cov + rev_alt] = alt_id
    is_fwd = np.zeros(cov, dtype=bool)
    is_fwd[:fwd_cov] = True

    quals = qdist.sample(rng, cov)
    err = rng.random(cov) < 10.0 ** (-quals / 10.0)
    # mutate to one of the three other bases, uniformly
    mut = (true_ids + rng.integers(1, 4, cov)) % 4
    bases = np.where(err, mut, true_ids).astype(np.int32)
    return bases, quals.astype(np.int32), is_fwd


def simulate_site_pileup(rng: np.random.Generator, gt_bases: tuple[int, int],
                         opt: SimOptions, qdist: QvalDistro | None = None):
    """One diploid site pileup (base_ids, quals, is_fwd): het genotypes
    use the stranded Binom(0.5) allele split (starling_sim_test pile
    gen)."""
    qdist = qdist or QvalDistro(opt.qscore)
    a0, a1 = gt_bases
    if a0 == a1:
        return sim_sample_pile(rng, opt.depth, qdist, a0, a0, 0.0)
    return sim_sample_pile(rng, opt.depth, qdist, a0, a1, 0.5)


def simulate_germline_sites(rng, n_sites: int, gt_bases, opt: SimOptions,
                            qdist: QvalDistro | None = None):
    """Padded [n_sites, D] tile arrays for the batched SNV caller."""
    cols = [simulate_site_pileup(rng, gt_bases, opt, qdist)
            for _ in range(n_sites)]
    D = max(max(len(c[0]) for c in cols), 1)
    base = np.zeros((n_sites, D), np.int32)
    qual = np.zeros((n_sites, D), np.int32)
    fwd = np.zeros((n_sites, D), bool)
    mask = np.zeros((n_sites, D), bool)
    for i, (b, q, f) in enumerate(cols):
        base[i, :len(b)] = b
        qual[i, :len(b)] = q
        fwd[i, :len(b)] = f
        mask[i, :len(b)] = True
    return base, qual, fwd, mask


def simulate_somatic_site(rng, normal_gt: tuple[int, int],
                          tumor_alt_freq: float, alt_base: int,
                          normal_opt: SimOptions, tumor_opt: SimOptions,
                          qdist: QvalDistro | None = None):
    """Tumor/normal pileup pair: normal drawn from its genotype, tumor
    from a continuous alt fraction (strelka_sim_test somatic mode)."""
    qdist = qdist or QvalDistro(normal_opt.qscore)
    nb, nq, nf = simulate_site_pileup(rng, normal_gt, normal_opt, qdist)
    tq_dist = qdist if qdist._ids is not None else QvalDistro(tumor_opt.qscore)
    tb, tq, tf = sim_sample_pile(rng, tumor_opt.depth, tq_dist,
                                 tumor_opt.ref_base, alt_base,
                                 tumor_alt_freq)
    return (nb, nq, nf), (tb, tq, tf)


# ---- somatic grid-state simulation (strelka_site_sim port) ----

SIM_REF = "REF"
SIM_NOISE = "NOISE"
SIM_SOMATIC = "SOMATIC"
SIM_GERMLINE = "GERMLINE"


@dataclass
class StrelkaSimOptions:
    """strelka_site_sim_options (strelka_sim_test.hh:27-50) + the
    strelka_options priors the state draw reads."""
    total_sites: int = 1000
    ncov: float = 35.0
    tcov: float = 35.0
    ssnv_prior: float = 1e-6
    shared_site_error_rate: float = 5e-7   # ssnvNoise default
    bsnp_diploid_theta: float = 0.001
    normal_purity: float = 1.0
    tumor_purity: float = 1.0
    mode: str = "RANDOM"
    ref_base: int = 0


@dataclass
class SimulatedSite:
    """One simulated T/N site + its oracle state (oracle_file analog)."""
    mode: str
    alt_id: int
    normal_alt_freq: float
    tumor_alt_freq: float
    normal: tuple  # (base_ids, quals, is_fwd)
    tumor: tuple


def _mut_base_id(rng, base_id: int) -> int:
    b = int(rng.integers(0, 3))
    return b + 1 if b >= base_id else b


def simulate_strelka_sites(rng: np.random.Generator,
                           opt: StrelkaSimOptions,
                           qdist: QvalDistro | None = None):
    """Yield SimulatedSite records per the reference's state machine
    (strelka_site_sim, strelka_sim_test.cpp:295-365):

      NOISE    shared alt at one uniform-random freq in both samples
      SOMATIC  tumor alt at 0.5*tumor_purity; normal contamination
               at 0.5*(1-normal_purity)
      GERMLINE shared het (freq 0.5) or hom (freq 1.0, p=1/3)
      REF      no alt
    """
    qdist = qdist or QvalDistro(30)
    ref_id = opt.ref_base
    for _ in range(opt.total_sites):
        mode = opt.mode
        if mode == "RANDOM":
            if rng.random() < opt.shared_site_error_rate:
                mode = SIM_NOISE
            elif rng.random() < opt.ssnv_prior:
                mode = SIM_SOMATIC
            elif rng.random() < opt.bsnp_diploid_theta:
                mode = SIM_GERMLINE
            else:
                mode = SIM_REF

        nalt_id = ref_id
        nalt_freq = 0.0
        talt_freq = 0.0
        if mode == SIM_NOISE:
            nalt_id = _mut_base_id(rng, ref_id)
            nalt_freq = talt_freq = float(rng.random())
        elif mode == SIM_SOMATIC:
            nalt_id = _mut_base_id(rng, ref_id)
            nalt_freq = 0.5 * (1.0 - opt.normal_purity)
            talt_freq = 0.5 * opt.tumor_purity
        elif mode == SIM_GERMLINE:
            nalt_id = _mut_base_id(rng, ref_id)
            nalt_freq = 1.0 if rng.random() <= 1.0 / 3.0 else 0.5
            talt_freq = nalt_freq

        normal = sim_sample_pile(rng, opt.ncov, qdist, ref_id, nalt_id,
                                 nalt_freq)
        tumor = sim_sample_pile(rng, opt.tcov, qdist, ref_id, nalt_id,
                                talt_freq)
        yield SimulatedSite(mode, nalt_id, nalt_freq, talt_freq,
                            normal, tumor)


# ---- germline indel locus simulation (model-layer) ----

@dataclass
class IndelSimOptions:
    depth: float = 30.0
    error_rate: float = 1e-3   # indel error rate for this STR context
    read_len: int = 100
    insert_len: int = 0
    delete_len: int = 1


def simulate_indel_locus(rng: np.random.Generator, n_alt_copies: int,
                         opt: IndelSimOptions):
    """Per-read ref/alt log likelihoods for one diploid indel locus:
    each read samples its true allele from the genotype and reports
    ln(1-e)/ln(e) likelihood columns (the shape of the realignment
    scorer's output for clean reads).

    Returns (allele_lhoods [R,2] f64, read_len [R], n_nonambig [R]).
    """
    assert 0 <= n_alt_copies <= 2
    r = max(int(rng.poisson(opt.depth)), 1)
    alt_p = n_alt_copies / 2.0
    is_alt = rng.random(r) < alt_p
    is_err = rng.random(r) < opt.error_rate
    observes_alt = is_alt ^ is_err
    ln_hit = np.log1p(-opt.error_rate)
    ln_miss = np.log(opt.error_rate)
    lhoods = np.where(observes_alt[:, None],
                      np.array([[ln_miss, ln_hit]]),
                      np.array([[ln_hit, ln_miss]]))
    read_len = np.full(r, opt.read_len, dtype=np.int64)
    return lhoods, read_len, read_len.copy()


def call_simulated_indel_locus(lhoods, read_len, n_nonambig,
                               opt: IndelSimOptions,
                               pattern_size: int = 1,
                               repeat_count: int = 1):
    """Drive models/indel_genotype end to end on one simulated locus;
    returns (max_gt_index, qphred_ref, qphred_gt) with genotype order
    (ref/ref, ref/alt, alt/alt)."""
    from .models import indel_genotype as ig

    info = ig.AlleleInfo(insert_len=np.array([opt.insert_len]),
                         delete_len=np.array([opt.delete_len]))
    gl = ig.genotype_log_lhoods(
        lhoods, np.ones(len(read_len), bool), read_len, n_nonambig,
        info, ploidy=2, min_read_bp_flank=6)
    priors6 = ig.context_priors_for(pattern_size, repeat_count).diploid
    ln_priors = ig.ag_genotype_priors_to_triangular(priors6, 2, 2)
    post = ig.genotype_posteriors(gl, ln_priors)
    return post[1], post[2], post[3]
