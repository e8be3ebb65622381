"""Somatic SNV strand-grid model (tumor/normal joint calling).

Reference: applications/strelka/position_somatic_snv_strand_grid.cpp,
position_somatic_snv_strand_grid_lhood_cached.cpp, qscore_calculator.cpp
calculate_result_set_grid:46-209, strelka_digt_states.hh (DIGT_GRID:
21 pre-strand frequency states = {REF=0, HOM=1, HET=0.5} + 18 grid
fractions; + 9 tumor strand states).

Every state is an expected non-ref allele frequency f, and each
basecall contributes
    obs==ref:  ln((1-e)(1-f) + (e/3) f)
    obs!=ref:  ln((1-e) f    + (e/3)(1-f))
so a pileup tile reduces to per-locus (qscore, class) histograms times
[Q, F] log-contribution tables, and the (Gn x somatic x Fn x Ft) joint
posterior is a masked logsumexp against precomputed prior tensors.

Port of strelka_tpu/models/somatic_snv.py. The state space and the
numpy tables are copies. The two device programs, freq_grid_lhoods and
somatic_snv_call, have plain versions (freq_grid_lhoods_plain,
somatic_snv_call_plain: torch ops on the tile's device, the CPU path)
and, on the card, one kernel each, KS-G (csrc/somatic_grid.cu, a launch
a sample) and KS-P (csrc/somatic_posterior.cu), which give the plain
versions' bits there. The plain versions are written so that a CUDA run
gives the CPU run's bits:

- the histogram is an int32 scatter-add (exact in any order), and each
  [L,128]@[128,F] product is summed in a fixed order — the order of the
  XLA CPU dot that the JAX package runs there: four fused-multiply-add
  accumulators over k = j (mod 4), ascending, combined as
  (a0 + a1) + (a2 + a3) — with each FMA emulated exactly
  (snv_digt._fma_f32), so the grid lhoods equal the JAX package's;
- the f32 logsumexps of the reference are taken in float64 with a
  fixed-order sum and rounded to f32 where the reference holds f32;
  they differ from XLA's f32 exp/log by an ulp at times, and between
  devices only where CUDA's and the CPU's float64 exp/log differ in the
  last bit and that bit decides an f32 rounding;
- divisions take their divisors as device tensors (snv_digt._div).
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from .. import device as devmod
from .snv_digt import _i32

# --- state space (strelka_digt_states.hh) ---------------------------------
HET_RES = 9
HET_COUNT = HET_RES * 2 + 1
PRESTRAND_SIZE = 2 + HET_COUNT          # 21
STRAND_STATE_SIZE = HET_RES             # 9
GRID_SIZE = PRESTRAND_SIZE + STRAND_STATE_SIZE
RATIO_INCREMENT = 0.5 / (HET_RES + 1)   # 0.05

REF, HOM, HET = 0, 1, 2  # SOMATIC_DIGT
NON_SOMATIC, SOMATIC = 0, 1


def fraction_from_index(i: int) -> float:
    """strelka_digt_states.cpp get_fraction_from_index."""
    if i == REF:
        return 0.0
    if i == HOM:
        return 1.0
    if i == HET:
        return 0.5
    if i < 3 + HET_RES:
        return RATIO_INCREMENT * (i - 3 + 1)
    return RATIO_INCREMENT * (i - 3 + 2)


FRACTIONS = np.array([fraction_from_index(i) for i in range(PRESTRAND_SIZE)])
STRAND_FRACTIONS = np.array([(i + 1) * RATIO_INCREMENT for i in range(HET_RES)])


# --- per-sample frequency-grid likelihoods --------------------------------

_QTAB_SIZE = 128


@functools.lru_cache(maxsize=1)
def _freq_grid_tables():
    """[Q, F] / [Q, S] f32 log-contribution tables per basecall qscore.
    Values match the inline f32 formulas bit for bit."""
    q = np.arange(_QTAB_SIZE, dtype=np.float32)
    with np.errstate(divide="ignore"):
        e = np.power(np.float32(10.0), -q / np.float32(10.0),
                     dtype=np.float32)
        ce = (np.float32(1.0) - e).astype(np.float32)
        f = np.asarray(FRACTIONS, np.float32)
        r = np.asarray(STRAND_FRACTIONS, np.float32)
        ref_t = np.log(ce[:, None] * (1 - f) + (e[:, None] / 3.0) * f
                       ).astype(np.float32)
        alt_t = np.log(ce[:, None] * f + (e[:, None] / 3.0) * (1 - f)
                       ).astype(np.float32)
        on_ref = np.log(ce[:, None] * (1 - r) + (e[:, None] / 3.0) * r
                        ).astype(np.float32)
        on_alt = np.log(ce[:, None] * r + (e[:, None] / 3.0) * (1 - r)
                        ).astype(np.float32)
        off_ref = (np.log(ce)[:, None] * np.ones_like(r)).astype(np.float32)
        off_alt = ((np.log(e) + np.log(np.float32(1.0 / 3.0)))[:, None]
                   * np.ones_like(r)).astype(np.float32)
    return ref_t, alt_t, on_ref, on_alt, off_ref, off_alt


@functools.lru_cache(maxsize=1)
def _freq_grid_matmul_tables():
    """Tables for the histogram product, with the three -inf entries
    (q=0: ln(1-e)=ln 0) zeroed out of the product and re-applied
    exactly afterwards."""
    ref_t, alt_t, on_ref, on_alt, off_ref, off_alt = _freq_grid_tables()
    ref_m = ref_t.copy()
    alt_m = alt_t.copy()
    off_ref_m = off_ref.copy()
    ref_m[0, 0] = 0.0        # ref call, f=0 state (REF) at q=0
    alt_m[0, 1] = 0.0        # alt call, f=1 state (HOM) at q=0
    off_ref_m[0, :] = 0.0    # off-strand ref call at q=0
    return ref_m, alt_m, on_ref, on_alt, off_ref_m, off_alt


# tile launches of the torch device programs: {(kind, device type,
# rows, depth): count}, kind "grid" (freq_grid_lhoods, one sample) or
# "post" (somatic_snv_call, depth 0). Always on; a caller resets it
# with LAUNCH_STATS.clear().
LAUNCH_STATS: dict = {}


def _tally(kind, dev, rows, depth):
    k = (kind, dev.type, int(rows), int(depth))
    LAUNCH_STATS[k] = LAUNCH_STATS.get(k, 0) + 1


def _grid_dot(h, tab, cols):
    """sum_k h[n, l, k] * tab[n, k, f] -> [n, L, F] f32 in the XLA CPU
    dot's order: accumulator j = k mod 4 takes its k ascending, one f32
    FMA each, and the four are combined as (a0 + a1) + (a2 + a3).

    h [n, L, Q] integer counts, tab [n, Q, F] f32 (finite), cols the
    host list of slots k that may be non-zero (ascending; a slot whose
    counts are all zero adds exactly nothing, fma(0, t, a) == a)."""
    from .snv_digt import _fma_f32
    n, L, _q = h.shape
    F = tab.shape[2]
    acc = torch.zeros((n, L, 4, F), dtype=torch.float32, device=h.device)
    ks, live = _chain_slots(tuple(cols), h.device)
    for i in range(ks.shape[0]):
        cnt = torch.where(live[i], h[:, :, ks[i]], 0).to(torch.float32)
        acc = _fma_f32(cnt[..., None], tab[:, ks[i]][:, None], acc)
    return ((acc[:, :, 0] + acc[:, :, 1])
            + (acc[:, :, 2] + acc[:, :, 3]))


@functools.lru_cache(maxsize=64)
def _chain_slots(cols, dev):
    """([steps, 4] slot, [steps, 4] live) on `dev`: step i of chain j
    takes the i-th slot k of `cols` with k = j (mod 4); a chain shorter
    than the longest is padded with a dead entry (slot 0, count 0).
    Cached, so a run of tiles with the same slots copies them once."""
    chains = [[k for k in cols if k % 4 == j] for j in range(4)]
    steps = max(len(c) for c in chains)
    ks = torch.tensor([[c[i] if i < len(c) else 0 for c in chains]
                       for i in range(steps)], dtype=torch.int64)
    live = torch.tensor([[i < len(c) for c in chains]
                         for i in range(steps)], dtype=torch.bool)
    return ks.reshape(steps, 4).to(dev), live.reshape(steps, 4).to(dev)


def _logaddexp64(a, b):
    """jnp.logaddexp in float64: max + log1p(exp(-|a-b|)), and a + b
    where a - b is NaN (both -inf)."""
    d = a - b
    out = torch.maximum(a, b) + torch.log1p(torch.exp(-torch.abs(d)))
    return torch.where(torch.isnan(d), a + b, out)


def _tree_sum(x):
    """Sum over the last axis in a fixed pairwise order (zero-padded to
    a power of two), the same on every device."""
    n = x.shape[-1]
    p = 1 << max(n - 1, 0).bit_length()
    if p != n:
        x = torch.cat([x, x.new_zeros(x.shape[:-1] + (p - n,))], dim=-1)
    while x.shape[-1] > 1:
        h = x.shape[-1] // 2
        x = x[..., :h] + x[..., h:]
    return x[..., 0]


def _seq_sum(x):
    """Sum over a short last axis left to right, one add at a time (the
    order of XLA's CPU reduction of the JAX package's 3- and 6-wide
    posterior sums, whose complements cancel: another order moves a
    phred value by more than one)."""
    s = x[..., 0]
    for i in range(1, x.shape[-1]):
        s = s + x[..., i]
    return s


def _logsumexp64(a):
    """jax.scipy.special.logsumexp over the last axis, in float64 (a of
    any float type): a row of -inf gives -inf (the max is replaced by 0
    where it is not finite, so no -inf - -inf NaN)."""
    a = a.to(torch.float64)
    amax = torch.amax(a, dim=-1)
    t = torch.where(torch.isfinite(amax), amax, torch.zeros_like(amax))
    s = _tree_sum(torch.exp(a - t[..., None]))
    return torch.log(torch.abs(s)) + t


def freq_grid_lhoods(base_id, qual, mask, is_fwd, ref_gt):
    """[L, GRID_SIZE] f32 log lhoods for a pileup tile (torch tensors on
    one device).

    base_id/qual/mask/is_fwd: [L, D]; ref_gt: [L]. States 0..20 =
    symmetric frequency grid; 21..29 = strand states (max over fwd-only
    / rev-only noise, get_strand_ratio_lhood_spi).

    On CPU tensors this runs the plain version (freq_grid_lhoods_plain);
    on any other device the kernel KS-G (ops/snv_kernels.somatic_grid,
    csrc/somatic_grid.cu), which gives the plain version's bits. KS-G
    reads the native pileup's lanes (int8 base ids, int16 qscores, int32
    ref_gt); integers of other widths (the Python pileup's and the
    simulators' int32) are cast to those first: base ids are -1..4 and
    qscores fit int16.
    """
    dev = base_id.device
    L, D = base_id.shape
    _tally("grid", dev, L, D)
    if dev.type == "cpu":
        return freq_grid_lhoods_plain(base_id, qual, mask, is_fwd, ref_gt)
    from ..convert import somatic_grid_tables
    from ..ops import snv_kernels
    base_id, qual, ref_gt = (base_id.to(torch.int8), qual.to(torch.int16),
                             ref_gt.to(torch.int32))
    return snv_kernels.somatic_grid(base_id, qual, mask, is_fwd, ref_gt,
                                    somatic_grid_tables(dev), _LN_HALF_F32)


def freq_grid_lhoods_plain(base_id, qual, mask, is_fwd, ref_gt):
    """The plain version of freq_grid_lhoods, as torch ops on the tile's
    device: the CPU path, and what KS-G is held to on the card."""
    dev = base_id.device
    L, D = base_id.shape
    from ..convert import somatic_grid_tables
    from ..ops import snv_kernels
    snv_kernels.count_plain("somatic_grid", dev)
    tabs = somatic_grid_tables(dev)
    q_idx = torch.clamp(qual.to(torch.int64), 0, _QTAB_SIZE - 1)
    rg = ref_gt.to(torch.int64)[:, None]
    b = base_id.to(torch.int64)
    is_ref = (b == rg) & mask
    is_alt = (b != rg) & mask
    valid = is_ref | is_alt
    # class packing: (is_alt << 1) | is_fwd; invalid lanes -> overflow bin
    cls = (is_alt.to(torch.int64) << 1) | is_fwd.to(torch.int64)
    idx = torch.where(valid, q_idx * 4 + cls, 4 * _QTAB_SIZE)
    hist = torch.zeros((L, 4 * _QTAB_SIZE + 1), dtype=torch.int32,
                       device=dev)
    hist.scatter_add_(1, idx, torch.ones_like(idx, dtype=torch.int32))
    h = hist[:, :4 * _QTAB_SIZE].reshape(L, _QTAB_SIZE, 4)
    h_ref_rev, h_ref_fwd = h[:, :, 0], h[:, :, 1]
    h_alt_rev, h_alt_fwd = h[:, :, 2], h[:, :, 3]
    h_ref = h_ref_rev + h_ref_fwd
    h_alt = h_alt_rev + h_alt_fwd
    # the qscore slots that hold a call in some row (one read back to
    # the host); every other slot adds exactly nothing to the products
    cols = torch.nonzero(h.any(dim=2).any(dim=0))[:, 0].tolist()

    ref_m, alt_m, on_ref, on_alt, off_ref_m, off_alt = (
        tabs[n] for n in ("grid_ref", "grid_alt", "grid_on_ref",
                          "grid_on_alt", "grid_off_ref", "grid_off_alt"))
    g = _grid_dot(torch.stack([h_ref, h_alt]),
                  torch.stack([ref_m, alt_m]), cols)
    lh = g[0] + g[1]                                               # [L, F]
    # strand states: on-strand noise at ratio r, off strand pure ref
    s = _grid_dot(
        torch.stack([h_ref_fwd, h_alt_fwd, h_ref_rev, h_alt_rev,
                     h_ref_rev, h_alt_rev, h_ref_fwd, h_alt_fwd]),
        torch.stack([on_ref, on_alt, off_ref_m, off_alt] * 2), cols)
    lh_fwd = ((s[0] + s[1]) + s[2]) + s[3]                         # [L, S]
    lh_rev = ((s[4] + s[5]) + s[6]) + s[7]

    # exact -inf re-application for the q=0 ln(0) entries
    ninf = float("-inf")
    q0_ref_fwd = h_ref_fwd[:, 0] > 0
    q0_ref_rev = h_ref_rev[:, 0] > 0
    q0_alt = (h_alt_fwd[:, 0] + h_alt_rev[:, 0]) > 0
    lh[:, 0].masked_fill_(q0_ref_fwd | q0_ref_rev, ninf)
    lh[:, 1].masked_fill_(q0_alt, ninf)
    lh_fwd = lh_fwd.masked_fill(q0_ref_rev[:, None], ninf)
    lh_rev = lh_rev.masked_fill(q0_ref_fwd[:, None], ninf)

    strand = (_logaddexp64(lh_fwd.to(torch.float64),
                           lh_rev.to(torch.float64)).to(torch.float32)
              + _LN_HALF_F32)
    return torch.cat([lh, strand], dim=-1)                         # [L, 30]


_LN_HALF_F32 = float(np.float32(np.log(0.5)))


# --- joint posterior prior tensors ----------------------------------------

@functools.lru_cache(maxsize=8)
def build_joint_prior(contam_tolerance: float, shared_error_rate: float,
                      somatic_rate: float, theta: float,
                      sse_strand_fraction: float = 0.5):
    """Precompute the (ngt, tgt, fn, ft) log-prior tensor with -inf at
    excluded combinations (qscore_calculator.cpp:67-142) plus the
    (ngt, tgt) genotype prior.

    ln_sse uses only the non-strand-specific portion of the shared
    error rate while the complement uses the full rate
    (somatic_snv_caller_strand_grid ctor,
    position_somatic_snv_strand_grid.cpp:43-55)."""
    log_error_mod = -np.log(PRESTRAND_SIZE - 1)
    ln_half = np.log(0.5)
    ln_sse = np.log(shared_error_rate * (1.0 - sse_strand_fraction))
    ln_csse = np.log1p(-shared_error_rate)

    pf = np.full((3, 2, PRESTRAND_SIZE, PRESTRAND_SIZE), -np.inf)
    for ngt in range(3):
        for fti in range(PRESTRAND_SIZE):
            ft = FRACTIONS[fti]
            consider_contam = contam_tolerance * ft >= RATIO_INCREMENT
            for fni in range(PRESTRAND_SIZE):
                # non-somatic: Fn == Ft
                if fni == fti:
                    pf[ngt, NON_SOMATIC, fni, fti] = (
                        ln_csse if fni == ngt else ln_sse + log_error_mod)
                else:
                    # somatic: Fn != Ft
                    if ngt != REF:
                        if fni == ngt:
                            pf[ngt, SOMATIC, fni, fti] = log_error_mod
                    else:
                        if not consider_contam:
                            if fni == 0:
                                pf[ngt, SOMATIC, fni, fti] = log_error_mod
                        else:
                            if fni == ngt or fni == 3:  # Fn=0 or Fn=0.05
                                pf[ngt, SOMATIC, fni, fti] = (
                                    log_error_mod + ln_half)
    # genotype priors
    g = np.empty(3)
    g[REF] = np.log1p(-(3.0 * theta) / 2.0)
    g[HOM] = np.log(theta / 2.0)
    g[HET] = np.log(theta)
    lnmatch = np.log1p(-somatic_rate)
    lnmismatch = np.log(somatic_rate)
    gp = g[:, None] + np.array([lnmatch, lnmismatch])[None, :]  # [3, 2]
    return pf.astype(np.float32), gp.astype(np.float32)


class SomaticSnvResult(NamedTuple):
    qphred: torch.Tensor            # [L] int32 Q(somatic)
    from_ntype_qphred: torch.Tensor # [L] int32 Q(somatic & normal=ntype)
    ntype: torch.Tensor             # [L] int32 normal genotype (REF/HOM/HET)
    max_gt: torch.Tensor            # [L] int32 DDIGT joint state
    strand_bias: torch.Tensor       # [L] f32
    nonsomatic_qphred: torch.Tensor # [L] int32


# Peak bytes one row holds while the plain versions run, rounded up:
# somatic_snv_call_plain keeps the [3,2,21,21] f32 sum, its float64
# copy, the exp and the power-of-two padded tree sum alive at once
# (about 81 KB); freq_grid_lhoods_plain holds the histogram and the
# exact-FMA temporaries (about 27 KB) plus about 35 bytes per depth
# lane. chip_smoke.py (phase 3b) measures both on the card and fails if
# they are exceeded.
CALL_ROW_BYTES = 96 << 10
GRID_ROW_BYTES = 32 << 10
GRID_LANE_BYTES = 64
# The same for the kernels KS-P and KS-G, which keep a row's work on the
# chip: their inputs and outputs alone. KS-P reads two [30] f32 lhood
# rows and writes five int32 fields and an f32; KS-G writes a [30] f32
# row from an int32 ref_gt, and its depth lanes are at most 4 bytes of
# base and of qual, a byte each of mask and strand, and the two bool
# masks the somatic caller ANDs into the use mask.
KERNEL_CALL_ROW_BYTES = 2 * GRID_SIZE * 4 + 6 * 4
KERNEL_GRID_ROW_BYTES = GRID_SIZE * 4 + 4
KERNEL_GRID_LANE_BYTES = 12


def call_row_bytes(dev) -> int:
    """Bytes a row of somatic_snv_call holds on `dev` (the plain
    version's on the CPU, the kernel's elsewhere)."""
    return (CALL_ROW_BYTES if torch.device(dev).type == "cpu"
            else KERNEL_CALL_ROW_BYTES)


def tile_row_bytes(dev, depth: int) -> int:
    """Bytes a row of a tier1 chunk holds on `dev`: the posterior and a
    sample's grid lhoods at `depth` lanes."""
    if torch.device(dev).type == "cpu":
        return CALL_ROW_BYTES + GRID_ROW_BYTES + GRID_LANE_BYTES * depth
    return (KERNEL_CALL_ROW_BYTES + KERNEL_GRID_ROW_BYTES
            + KERNEL_GRID_LANE_BYTES * depth)


# the working-set budget on the host; a card offers half of its free
# memory (the caching allocator's idle blocks included), divided among
# the local workers that share it
HOST_BUDGET_BYTES = 768 << 20
# rows per launch at most, so that no tensor reaches 2^31 elements (the
# padded [rows, 3, 2, 512] tree sum) and every op keeps 32-bit indexing
MAX_ROWS = 1 << 19


def rows_per_launch(dev, row_bytes: int) -> int:
    """How many rows of `row_bytes` each fit one launch on `dev`: the
    memory budget over the row's bytes, a multiple of 1024 between 1024
    and MAX_ROWS. Rows are independent, so the count never changes a
    result; it only bounds the working set.

    N local workers (--jobs N) measure the card's free memory at about
    the same moment, so each takes its 1/N share of the half: together
    they stay inside the card."""
    dev = torch.device(dev)
    if dev.type == "cuda":
        free, _total = torch.cuda.mem_get_info(dev)
        idle = (torch.cuda.memory_reserved(dev)
                - torch.cuda.memory_allocated(dev))
        budget = (free + idle) // 2 // devmod.workers_sharing()
    else:
        budget = HOST_BUDGET_BYTES
    rows = budget // row_bytes // 1024 * 1024
    return int(min(max(rows, 1024), MAX_ROWS))


def somatic_snv_call_capped(normal_lhood, tumor_lhood, **kw):
    """somatic_snv_call in one launch where the rows fit the device's
    memory budget (rows_per_launch), else over row chunks that do
    (results concatenated on the device; identical per-row math)."""
    L = normal_lhood.shape[0]
    cap = rows_per_launch(normal_lhood.device,
                          call_row_bytes(normal_lhood.device))
    if L <= cap:
        return somatic_snv_call(normal_lhood, tumor_lhood, **kw)
    parts = [somatic_snv_call(normal_lhood[i:i + cap],
                              tumor_lhood[i:i + cap], **kw)
             for i in range(0, L, cap)]
    return SomaticSnvResult(*[torch.cat([getattr(p, f) for p in parts])
                              for f in SomaticSnvResult._fields])


_LOG10_E = 0.4342944819032518   # the f64 constant of jnp.log10
_F64_TINY = float(np.finfo(np.float64).tiny)


def _phred64(x):
    """min(floor(-10 * log10(max(x, tiny)) + 0.5), 999) as the JAX
    package evaluates it in float64 (log10 = log * 1/ln 10), as int32
    with NaN as 0 (XLA's convert; an all -inf row gives NaN here)."""
    lg = torch.log(torch.clamp_min(x, _F64_TINY)) * _LOG10_E
    return _i32(torch.clamp_max(torch.floor(-10.0 * lg + 0.5), 999.0))


def somatic_snv_call(normal_lhood, tumor_lhood,
                     contam_tolerance=0.15, shared_error_rate=5e-10,
                     somatic_rate=1e-4, theta=0.001,
                     sse_strand_fraction=0.0) -> SomaticSnvResult:
    """Joint somatic posterior over batched loci.

    normal_lhood/tumor_lhood: [L, GRID_SIZE] f32 from freq_grid_lhoods,
    on one device. On CPU tensors this runs the plain version
    (somatic_snv_call_plain); on any other device the kernel KS-P
    (ops/snv_kernels.somatic_posterior, csrc/somatic_posterior.cu),
    which gives the plain version's bits.
    """
    dev = normal_lhood.device
    _tally("post", dev, normal_lhood.shape[0], 0)
    args = (contam_tolerance, shared_error_rate, somatic_rate, theta,
            sse_strand_fraction)
    if dev.type == "cpu":
        return somatic_snv_call_plain(normal_lhood, tumor_lhood, *args)
    from ..ops import snv_kernels
    pf, gp, valid_eq, off_prior, _eye = _posterior_tables(dev, *args)
    return SomaticSnvResult(*snv_kernels.somatic_posterior(
        normal_lhood, tumor_lhood, pf, gp, valid_eq, off_prior))


def somatic_snv_call_plain(normal_lhood, tumor_lhood,
                           contam_tolerance=0.15, shared_error_rate=5e-10,
                           somatic_rate=1e-4, theta=0.001,
                           sse_strand_fraction=0.0) -> SomaticSnvResult:
    """The plain version of somatic_snv_call, as torch ops on the
    lhoods' device: the CPU path, and what KS-P is held to on the card.
    The dtypes follow the JAX package's program step by step (f32 where
    it holds f32, float64 where x64 promotes)."""
    from ..ops import snv_kernels
    dev = normal_lhood.device
    L = normal_lhood.shape[0]
    snv_kernels.count_plain("somatic_posterior", dev)
    pf, gp, valid_eq, off_prior, eye = _posterior_tables(
        dev, contam_tolerance, shared_error_rate, somatic_rate, theta,
        sse_strand_fraction)
    nl = normal_lhood[:, :PRESTRAND_SIZE]
    tl = tumor_lhood[:, :PRESTRAND_SIZE]
    # [L, 3, 2, fn, ft] in f32, (pf + nl) + tl
    s = (pf[None] + nl[:, None, None, :, None]) + tl[:, None, None, None, :]
    lse = _logsumexp64(s.reshape(L, 3, 2, PRESTRAND_SIZE ** 2)).to(
        torch.float32)
    del s
    log_post = lse + gp[None]                                   # [L, 3, 2]

    # posterior normalization in f64 (the reference stores post_prob as
    # double, qscore_calculator.cpp:183-207)
    flat = log_post.reshape(-1, 6).to(torch.float64)
    mx = torch.amax(flat, dim=-1, keepdim=True)
    p = torch.exp(flat - mx)
    p = p / _seq_sum(p)[:, None]
    p = p.reshape(-1, 3, 2)

    nonsom = _seq_sum(p[:, :, NON_SOMATIC])
    som_given_n = p[:, :, SOMATIC]
    # err[n] = everything except (n, SOMATIC), summed explicitly for
    # precision (complement-sum, prob_comp semantics)
    total_som = _seq_sum(som_given_n)[:, None]
    err_som_and_ngt = nonsom[:, None] + (total_som - som_given_n)  # [L, 3]
    ntype = torch.argmin(err_som_and_ngt, dim=-1)
    min_err = torch.amin(err_som_and_ngt, dim=-1)
    q = _phred64(nonsom)
    qn = _phred64(min_err)
    max_flat = torch.argmax(log_post.reshape(-1, 6), dim=-1)

    # strand bias: max strand-state lhood minus max symmetric het-grid
    symm = torch.amax(tumor_lhood[:, 3:PRESTRAND_SIZE], dim=-1)
    strand = torch.amax(tumor_lhood[:, PRESTRAND_SIZE:], dim=-1)
    sb = torch.clamp_min(strand - symm, 0.0)

    # nonsomatic quality (gvcf_nonsomatic_gvcf_prior): uniform prior,
    # restricted 'valid' tumor freq states; pp_diag is f32 and pp_off
    # float64 (the reference's np.log(0.5) is a strong float64)
    pp_diag = (nl + tl) + valid_eq[None]
    lse_diag = _logsumexp64(pp_diag).to(torch.float32).to(torch.float64)
    pp_off = ((nl[:, :, None] + tl[:, None, :]).to(torch.float64)
              + off_prior[None])
    pp_off = torch.where(eye[None], float("-inf"), pp_off)
    denom = _logaddexp64(lse_diag, _logsumexp64(
        pp_off.reshape(L, PRESTRAND_SIZE ** 2)))
    nonsom_frac = torch.exp(lse_diag - denom)
    qns = _phred64(1.0 - nonsom_frac)

    i32 = torch.int32
    return SomaticSnvResult(
        qphred=q, from_ntype_qphred=qn,
        ntype=ntype.to(i32), max_gt=max_flat.to(i32),
        strand_bias=sb, nonsomatic_qphred=qns)


@functools.lru_cache(maxsize=16)
def _posterior_tables(dev, contam_tolerance, shared_error_rate,
                      somatic_rate, theta, sse_strand_fraction):
    """(pf f32, gp f32, eq prior f32 [21], off prior f64 [21, 21], eye
    bool [21, 21]) on `dev`."""
    from ..convert import somatic_prior_tables
    tabs = somatic_prior_tables(
        dev, (contam_tolerance, shared_error_rate, somatic_rate, theta,
              sse_strand_fraction))
    valid_t = (FRACTIONS >= 0.1 - 1e-4) & (FRACTIONS <= 0.9 + 1e-4)
    valid_t |= np.arange(PRESTRAND_SIZE) < 2  # REF/HOM always valid
    eq = np.where(valid_t, 0.0, -np.inf).astype(np.float32)
    ref_or_hom = np.arange(PRESTRAND_SIZE) < 2
    off = np.where(valid_t[None, :],
                   np.where(ref_or_hom[:, None], np.log(0.5), -np.inf),
                   -np.inf)
    eye = np.eye(PRESTRAND_SIZE, dtype=bool)
    return (tabs["joint_pf"], tabs["joint_gp"],
            *(devmod.put("tables", a, dev) for a in (eq, off, eye)))
