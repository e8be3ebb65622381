"""Batched read-vs-haplotype likelihood scoring.

This is the engine's hot op — the TPU-native replacement for the
reference's candidate-alignment scoring loop
(reference: starling_read_align_score.cpp scoreCandidateAlignment and
the enumerate-and-max search in starling_read_align.cpp:859-1293, which
the reference itself documents as a max-over-alignments approximation
of the pair-HMM marginal, docs/methods/primary/methods.tex:915-922).

Re-design: a read maps GAPLESSLY onto any haplotype (reference sequence
with a subset of candidate indels applied), so

    score(read r, hap h, offset o)
        = sum_i [ r_i == h_{o+i} ]·ln(1-e_i) + [ r_i != h_{o+i} ]·ln(e_i/3)
        = lnmis_sum[r] + sum_{i,b} D[r,i,b] · H[h,o+i,b]

with D[r,i,b] = (ln(1-e_i) - ln(e_i/3)) · onehot(r_i)[b]. The inner sum
is a correlation, evaluated as [R, L*4] @ [L*4, W] matmuls.
Per-read allele likelihoods are the max over the offset window —
superset of the reference's enumerated candidate alignments.

Port of strelka_tpu/ops/readlik.py: the quantized LUTs and limb
constants are copied exactly (:45-73); the per-locus scoring
(score_all_offsets / score_reads_vs_haps, :117-170) runs as torch ops
on the caller's device (the batched path is ops/score_kernel.py).
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from .. import device as devmod

N_BASE_CODES = 4  # A, C, G, T; N padded as all-zero one-hot

# Per-base match-vs-mismatch deltas are quantized to integer multiples
# of 2^-QUANT_BITS so the scoring contraction can run as exact integer
# arithmetic (base-256 limbs on one-pass bf16 MXU matmuls with f32
# integer accumulation) — bit-identical on every backend regardless of
# accumulation order. See ops/score_kernel.py module doc. Max delta
# (q=127) is ~30.34, which quantizes to 62139 < 2^16 at QUANT_BITS=11,
# so TWO 8-bit limbs cover the full qual range (VERDICT r3 #3a: was
# 2^-19/3 limbs in rounds 2-3 — one fewer limb slab + a [2R,4L] dot).
# Exactness is STRONGER than the 3-limb scheme: with <= 256 scored
# bases the combined S_hi*256 + S_lo stays < 2^24, i.e. the limb
# combination itself is exact in f32 (the 3-limb path had two
# deterministic-but-rounded adds).
QUANT_BITS = 11
QUANT_SCALE = np.float32(2.0 ** QUANT_BITS)
QUANT_INV = np.float32(2.0 ** -QUANT_BITS)
# (shift, weight) of the base-256 limb decomposition of d_int; every
# exact scoring path MUST combine limbs in this order (for reads
# longer than 256 scored bases the single f32 add can round, and its
# fixed order defines the canonical result)
LIMBS = ((8, 256.0), (0, 1.0))


@functools.lru_cache(maxsize=1)
def quantized_qscore_luts() -> tuple[np.ndarray, np.ndarray]:
    """(delta_lut[128], lnmis_lut[128]) f32 numpy.

    delta_lut[q] = ln(1-e_q) - ln(e_q/3) rounded to a multiple of
    2^-QUANT_BITS (the engine's canonical per-base score weights);
    lnmis_lut[q] = ln(e_q/3). e floors at 0.75 (qual 0..2) so deltas
    are non-negative (reference emission: scoreMatchSegment,
    starling_read_align_score.cpp:120-168).
    """
    # f32 arithmetic matches the engine's historical LUT bit-for-bit;
    # only the round-to-2^-QUANT_BITS-multiple step is new
    q = np.arange(128, dtype=np.float32)
    e = np.clip(np.power(10.0, -q / 10.0), 1e-35, 0.75)
    lm = np.log1p(-e)
    lmis = np.log(e / 3.0).astype(np.float32)
    raw = (lm - lmis).astype(np.float64)
    delta = np.round(raw * 2.0 ** QUANT_BITS) * 2.0 ** -QUANT_BITS
    return delta.astype(np.float32), lmis


class ReadTile(NamedTuple):
    """Padded read tensors for scoring. R reads x L max length."""
    delta: torch.Tensor       # [R, L, 4] f32: (ln(1-e)-ln(e/3)) one-hot
    lnmis_sum: torch.Tensor   # [R] f32: sum of ln(e_i/3) over valid bases
    n_valid: np.ndarray       # [R] i32: non-N scored bases (host counts)
    read_len: np.ndarray      # [R] i32 full read length (host counts)


def build_read_tile(seqs: np.ndarray, quals: np.ndarray, mask: np.ndarray,
                    device=None) -> ReadTile:
    """Build scoring tensors from padded [R, L] base codes + quals.

    mask marks real (non-padding) bases; N bases (code 4) score as
    neither match nor mismatch (skipped, scoreMatchSegment's ANY check).
    The f32 tensors are built on the host (numpy, the JAX package's
    exact arithmetic) and copied to `device` (default: the current
    device of strelka_tpu_torch.device).
    """
    dev = devmod.current() if device is None else torch.device(device)
    delta_lut, lmis_lut = quantized_qscore_luts()
    qi = np.clip(quals, 0, 127)
    ln_mis = lmis_lut[qi]
    is_base = mask & (seqs < N_BASE_CODES)
    delta_val = np.where(is_base, delta_lut[qi], 0.0).astype(np.float32)
    onehot = np.zeros(seqs.shape + (N_BASE_CODES,), dtype=np.float32)
    r, c = np.nonzero(is_base)
    onehot[r, c, seqs[r, c]] = 1.0
    delta = onehot * delta_val[..., None]
    lnmis_sum = np.where(is_base, ln_mis, 0.0).sum(axis=1).astype(np.float32)
    return ReadTile(
        delta=torch.from_numpy(delta).to(dev),
        lnmis_sum=torch.from_numpy(lnmis_sum).to(dev),
        n_valid=is_base.sum(axis=1).astype(np.int32),
        read_len=mask.sum(axis=1).astype(np.int32),
    )


def build_hap_onehot(hap_codes: np.ndarray) -> np.ndarray:
    """[H, Lh] codes -> [H, Lh, 4] one-hot f32 (N/padding rows zero)."""
    H, Lh = hap_codes.shape
    onehot = np.zeros((H, Lh, N_BASE_CODES), dtype=np.float32)
    h, p = np.nonzero(hap_codes < N_BASE_CODES)
    onehot[h, p, hap_codes[h, p]] = 1.0
    return onehot


def score_all_offsets(delta: torch.Tensor, lnmis_sum: torch.Tensor,
                      hap_onehot: torch.Tensor) -> torch.Tensor:
    """Scores [R, H, W] for all haplotypes and offsets.

    delta [R, L, 4] (one-hot premultiplied quantized deltas),
    hap_onehot [H, Lh, 4]; W = Lh - L + 1 offsets.

    Uses the same exact base-256-limb formulation (and the identical
    fixed combination order) as ops/score_kernel, so per-locus scores
    are bit-identical to the batched kernel's for matching window
    geometry on any device: every limb product is an integer times
    {0,1} and every partial sum an integer < 2^24, exact in f32 in any
    accumulation order (TF32 is off, package __init__).
    """
    R, L, _ = delta.shape
    H, Lh, _ = hap_onehot.shape
    W = Lh - L + 1
    dev = delta.device
    # windows[h, o, i, b] = hap_onehot[h, o+i, b]
    idx = (torch.arange(W, device=dev)[:, None]
           + torch.arange(L, device=dev)[None, :])               # [W, L]
    windows = hap_onehot[:, idx, :]                              # [H, W, L, 4]
    b = windows.reshape(H * W, L * N_BASE_CODES)
    d_int = (delta * float(QUANT_SCALE)).to(torch.int32)
    s = None
    for shift, weight in LIMBS:
        limb = ((d_int >> shift) & 255).to(torch.float32)
        a = limb.reshape(R, L * N_BASE_CODES)
        part = (a @ b.T).reshape(R, H, W)
        part = part * weight
        s = part if s is None else s + part
    s = s * float(QUANT_INV)
    return s + lnmis_sum[:, None, None]


def best_offset_scores(scores: torch.Tensor):
    """Max over offsets -> per-read per-hap log likelihood [R, H] and
    the first (lowest) argmax offset."""
    off = torch.argmax(scores, dim=-1)
    return torch.gather(scores, -1, off[..., None])[..., 0], off


def score_reads_vs_haps(read_tile: ReadTile, hap_onehot):
    """Convenience wrapper: [R, H] best log-lhoods + offsets, as host
    numpy arrays (f32 scores, int64 offsets)."""
    dev = read_tile.delta.device
    s = score_all_offsets(read_tile.delta, read_tile.lnmis_sum,
                          torch.as_tensor(hap_onehot, device=dev))
    best, off = best_offset_scores(s)
    return best.cpu().numpy(), off.cpu().numpy()
