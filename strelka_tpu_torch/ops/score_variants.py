"""The K1-x scoring variants: the CUDA kernels and an A/B runner.

Counterpart of the JAX package's on-chip A/B harness
benchmarks/exp_exact_kernel.py, whose Pallas bodies are variants of the
exact read x haplotype scorer K1 (ops/score_kernel.py). Most of them
differ from K1 only in how the TPU schedules the same function, and
their counterpart here is K1's kernel. The others compute a function or
take an operand contract that K1 does not, and each has a CUDA kernel
(``KERNELS`` maps each to its wrapper, plain version and source): on
K1's or K1-h's tensor-core pipeline where it was redesigned for Hopper,
else in csrc/score_variants.cu. ``KERNELS`` also holds K1-s
``score_simt``, K1's earlier SIMT kernel (csrc/score_best_offsets.cu,
compare-adds on the CUDA cores): K1's function and operands, kept as
the before-number of the tensor-core K1.

- KX-P ``score_packed`` (``fused``, ``fusedwhole``, ``fusedin``,
  ``fusedlm``): K1 on one int32 per base, ``(d_int << 3) | code``,
  optionally with the lnmis bits folded in as ceil(R/L) extra rows;
  out f32 [B,R,2] = (best, the bits of the int32 offset). Its kernel is
  K1's own, instantiated on the packed operand
  (csrc/score_best_offsets_tc.cu, u8 tensor cores); its earlier SIMT
  kernels (csrc/score_variants.cu) are kept as its before-numbers,
  ``score_packed_simt`` (``KERNELS["packed_simt"]`` and
  ``["packed_fold_simt"]``), on no path.
- KX-K ``score_onesum`` (``limb2k``): K1 with one sum of ``hi*256 +
  lo`` per offset, for L <= 256, where f32(S) is exact and the result
  equals K1's bits. Its kernel is K1-h's bf16 tensor-core pipeline on
  two exact pieces of ``d_int & 0xFFFF`` (csrc/score_highest_tc.cu,
  ``score_highest_tc_kernel<kOneSum>``).
- KX-H ``score_hap`` (``hap2``): reads [B,R,L] against H windows
  [B,L,H*W]; best and off [B,R,H], the offset within each window. Its
  kernel is K1's u8 pipeline with its N tiles walking the H windows and
  the A words built once for all of them
  (``score_best_offsets_tc_kernel<kStandard, kHapOut>``).
- KX-K's and KX-H's earlier SIMT kernels (csrc/score_variants.cu) are
  kept as their before-numbers, ``score_onesum_simt`` and
  ``score_hap_simt`` (``KERNELS["onesum_simt"]``, ``["hap_simt"]``),
  on no path.
- KX-I ``score_int8`` (``int8``): K1 with each limb clamped to
  ``min(limb, 127)`` (the Pallas body's clamp, exp_exact_kernel.py:122).
  Every clamped limb is a u8 value, so its kernel is K1's u8 pipeline
  with the clamp in the A words
  (``score_best_offsets_tc_kernel<kClamped, kBestOff>``). Its earlier
  kernel on the int8 tensor cores (csrc/score_variants.cu, mma.sync
  m16n8k32 s8) is kept as its before-number, ``score_int8_mma``
  (``KERNELS["int8_mma"]``), on no path.
- KX-A ``score_ablation`` (``limb2-noA``, ``-noW``, ``-nomax``,
  ``-nodot``): the timing ablations of the 2-limb body, each dropping
  the stage its Pallas body drops and computing that body's result,
  another function than K1's: limbs not masked by the read's code;
  each pair scored against the window of the first pair of its grid
  step of G; no argmax (offset 0); no product (see
  ``nodot_best_offsets``). All four run on K1's u8 tensor-core
  pipeline: noA as ``score_best_offsets_tc_kernel<kUnmasked,
  kBestOff>`` (A words with the limb in every code byte); noW as
  ``<kStandard, kBestOff, kProduct, kGroupSlab>`` (plan S: one CTA a
  group of G pairs, the group's window expanded once into a slab that
  every pair of the group reads) or ``<..., kGroupRing>`` (plan R:
  K1's ring on the group's window), whichever ``now_plan`` names;
  nomax as ``<kStandard, kBestOnly>`` (a max-only epilogue); nodot as
  ``<kStandard, kBestOff, kSlabSlice>`` (K1's slab build with the
  wgmma replaced by reads of the slabs' terms). Their earlier SIMT
  kernels (csrc/score_variants.cu) are kept as their before-numbers,
  ``score_ablation_simt`` (``KERNELS["noA_simt"]``, ``["noW_simt"]``,
  ``["nomax_simt"]``, ``["nodot_simt"]``), on no path.

Each wrapper launches its kernel for CUDA tensors (or raises on what
the kernel does not take) and runs its plain torch version, kept beside
it, only for tensors on the CPU. Each kernel instantiation has a launch
counter.

The runner, ``python -m strelka_tpu_torch.ops.score_variants [variant
...] [--device cuda|cpu] [--B N] [--R N]``, makes the harness's inputs
from numpy seed 0 at its shapes (B,R,L,W = 512,128,128,128; hap2 at
B/2 loci x H=2 windows), checks each variant's result on the first 8
pairs, times its counterpart with CUDA events (median of 20 launches
after warm-up) and prints ``name: step=...ms reads/s=...M exact=...
body_exact=... kernel=...`` (``limb2-noW`` also ``plan=S`` or
``plan=R``, ``now_plan``). ``exact`` is the harness's check, against
K1's function (per window for hap2); it is False where the body
computes another function by design (int8, the ablations), as it would
be on the TPU. ``body_exact`` holds the kernel against the plain
version of the body's own function; the runner exits 1 unless every
variant is body-exact.
"""
from __future__ import annotations

import argparse
import ctypes
import statistics
import sys
import time
from typing import Callable, NamedTuple

import numpy as np
import torch

from .. import device as devmod
from .readlik import LIMBS, QUANT_INV, QUANT_SCALE, quantized_qscore_luts
from .readlik import N_BASE_CODES as N_BASE
from . import score_kernel
from .score_kernel import exact_best_offsets, score_best_offsets

# launches of each CUDA kernel (plain-version calls do not count)
LAUNCHES_PACKED = 0     # KX-P, score_best_offsets_tc_kernel<kPacked, true>
LAUNCHES_PACKED_FOLD = 0    # KX-P, <kPackedFold, true> (lnmis folded)
LAUNCHES_PACKED_SIMT = 0    # KX-P-s, score_packed_kernel<false>
LAUNCHES_PACKED_FOLD_SIMT = 0   # KX-P-s, score_packed_kernel<true>
LAUNCHES_ONESUM = 0     # KX-K, score_highest_tc_kernel<kOneSum>
LAUNCHES_HAP = 0        # KX-H, score_best_offsets_tc_kernel<kStandard,
                        # kHapOut>
LAUNCHES_ONESUM_SIMT = 0    # KX-K-s, score_onesum_kernel
LAUNCHES_HAP_SIMT = 0   # KX-H-s, score_hap_kernel
LAUNCHES_INT8 = 0       # KX-I, score_best_offsets_tc_kernel<kClamped,
                        # kBestOff>
LAUNCHES_INT8_MMA = 0   # KX-I-s, score_int8_mma_kernel
LAUNCHES_NOA = 0        # KX-A, score_best_offsets_tc_kernel<kUnmasked,
                        # kBestOff>
LAUNCHES_NOW = 0        # KX-A, score_best_offsets_tc_kernel<kStandard,
                        # kBestOff, kProduct, kGroupSlab or kGroupRing>
LAUNCHES_NOMAX = 0      # KX-A, score_best_offsets_tc_kernel<kStandard,
                        # kBestOnly>
LAUNCHES_NODOT = 0      # KX-A, score_best_offsets_tc_kernel<kStandard,
                        # kBestOff, kSlabSlice>
LAUNCHES_NOA_SIMT = 0   # KX-A-s, score_ablation_kernel<kNoA>
LAUNCHES_NOW_SIMT = 0   # KX-A-s, score_ablation_kernel<kNoW>
LAUNCHES_NOMAX_SIMT = 0     # KX-A-s, score_ablation_kernel<kNoMax>
LAUNCHES_NODOT_SIMT = 0     # KX-A-s, score_ablation_kernel<kNoDot>
LAUNCHES_SIMT = 0       # K1-s, score_best_offsets_kernel<false>

SOURCE = "strelka_tpu_torch/csrc/score_variants.cu"
TC_SOURCE = "strelka_tpu_torch/csrc/score_best_offsets_tc.cu"
HIGHEST_SOURCE = "strelka_tpu_torch/csrc/score_highest_tc.cu"
HARNESS = "benchmarks/exp_exact_kernel.py"
# S = S1*256 + S0 < 2^24 (exp_exact_kernel.py:243-247): the plain
# version's limit, the kernels' own (score_onesum_tc_max_len,
# score_onesum_max_len) on the card
ONESUM_MAX_LEN = 256
DEFAULT_G = 4           # the harness's tiles per grid step (:782)
HAP_WINDOWS = 2         # H of hap2 (:920)
_MAX_B = 65535          # the kernels' grid y dimension
# noW's plan S on K1's pipeline (csrc/score_best_offsets_tc.cu): its
# shared memory holds the barriers, the raw window ring, the slab of every
# step's expanded Bw tile and K1's resident A, within the card's 232,448
# bytes a block
_SMEM_LIMIT = 232448
_TC_BAR, _TC_RAW_RING = 128, 3 * 32 * 64    # bytes
_TC_STEP_TILE = 64 * 128                    # a step's Bw: 64 offsets x 128 K


# --- plain versions ---------------------------------------------------------

def pack_operands(codes, delta, lnmis, fold_lnmis=False):
    """int32 [B, R + (ceil(R/L) if fold_lnmis), L]: ``(d_int << 3) |
    code`` per base with d_int = int(delta * 2^11), then, folded, the
    bits of lnmis [B,R] zero-padded to ceil(R/L) rows of L (the
    harness's build_packedin, exp_exact_kernel.py:642-649)."""
    B, R, L = codes.shape
    d_int = (delta * float(QUANT_SCALE)).to(torch.int32)
    packed = (d_int << 3) | codes.to(torch.int32)
    if fold_lnmis:
        rows = -(-R // L)
        lm = torch.zeros((B, rows * L), dtype=torch.int32,
                         device=codes.device)
        lm[:, :R] = lnmis.contiguous().view(torch.int32)
        packed = torch.cat([packed, lm.reshape(B, rows, L)], dim=1)
    return packed.contiguous()


def packed_reads(packed, lnmis, n_reads=None) -> int:
    """The read count R of a packed operand: its rows, or with lnmis
    folded (lnmis None) `n_reads`, whose R + ceil(R/L) must be its
    rows."""
    _, rows, L = packed.shape
    if lnmis is not None:
        return rows
    if n_reads is None or n_reads + -(-n_reads // L) != rows:
        raise ValueError(f"packed has {rows} rows of L={L}: give n_reads "
                         f"R with R + ceil(R/L) = {rows} (got {n_reads})")
    return n_reads


def unpack_best_offsets(out):
    """(best [B,R] f32, off [B,R] int32) of a packed [B,R,2] output."""
    return out[..., 0], out.view(torch.int32)[..., 1]


def packed_best_offsets(packed, lnmis, win_t, n_reads=None):
    """Plain version of KX-P: unpack, exact_best_offsets, pack. lnmis
    None reads it from the folded rows (then `n_reads` is R). Returns
    f32 [B,R,2] = (best, the bits of the int32 offset)."""
    R = packed_reads(packed, lnmis, n_reads)
    B, _, L = packed.shape
    p = packed[:, :R]
    codes = p & 7           # a code >= 4 matches nothing
    delta = (p >> 3).to(torch.float32) * float(QUANT_INV)   # exact
    if lnmis is None:
        lnmis = packed[:, R:].reshape(B, -1)[:, :R].contiguous().view(
            torch.float32)
    best, off = exact_best_offsets(codes, delta, lnmis, win_t)
    return torch.stack([best.view(torch.int32), off], dim=-1).view(
        torch.float32)


def _first_max(s):
    off = torch.argmax(s, dim=-1)       # first max
    best = torch.gather(s, -1, off[..., None])[..., 0]
    return best, off.to(torch.int32)


def _d_int(delta):
    return (delta * float(QUANT_SCALE)).to(torch.int32)


def onesum_best_offsets(codes, delta, lnmis, win_t):
    """Plain version of KX-K: one f32 bmm of ``d_int & 0xFFFF`` (=
    limb_1*256 + limb_0) over the window one-hot, exact for L <= 256
    (every partial sum is an integer below 2^24), then * 2^-11 +
    lnmis; max and first argmax over offsets. Raises for L > 256."""
    B, R, L = codes.shape
    if L > ONESUM_MAX_LEN:
        raise ValueError(f"the one-accumulator form is exact only for "
                         f"L <= {ONESUM_MAX_LEN}, got L={L}")
    c = codes.to(torch.int32)
    win = win_t.to(torch.int32)
    d = (_d_int(delta) & 0xFFFF).to(torch.float32)
    a = torch.cat([torch.where(c == k, d, 0.0) for k in range(N_BASE)],
                  dim=2)                                       # [B,R,4L]
    oh_w = torch.cat([(win == k).to(torch.float32) for k in range(N_BASE)],
                     dim=1)                                    # [B,4L,W]
    s = torch.bmm(a, oh_w) * float(QUANT_INV) + lnmis[..., None]
    return _first_max(s)


def hap_best_offsets(codes, delta, lnmis, win_t, n_haps):
    """Plain version of KX-H: exact_best_offsets against each of the
    `n_haps` windows win_t[:, :, h*W:(h+1)*W]; best f32 and off int32
    [B,R,H], the offset within the window."""
    W = _hap_width(win_t, n_haps)
    outs = [exact_best_offsets(codes, delta, lnmis,
                               win_t[:, :, h * W:(h + 1) * W])
            for h in range(n_haps)]
    return (torch.stack([o[0] for o in outs], dim=-1),
            torch.stack([o[1] for o in outs], dim=-1))


def clamp_limbs(delta):
    """delta rebuilt from its limbs clamped to 0..127:
    (min(limb_1,127)*256 + min(limb_0,127)) * 2^-11, exact in f32."""
    d = _d_int(delta)
    hi = ((d >> 8) & 255).clamp(max=127)
    lo = (d & 255).clamp(max=127)
    return ((hi << 8) | lo).to(torch.float32) * float(QUANT_INV)


def int8_best_offsets(codes, delta, lnmis, win_t):
    """Plain version of KX-I: exact_best_offsets on clamped limbs."""
    return exact_best_offsets(codes, clamp_limbs(delta), lnmis, win_t)


def noa_best_offsets(codes, delta, lnmis, win_t):
    """Plain version of limb2-noA (_kernel_limb2_noA :310): every base's
    limbs count against every window code 0..3, whatever the read's
    code, S_j[w] = sum_l limb_j * [win[l,w] < 4]; K1's combine, max and
    first argmax."""
    d = _d_int(delta)
    valid = ((win_t >= 0) & (win_t < N_BASE)).to(torch.float32)   # [B,L,W]
    s = None
    for shift, weight in LIMBS:
        part = torch.bmm(((d >> shift) & 255).to(torch.float32), valid)
        part = part * weight            # exact: integer sums < 2^24
        s = part if s is None else s + part
    return _first_max(s * float(QUANT_INV) + lnmis[..., None])


def now_best_offsets(codes, delta, lnmis, win_t, G=DEFAULT_G):
    """Plain version of limb2-noW (_kernel_limb2_noW :333): K1 with pair
    b scored against the window of pair b//G*G, the first of its grid
    step of G."""
    if G < 1:
        raise ValueError(f"G must be at least 1, got {G}")
    first = torch.arange(codes.shape[0], device=codes.device) // G * G
    return exact_best_offsets(codes, delta, lnmis, win_t[first])


def nomax_best_offsets(codes, delta, lnmis, win_t):
    """Plain version of limb2-nomax (_kernel_limb2_nomax :360): K1's
    best, offset 0."""
    best, off = exact_best_offsets(codes, delta, lnmis, win_t)
    return best, torch.zeros_like(off)


def nodot_best_offsets(codes, delta, lnmis, win_t):
    """Plain version of limb2-nodot (_kernel_limb2_nodot :386), where a
    slice sum replaces the product: s[r,w] = A[r,w] + Wo[r,w], A the
    high-limb slab [R,4L] (column c*L + l: limb_1 of base l where the
    read's code is c) and Wo the window one-hot [4L,W] (row c*L + l:
    [win[l,w] == c]), scaled as K1's; max and first argmax. Defined for
    R <= 4L and W <= 4L (the slabs' extent)."""
    B, R, L = codes.shape
    W = win_t.shape[2]
    if R > N_BASE * L or W > N_BASE * L:
        raise ValueError(f"limb2-nodot reads its slabs at R={R} rows and "
                         f"W={W} columns: both must be at most 4L = "
                         f"{N_BASE * L}")
    c = codes.to(torch.int32)
    win = win_t.to(torch.int32)
    hi = (_d_int(delta) >> LIMBS[0][0]) & 255
    a = torch.cat([torch.where(c == k, hi, 0) for k in range(N_BASE)],
                  dim=2)[:, :, :W]                             # [B,R,W]
    oh_w = torch.cat([(win == k).to(torch.int32) for k in range(N_BASE)],
                     dim=1)[:, :R]                             # [B,R,W]
    s = (a + oh_w).to(torch.float32) * float(QUANT_INV) + lnmis[..., None]
    return _first_max(s)


def _hap_width(win_t, n_haps) -> int:
    if n_haps < 1 or win_t.shape[2] % n_haps:
        raise ValueError(f"window width {win_t.shape[2]} is not a "
                         f"multiple of n_haps={n_haps}")
    return win_t.shape[2] // n_haps


# --- wrappers ---------------------------------------------------------------

def _tc_lib():
    """K1's library (csrc/score_best_offsets_tc.cu) with KX-P's, KX-H's,
    KX-I's and KX-A's launches bound."""
    from .. import _build
    lib = _build.load(score_kernel.KERNEL_FUNCTIONS["exact"][0])
    if not getattr(lib, "_packed_bound", False):
        vp, ll = ctypes.c_void_p, ctypes.c_longlong
        lib.score_packed_tc_launch.argtypes = [vp, vp, vp] + [ll] * 5 + [
            vp, vp]
        lib.score_hap_tc_launch.argtypes = [vp] * 4 + [ll] * 5 + [vp] * 3
        lib.score_int8_tc_launch.argtypes = [vp] * 4 + [ll] * 4 + [vp] * 3
        lib.score_ablation_tc_launch.argtypes = [vp] * 4 + [ll] * 5 + [
            ctypes.c_int] + [vp] * 3
        lib.score_now_tc_plan.argtypes = [ll] * 5
        for fn in (lib.score_packed_tc_launch, lib.score_hap_tc_launch,
                   lib.score_int8_tc_launch, lib.score_ablation_tc_launch, lib.score_now_tc_plan,
                   lib.score_best_offsets_tc_max_len):
            fn.restype = ctypes.c_int
        lib._packed_bound = True
    return lib


def _highest_lib():
    """K1-h's library (csrc/score_highest_tc.cu) with KX-K's launch
    bound."""
    from .. import _build
    lib = _build.load(score_kernel.KERNEL_FUNCTIONS["highest"][0])
    if not getattr(lib, "_onesum_bound", False):
        vp, ll = ctypes.c_void_p, ctypes.c_longlong
        lib.score_onesum_tc_launch.argtypes = [vp] * 4 + [ll] * 4 + [vp] * 3
        for fn in (lib.score_onesum_tc_launch, lib.score_onesum_tc_max_len):
            fn.restype = ctypes.c_int
        lib._onesum_bound = True
    return lib


def _lib():
    from .. import _build
    lib = _build.load("score_variants")
    if not getattr(lib, "_bound", False):
        vp, ll = ctypes.c_void_p, ctypes.c_longlong
        lib.score_packed_launch.argtypes = [vp, vp, vp] + [ll] * 5 + [vp, vp]
        lib.score_onesum_launch.argtypes = [vp] * 4 + [ll] * 4 + [vp] * 3
        lib.score_hap_launch.argtypes = [vp] * 4 + [ll] * 5 + [vp] * 3
        lib.score_ablation_launch.argtypes = [vp] * 4 + [ll] * 5 + [
            ctypes.c_int] + [vp] * 3
        lib.score_int8_mma_launch.argtypes = [vp] * 4 + [ll] * 4 + [vp] * 3
        for fn in (lib.score_packed_launch, lib.score_onesum_launch,
                   lib.score_hap_launch, lib.score_ablation_launch,
                   lib.score_int8_mma_launch, lib.score_variants_max_len,
                   lib.score_onesum_max_len):
            fn.restype = ctypes.c_int
        lib._bound = True
    return lib


def _check(fn_name, dev, operands):
    """Raise unless every (name, tensor, dtype) lies on `dev`, has the
    dtype and is contiguous."""
    if dev.type != "cuda":
        raise ValueError(f"{fn_name}: unsupported device {dev}")
    for name, t, dt in operands:
        if t.device != dev:
            raise ValueError(f"{fn_name}: {name} is on {t.device}, "
                             f"expected {dev}")
        if t.dtype != dt:
            raise ValueError(f"{fn_name}: {name} must be {dt}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{fn_name}: {name} must be contiguous")


def _check_standard(fn_name, codes, delta, lnmis, win_t, max_len):
    """Device, dtype, contiguity and shape of the standard operands;
    returns B, R, L, W."""
    _check(fn_name, codes.device, (("codes", codes, torch.int8),
                                   ("delta", delta, torch.float32),
                                   ("lnmis", lnmis, torch.float32),
                                   ("win_t", win_t, torch.int8)))
    B, R, L = codes.shape
    if win_t.dim() != 3 or win_t.shape[:2] != (B, L):
        raise ValueError(f"{fn_name}: win_t shape {tuple(win_t.shape)} does "
                         f"not match codes {tuple(codes.shape)}")
    if delta.shape != (B, R, L) or lnmis.shape != (B, R):
        raise ValueError(f"{fn_name}: delta/lnmis shapes do not match codes")
    W = win_t.shape[2]
    if L > max_len or B > _MAX_B or min(B, R, L, W) < 1:
        raise ValueError(f"{fn_name}: shape B={B} R={R} L={L} W={W} outside "
                         f"the kernel's range (L <= {max_len})")
    return B, R, L, W


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def _launch_on(fn_name, dev, fn, *args):
    """fn(*args, stream of `dev`) with `dev` made the current CUDA
    device: the runtime applies a kernel's attributes (its dynamic
    shared memory) to the current device, and a launch on another card
    than the current one would be refused or land on the wrong card.
    Raises when the launch is refused."""
    with torch.cuda.device(dev):
        _raise_on(fn_name, fn(*args, _stream(dev)))


def _raise_on(fn_name, rc):
    if rc != 0:
        raise RuntimeError(f"{fn_name} launch failed: CUDA error {rc}")


def _best_off(shape, dev):
    return (torch.empty(shape, dtype=torch.float32, device=dev),
            torch.empty(shape, dtype=torch.int32, device=dev))


def _launch_packed(fn_name, fn, max_len, packed, lnmis, win_t, n_reads):
    """Check KX-P's operands on the card and launch `fn` (a launch with
    score_packed_tc_launch's arguments) on them; returns out [B,R,2]."""
    dev = packed.device
    R = packed_reads(packed, lnmis, n_reads)
    B, Rp, L = packed.shape
    ops = [("packed", packed, torch.int32), ("win_t", win_t, torch.int8)]
    if lnmis is not None:
        ops.append(("lnmis", lnmis, torch.float32))
        if lnmis.shape != (B, R):
            raise ValueError(f"{fn_name}: lnmis shape does not match")
    _check(fn_name, dev, ops)
    if win_t.dim() != 3 or win_t.shape[:2] != (B, L):
        raise ValueError(f"{fn_name}: win_t shape {tuple(win_t.shape)} "
                         f"does not match packed {tuple(packed.shape)}")
    W = win_t.shape[2]
    if L > max_len or B > _MAX_B or min(B, R, L, W) < 1:
        raise ValueError(f"{fn_name}: shape B={B} R={R} L={L} W={W} "
                         f"outside the kernel's range (L <= {max_len})")
    out = torch.empty((B, R, 2), dtype=torch.float32, device=dev)
    _launch_on(
        fn_name, dev, fn, packed.data_ptr(),
        None if lnmis is None else lnmis.data_ptr(), win_t.data_ptr(), B, R,
        Rp, L, W, out.data_ptr())
    return out


def score_packed(packed, lnmis, win_t, n_reads=None):
    """KX-P: best and first-max offset per (pair, read) from the packed
    operand int32 [B,R,L] (``pack_operands``) and lnmis f32 [B,R], or,
    with lnmis None, from int32 [B, R + ceil(R/L), L] with lnmis folded
    in (`n_reads` = R), on K1's u8 tensor-core pipeline. Returns f32
    [B,R,2] (best, offset bits); ``unpack_best_offsets`` splits it."""
    global LAUNCHES_PACKED, LAUNCHES_PACKED_FOLD
    if packed.device.type == "cpu":
        return packed_best_offsets(packed, lnmis, win_t, n_reads)
    lib = _tc_lib()
    out = _launch_packed("score_packed", lib.score_packed_tc_launch,
                         lib.score_best_offsets_tc_max_len(), packed, lnmis,
                         win_t, n_reads)
    if lnmis is None:
        LAUNCHES_PACKED_FOLD += 1
    else:
        LAUNCHES_PACKED += 1
    return out


def score_packed_simt(packed, lnmis, win_t, n_reads=None):
    """KX-P-s: score_packed's function from its earlier SIMT kernels,
    the before-numbers of the tensor-core one; on no path."""
    global LAUNCHES_PACKED_SIMT, LAUNCHES_PACKED_FOLD_SIMT
    if packed.device.type == "cpu":
        return packed_best_offsets(packed, lnmis, win_t, n_reads)
    lib = _lib()
    out = _launch_packed("score_packed_simt", lib.score_packed_launch,
                         lib.score_variants_max_len(), packed, lnmis, win_t,
                         n_reads)
    if lnmis is None:
        LAUNCHES_PACKED_FOLD_SIMT += 1
    else:
        LAUNCHES_PACKED_SIMT += 1
    return out


def _launch_standard(fn_name, fn, max_len, codes, delta, lnmis, win_t):
    """Check the standard operands on the card and launch `fn` (codes,
    delta, lnmis, win, B, R, L, W, best, off, stream) on them; returns
    (best, off) [B,R]."""
    B, R, L, W = _check_standard(fn_name, codes, delta, lnmis, win_t,
                                 max_len)
    best, off = _best_off((B, R), codes.device)
    _launch_on(
        fn_name, codes.device, fn, codes.data_ptr(), delta.data_ptr(),
        lnmis.data_ptr(), win_t.data_ptr(), B, R, L, W, best.data_ptr(),
        off.data_ptr())
    return best, off


def score_onesum(codes, delta, lnmis, win_t):
    """KX-K: K1's (best, off) [B,R] with one accumulator per offset, on
    K1-h's bf16 tensor-core pipeline; L <= 256. Shapes and dtypes as
    score_best_offsets."""
    global LAUNCHES_ONESUM
    if codes.device.type == "cpu":
        return onesum_best_offsets(codes, delta, lnmis, win_t)
    lib = _highest_lib()
    out = _launch_standard("score_onesum", lib.score_onesum_tc_launch,
                           lib.score_onesum_tc_max_len(), codes, delta,
                           lnmis, win_t)
    LAUNCHES_ONESUM += 1
    return out


def score_onesum_simt(codes, delta, lnmis, win_t):
    """KX-K-s: score_onesum's function from its earlier SIMT kernel, the
    before-number of the tensor-core one; on no path."""
    global LAUNCHES_ONESUM_SIMT
    if codes.device.type == "cpu":
        return onesum_best_offsets(codes, delta, lnmis, win_t)
    lib = _lib()
    out = _launch_standard("score_onesum_simt", lib.score_onesum_launch,
                           lib.score_onesum_max_len(), codes, delta, lnmis,
                           win_t)
    LAUNCHES_ONESUM_SIMT += 1
    return out


def _launch_hap(fn_name, fn, max_len, codes, delta, lnmis, win_t, n_haps):
    """Check KX-H's operands on the card and launch `fn` (codes, delta,
    lnmis, win, B, R, L, W, H, best, off, stream) on them; returns
    (best, off) [B,R,H]."""
    B, R, L, _ = _check_standard(fn_name, codes, delta, lnmis, win_t,
                                 max_len)
    W = _hap_width(win_t, n_haps)
    best, off = _best_off((B, R, n_haps), codes.device)
    _launch_on(
        fn_name, codes.device, fn, codes.data_ptr(), delta.data_ptr(),
        lnmis.data_ptr(), win_t.data_ptr(), B, R, L, W, n_haps,
        best.data_ptr(), off.data_ptr())
    return best, off


def score_hap(codes, delta, lnmis, win_t, n_haps):
    """KX-H: reads codes/delta [B,R,L], lnmis [B,R] against `n_haps`
    windows win_t [B, L, n_haps*W], on K1's u8 tensor-core pipeline;
    best f32 and off int32 [B,R,H], the offset within each window."""
    global LAUNCHES_HAP
    if codes.device.type == "cpu":
        return hap_best_offsets(codes, delta, lnmis, win_t, n_haps)
    lib = _tc_lib()
    out = _launch_hap("score_hap", lib.score_hap_tc_launch,
                      lib.score_best_offsets_tc_max_len(), codes, delta,
                      lnmis, win_t, n_haps)
    LAUNCHES_HAP += 1
    return out


def score_hap_simt(codes, delta, lnmis, win_t, n_haps):
    """KX-H-s: score_hap's function from its earlier SIMT kernel, the
    before-number of the tensor-core one; on no path."""
    global LAUNCHES_HAP_SIMT
    if codes.device.type == "cpu":
        return hap_best_offsets(codes, delta, lnmis, win_t, n_haps)
    lib = _lib()
    out = _launch_hap("score_hap_simt", lib.score_hap_launch,
                      lib.score_variants_max_len(), codes, delta, lnmis,
                      win_t, n_haps)
    LAUNCHES_HAP_SIMT += 1
    return out


def score_int8(codes, delta, lnmis, win_t):
    """KX-I: (best, off) [B,R] of K1's function on limbs clamped to
    0..127, on K1's u8 tensor-core pipeline. Shapes as
    score_best_offsets."""
    global LAUNCHES_INT8
    if codes.device.type == "cpu":
        return int8_best_offsets(codes, delta, lnmis, win_t)
    lib = _tc_lib()
    out = _launch_standard("score_int8", lib.score_int8_tc_launch,
                           lib.score_best_offsets_tc_max_len(), codes, delta,
                           lnmis, win_t)
    LAUNCHES_INT8 += 1
    return out


def score_int8_mma(codes, delta, lnmis, win_t):
    """KX-I-s: score_int8's function from its earlier kernel on the
    int8 tensor cores (mma.sync), the before-number of the wgmma one; on
    no path."""
    global LAUNCHES_INT8_MMA
    if codes.device.type == "cpu":
        return int8_best_offsets(codes, delta, lnmis, win_t)
    lib = _lib()
    out = _launch_standard("score_int8_mma", lib.score_int8_mma_launch,
                           lib.score_variants_max_len(), codes, delta,
                           lnmis, win_t)
    LAUNCHES_INT8_MMA += 1
    return out


def score_simt(codes, delta, lnmis, win_t):
    """K1-s: K1's (best, off) [B,R] from its earlier SIMT kernel.
    Shapes, dtypes and range as score_best_offsets."""
    global LAUNCHES_SIMT
    if codes.device.type == "cpu":
        return exact_best_offsets(codes, delta, lnmis, win_t)
    out = score_kernel.launch("simt", codes, delta, lnmis, win_t)
    LAUNCHES_SIMT += 1
    return out


# ablation: (the kernels' `which`, plain version); its launch counter is
# LAUNCHES_<WHICH>, its SIMT before-number's LAUNCHES_<WHICH>_SIMT
_ABLATIONS = {
    "noA": (0, noa_best_offsets),
    "noW": (1, now_best_offsets),
    "nomax": (2, nomax_best_offsets),
    "nodot": (3, nodot_best_offsets),
}
# the ablations on K1's u8 tensor-core pipeline: all four, each with its
# SIMT kernel kept as its before-number
TC_ABLATIONS = tuple(_ABLATIONS)


def _known_ablation(which):
    if which not in _ABLATIONS:
        raise ValueError(f"unknown ablation {which!r}; known: "
                         f"{sorted(_ABLATIONS)}")


def _counter(which, simt=False):
    return f"LAUNCHES_{which.upper()}" + ("_SIMT" if simt else "")


def ablation_best_offsets(which, codes, delta, lnmis, win_t, G=DEFAULT_G):
    """Plain version of KX-A `which`: its body's (best, off) [B,R]. `G`
    is noW's grid step; the others ignore it."""
    _known_ablation(which)
    plain = _ABLATIONS[which][1]
    if which == "noW":
        return plain(codes, delta, lnmis, win_t, G)
    return plain(codes, delta, lnmis, win_t)


def now_slab_bytes(R, L, W) -> int:
    """Shared memory of noW's plan S for R reads of L bases against W
    offsets: the barriers, the raw window ring, the slab of all nT*nK
    step tiles (4*Lp*nTw*64 bytes) and K1's resident A of its warpgroups
    (one per 32 reads, at most 4; 256*Lp bytes each), Lp = L rounded up
    to 32 (csrc/score_best_offsets_tc.cu slab_smem)."""
    Lp = -(-L // 32) * 32
    n_wg = min(-(-R // 32), 4)
    return (_TC_BAR + _TC_RAW_RING + (Lp // 32) * -(-W // 64) * _TC_STEP_TILE
            + n_wg * 256 * Lp)


def now_plan(B, R, L, W, G=DEFAULT_G, device="cpu") -> str:
    """The plan noW's tensor-core kernel takes at this shape: "S" where
    now_slab_bytes fits in a block's shared memory (one CTA a group of G
    pairs, the group's window expanded once), else "R" (K1's ring on the
    group's window). On a CUDA device it is the kernel library's own
    answer (score_now_tc_plan), else the same rule here. Raises for a
    shape the kernel does not take."""
    if min(B, R, L, W, G) < 1 or B > _MAX_B:
        raise ValueError(f"noW: no plan for B={B} R={R} L={L} W={W} G={G}")
    if torch.device(device).type == "cuda":
        lib = _tc_lib()
        code = lib.score_now_tc_plan(B, R, L, W, G)
        if code < 0:
            raise ValueError(f"noW: the kernel takes no B={B} R={R} L={L} "
                             f"W={W} G={G}")
        return "S" if code else "R"
    return "S" if now_slab_bytes(R, L, W) <= _SMEM_LIMIT else "R"


def _launch_ablation(fn_name, which, codes, delta, lnmis, win_t, G, tc):
    """Check KX-A's operands on the card and launch `which` on K1's
    pipeline (`tc`) or the SIMT kernel; returns (best, off) [B,R]."""
    code = _ABLATIONS[which][0]
    lib = _tc_lib() if tc else _lib()
    max_len = (lib.score_best_offsets_tc_max_len() if tc
               else lib.score_variants_max_len())
    B, R, L, W = _check_standard(fn_name, codes, delta, lnmis, win_t,
                                 max_len)
    if which == "nodot" and (R > N_BASE * L or W > N_BASE * L):
        raise ValueError(f"{fn_name}: R={R} and W={W} must be at most "
                         f"4L = {N_BASE * L}")
    if G < 1:
        raise ValueError(f"{fn_name}: G must be at least 1, got {G}")
    best, off = _best_off((B, R), codes.device)
    launch = lib.score_ablation_tc_launch if tc else lib.score_ablation_launch
    _launch_on(
        fn_name, codes.device, launch, codes.data_ptr(), delta.data_ptr(),
        lnmis.data_ptr(), win_t.data_ptr(), B, R, L, W, G, code,
        best.data_ptr(), off.data_ptr())
    return best, off


def score_ablation(which, codes, delta, lnmis, win_t, G=DEFAULT_G):
    """KX-A: the timing ablation `which` (noA, noW, nomax, nodot) of
    the 2-limb body: (best, off) [B,R], the body's result (see the
    plain versions), on K1's u8 tensor-core pipeline. `G` is noW's grid
    step (its plan: ``now_plan``); the others ignore it. Shapes and
    dtypes as score_best_offsets."""
    _known_ablation(which)
    if codes.device.type == "cpu":
        return ablation_best_offsets(which, codes, delta, lnmis, win_t, G)
    out = _launch_ablation(f"score_ablation({which})", which, codes, delta,
                           lnmis, win_t, G, tc=True)
    globals()[_counter(which)] += 1
    return out


def score_ablation_simt(which, codes, delta, lnmis, win_t, G=DEFAULT_G):
    """KX-A-s: the ablation `which`'s result from the earlier SIMT
    kernel (csrc/score_variants.cu, L <= 907), the before-number of its
    tensor-core one; on no path."""
    _known_ablation(which)
    if codes.device.type == "cpu":
        return ablation_best_offsets(which, codes, delta, lnmis, win_t, G)
    out = _launch_ablation(f"score_ablation_simt({which})", which, codes,
                           delta, lnmis, win_t, G, tc=False)
    globals()[_counter(which, simt=True)] += 1
    return out


# --- the kernels: operands, wrapper and plain version of each ---------------

class Kernel(NamedTuple):
    """One CUDA kernel instantiation. ``prepare(t, G)`` builds its
    operands from the standard ones t = (codes, delta, lnmis, win_t);
    ``call`` (the wrapper) and ``plain`` (its plain version) take them
    and return (best, off)."""
    label: str      # the name in the smoke's kernels line
    kernel: str     # the CUDA kernel
    counter: str    # this module's launch counter ("" for K1's)
    replaces: str   # the TPU body, file:line
    prepare: Callable
    call: Callable
    plain: Callable
    source: str = SOURCE    # the CUDA source, path in the repository
    # the function it computes, as the smoke's library route names it
    # ("k1", "onesum", "hap": K1's against HAP_WINDOWS windows, "int8",
    # or an ablation: "noA", "noW" (with G), "nomax", "nodot")
    function: str = "k1"
    before_of: str = ""     # the label of its redesign, if a before-number


def _standard(t, G):
    return tuple(t)


def _with_g(t, G):
    return (*t, G)


def _with_haps(t, G):
    return (*t, HAP_WINDOWS)


def _packed_prepare(fold):
    def prepare(t, G):
        c, d, m, w = t
        return (pack_operands(c, d, m, fold_lnmis=fold), None if fold else m,
                w, c.shape[1])
    return prepare


def _packed_call(p, m, w, R):
    return unpack_best_offsets(score_packed(p, m, w, n_reads=R))


def _packed_simt_call(p, m, w, R):
    return unpack_best_offsets(score_packed_simt(p, m, w, n_reads=R))


def _packed_plain(p, m, w, R):
    return unpack_best_offsets(packed_best_offsets(p, m, w, n_reads=R))


def _ablation(which, kernel, line, simt=False):
    """KX-A `which`'s kernel: on the path, or (`simt`) the SIMT
    before-number of its tensor-core redesign."""
    wrapper = score_ablation_simt if simt else score_ablation

    def call(c, d, m, w, G):
        return wrapper(which, c, d, m, w, G)

    def plain(c, d, m, w, G):
        return ablation_best_offsets(which, c, d, m, w, G)
    label = f"score_limb2_{which}"
    return Kernel(label + ("_simt" if simt else ""), kernel,
                  _counter(which, simt), f"{HARNESS}:{line}", _with_g, call,
                  plain, SOURCE if simt else TC_SOURCE, which,
                  label if simt else "")


K1_TPU = "strelka_tpu/ops/pallas_readlik.py:76"
K1 = Kernel("score_best_offsets", "score_best_offsets_tc_kernel<kStandard, "
            "kBestOff>", "", K1_TPU, _standard, score_best_offsets,
            exact_best_offsets, TC_SOURCE, "k1")

KERNELS = {
    "packed": Kernel("score_packed",
                     "score_best_offsets_tc_kernel<kPacked, kPairOut>",
                     "LAUNCHES_PACKED", f"{HARNESS}:418",
                     _packed_prepare(False), _packed_call, _packed_plain,
                     TC_SOURCE, "k1"),
    "packed_fold": Kernel("score_packed_fold",
                          "score_best_offsets_tc_kernel<kPackedFold, "
                          "kPairOut>",
                          "LAUNCHES_PACKED_FOLD", f"{HARNESS}:579",
                          _packed_prepare(True), _packed_call,
                          _packed_plain, TC_SOURCE, "k1"),
    "packed_simt": Kernel("score_packed_simt", "score_packed_kernel<false>",
                          "LAUNCHES_PACKED_SIMT", f"{HARNESS}:418",
                          _packed_prepare(False), _packed_simt_call,
                          _packed_plain, function="k1",
                          before_of="score_packed"),
    "packed_fold_simt": Kernel("score_packed_fold_simt",
                               "score_packed_kernel<true>",
                               "LAUNCHES_PACKED_FOLD_SIMT", f"{HARNESS}:579",
                               _packed_prepare(True), _packed_simt_call,
                               _packed_plain, function="k1",
                               before_of="score_packed_fold"),
    "onesum": Kernel("score_onesum", "score_highest_tc_kernel<kOneSum>",
                     "LAUNCHES_ONESUM", f"{HARNESS}:241", _standard,
                     score_onesum, onesum_best_offsets, HIGHEST_SOURCE,
                     "onesum"),
    "hap": Kernel("score_hap",
                  "score_best_offsets_tc_kernel<kStandard, kHapOut>",
                  "LAUNCHES_HAP", f"{HARNESS}:860", _with_haps, score_hap,
                  hap_best_offsets, TC_SOURCE, "hap"),
    "onesum_simt": Kernel("score_onesum_simt", "score_onesum_kernel",
                          "LAUNCHES_ONESUM_SIMT", f"{HARNESS}:241",
                          _standard, score_onesum_simt,
                          onesum_best_offsets, function="onesum",
                          before_of="score_onesum"),
    "hap_simt": Kernel("score_hap_simt", "score_hap_kernel",
                       "LAUNCHES_HAP_SIMT", f"{HARNESS}:860", _with_haps,
                       score_hap_simt, hap_best_offsets, function="hap",
                       before_of="score_hap"),
    "int8": Kernel("score_int8",
                   "score_best_offsets_tc_kernel<kClamped, kBestOff>",
                   "LAUNCHES_INT8", f"{HARNESS}:109", _standard, score_int8,
                   int8_best_offsets, TC_SOURCE, "int8"),
    "int8_mma": Kernel("score_int8_mma", "score_int8_mma_kernel",
                       "LAUNCHES_INT8_MMA", f"{HARNESS}:109", _standard,
                       score_int8_mma, int8_best_offsets, function="int8",
                       before_of="score_int8"),
    "noA": _ablation("noA", "score_best_offsets_tc_kernel<kUnmasked, "
                     "kBestOff>", 310),
    "noW": _ablation("noW", "score_best_offsets_tc_kernel<kStandard, "
                     "kBestOff, kProduct, kGroupSlab | kGroupRing>", 333),
    "nomax": _ablation("nomax", "score_best_offsets_tc_kernel<kStandard, "
                       "kBestOnly>", 360),
    "nodot": _ablation("nodot", "score_best_offsets_tc_kernel<kStandard, "
                       "kBestOff, kSlabSlice>", 386),
    "noA_simt": _ablation("noA", "score_ablation_kernel<kNoA>", 310,
                          simt=True),
    "noW_simt": _ablation("noW", "score_ablation_kernel<kNoW>", 333,
                          simt=True),
    "nomax_simt": _ablation("nomax", "score_ablation_kernel<kNoMax>", 360,
                            simt=True),
    "nodot_simt": _ablation("nodot", "score_ablation_kernel<kNoDot>", 386,
                            simt=True),
    "simt": Kernel("score_best_offsets_simt",
                   "score_best_offsets_kernel<false>", "LAUNCHES_SIMT",
                   K1_TPU, _standard, score_simt, exact_best_offsets,
                   "strelka_tpu_torch/csrc/score_best_offsets.cu", "k1",
                   "score_best_offsets"),
}
# the KERNELS entries that take HAP_WINDOWS windows
HAP_KINDS = tuple(k for k, v in KERNELS.items() if v.function == "hap")


# --- the A/B runner (exp_exact_kernel.py main :745-847, main_hap2 :917-967)

HARNESS_SHAPE = (512, 128, 128, 128)    # B, R, L, W (:750)
DEFAULT_VARIANTS = ("base", "hoist", "stack", "stackG8", "int8")   # :749
# bodies that compute K1's function and operands: their counterpart is K1
K1_VARIANTS = ("base", "limb2", "limb2G2", "limb2G8", "limb2r", "wholeout",
               "hoist", "stack", "stackG1", "stackG2", "stackG8", "bfcmp")
# variant name -> the KERNELS entry (None: K1)
VARIANTS = dict.fromkeys(K1_VARIANTS)
VARIANTS.update({
    "fused": "packed", "fusedwhole": "packed", "fusedin": "packed",
    "fusedlm": "packed_fold", "limb2k": "onesum", "hap2": "hap",
    "int8": "int8", "limb2-noA": "noA", "limb2-noW": "noW",
    "limb2-nomax": "nomax", "limb2-nodot": "nodot",
})
# their TPU step packs the operands too; fusedin/fusedlm stage them packed
PACK_IN_STEP = ("fused", "fusedwhole")


def variant_kernel(name: str) -> tuple[str, Kernel, int]:
    """(body, kernel, G) of a variant name. An ``@G`` suffix sets the
    tiles per TPU grid step: only noW's result depends on it; elsewhere
    it has no counterpart on the card. Raises ValueError for an unknown
    name."""
    base, _, g = name.partition("@")
    if base not in VARIANTS:
        raise ValueError(f"unknown variant {name!r}; known: "
                         f"{sorted(VARIANTS)}")
    kind = VARIANTS[base]
    return base, K1 if kind is None else KERNELS[kind], int(
        g) if g else DEFAULT_G


def harness_inputs(B, R, L, W, seed=0):
    """The harness's inputs from numpy: qscores 2..41, codes 0..4 (delta
    and lnmis 0 under code 4), windows 0..4 (exp_exact_kernel.py:754-762;
    main_hap2 draws the same with W = H*W, :921-927)."""
    rng = np.random.default_rng(seed)
    dl, ml = quantized_qscore_luts()
    q = rng.integers(2, 42, (B, R, L))
    codes = rng.integers(0, 5, (B, R, L)).astype(np.int8)
    delta = np.where(codes < 4, dl[q], 0).astype(np.float32)
    lnmis = np.where(codes < 4, ml[q], 0).sum(2).astype(np.float32)
    win = rng.integers(0, 5, (B, L, W)).astype(np.int8)
    return codes, delta, lnmis, win


def median_ms(fn, dev, iters=20, warm=3) -> float:
    """Median time of `fn` over `iters` calls after `warm`: CUDA events
    around each call on the card, the host clock on the CPU."""
    for _ in range(warm):
        fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        ev = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
        for s, e in ev:
            s.record()
            fn()
            e.record()
        torch.cuda.synchronize(dev)
        return statistics.median(s.elapsed_time(e) for s, e in ev)
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        ts.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(ts)


def _equal(got, want) -> bool:
    return all(torch.equal(a.view(torch.int32), b.view(torch.int32))
               for a, b in zip(got, want))


def run(variants, device="cuda", B=HARNESS_SHAPE[0],
        R=HARNESS_SHAPE[1]) -> list[dict]:
    """Each variant as the harness runs it, on `device` (resolved: cuda
    without a GPU raises): its result on the first 8 pairs against the
    harness's oracle (``exact``) and against the plain version of the
    body's own function (``body_exact``), and the median time of its
    counterpart. Prints one line per variant and returns them as
    dicts."""
    dev = devmod.resolve(device)
    parsed = [variant_kernel(n) for n in variants]   # raise before any work
    _, _, L, W = HARNESS_SHAPE
    inputs = {}
    rows = []
    for name, (base, k, G) in zip(variants, parsed):
        hap = k is KERNELS["hap"]
        shape = (B // 2, R, L, HAP_WINDOWS * W) if hap else (B, R, L, W)
        if shape not in inputs:
            inputs[shape] = [torch.from_numpy(a).to(dev)
                             for a in harness_inputs(*shape)]
        t = inputs[shape]
        if base in PACK_IN_STEP:
            step = lambda: k.call(*k.prepare(t, G))    # noqa: E731
        else:
            args = k.prepare(t, G)
            step = lambda: k.call(*args)                # noqa: E731
        got = [x[:8] for x in step()]
        first8 = [x[:8] for x in t]
        body = k.plain(*k.prepare(first8, G))
        oracle = body if hap else exact_best_offsets(*first8)
        exact, body_exact = _equal(got, oracle), _equal(got, body)
        ms = median_ms(step, dev)
        pairs = shape[0] * R * (HAP_WINDOWS if hap else 1)
        row = {"name": name, "kernel": k.kernel, "label": k.label,
               "device": dev.type, "shape": list(shape), "G": G,
               "step_ms": ms, "reads_per_s": pairs / ms * 1e3,
               "exact": exact, "body_exact": body_exact}
        plan = ""
        if k is KERNELS["noW"]:
            row["plan"] = now_plan(*shape, G, dev)
            plan = f" plan={row['plan']}"
        rows.append(row)
        print(f"{name}: step={ms:.3f}ms reads/s={pairs / ms / 1e3:.1f}M "
              f"exact={exact} body_exact={body_exact} kernel={k.kernel}"
              f"{plan}", flush=True)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m strelka_tpu_torch.ops.score_variants",
        description="The K1-x scoring variants of exp_exact_kernel.py on "
                    "the card: checked against the harness's oracle and "
                    "their body's own function, and timed.")
    ap.add_argument("variants", nargs="*", default=list(DEFAULT_VARIANTS),
                    help=f"variant names (default: {' '.join(DEFAULT_VARIANTS)})")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--B", type=int, default=HARNESS_SHAPE[0],
                    help="locus-haplotype pairs (hap2 takes B/2 loci)")
    ap.add_argument("--R", type=int, default=HARNESS_SHAPE[1],
                    help="reads per pair")
    args = ap.parse_args(argv)
    if args.B < 2 or args.R < 1:
        ap.error("--B must be at least 2 and --R at least 1")
    rows = run(args.variants or DEFAULT_VARIANTS, args.device, args.B,
               args.R)
    return 0 if all(r["body_exact"] for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
