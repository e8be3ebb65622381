"""Batched best-offset read x haplotype scoring: the CUDA kernel K1.

Counterpart of strelka_tpu/ops/pallas_readlik.py. For each
locus-haplotype pair b and read r:

    s[r, w] = (f32(S1) * 256 + f32(S0)) * 2^-11 + lnmis[r]
    S_j[r, w] = sum_l limb_j(int(delta[r,l] * 2^11))
                      * [codes[r,l] < 4 and codes[r,l] == win_t[l,w]]

with limb_1 = bits 8-15 and limb_0 = bits 0-7, and returns max_w s and
the first (lowest-w) argmax. Deltas are multiples of 2^-11 from the
quantized LUT (ops/readlik.quantized_qscore_luts), so every per-limb
sum is an exact integer < 2^24 in any accumulation order, and the
fixed-order f32 combination gives the same bits on every device: the
plain version below, the CUDA kernel (csrc/score_best_offsets.cu), the
JAX package's exact_best_offsets and its interpret-mode Pallas kernel.

score_best_offsets launches the CUDA kernel for CUDA tensors and uses
the plain version only for tensors on the CPU.
"""
from __future__ import annotations

import ctypes

import torch

from .readlik import LIMBS, QUANT_INV, QUANT_SCALE
from .readlik import N_BASE_CODES as N_BASE

# launches of the CUDA kernel (plain-version calls do not count)
LAUNCHES = 0


def exact_best_offsets(codes, delta, lnmis, win_t):
    """Plain torch version of the exact limb formulation — the oracle
    the kernel must match bit for bit (scores and argmax offsets), and
    the CPU path. Counterpart of pallas_readlik.exact_best_offsets.

    codes [B,R,L] int, delta [B,R,L] f32, lnmis [B,R] f32,
    win_t [B,L,W] int (offset-major: win_t[b,l,w] = base at window
    position l of offset w). Returns (best [B,R] f32, off [B,R] i32).
    """
    B, R, L = codes.shape
    codes = codes.to(torch.int32)
    win = win_t.to(torch.int32)
    d_int = (delta * float(QUANT_SCALE)).to(torch.int32)
    # one-hot slabs along a 4L contraction axis; a code >= 4 is the
    # zero row on both sides
    oh_w = torch.cat([(win == c).to(torch.float32) for c in range(N_BASE)],
                     dim=1)                                   # [B,4L,W]
    s = None
    for shift, weight in LIMBS:
        limb = ((d_int >> shift) & 255).to(torch.float32)
        a = torch.cat([torch.where(codes == c, limb, 0.0)
                       for c in range(N_BASE)], dim=2)        # [B,R,4L]
        part = torch.bmm(a, oh_w)       # exact: integer sums < 2^24
        part = part * weight
        s = part if s is None else s + part
    s = s * float(QUANT_INV) + lnmis[..., None]
    off = torch.argmax(s, dim=-1)       # first max
    best = torch.gather(s, -1, off[..., None])[..., 0]
    return best, off.to(torch.int32)


def _lib():
    from .. import _build
    lib = _build.load("score_best_offsets")
    if not getattr(lib, "_bound", False):
        vp = ctypes.c_void_p
        ll = ctypes.c_longlong
        lib.score_best_offsets_launch.restype = ctypes.c_int
        lib.score_best_offsets_launch.argtypes = [
            vp, vp, vp, vp, ll, ll, ll, ll, vp, vp, vp]
        lib.score_best_offsets_max_len.restype = ctypes.c_int
        lib._bound = True
    return lib


def score_best_offsets(codes, delta, lnmis, win_t):
    """Best score and first argmax offset per (pair, read).

    On CUDA tensors this launches the hand-written kernel on the
    current stream (outputs allocated here); on CPU tensors it runs the
    plain version. Shapes and layout as exact_best_offsets; the kernel
    takes int8 codes/windows, f32 delta/lnmis, all contiguous.
    """
    global LAUNCHES
    dev = codes.device
    if dev.type == "cpu":
        return exact_best_offsets(codes, delta, lnmis, win_t)
    if dev.type != "cuda":
        raise ValueError(f"score_best_offsets: unsupported device {dev}")
    B, R, L = codes.shape
    if win_t.dim() != 3 or win_t.shape[:2] != (B, L):
        raise ValueError(f"win_t shape {tuple(win_t.shape)} does not "
                         f"match codes {tuple(codes.shape)}")
    W = win_t.shape[2]
    if delta.shape != (B, R, L) or lnmis.shape != (B, R):
        raise ValueError("delta/lnmis shapes do not match codes")
    for name, t, dt in (("codes", codes, torch.int8),
                        ("delta", delta, torch.float32),
                        ("lnmis", lnmis, torch.float32),
                        ("win_t", win_t, torch.int8)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, codes on {dev}")
        if t.dtype != dt:
            raise ValueError(f"{name} must be {dt}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    lib = _lib()
    if L > lib.score_best_offsets_max_len() or B > 65535 or min(
            B, R, L, W) < 1:
        raise ValueError(f"score_best_offsets: shape B={B} R={R} L={L} "
                         f"W={W} outside the kernel's range")
    best = torch.empty((B, R), dtype=torch.float32, device=dev)
    off = torch.empty((B, R), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.score_best_offsets_launch(
        codes.data_ptr(), delta.data_ptr(), lnmis.data_ptr(),
        win_t.data_ptr(), B, R, L, W, best.data_ptr(), off.data_ptr(),
        stream)
    if rc != 0:
        raise RuntimeError(f"score_best_offsets launch failed: CUDA error "
                           f"{rc}")
    LAUNCHES += 1
    return best, off
