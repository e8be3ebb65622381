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
plain version below, the CUDA kernel, the JAX package's
exact_best_offsets and its interpret-mode Pallas kernel.

K1 is csrc/score_best_offsets_tc.cu: the one-hot product on the u8
tensor cores (wgmma, s32 sums), the two limbs combined in int32
(S = S1*256 + S0) and converted to f32 once, which rounds as the
reference's f32 combination does for every S < 2^31. Its first max runs
over N tiles of TC_N_TILE offsets in ascending order. The earlier SIMT
kernel (csrc/score_best_offsets.cu, K1-s) is kept as a K1-x row of
ops/score_variants.KERNELS, the before-number of this one.

score_best_offsets launches the CUDA kernel for CUDA tensors and uses
the plain version only for tensors on the CPU.

mode="highest" is the TPU kernel's other path (K1-h): the same max and
first argmax of sum_l delta[r,l] * [codes[r,l] == win_t[l,w]] + lnmis
in f32 with unquantized deltas. Its plain version is
reference_best_offsets (a one-hot f32 bmm). Its CUDA kernel
(csrc/score_highest_tc.cu) runs the one-hot product on the bf16 tensor
cores: each delta split exactly into three bf16 pieces, three wgmma
passes into one f32 accumulator, so with the quantized LUT's deltas it
equals the plain version bit for bit, and with unquantized deltas the
two round in different orders (the tests hold scores to atol 1e-4 and
to an f32 rounding bound). Its earlier SIMT kernel
(csrc/score_best_offsets.cu, K1-h-s, ascending-l f32 adds on the CUDA
cores) is kept as its before-number: ``score_highest_simt``, on no
path. No pipeline path uses this mode.
"""
from __future__ import annotations

import ctypes

import torch

from .readlik import LIMBS, QUANT_INV, QUANT_SCALE
from .readlik import N_BASE_CODES as N_BASE

# launches of the CUDA kernels (plain-version calls do not count):
# mode="exact" in LAUNCHES, mode="highest" in LAUNCHES_HIGHEST, K1-h-s
# (score_highest_simt) in LAUNCHES_HIGHEST_SIMT
LAUNCHES = 0
LAUNCHES_HIGHEST = 0
LAUNCHES_HIGHEST_SIMT = 0
MODES = ("exact", "highest")
TC_N_TILE = 64      # offsets per N tile of the tensor-core kernels
# kernel -> (csrc/<library>.cu, its launch function, its max_len function);
# "simt" is K1-s, launched by ops/score_variants.score_simt
KERNEL_FUNCTIONS = {
    "exact": ("score_best_offsets_tc", "score_best_offsets_tc_launch",
              "score_best_offsets_tc_max_len"),
    "highest": ("score_highest_tc", "score_highest_tc_launch",
                "score_highest_tc_max_len"),
    "highest_simt": ("score_best_offsets",
                     "score_best_offsets_highest_launch",
                     "score_best_offsets_max_len"),
    "simt": ("score_best_offsets", "score_best_offsets_launch",
             "score_best_offsets_max_len"),
}


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


def highest_scores(codes, delta, lnmis, win_t):
    """[B, R, W] f32 scores of mode="highest": a one-hot f32 bmm over
    the (l, base) axis plus lnmis. A code outside 0..3 matches
    nothing."""
    B, R, L = codes.shape
    W = win_t.shape[2]
    c = codes.to(torch.int64)
    w = win_t.to(torch.int64)
    oh_r = torch.stack([c == k for k in range(N_BASE)], dim=-1)
    a = (oh_r.to(torch.float32) * delta[..., None]).reshape(B, R, L * N_BASE)
    oh_w = torch.stack([w == k for k in range(N_BASE)], dim=2)  # [B,L,4,W]
    s = torch.bmm(a, oh_w.to(torch.float32).reshape(B, L * N_BASE, W))
    return s + lnmis[..., None]


def reference_best_offsets(codes, delta, lnmis, win_t):
    """Plain torch version of mode="highest" — counterpart of
    pallas_readlik.reference_best_offsets: max and first argmax of
    highest_scores. Same layout and outputs as exact_best_offsets."""
    s = highest_scores(codes, delta, lnmis, win_t)
    off = torch.argmax(s, dim=-1)       # first max
    best = torch.gather(s, -1, off[..., None])[..., 0]
    return best, off.to(torch.int32)


_BOUND: dict = {}


def _functions(kernel):
    """(launch, max_len) of `kernel` (a KERNEL_FUNCTIONS key), bound
    with ctypes; builds its library first if stale."""
    if kernel not in _BOUND:
        from .. import _build
        name, launch_name, len_name = KERNEL_FUNCTIONS[kernel]
        lib = _build.load(name)
        vp, ll = ctypes.c_void_p, ctypes.c_longlong
        launch = getattr(lib, launch_name)
        launch.restype = ctypes.c_int
        launch.argtypes = [vp, vp, vp, vp, ll, ll, ll, ll, vp, vp, vp]
        max_len = getattr(lib, len_name)
        max_len.restype = ctypes.c_int
        _BOUND[kernel] = (launch, max_len)
    return _BOUND[kernel]


def launch(kernel, codes, delta, lnmis, win_t):
    """Check the operands and launch `kernel` (a KERNEL_FUNCTIONS key)
    on CUDA tensors, on their card (made the current device for the
    launch) and its current stream; raises on what it does not
    take and when the launch is refused. Returns (best, off)."""
    dev = codes.device
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
    fn, max_len = _functions(kernel)
    if L > max_len() or B > 65535 or min(B, R, L, W) < 1:
        raise ValueError(f"score_best_offsets: shape B={B} R={R} L={L} "
                         f"W={W} outside the kernel's range")
    best = torch.empty((B, R), dtype=torch.float32, device=dev)
    off = torch.empty((B, R), dtype=torch.int32, device=dev)
    # `dev` made current for the launch: the runtime applies the
    # kernel's dynamic shared memory attribute to the current device,
    # and launches on the current device's context
    with torch.cuda.device(dev):
        rc = fn(codes.data_ptr(), delta.data_ptr(), lnmis.data_ptr(),
                win_t.data_ptr(), B, R, L, W, best.data_ptr(),
                off.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"score_best_offsets ({kernel}) launch failed: "
                           f"CUDA error {rc}")
    return best, off


def score_best_offsets(codes, delta, lnmis, win_t, mode="exact"):
    """Best score and first argmax offset per (pair, read).

    On CUDA tensors this launches the hand-written kernel on the
    current stream (outputs allocated here); on CPU tensors it runs the
    plain version (exact_best_offsets, or reference_best_offsets for
    mode="highest"). Shapes and layout as exact_best_offsets; the
    kernel takes int8 codes/windows, f32 delta/lnmis, all contiguous.
    """
    global LAUNCHES, LAUNCHES_HIGHEST
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    if codes.device.type == "cpu":
        plain = exact_best_offsets if mode == "exact" else \
            reference_best_offsets
        return plain(codes, delta, lnmis, win_t)
    out = launch(mode, codes, delta, lnmis, win_t)
    if mode == "exact":
        LAUNCHES += 1
    else:
        LAUNCHES_HIGHEST += 1
    return out


def score_highest_simt(codes, delta, lnmis, win_t):
    """K1-h-s: mode="highest"'s (best, off) [B,R] from its earlier SIMT
    kernel, the before-number of the tensor-core one; on no path. Shapes,
    dtypes and range as score_best_offsets."""
    global LAUNCHES_HIGHEST_SIMT
    if codes.device.type == "cpu":
        return reference_best_offsets(codes, delta, lnmis, win_t)
    out = launch("highest_simt", codes, delta, lnmis, win_t)
    LAUNCHES_HIGHEST_SIMT += 1
    return out
