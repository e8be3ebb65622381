"""strelka_tpu_torch — the small-variant calling engine on PyTorch and CUDA.

The port of strelka_tpu (JAX on a TPU) to PyTorch on an NVIDIA H100.
Module paths mirror the JAX package's, so
``strelka_tpu_torch/models/snv_digt.py`` is the counterpart of
``strelka_tpu/models/snv_digt.py``. The port imports neither ``jax``
nor ``strelka_tpu``: host modules are copies, device code is torch, and
the read x haplotype scoring kernel is hand-written CUDA
(``csrc/score_best_offsets.cu``).

Entry points take an explicit device and default to ``cuda``; asking
for ``cuda`` without a GPU raises (``device.resolve``).
"""

import torch as _torch

# Likelihood accumulation is float32 (the reference's blt_float_t is
# float, blt_util/blt_types.hh:27) but posterior normalization uses
# float64 (position_snp_call_pprob_digt.cpp:419 stores pprob as
# double); the posterior tails in models/snv_digt.py run in float64.
#
# f32 matmuls at full precision everywhere: TF32 rounds f32 inputs to
# a 10-bit mantissa, and the likelihood matmuls feed exact-parity
# phred scores (one ulp flips a rounded Q at a boundary).
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")

import os as _os

# Crash observability for the native layer (blt_util/sig_handler.cpp
# analog): dump Python tracebacks on fatal signals so a fault inside
# ctypes-called C++ still leaves a usable context in the task log.
import faulthandler as _faulthandler

try:
    _faulthandler.enable()
except Exception:  # noqa: BLE001 - unavailable in exotic embeddings
    pass

# Keep glibc from munmap'ing the large per-region tables (expansion,
# pileup tiles) between calls: default malloc serves >128KB from mmap
# and returns it to the kernel on free, so every region re-pays the
# first-touch page-fault cost (tens of MB/s inside this VM). Raising
# M_MMAP_THRESHOLD and disabling trim keeps the heap pages resident,
# making every region after the first run at warm-allocation speed.
if _os.name == "posix":
    try:
        import ctypes as _ctypes
        _libc = _ctypes.CDLL(None, use_errno=True)
        _libc.mallopt(-1, -1)         # M_TRIM_THRESHOLD: never trim
        _libc.mallopt(-3, 1 << 30)    # M_MMAP_THRESHOLD: 1GB
    except Exception:  # noqa: BLE001 - allocator tuning is best-effort
        pass

__version__ = "0.1.0"


class NotPortedError(NotImplementedError):
    """A feature of the JAX package that this port does not carry yet."""

    def __init__(self, what: str):
        super().__init__(f"{what} is not yet ported to strelka_tpu_torch")
