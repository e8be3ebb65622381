"""Device selection for the port.

Entry points take an explicit device and default to ``cuda``. Asking
for ``cuda`` on a machine without a GPU raises: nothing falls back to
the CPU silently. The entry point installs its resolved device with
``use``; the pipeline modules below it (scoring, SNV tiles) read it
with ``current``.

Local fan-out workers (``--jobs N``) share one card: the parent sets
``SHARE_ENV`` to N in their environment, and memory budgets read it
through ``workers_sharing``.

Every copy between the host and a card on the callers' paths goes
through ``put`` and ``pull``, which count it by call site (``h2d`` /
``d2h`` ``.copies`` and ``.bytes``) and, with the span recorder on,
record it as a leaf span (utils/spans.py).
"""
from __future__ import annotations

import contextlib
import os

import numpy as np
import torch

from .utils import spans

_CURRENT: torch.device | None = None

# number of local worker processes that share this process's card
SHARE_ENV = "STRELKA_TPU_WORKERS_PER_DEVICE"


def check(device=None) -> torch.device:
    """torch.device for `device` (None -> cuda) without a device index.
    Raises RuntimeError on cuda without a GPU and ValueError on anything
    but cuda or cpu. Creates no CUDA context."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use cuda or cpu")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device cuda was asked for but no CUDA GPU is available; "
            "pass --device cpu (or device='cpu') to run on the CPU")
    return dev


def resolve(device=None) -> torch.device:
    """`check`, then the current CUDA device's index for a bare cuda."""
    dev = check(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


@contextlib.contextmanager
def use(device):
    """Make `device` (resolved) the current device inside the block."""
    global _CURRENT
    prev = _CURRENT
    _CURRENT = resolve(device)
    try:
        yield _CURRENT
    finally:
        _CURRENT = prev


def current() -> torch.device:
    """The device installed by `use`, else the default (cuda, which
    raises without a GPU)."""
    return _CURRENT if _CURRENT is not None else resolve(None)


def workers_sharing() -> int:
    """How many local worker processes share this process's card (1
    unless a --jobs parent set SHARE_ENV)."""
    return max(1, int(os.environ.get(SHARE_ENV, "1") or 1))


def put(site: str, a, dev: torch.device) -> torch.Tensor:
    """Host array `a` as a tensor on `dev`: a view of it on the CPU
    (whose ops have read it by the time they return), a blocking copy
    from pageable memory on a card, so no host buffer is read after the
    call returns. A copy of one byte or more is counted under `site`."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    n = t.nbytes
    if dev.type == "cpu" or not n:
        return t.to(dev)
    spans.count("h2d.copies", site=site)
    spans.count("h2d.bytes", n, site=site)
    if not spans.ON:
        return t.to(dev)
    with spans.span("h2d", site=site, bytes=n):
        return t.to(dev)


def pull(site: str, t: torch.Tensor) -> np.ndarray:
    """Tensor `t` as a host numpy array: a view of a CPU tensor, a
    blocking copy from a card into pageable memory (which waits for the
    work queued on its stream first). A copy of one byte or more is
    counted under `site`."""
    n = t.numel() * t.element_size()
    if t.device.type == "cpu" or not n:
        return t.cpu().numpy()
    spans.count("d2h.copies", site=site)
    spans.count("d2h.bytes", n, site=site)
    if not spans.ON:
        return t.cpu().numpy()
    with spans.span("d2h", site=site, bytes=n):
        return t.cpu().numpy()
