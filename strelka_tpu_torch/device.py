"""Device selection for the port.

Entry points take an explicit device and default to ``cuda``. Asking
for ``cuda`` on a machine without a GPU raises: nothing falls back to
the CPU silently. The entry point installs its resolved device with
``use``; the pipeline modules below it (scoring, SNV tiles) read it
with ``current``.

Local fan-out workers (``--jobs N``) share one card: the parent sets
``SHARE_ENV`` to N in their environment, and memory budgets read it
through ``workers_sharing``.
"""
from __future__ import annotations

import contextlib
import os

import torch

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
