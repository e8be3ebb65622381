"""Device selection for the port.

Entry points take an explicit device and default to ``cuda``. Asking
for ``cuda`` on a machine without a GPU raises: nothing falls back to
the CPU silently. The entry point installs its resolved device with
``use``; the pipeline modules below it (scoring, SNV tiles) read it
with ``current``.
"""
from __future__ import annotations

import contextlib

import torch

_CURRENT: torch.device | None = None


def resolve(device=None) -> torch.device:
    """torch.device for `device` (None -> cuda). Raises RuntimeError on
    cuda without a GPU and ValueError on anything but cuda or cpu."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use cuda or cpu")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device cuda was asked for but no CUDA GPU is available; "
                "pass --device cpu (or device='cpu') to run on the CPU")
        if dev.index is None:
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
