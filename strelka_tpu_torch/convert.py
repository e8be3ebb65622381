"""The port's device-resident tables, built from numpy arrays.

This system has no learned weights on its main path: what the device
code reads are fixed tables that the numpy code derives — the
quantized qscore LUTs of the scoring kernel (ops/readlik.py) and the
(qscore, base) genotype contribution table, the mismatch-cell
indicator and the ln prior tables of the SNV model
(models/snv_digt.py). ``numpy_tables`` builds them with the port's own
numpy code; ``tables_from_numpy`` puts any such set on a device, so the
JAX package's arrays and the port's can be held against each other
bit for bit.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

# name -> dtype of every table
TABLE_DTYPES = {
    "delta_lut": np.float32,             # [128] quantized ln(1-e)-ln(e/3)
    "lnmis_lut": np.float32,             # [128] ln(e/3)
    "snv_qtab": np.float32,              # [Q*4, 10]
    "e0_tab": np.float32,                # [4, 10]
    "prior_genome": np.float64,          # [5, 10] ln priors by ref base
    "prior_poly": np.float64,
    "prior_genome_haploid": np.float64,
    "prior_poly_haploid": np.float64,
}


def numpy_tables(theta: float = 0.001) -> dict[str, np.ndarray]:
    """Every table, from the port's own numpy code."""
    from .models import snv_digt
    from .ops import readlik
    delta_lut, lnmis_lut = readlik.quantized_qscore_luts()
    priors = snv_digt.make_ln_priors(theta)
    return {
        "delta_lut": delta_lut,
        "lnmis_lut": lnmis_lut,
        "snv_qtab": snv_digt._snv_qtab(),
        "e0_tab": snv_digt._e0_tab(),
        **{f"prior_{k}": v for k, v in priors.items()},
    }


def tables_from_numpy(arrays: dict[str, np.ndarray],
                      device) -> dict[str, torch.Tensor]:
    """Device tensors of `arrays` (every name of TABLE_DTYPES, in its
    dtype; values are copied as they are)."""
    missing = set(TABLE_DTYPES) - set(arrays)
    if missing:
        raise KeyError(f"tables missing: {sorted(missing)}")
    out = {}
    for name, dt in TABLE_DTYPES.items():
        a = np.asarray(arrays[name])
        if a.dtype != dt:
            raise TypeError(f"table {name} is {a.dtype}, expected "
                            f"{np.dtype(dt)}")
        out[name] = torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return out


@functools.lru_cache(maxsize=8)
def device_tables(theta: float, device: torch.device):
    """The port's tables on `device` (cached per theta and device)."""
    return tables_from_numpy(numpy_tables(theta), device)
