"""The port's device-resident tables, built from numpy arrays.

This system has no learned weights on its main path: what the device
code reads are fixed tables that the numpy code derives — the
quantized qscore LUTs of the scoring kernel (ops/readlik.py) and the
(qscore, base) genotype contribution table, the mismatch-cell
indicator and the ln prior tables of the SNV model
(models/snv_digt.py), and the somatic model's six [128, F] frequency-
grid tables and joint prior (models/somatic_snv.py). ``numpy_tables``
and ``somatic_numpy_tables`` build them with the port's own numpy code
(the joint prior from SomaticOptions through ``somatic_prior_args``);
``tables_from_numpy`` puts any such set on a device, so the JAX
package's arrays and the port's can be held against each other bit for
bit.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from . import device as devmod

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


# the somatic SNV model's tables (models/somatic_snv.py), all f32: the
# frequency-grid tables, which depend on nothing, and the joint prior,
# which depends on build_joint_prior's arguments
SOMATIC_GRID_DTYPES = {
    "grid_ref": np.float32,              # [128, 21] ref call, q=0 REF zeroed
    "grid_alt": np.float32,              # [128, 21] alt call, q=0 HOM zeroed
    "grid_on_ref": np.float32,           # [128, 9] on-strand ref call
    "grid_on_alt": np.float32,           # [128, 9] on-strand alt call
    "grid_off_ref": np.float32,          # [128, 9] off-strand ref, q=0 zeroed
    "grid_off_alt": np.float32,          # [128, 9] off-strand alt call
}
SOMATIC_PRIOR_DTYPES = {
    "joint_pf": np.float32,              # [3, 2, 21, 21] ln prior, -inf excluded
    "joint_gp": np.float32,              # [3, 2] genotype x somatic prior
}
SOMATIC_TABLE_DTYPES = {**SOMATIC_GRID_DTYPES, **SOMATIC_PRIOR_DTYPES}


def somatic_prior_args(opt) -> tuple:
    """build_joint_prior's arguments from SomaticOptions `opt`."""
    return (opt.ssnv_contam_tolerance, opt.shared_site_error_rate,
            opt.somatic_snv_rate, opt.bsnp_diploid_theta,
            opt.shared_site_error_strand_bias_fraction)


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


def somatic_numpy_tables(prior) -> dict[str, np.ndarray]:
    """The somatic model's tables from the port's own numpy code; prior
    is build_joint_prior's argument tuple (somatic_prior_args)."""
    from .models import somatic_snv
    grid = somatic_snv._freq_grid_matmul_tables()
    pf, gp = somatic_snv.build_joint_prior(*prior)
    return {**dict(zip(SOMATIC_GRID_DTYPES, grid)),
            "joint_pf": pf, "joint_gp": gp}


def tables_from_numpy(arrays: dict[str, np.ndarray], device,
                      dtypes=None) -> dict[str, torch.Tensor]:
    """Device tensors of `arrays` (every name of `dtypes`, default
    TABLE_DTYPES, in its dtype; values are copied as they are)."""
    dtypes = TABLE_DTYPES if dtypes is None else dtypes
    missing = set(dtypes) - set(arrays)
    if missing:
        raise KeyError(f"tables missing: {sorted(missing)}")
    out = {}
    for name, dt in dtypes.items():
        a = np.asarray(arrays[name])
        if a.dtype != dt:
            raise TypeError(f"table {name} is {a.dtype}, expected "
                            f"{np.dtype(dt)}")
        out[name] = devmod.put("tables", a, torch.device(device))
    return out


@functools.lru_cache(maxsize=8)
def device_tables(theta: float, device: torch.device):
    """The port's tables on `device` (cached per theta and device)."""
    return tables_from_numpy(numpy_tables(theta), device)


@functools.lru_cache(maxsize=8)
def somatic_grid_tables(device: torch.device):
    """The six frequency-grid tables on `device` (cached per device)."""
    from .models import somatic_snv
    grid = somatic_snv._freq_grid_matmul_tables()
    return tables_from_numpy(dict(zip(SOMATIC_GRID_DTYPES, grid)), device,
                             SOMATIC_GRID_DTYPES)


def somatic_prior_tables(device: torch.device, prior):
    """joint_pf and joint_gp of build_joint_prior(*prior) on `device`
    (the caller, somatic_snv._posterior_tables, caches them)."""
    from .models import somatic_snv
    pf, gp = somatic_snv.build_joint_prior(*prior)
    return tables_from_numpy({"joint_pf": pf, "joint_gp": gp}, device,
                             SOMATIC_PRIOR_DTYPES)
