"""The port's device tables (strelka_tpu_torch.convert) built from the JAX
package's numpy arrays equal the port's own, bit for bit."""
import numpy as np
import pytest
import torch

import strelka_tpu  # noqa: F401  (enables x64)
from strelka_tpu.models import snv_digt as jsd
from strelka_tpu.ops import readlik as jrl
from strelka_tpu_torch import convert


def jax_arrays(theta):
    delta_lut, lnmis_lut = jrl.quantized_qscore_luts()
    pr = jsd.make_ln_priors(theta)
    return {"delta_lut": delta_lut, "lnmis_lut": lnmis_lut,
            "snv_qtab": jsd._snv_qtab(), "e0_tab": np.asarray(jsd._e0_tab()),
            **{f"prior_{k}": v for k, v in pr.items()}}


@pytest.mark.parametrize("theta", [0.001, 0.01])
def test_tables_bit_identical(theta):
    ours = convert.tables_from_numpy(convert.numpy_tables(theta), "cpu")
    theirs = convert.tables_from_numpy(jax_arrays(theta), "cpu")
    assert set(ours) == set(convert.TABLE_DTYPES) == set(theirs)
    for name in convert.TABLE_DTYPES:
        a, b = ours[name], theirs[name]
        assert a.dtype == b.dtype and a.shape == b.shape, name
        # -inf entries of the ln priors compare equal bitwise too
        ia = a.view(torch.int64 if a.dtype == torch.float64 else torch.int32)
        ib = b.view(torch.int64 if b.dtype == torch.float64 else torch.int32)
        assert torch.equal(ia, ib), name


def test_device_tables_are_the_ports_own():
    tabs = convert.device_tables(0.001, torch.device("cpu"))
    np.testing.assert_array_equal(tabs["snv_qtab"].numpy(),
                                  convert.numpy_tables(0.001)["snv_qtab"])


def test_tables_from_numpy_rejects_bad_input():
    arrays = convert.numpy_tables(0.001)
    with pytest.raises(KeyError):
        convert.tables_from_numpy({k: v for k, v in arrays.items()
                                   if k != "e0_tab"}, "cpu")
    bad = dict(arrays, snv_qtab=arrays["snv_qtab"].astype(np.float64))
    with pytest.raises(TypeError):
        convert.tables_from_numpy(bad, "cpu")


def jax_somatic_arrays(prior):
    from strelka_tpu.models import somatic_snv as jss
    grid = jss._freq_grid_matmul_tables()
    pf, gp = jss.build_joint_prior(*prior)
    return {**dict(zip(convert.SOMATIC_GRID_DTYPES, grid)),
            "joint_pf": pf, "joint_gp": gp}


def default_prior():
    from strelka_tpu_torch.options import SomaticOptions
    return convert.somatic_prior_args(SomaticOptions())


@pytest.mark.parametrize("prior", [default_prior(),
                                   (0.15, 5e-10, 1e-4, 0.001, 0.5)])
def test_somatic_tables_bit_identical(prior):
    ours = convert.tables_from_numpy(convert.somatic_numpy_tables(prior),
                                     "cpu", convert.SOMATIC_TABLE_DTYPES)
    theirs = convert.tables_from_numpy(jax_somatic_arrays(prior), "cpu",
                                       convert.SOMATIC_TABLE_DTYPES)
    assert set(ours) == set(theirs) == set(convert.SOMATIC_TABLE_DTYPES)
    assert ours["grid_ref"].shape == (128, 21)
    assert ours["grid_on_ref"].shape == (128, 9)
    assert ours["joint_pf"].shape == (3, 2, 21, 21)
    assert ours["joint_gp"].shape == (3, 2)
    assert torch.isneginf(ours["joint_pf"]).any()
    for name in convert.SOMATIC_TABLE_DTYPES:
        a, b = ours[name], theirs[name]
        assert a.dtype == b.dtype == torch.float32, name
        # -inf entries of the joint prior compare equal bitwise too
        assert torch.equal(a.view(torch.int32), b.view(torch.int32)), name


def test_somatic_prior_defaults_are_the_somatic_options():
    """somatic_snv_call's keyword defaults (the JAX signature's) are the
    default SomaticOptions, and the cached device tables are the numpy
    ones: the grid tables per device, the joint prior per argument."""
    import inspect

    from strelka_tpu_torch.models import somatic_snv
    sig = inspect.signature(somatic_snv.somatic_snv_call).parameters
    names = ("contam_tolerance", "shared_error_rate", "somatic_rate",
             "theta", "sse_strand_fraction")
    assert tuple(sig[n].default for n in names) == default_prior()
    cpu = torch.device("cpu")
    want = convert.somatic_numpy_tables(default_prior())
    got = {**convert.somatic_grid_tables(cpu),
           **convert.somatic_prior_tables(cpu, default_prior())}
    assert set(got) == set(convert.SOMATIC_TABLE_DTYPES)
    for name, a in got.items():
        assert torch.equal(a.view(torch.int32),
                           torch.from_numpy(want[name]).view(torch.int32)), name
    assert convert.somatic_grid_tables(cpu) is convert.somatic_grid_tables(cpu)
