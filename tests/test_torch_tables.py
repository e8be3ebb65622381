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
