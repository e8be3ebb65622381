"""The port's somatic models (strelka_tpu_torch.models.somatic_snv and
somatic_indel) against the JAX package's, on the CPU, on the same
numpy-seeded inputs. Mirrors tests/test_somatic_grid_kernel.py.

- freq_grid_lhoods: the -inf positions are identical and the 21
  frequency-grid states are bit-identical (the port sums each histogram
  product in the XLA CPU dot's order, with its FMAs emulated exactly).
  The 9 strand states go through a logaddexp that the port takes in
  float64 and XLA in f32: they differ by at most STRAND_MAX_ULP ulp, at
  under STRAND_MAX_FRAC of the entries.
- build_joint_prior: bit-identical.
- somatic_snv_call: every integer field equal, strand_bias equal, on
  the same lhoods and end to end from the same pileup tiles (the
  posterior reads only the grid states). No phred flips at these seeds.
- The capped call equals the uncapped one row by row.
- somatic_indel: indel_freq_grid_lhoods and somatic_indel_call equal.
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import strelka_tpu  # noqa: F401  (enables x64, as the JAX caller runs)
from strelka_tpu.models import somatic_indel as jsi
from strelka_tpu.models import somatic_snv as jss
from strelka_tpu_torch.models import somatic_indel as tsi
from strelka_tpu_torch.models import somatic_snv as tss
from test_somatic_grid_kernel import _dense_oracle

STRAND_MAX_ULP = 4
STRAND_MAX_FRAC = 0.01
INT_FIELDS = ("qphred", "from_ntype_qphred", "ntype", "max_gt",
              "nonsomatic_qphred")


def pileup_tile(rng, L, D, alt_frac=0.1):
    """A random pileup tile with q=0 calls, masked lanes, all-masked rows
    and ref_gt=4 rows (numpy: base int8, qual int16, mask/fwd bool,
    ref_gt int32)."""
    ref = rng.integers(0, 5, L).astype(np.int32)
    ref[:7] = 4
    base = rng.integers(-1, 4, (L, D)).astype(np.int8)
    base = np.where(rng.random((L, D)) < 1 - alt_frac,
                    np.minimum(ref, 3)[:, None], base).astype(np.int8)
    qual = rng.integers(0, 45, (L, D)).astype(np.int16)
    qual = np.where(rng.random((L, D)) < 0.02, 0, qual).astype(np.int16)
    mask = rng.random((L, D)) < 0.85
    mask[10:20] = False
    fwd = rng.random((L, D)) < 0.5
    return base, qual, mask, fwd, ref


def jax_grid(t):
    return np.asarray(jss.freq_grid_lhoods(*(jnp.asarray(a) for a in t)))


def port_grid(t):
    return tss.freq_grid_lhoods(*(torch.from_numpy(a) for a in t)).numpy()


def ulps(a, b):
    return np.abs(a.view(np.int32).astype(np.int64)
                  - b.view(np.int32).astype(np.int64))


@pytest.fixture(scope="module", params=[32, 96])
def tiles(request):
    D = request.param
    rng = np.random.default_rng(D)
    normal = pileup_tile(rng, 2000, D)
    tumor = pileup_tile(rng, 2000, D, alt_frac=0.3)
    return normal, tumor


def test_freq_grid_lhoods_matches_jax(tiles):
    for t in tiles:
        j, p = jax_grid(t), port_grid(t)
        assert p.dtype == np.float32 and p.shape == j.shape
        np.testing.assert_array_equal(np.isneginf(j), np.isneginf(p))
        assert np.isfinite(p[~np.isneginf(p)]).all()
        np.testing.assert_array_equal(j[:, :tss.PRESTRAND_SIZE].view(np.int32),
                                      p[:, :tss.PRESTRAND_SIZE].view(np.int32))
        d = ulps(j[:, tss.PRESTRAND_SIZE:], p[:, tss.PRESTRAND_SIZE:])
        assert d.max() <= STRAND_MAX_ULP
        assert (d > 0).mean() <= STRAND_MAX_FRAC
        # the all-masked rows contribute nothing
        np.testing.assert_array_equal(p[10:20, :tss.PRESTRAND_SIZE], 0.0)


def test_somatic_snv_call_matches_jax(tiles):
    nl, tl = (jax_grid(t) for t in tiles)
    want = jss.somatic_snv_call(jnp.asarray(nl), jnp.asarray(tl))
    got = tss.somatic_snv_call(torch.from_numpy(nl), torch.from_numpy(tl))
    for f in INT_FIELDS:
        a, b = np.asarray(getattr(want, f)), getattr(got, f).numpy()
        assert b.dtype == np.int32
        np.testing.assert_array_equal(a, b, err_msg=f)
    np.testing.assert_allclose(got.strand_bias.numpy(),
                               np.asarray(want.strand_bias), rtol=0,
                               atol=0)
    assert (np.asarray(want.qphred) > 0).any()


def test_somatic_chain_matches_jax_from_tiles(tiles):
    """Grid lhoods and posterior of each package from the same tiles:
    the posterior reads only the bit-identical grid states, so every
    integer field is equal; strand_bias reads the strand states and
    stays within their ulp bound."""
    want = jss.somatic_snv_call(*(jnp.asarray(jax_grid(t)) for t in tiles))
    got = tss.somatic_snv_call_capped(*(torch.from_numpy(port_grid(t))
                                        for t in tiles))
    for f in INT_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(want, f)),
                                      getattr(got, f).numpy(), err_msg=f)
    np.testing.assert_allclose(got.strand_bias.numpy(),
                               np.asarray(want.strand_bias), rtol=0,
                               atol=1e-4)


def test_freq_grid_lhoods_matches_dense_oracle():
    rng = np.random.default_rng(9)
    L, D = 64, 24
    base = rng.integers(0, 4, (L, D)).astype(np.int8)
    qual = rng.integers(2, 41, (L, D)).astype(np.int16)
    mask = rng.random((L, D)) < 0.9
    fwd = rng.random((L, D)) < 0.5
    ref_gt = rng.integers(0, 4, L).astype(np.int32)
    t = (base, qual, mask, fwd, ref_gt)
    assert np.allclose(port_grid(t), _dense_oracle(*t), rtol=2e-4,
                       atol=2e-3)


def test_q0_neg_inf_cases():
    base = np.zeros((3, 2), np.int8)
    qual = np.zeros((3, 2), np.int16)
    mask = np.ones((3, 2), bool)
    fwd = np.array([[True, True], [False, False], [True, False]])
    ref_gt = np.array([0, 0, 1], np.int32)
    t = (base, qual, mask, fwd, ref_gt)
    got, exp = port_grid(t), _dense_oracle(*t)
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(exp))
    np.testing.assert_array_equal(got.view(np.int32),
                                  jax_grid(t).view(np.int32))
    assert np.isneginf(got[0, 0]) and np.isneginf(got[2, 1])


def test_all_neg_inf_rows_give_neg_inf_not_nan():
    a = torch.tensor([[-np.inf] * 5, [0.0, -np.inf, 1.0, -np.inf, 2.0]],
                     dtype=torch.float32)
    lse = tss._logsumexp64(a)
    assert lse[0] == -np.inf and torch.isfinite(lse[1])
    ninf = torch.tensor([-np.inf, -np.inf, 1.0], dtype=torch.float64)
    out = tss._logaddexp64(ninf[:2], ninf[[0, 2]])
    assert out[0] == -np.inf and out[1] == 1.0
    # rows whose REF and HOM states are -inf (q=0 ref and alt calls in
    # both samples) give the JAX package's finite results
    nl = np.full((3, tss.GRID_SIZE), -5.0, np.float32)
    nl[:, :2] = -np.inf
    nl[2, 5:9] = -np.inf
    got = tss.somatic_snv_call(torch.from_numpy(nl), torch.from_numpy(nl))
    want = jss.somatic_snv_call(jnp.asarray(nl), jnp.asarray(nl))
    for f in INT_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(want, f)),
                                      getattr(got, f).numpy(), err_msg=f)
    assert not torch.isnan(got.strand_bias).any()


@pytest.mark.parametrize("args", [
    (0.15, 5e-10, 1e-4, 0.001, 0.0), (0.15, 5e-10, 1e-4, 0.001, 0.5),
    (0.1, 1e-6, 1e-6, 1e-4, 0.0), (0.15, 2.5e-7, 1e-6, 1e-4, 0.0)])
def test_build_joint_prior_bit_identical(args):
    for a, b in zip(jss.build_joint_prior(*args),
                    tss.build_joint_prior(*args)):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32))


def test_capped_call_matches_uncapped_rowwise():
    rng = np.random.default_rng(11)
    # one row past a chunk boundary of the host's budget, so the capped
    # call runs two launches
    L = tss.rows_per_launch("cpu", tss.CALL_ROW_BYTES) + 1237
    G = tss.GRID_SIZE
    nl = -np.abs(rng.normal(80, 40, (L, G))).astype(np.float32)
    tl = -np.abs(rng.normal(80, 40, (L, G))).astype(np.float32)
    full = tss.somatic_snv_call(torch.from_numpy(nl), torch.from_numpy(tl))
    tss.LAUNCH_STATS.clear()
    capped = tss.somatic_snv_call_capped(torch.from_numpy(nl),
                                         torch.from_numpy(tl))
    assert sum(tss.LAUNCH_STATS.values()) == 2
    for f in tss.SomaticSnvResult._fields:
        assert torch.equal(getattr(full, f), getattr(capped, f)), f
    want = jss.somatic_snv_call(jnp.asarray(nl), jnp.asarray(tl))
    for f in INT_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(want, f)),
                                      getattr(capped, f).numpy(), err_msg=f)


def test_launch_stats_count_each_program():
    rng = np.random.default_rng(2)
    t = pileup_tile(rng, 100, 8)
    tss.LAUNCH_STATS.clear()
    lh = tss.freq_grid_lhoods(*(torch.from_numpy(a) for a in t))
    tss.somatic_snv_call(lh, lh)
    assert tss.LAUNCH_STATS == {("grid", "cpu", 100, 8): 1,
                                ("post", "cpu", 100, 0): 1}


def test_capped_call_is_wired_into_the_caller():
    import inspect

    from strelka_tpu_torch.pipeline import somatic_caller as sc
    src = inspect.getsource(sc)
    assert "somatic_snv_call_capped(" in src
    assert "ss.somatic_snv_call(" not in src
    # the caller's chunk fits the capped call's budget, so the posterior
    # runs once per chunk
    for D in (32, 96, 512):
        pus = [SimpleNamespace(base_id=np.zeros((1, d), np.int8))
               for d in (D // 2, D)]
        assert sc._tile_rows(pus, torch.device("cpu")) <= \
            tss.rows_per_launch("cpu", tss.CALL_ROW_BYTES)


def test_rows_per_launch_fits_the_budget():
    cpu = torch.device("cpu")
    for row_bytes in (1, 1000, tss.CALL_ROW_BYTES, 10 ** 9):
        n = tss.rows_per_launch(cpu, row_bytes)
        assert 1024 <= n <= tss.MAX_ROWS and n % 1024 == 0
        assert n == 1024 or n * row_bytes <= tss.HOST_BUDGET_BYTES
    assert tss.rows_per_launch(cpu, 1) == tss.MAX_ROWS
    assert tss.rows_per_launch(cpu, 10 ** 9) == 1024


def _indel_inputs(rng, R):
    ref = -np.abs(rng.normal(10, 8, R))
    ind = -np.abs(rng.normal(10, 8, R))
    rl = rng.integers(60, 151, R).astype(np.int64)
    nn = rl - rng.integers(0, 5, R)
    mask = rng.random(R) < 0.9
    return ref, ind, rl, nn, mask


@pytest.mark.parametrize("seed", range(6))
def test_somatic_indel_matches_jax(seed):
    rng = np.random.default_rng(seed)
    sizes = (int(rng.integers(1, 40)), int(rng.integers(1, 90)))
    grids = {}
    for name, mod in (("jax", jsi), ("port", tsi)):
        r2 = np.random.default_rng(seed)
        grids[name] = [mod.indel_freq_grid_lhoods(
            *_indel_inputs(r2, n), insert_len=3 * (seed % 2),
            delete_len=3 * (1 - seed % 2), min_read_bp_flank=1 + 4 * s,
            ln_random_base_match=np.log(0.25 if seed % 3 else 0.5))
            for s, n in enumerate(sizes)]
    for a, b in zip(grids["jax"], grids["port"]):
        np.testing.assert_array_equal(a, b)
    rate = float(rng.uniform(1e-5, 1e-2))
    want = jsi.somatic_indel_call(*grids["jax"], rate)
    got = tsi.somatic_indel_call(*grids["port"], rate)
    assert tuple(want) == tuple(got)
    assert all(isinstance(v, int) for v in got)
