"""KE-F's arithmetic (strelka_tpu_torch/ops/fit_kernels.py: the torch
model of csrc/error_fit_step.cu) against the JAX package's fit on the
CPU, on counts from tests/test_torch_error_fit.py's seeded generator,
the fit entry's grid (fit_grid) and host operands (FitRun), and the
dispatch of models/error_fit.fit_context (the plain step on the CPU,
KE-F's fit entry elsewhere, no fallback). The kernel itself runs on a
card only: tests/test_torch_cuda.py holds it against this model and the
plain step there.

Bounds, tests/test_torch_error_fit.py's and the reason beside each:
- the loss within LOSS_RTOL: the per-locus values are the plain
  version's, only the order of the sums over loci differs (XLA's, the
  kernel's grid_sum);
- the gradient within GRAD_RTOL of its largest component: the closed
  form adds each component's terms in another order than autodiff does;
  near an optimum, where the terms cancel, within eps * N * sum|terms|
  of each component's terms (a sum's rounding bound), carried through
  the chain's factors;
- the fitted log-rates within RATE_RTOL where the optimum is sharp and
  within FLAT_RTOL where it is flat, with the loss at the fit within
  LOSS_AT_FIT_RTOL (steps whose losses tie within an ulp are kept by
  another order's choice);
- Adam and the prep's values bit for bit (the same operations).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import strelka_tpu  # noqa: F401  (enables x64)
from strelka_tpu.models import error_fit as jef
from strelka_tpu.models.error_fit import LOW_REPEAT_COUNT
from strelka_tpu.models.indel_genotype import HPOL_THETA
from strelka_tpu_torch.models import error_fit as tef
from strelka_tpu_torch.ops import fit_kernels as fk
from strelka_tpu_torch.utils import special as sp
from tests.test_torch_error_fit import (FLAT_RTOL, GRAD_RTOL,
                                        LOSS_AT_FIT_RTOL, LOSS_RTOL,
                                        RATE_RTOL, RATES, both_counts,
                                        simulate_context)

EPS = np.finfo(np.float64).eps
LT = float(np.log(0.002))

# alt rows that reach the prep's edges: tied slots (the first max wins,
# then the first of the rest), an all-zero row, max2 = 0, a deletion max
EDGE_ALT = np.array([[3, 3, 0, 3, 0, 0], [0, 0, 2, 2, 0, 0],
                     [0, 0, 0, 0, 0, 0], [0, 0, 0, 0, 5, 0],
                     [0, 1, 0, 4, 4, 1], [2, 0, 0, 0, 0, 2]], np.int64)


def edge_counts(seed=6):
    """(jax counts, torch counts, numpy (ref, alt, inst)): simulated loci
    (tests/test_torch_error_fit.py's generator, theta 0.01 for het and
    hom indels) and EDGE_ALT's rows, deduplicated by both packages."""
    rng = np.random.default_rng(seed)
    ref, alt = simulate_context(rng, 1500, 40, 2e-2, 0.3, theta=0.01)
    ref = np.concatenate([ref, 30 - EDGE_ALT.sum(axis=1)])
    alt = np.concatenate([alt, EDGE_ALT])
    jc, tc = jef.dedupe_counts(ref, alt), tef.dedupe_counts(ref, alt)
    return jc, tc


def host(tc):
    return [torch.as_tensor(np.asarray(a, np.float64))
            for a in (tc.ref_obs, tc.alt_obs, tc.instance_count)]


def consts(lt=LT, lr=0.05):
    return tef.kernel_consts(lt, lr)


def jax_value_and_grad(jc, lt):
    """The JAX package's loss and gradient on jc at lt, jitted once:
    point -> (loss, gradient)."""
    r, a, n = (jnp.asarray(np.asarray(x, np.float64)) for x in
               (jc.ref_obs, jc.alt_obs, jc.instance_count))

    def loss(p):
        li = jef._rate_smoother(p[0], jef.MAX_LOG_RATE)
        ld = jef._rate_smoother(p[1], jef.MAX_LOG_RATE)
        ln = jef._rate_smoother(p[2], jef.MAX_LOG_LOCUS_RATE)
        return -jef.context_log_lhood(li, ld, ln, jnp.float64(lt), r, a, n)
    vg = jax.jit(jax.value_and_grad(loss))

    def at(point):
        v, g = vg(jnp.asarray(point, jnp.float64))
        return float(v), np.asarray(g)
    return at


# the smoother's branches, rate and locus rate: below the trigger, past
# it, and folded back past max_log
POINTS = [
    (math.log(1e-3), math.log(1e-3), math.log(0.5)),   # the fit's start
    (-4.0, -5.0, -1.2),            # both below their triggers
    (-2.0, -9.0, -0.05),           # past the rate and locus triggers
    (-8.0, -3.0, 0.4),             # the locus rate folded back
    (500.0, -3.0, 0.4),            # the insert rate folded back
    (500.0, 600.0, 1.5),           # every rate folded back
]


@pytest.mark.parametrize("point", POINTS)
def test_model_value_and_grad_match_jax(point):
    jc, tc = edge_counts()
    loc = tef.fit_prep_plain(*host(tc), LT)
    out = fk.fit_step_model(loc, torch.tensor(point, dtype=torch.float64),
                            consts())
    jv, jg = jax_value_and_grad(jc, LT)(point)
    assert float(out["v"]) == pytest.approx(jv, rel=LOSS_RTOL, abs=0)
    np.testing.assert_allclose(out["g"].numpy(), jg, rtol=0,
                               atol=GRAD_RTOL * np.abs(jg).max())


def test_model_grad_at_the_optimum_within_the_sum_bound():
    """At the loss's optimum (L-BFGS on the JAX loss from the fit's
    start) the gradient's terms cancel: each component within GRAD_RTOL
    of the largest or 2 eps N times its terms' scale (fit_step_model's
    "scale") of JAX's."""
    from scipy.optimize import minimize
    jc, tc = edge_counts()
    vg = jax_value_and_grad(jc, LT)
    res = minimize(vg,
                   [np.log(1e-3), np.log(1e-3), np.log(0.5)], jac=True,
                   method="L-BFGS-B", options=dict(ftol=0, gtol=1e-9))
    loc = tef.fit_prep_plain(*host(tc), LT)
    out = fk.fit_step_model(loc, torch.from_numpy(res.x), consts())
    jv, jg = vg(res.x)
    # the terms cancel: the gradient is far below its terms' scale
    assert np.abs(jg).max() < 1e-6 * out["scale"].numpy().max()
    bound = np.maximum(GRAD_RTOL * np.abs(jg).max(),
                       2 * EPS * loc.shape[1] * out["scale"].numpy())
    assert np.all(np.abs(out["g"].numpy() - jg) <= bound)
    assert float(out["v"]) == pytest.approx(jv, rel=LOSS_RTOL, abs=0)


def test_prep_rows_and_terms_bit_for_bit_with_the_plain_expressions():
    """fit_prep_plain's count rows from numpy (first max, then the first
    of the rest; max2 clamped at 0), and the model's per-locus loss
    terms from its hoisted prefixes equal the plain expressions' mix *
    inst bit for bit at a point past both triggers."""
    _, tc = edge_counts()
    ref, alt, inst = host(tc)
    loc = tef.fit_prep_plain(ref, alt, inst, LT)
    a = tc.alt_obs.astype(np.int64)
    mi = np.argmax(a, axis=1)
    mv = a[np.arange(len(a)), mi]
    masked = a.copy()
    masked[np.arange(len(a)), mi] = -1
    mi2 = np.argmax(masked, axis=1)
    mv2 = np.maximum(masked[np.arange(len(a)), mi2], 0)
    ins, dele = a[:, :3].sum(axis=1), a[:, 3:].sum(axis=1)
    rem_ins = ins - np.where(mi < 3, mv, 0)
    rem_del = dele - np.where(mi < 3, 0, mv)
    want = [tc.ref_obs, ins, dele, rem_ins, rem_del,
            rem_ins - np.where(mi2 < 3, mv2, 0),
            rem_del - np.where(mi2 < 3, 0, mv2)]
    for row, w in zip(loc[:7], want):
        np.testing.assert_array_equal(row.numpy(), w.astype(np.float64))
    np.testing.assert_array_equal(loc[11].numpy(), inst.numpy())
    assert {tuple(r) for r in EDGE_ALT} <= {tuple(r) for r in a}

    p = torch.tensor((-2.0, -4.0, -0.05), dtype=torch.float64)
    out = fk.fit_step_model(loc, p, consts())
    li, ld, ln = (tef._rate_smoother(p[0], tef.MAX_LOG_RATE),
                  tef._rate_smoother(p[1], tef.MAX_LOG_RATE),
                  tef._rate_smoother(p[2], tef.MAX_LOG_LOCUS_RATE))
    for got, want in zip(out["rates"], (li, ld, ln)):
        assert got.view(torch.int64) == want.view(torch.int64)
    lr = torch.log(1 - torch.exp(li) - torch.exp(ld))
    noisy = tef._obs_log_lhood(li, ld, lr, ref, alt, LT)
    clean = tef._obs_log_lhood(
        math.log(tef.CLEAN_LOCUS_INDEL_RATE),
        math.log(tef.CLEAN_LOCUS_INDEL_RATE),
        math.log(1 - tef.CLEAN_LOCUS_INDEL_RATE), ref, alt, LT)
    assert torch.equal(loc[10].view(torch.int64), clean.view(torch.int64))
    mix = sp.logaddexp(torch.log1p(-torch.exp(ln)) + clean, ln + noisy)
    assert torch.equal(out["terms"][0].view(torch.int64),
                       (mix * inst).view(torch.int64))


def test_model_adam_bit_for_bit_with_special_adam():
    rng = np.random.default_rng(0)
    c = consts(lr=0.05)
    p0 = torch.from_numpy(rng.normal(size=3))
    pa, opt = p0.clone(), sp.Adam(p0.clone(), 0.05)
    pm, mu, nu = p0.clone(), torch.zeros(3, dtype=torch.float64), \
        torch.zeros(3, dtype=torch.float64)
    for t in range(1, 601):
        g = torch.from_numpy(rng.normal(0, 1, 3) * np.exp(rng.normal(0, 3, 3)))
        pa = opt.step(pa, g)
        pm, mu, nu = fk.adam_model(pm, mu, nu, g, t, c)
        assert torch.equal(pm.view(torch.int64), pa.view(torch.int64)), t
    assert torch.equal(mu, opt.mu) and torch.equal(nu, opt.nu)


@pytest.mark.parametrize("losses,best", [
    ([5.0, float("nan"), 5.0, 4.0, 4.0, float("nan"), 4.5], 3),
    ([float("nan"), 1.0, 0.0], 0),          # a first NaN stays
    ([2.0, 2.0, 2.0], 0),                   # ties keep the earliest
])
def test_best_step_rule(losses, best):
    """keeps_step against the JAX package's loop (error_fit.py: best is
    None or float(v) < best[0])."""
    kept = None
    for t, v in enumerate(losses, 1):
        if fk.keeps_step(t, v, None if kept is None else losses[kept]):
            kept = t - 1
    want = None
    for i, v in enumerate(losses):
        if want is None or v < losses[want]:
            want = i
    assert kept == want == best


@pytest.mark.parametrize("case", ["sharp", "flat"])
def test_model_fit_matches_jax(case):
    """A 600-step fit through fit_model against the JAX package's
    fit_context: tests/test_torch_error_fit.py's sharp case (within
    RATE_RTOL) and its flat case (FLAT_RTOL, and the JAX loss at the
    model's rates within LOSS_AT_FIT_RTOL of its loss at its own)."""
    if case == "sharp":
        rng = np.random.default_rng(0)
        jc, tc = both_counts(rng, 2000, 30, 5e-3, 1.0, theta=0.001)
        lt, rtol = float(np.log(0.001)), RATE_RTOL
    else:
        rng = np.random.default_rng(2)
        both_counts(rng, 60, 30, 1e-4, 1.0)
        jc, tc = both_counts(rng, 600, 30, 5e-4, 1.0)
        lt, rtol = float(np.log(HPOL_THETA[LOW_REPEAT_COUNT - 1])), FLAT_RTOL
    want = jef.fit_context(jc, lt)
    loc = tef.fit_prep_plain(*host(tc), lt)
    p0 = torch.tensor([np.log(1e-3), np.log(1e-3), np.log(0.5)],
                      dtype=torch.float64)
    _, p, losses, _ = fk.fit_model(loc, p0, consts(lt), 600)
    assert losses.shape == (600,) and bool(torch.isfinite(losses).all())
    li = float(tef._rate_smoother(p[0], tef.MAX_LOG_RATE))
    ld = float(tef._rate_smoother(p[1], tef.MAX_LOG_RATE))
    ln = float(tef._rate_smoother(p[2], tef.MAX_LOG_LOCUS_RATE))
    got = dict(log_error_rate=(li + ld) / 2.0, log_noisy_locus_rate=ln,
               log_insert_rate=li, log_delete_rate=ld)
    for f in RATES:
        assert got[f] == pytest.approx(getattr(want, f), rel=rtol, abs=0), f
    if case == "flat":
        args = [jnp.asarray(np.asarray(x, np.float64)) for x in
                (jc.ref_obs, jc.alt_obs, jc.instance_count)]

        def loss(i, d, n):
            return -float(jef.context_log_lhood(i, d, n, jnp.float64(lt),
                                                *args))
        assert loss(li, ld, ln) == pytest.approx(
            loss(want.log_insert_rate, want.log_delete_rate,
                 want.log_noisy_locus_rate), rel=LOSS_AT_FIT_RTOL, abs=0)


def test_grid_sum_order_and_grids():
    """fit_grid covers N with at most MAX_BLOCKS blocks and no empty
    block; grid_sum's partials add to its totals in block order and
    stay within a sum's rounding bound of the exact sums, at one locus a
    thread and at several (the 50,000-pattern size and past it)."""
    for n in (1, 255, 256, 257, 50_000, fk.THREADS * fk.MAX_BLOCKS + 1,
              10**6):
        blocks, per, _ = fk.fit_grid(n)
        assert blocks * per * fk.THREADS >= n > (blocks - 1) * per * \
            fk.THREADS
        assert blocks <= fk.MAX_BLOCKS
    rng = np.random.default_rng(3)
    for n, grid in ((700, fk.fit_grid(700)[:2]), (5000, (3, 7))):
        x = rng.normal(size=(2, n)) * np.exp(rng.normal(0, 4, (2, n)))
        tot, part = fk.grid_sum(torch.from_numpy(x), *grid)
        assert part.shape == (grid[0], 2)
        seq = part[0].clone()
        for b in range(1, grid[0]):
            seq = seq + part[b]
        assert torch.equal(seq, tot)
        exact = np.array([math.fsum(r) for r in x])
        assert np.all(np.abs(tot.numpy() - exact)
                      <= EPS * n * np.abs(x).sum(axis=1))


def test_model_step_at_50000_patterns_matches_the_plain_step():
    """One step at a context of over 50,000 patterns (several loci a
    thread past MAX_BLOCKS' one): the model's loss, gradient and Adam
    step against fit_step_plain's."""
    tc = fk.synthetic_counts(9, 60_000, 300)
    assert len(tc.ref_obs) >= 50_000
    obs = host(tc)
    c = consts()
    loc = tef.fit_prep_plain(*obs, LT)
    p = torch.tensor([-5.0, -6.0, -1.0], dtype=torch.float64)
    for grid in (None, (fk.MAX_BLOCKS // 2, 2)):
        out = fk.fit_step_model(loc, p, c, grid)
        pp, v, g = tef.fit_step_plain(p, sp.Adam(p, 0.05), LT, *obs)
        assert float(out["v"]) == pytest.approx(float(v), rel=LOSS_RTOL,
                                                abs=0)
        bound = np.maximum(GRAD_RTOL * float(g.abs().max()),
                           2 * EPS * loc.shape[1] * out["scale"].numpy())
        assert np.all(np.abs((out["g"] - g).numpy()) <= bound)
        pm, _, _ = fk.adam_model(p, torch.zeros(3, dtype=torch.float64),
                                 torch.zeros(3, dtype=torch.float64), g, 1, c)
        assert torch.equal(pm.view(torch.int64), pp.view(torch.int64))


def test_cpu_fit_never_reaches_the_wrapper(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("a CPU fit reached KE-F's wrapper")
    monkeypatch.setattr(fk, "error_fit_prep", boom)
    monkeypatch.setattr(fk, "error_fit_run", boom)
    monkeypatch.setattr(fk, "FitRun", boom)
    fk.reset()
    rng = np.random.default_rng(7)
    _, tc = both_counts(rng, 200, 20, 1e-2, 1.0)
    got = tef.fit_context(tc, -6.0, n_steps=25, device="cpu")
    assert got.acceptable
    assert fk.LAUNCHES == {"error_fit_prep": 0, "error_fit_run": 0}
    assert fk.PLAIN_ON_CUDA == {"error_fit_prep": 0, "error_fit_step": 0}


def test_device_fit_without_a_built_kernel_raises(monkeypatch, tmp_path):
    """A fit whose tensors are not on the CPU goes to KE-F, and where the
    kernel cannot be built (no nvcc here) it raises: the plain step never
    runs in its place and nothing is counted."""
    calls = []
    monkeypatch.setattr(tef, "fit_step_plain",
                        lambda *a, **k: calls.append(1))
    monkeypatch.setattr(tef.devmod, "resolve",
                        lambda device=None: torch.device("meta"))
    monkeypatch.setattr(fk, "_BOUND", {})
    monkeypatch.setattr(fk, "_RESIDENT", {})
    from strelka_tpu_torch import _build
    monkeypatch.setattr(_build, "nvcc_path", lambda: None)
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(_build, "_LIBS", {})
    fk.reset()
    before = dict(tef.FIT_STATS)
    rng = np.random.default_rng(7)
    _, tc = both_counts(rng, 200, 20, 1e-2, 1.0)
    with pytest.raises(RuntimeError, match="nvcc"):
        tef.fit_context(tc, -6.0, n_steps=5, device="cuda")
    assert not calls
    assert tef.FIT_STATS == before
    assert fk.LAUNCHES == {"error_fit_prep": 0, "error_fit_run": 0}


def test_wrappers_reject_what_the_kernel_does_not_take(monkeypatch):
    """The prep and fit wrappers raise on what the kernel does not take
    before any build: a wrong dtype, shape or layout, N = 0, too few
    constants, n_steps < 1."""
    def boom(*a, **k):
        raise AssertionError("a rejected call reached the build")
    monkeypatch.setattr(fk, "function", boom)
    _, tc = edge_counts()
    ref, alt, inst = host(tc)
    c = consts()
    fk.reset()
    p0 = torch.zeros(3, dtype=torch.float64)
    for call in (fk.error_fit_prep,
                 lambda r, a, i, k: fk.FitRun(r, a, i, p0, k, 4)):
        with pytest.raises(ValueError, match="float64"):
            call(ref, alt.float(), inst, c)
        with pytest.raises(ValueError, match="shape"):
            call(ref, alt[:, :5].contiguous(), inst, c)
        with pytest.raises(ValueError, match="shape"):
            call(ref, alt, inst[:-1].contiguous(), c)
        with pytest.raises(ValueError, match="contiguous"):
            call(ref, alt.T.contiguous().T, inst, c)
        with pytest.raises(ValueError, match="N >= 1"):
            call(ref[:0], alt[:0], inst[:0], c)
        with pytest.raises(ValueError, match="N >= 1"):
            call(ref[:, None], alt, inst, c)
        with pytest.raises(ValueError, match="constants"):
            call(ref, alt, inst, c[:-1])
    for n_steps in (0, -1):
        with pytest.raises(ValueError, match="n_steps"):
            fk.error_fit_run(ref, alt, inst, p0, c, n_steps)
    assert fk.LAUNCHES == {"error_fit_prep": 0, "error_fit_run": 0}


@pytest.mark.parametrize("grid,ok", [
    ((2, 1, "grid"), True), ((2, 1, "cluster"), True),
    ((20, 1, "cluster"), True), ((1, 5, "global"), True),
    ((1, 1, "cluster"), False), ((2, 5, "grid"), False),
    ((2, 1, "global"), False), ((fk.MAX_BLOCKS + 1, 1, "grid"), True),
    ((0, 1, "grid"), False), ((2, 1, "tiles"), False)])
def test_fit_run_takes_a_grid(monkeypatch, grid, ok):
    """FitRun with a grid in place of fit_grid's (to measure a regime, or
    to have the card refuse one) on 300 loci, with no build or card
    query: one that covers the loci in a regime of the entry ("global"
    just past ON_CHIP_PER loci a thread) binds with its cluster flag and
    buffers; any other raises. More than MAX_BLOCKS blocks, or a grid
    that the card cannot place, is the launch's to refuse."""
    def boom(*a, **k):
        raise AssertionError("FitRun with a grid asked the card")
    monkeypatch.setattr(fk, "function", boom)
    monkeypatch.setattr(fk, "resident_blocks", boom)
    tc = fk.synthetic_counts(4, 900, 200)
    ref, alt, inst = (x[:300].contiguous() for x in host(tc))
    p0 = torch.zeros(3, dtype=torch.float64)
    if not ok:
        with pytest.raises(ValueError, match="grid"):
            fk.FitRun(ref, alt, inst, p0, consts(), 3, grid=grid)
        return
    run = fk.FitRun(ref, alt, inst, p0, consts(), 3, grid=grid)
    blocks, per, regime = grid
    assert run.grid == grid
    assert run._args[4:8] == [blocks, per, 3, int(regime == "cluster")]
    assert (run.partials is None) == (regime == "cluster")
    assert (run.loc is None) == (regime != "global")


# fit_grid's edge sizes on a card of `resident` blocks: one locus a
# thread, a cluster up to CLUSTER_MAX blocks, the on-chip limit
# (resident * THREADS * ON_CHIP_PER) and past it
def _edges(resident):
    limit = resident * fk.THREADS * fk.ON_CHIP_PER
    return [(resident, n) for n in (1, 255, 256, 257, fk.THREADS * 16,
                                    fk.THREADS * 16 + 1, limit - 1, limit,
                                    limit + 1, 10**6)]


@pytest.mark.parametrize("resident,n", _edges(fk.MAX_BLOCKS) + _edges(132))
def test_fit_grid_edges(resident, n):
    """fit_grid covers n (blocks * per * 256 >= n) with no empty block
    and at most `resident` blocks, at the fewest loci a thread that
    allows; its regime: a cluster up to CLUSTER_MAX blocks, the loci on
    chip up to ON_CHIP_PER a thread (n up to the limit), else global."""
    blocks, per, regime = fk.fit_grid(n, resident)
    t = fk.THREADS
    assert blocks * per * t >= n > (blocks - 1) * per * t
    assert blocks <= resident
    assert per == max(1, -(-n // (t * resident)))
    limit = resident * t * fk.ON_CHIP_PER
    want = ("global" if n > limit else
            "cluster" if blocks <= fk.CLUSTER_MAX else "grid")
    assert regime == want
    if n <= t * fk.CLUSTER_MAX:
        assert (blocks, per, regime) == (-(-n // t), 1, "cluster")


def synthetic_both(seed, n, ref_max):
    """(jax counts, torch counts) of fit_kernels.synthetic_counts' seeded
    loci, deduplicated by both packages."""
    rng = np.random.default_rng(seed)
    ref = rng.integers(0, ref_max, n)
    alt = rng.poisson(rng.choice([0.3, 2.0, 6.0], (n, 1)), (n, 6))
    return jef.dedupe_counts(ref, alt), tef.dedupe_counts(ref, alt)


@pytest.mark.parametrize("n,ref_max,resident", [(1500, 60, 1),
                                                (1500, 60, 2),
                                                (3000, 100, 2)])
def test_fit_model_on_fit_grid_matches_jax(n, ref_max, resident):
    """A 600-step fit through fit_model on fit_grid(N, resident) for a
    card of one or two resident blocks (several loci a thread, on chip
    and past it: the orders of large contexts on the H100) on 1,423 and
    2,830 seeded patterns against the JAX package's fit_context, within
    RATE_RTOL (test_model_fit_matches_jax's sharp bound: these optima are
    sharp); the state holds the best step and the last."""
    jc, tc = synthetic_both(5, n, ref_max)
    lt = float(np.log(0.001))
    want = jef.fit_context(jc, lt)
    loc = tef.fit_prep_plain(*host(tc), lt)
    grid = fk.fit_grid(loc.shape[1], resident)
    assert grid[1] > 1
    p0 = torch.tensor([np.log(1e-3), np.log(1e-3), np.log(0.5)],
                      dtype=torch.float64)
    best_v, p, losses, state = fk.fit_model(loc, p0, consts(lt), 600,
                                            grid[:2])
    assert float(state[fk.BEST_V]) == best_v == float(losses.min())
    assert torch.equal(state[fk.BEST_PARAMS], p)
    assert float(state[fk.V]) == float(losses[-1])
    li = float(tef._rate_smoother(p[0], tef.MAX_LOG_RATE))
    ld = float(tef._rate_smoother(p[1], tef.MAX_LOG_RATE))
    ln = float(tef._rate_smoother(p[2], tef.MAX_LOG_LOCUS_RATE))
    got = dict(log_error_rate=(li + ld) / 2.0, log_noisy_locus_rate=ln,
               log_insert_rate=li, log_delete_rate=ld)
    for f in RATES:
        assert got[f] == pytest.approx(getattr(want, f), rel=RATE_RTOL,
                                       abs=0), f


@pytest.mark.parametrize("n,resident,regime", [
    (300, fk.MAX_BLOCKS, "cluster"), (5000, fk.MAX_BLOCKS, "grid"),
    (1300, 1, "global")])
def test_fit_run_operands_by_regime(monkeypatch, n, resident, regime):
    """FitRun's host side, on CPU tensors with the card's parts stubbed:
    the grid from fit_grid(N, resident_blocks), the start parameters and
    zero moments, the bias table of Python's ** and the barrier's zero
    counters in one buffer, the partials past the cluster regime and loc
    in the global regime; each launch passes them to the C entry in its
    argument order (the cluster flag by the regime); it holds the
    observations, and reset() puts the start back."""
    monkeypatch.setattr(fk, "resident_blocks", lambda dev: resident)
    launched = []
    monkeypatch.setattr(fk, "_launch",
                        lambda name, dev, args: launched.append((name, args)))
    tc = fk.synthetic_counts(4, 3 * n, 200)
    ref, alt, inst = (x[:n].contiguous() for x in host(tc))
    c = consts()
    p0 = torch.tensor([-5.0, -6.0, -1.0], dtype=torch.float64)
    run = fk.error_fit_run(ref, alt, inst, p0, c, 7)
    blocks, per, got = run.grid
    assert (got, run.grid) == (regime, fk.fit_grid(n, resident))
    assert torch.equal(run.state[fk.PARAMS], p0)
    assert not run.state[3:].any()
    b1, b2 = c[fk.CONSTS.index("b1")], c[fk.CONSTS.index("b2")]
    bias = run._io[fk.STATE:fk.STATE + 14].view(7, 2)
    assert bias.tolist() == [[1 - b1 ** t, 1 - b2 ** t] for t in range(1, 8)]
    assert run._io[-1].item() == 0.0
    assert (run.partials is None) == (regime == "cluster")
    if run.partials is not None:
        assert run.partials.shape == (2, blocks, fk.SUMS)
    assert (run.loc is None) == (regime != "global")
    if run.loc is not None:
        assert run.loc.shape == (len(fk.ROWS), n)
    run.launch()
    assert [name for name, _ in launched] == ["error_fit_run"] * 2
    args = launched[0][1]
    assert args[:8] == [ref.data_ptr(), alt.data_ptr(), inst.data_ptr(), n,
                        blocks, per, 7, int(regime == "cluster")]
    assert list(args[8]) == [float(x) for x in c]
    assert all(a is b for a, b in zip(run._obs, (ref, alt, inst)))
    start = run._io.clone()
    run._io.normal_()
    run.reset()
    assert torch.equal(run._io, start)
    assert args[9:] == [bias.data_ptr(), run.state.data_ptr(),
                        None if run.loc is None else run.loc.data_ptr(),
                        None if run.partials is None
                        else run.partials.data_ptr(),
                        run._io[-1:].data_ptr()]
