"""KZ's arithmetic (strelka_tpu_torch/ops/zoo_kernels.py: the torch model
of csrc/error_zoo_fit.cu) against the JAX package's zoo fits on the CPU,
on counts from tests/test_torch_error_zoo.py's seeded generator; the
grids it sums on; the binomial mixtures' pick between their two starts;
ZooRun's host operands; and the dispatch of
models/error_zoo.fit_contexts (the plain version on the CPU, KZ
elsewhere, no fallback). The kernels
themselves run on a card only: tests/test_torch_cuda.py holds them
against this model and the plain version there.

Bounds, tests/test_torch_error_zoo.py's, and the reason beside each:
- the loss within LOSS_RTOL: the per-locus values are the plain
  version's, only the order of the sums over loci differs (XLA's, the
  kernel's grid_sum);
- the gradient within GRAD_RTOL of its largest component: the closed
  form adds each component's terms in another order than autodiff does,
  and KZ-B's digamma (ATen's algorithm, each product and sum rounded on
  its own) is not XLA's;
- fitted values within FIT_RTOL: the zoo keeps its last step (no
  best-step pick), so a fit moves with its inputs continuously and the
  sums' order moves its fields by a few ulps a step. No field of these
  fits needs a flat bound (measured under 1e-14 here, and on the card
  against the CPU in tests/test_torch_cuda.py and chip_smoke.py phase
  15c, which hold every field within FIT_RTOL).
"""
import contextlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import strelka_tpu  # noqa: F401  (enables x64)
from strelka_tpu.models import error_zoo as jez
from strelka_tpu_torch.models import error_zoo as tez
from strelka_tpu_torch.ops import fit_kernels as fk
from strelka_tpu_torch.ops import zoo_kernels as zk
from tests.test_torch_error_zoo import (FIT_RTOL, GRAD_RTOL, LOSS_RTOL,
                                        counts)

EPS = np.finfo(np.float64).eps
STEPS = 40

# the tool's fitted model names: (fit function, its positional args, the
# kernel's family)
FITS = {
    "indelIndy": ("fit_indel_indy", (), "indy"),
    "indelBinomialMixture": ("fit_indel_binom_mixture", (),
                             "binom_mixture"),
    "indelBetaBinomialInsert": ("fit_indel_beta_binomial", (True,),
                                "beta_binomial"),
    "indelBetaBinomialDelete": ("fit_indel_beta_binomial", (False,),
                                "beta_binomial"),
    "indelIndyNoOverlapInsert": ("fit_indel_indy_noovl", (True,),
                                 "indy_noovl"),
    "indelIndyNoOverlapDelete": ("fit_indel_indy_noovl", (False,),
                                 "indy_noovl"),
    "indelBinomialMixtureNoOverlapInsert": (
        "fit_indel_binom_mixture_noovl", (True,), "binom_mixture_noovl"),
    "indelBinomialMixtureNoOverlapDelete": (
        "fit_indel_binom_mixture_noovl", (False,), "binom_mixture_noovl"),
}

def obs_of(p):
    return (p.ref_obs, p.alt_obs, p.inst, p.max1, p.max2)


def model_fit(monkeypatch, name, tc, lock, steps):
    """The port's fit `name` on the CPU with the kernel's route of
    _fit_starts taken by zoo_fit_model (the family, flags and starts that
    each fit hands the kernel), its result dict."""
    fn, args, _ = FITS[name]

    def through_model(family, counts_list, n, lock_theta, is_insert, dev,
                      plain):
        c = tez.kernel_consts(family, lock_theta)
        at = zk.state_slots(zk.FAMILIES[family])
        out = []
        for cc in counts_list:
            obs = obs_of(tez.IndelPatterns.build(cc, "cpu"))
            ends = []
            for x0 in tez.fit_starts(family):
                st, _ = zk.zoo_fit_model(family, obs, x0, c, n, lock_theta,
                                         is_insert)
                ends.append((st[at["params"]].numpy(),
                             float(st[at["final"]])))
            out.append(ends)
        return out
    monkeypatch.setattr(tez, "_fit_starts", through_model)
    return getattr(tez, fn)(tc, *args, lock_theta=lock, steps=steps,
                            device="cpu")


def assert_close(got, want):
    assert list(got) == list(want)
    for k, w in want.items():
        assert got[k] == pytest.approx(w, rel=FIT_RTOL, abs=0), k


@pytest.mark.parametrize("lock", [False, True])
@pytest.mark.parametrize("name", list(FITS))
def test_model_fits_match_jax(monkeypatch, name, lock):
    """Each of the tool's fitted model names through zoo_fit_model,
    theta locked and free, at reduced steps, against the JAX package's
    fit: every field within FIT_RTOL, the log likelihood too."""
    jc, tc = counts(5, n=120)
    fn, args, _ = FITS[name]
    want = getattr(jez, fn)(jc, *args, lock_theta=lock, steps=STEPS)
    assert_close(model_fit(monkeypatch, name, tc, lock, STEPS), want)


def test_model_indel_indy_full_steps_matches_jax(monkeypatch):
    jc, tc = counts(7, n=200)
    assert_close(model_fit(monkeypatch, "indelIndy", tc, False, 600),
                 jez.fit_indel_indy(jc))


# points in x (the unconstrained parameters) per family: the fits' start,
# and points past the limits' middle and far out on both sides
POINTS = {
    "indy": [(-8.5, -8.5, -8.0), (-3.0, -9.0, -5.0), (2.0, -12.0, 1.0)],
    "binom_mixture": [(-8.5, -8.5, 2.2, -8.0), (-3.0, -9.0, -4.6, -5.0),
                      (-6.0, -5.0, 0.0, 1.0)],
    "beta_binomial": [(-8.5, -2.9, -8.0), (-3.0, 1.5, -5.0),
                      (-6.0, -9.0, 0.5)],
    "indy_noovl": [(-8.5, -8.0), (-2.0, -4.0), (3.0, 1.0)],
    "binom_mixture_noovl": [(-8.5, 2.2, -8.0), (-3.0, -4.6, -5.0),
                            (-6.0, 0.0, 1.0)],
}


def jax_loss(name, jc, lock):
    """The JAX package's loss of fit `name` at x: its _fit's loss_fn."""
    fn, args, _ = FITS[name]
    p = jez.IndelPatterns.build(jc)
    lb, lt = jez._ln_bounded, jez.DEFAULT_LOG_THETA

    def theta(x, i):
        return lt if lock else lb(x[i], 0.3)
    if fn == "fit_indel_indy":
        return lambda x: -jez.indel_indy_lhood(p, lb(x[0], .5), lb(x[1], .5),
                                               theta(x, 2))
    if fn == "fit_indel_binom_mixture":
        return lambda x: -jez.indel_binom_mixture_lhood(
            p, lb(x[0], .5), lb(x[1], .5), lb(x[2], 1.0), theta(x, 3))
    if fn == "fit_indel_beta_binomial":
        return lambda x: -jez.indel_beta_binom_lhood(
            p, lb(x[0], .5), lb(x[1], jez.MAX_CONCENTRATION), args[0],
            theta(x, 2))
    if fn == "fit_indel_indy_noovl":
        return lambda x: -jez.indel_indy_noovl_lhood(p, lb(x[0], .5),
                                                     args[0], theta(x, 1))
    return lambda x: -jez.indel_binom_mixture_noovl_lhood(
        p, lb(x[0], .5), lb(x[1], 1.0), args[0], theta(x, 2))


@pytest.mark.parametrize("lock", [False, True])
@pytest.mark.parametrize("name", ["indelIndy", "indelBinomialMixture",
                                  "indelBetaBinomialInsert",
                                  "indelIndyNoOverlapDelete",
                                  "indelBinomialMixtureNoOverlapInsert"])
def test_model_value_and_grad_match_jax(name, lock):
    """One step of zoo_fit_model: its loss (the state's v) within
    LOSS_RTOL and its closed-form gradient (the state's grad; 0 on a
    locked theta) within GRAD_RTOL of the largest component of JAX's
    value_and_grad, at each of the family's POINTS."""
    jc, tc = counts(3)
    family = FITS[name][2]
    _, args, _ = FITS[name]
    is_insert = args[0] if args else True
    obs = obs_of(tez.IndelPatterns.build(tc, "cpu"))
    vg = jax.jit(jax.value_and_grad(jax_loss(name, jc, lock)))
    at = zk.state_slots(zk.FAMILIES[family])
    for x in POINTS[family]:
        st, _ = zk.zoo_fit_model(family, obs, x,
                                 tez.kernel_consts(family, lock), 1, lock,
                                 is_insert)
        jv, jg = vg(jnp.asarray(x, jnp.float64))
        jg = np.asarray(jg)
        assert float(st[at["v"]]) == pytest.approx(float(jv), rel=LOSS_RTOL,
                                                   abs=0), x
        np.testing.assert_allclose(st[at["grad"]].numpy(), jg, rtol=0,
                                   atol=GRAD_RTOL * np.abs(jg).max(),
                                   err_msg=str(x))


def test_digamma_and_betaln_grad_against_torch_autograd():
    """zoo_kernels.digamma within a few ulps of torch.digamma (the same
    algorithm; torch's kernel may contract its series into FMAs), and
    betaln_grad's value bit for bit with special.betaln's and its partial
    derivatives within 1e-13 relative of autograd's through it, on both
    branches (max below and past 8) and on ties."""
    from strelka_tpu_torch.utils import special as sp
    rng = np.random.default_rng(0)
    x = torch.from_numpy(np.concatenate([
        np.exp(rng.uniform(-12, 8, 2000)), [1e-300, 0.5, 1.0, 9.0, 10.0,
                                            10.5, 1e17, 3e17]]))
    ours, theirs = zk.digamma(x), torch.digamma(x)
    assert torch.all((ours - theirs).abs() <= 8 * EPS * theirs.abs())
    assert zk.digamma(torch.tensor([0.0])).item() == -math.inf
    assert math.isnan(zk.digamma(torch.tensor([-1.5])).item())
    a = torch.from_numpy(np.concatenate([np.exp(rng.uniform(-9, 6, 500)),
                                         [3.0, 9.5, 0.01]]))
    b = torch.from_numpy(np.concatenate([np.exp(rng.uniform(-9, 6, 500)),
                                         [3.0, 9.5, 40.0]]))
    a.requires_grad_(True)
    b.requires_grad_(True)
    want = sp.betaln(a, b)
    ga, gb = torch.autograd.grad(want.sum(), (a, b))
    val, da, db = zk.betaln_grad(a.detach(), b.detach())
    assert torch.equal(val.view(torch.int64), want.detach().view(torch.int64))
    assert bool(((a > 8) | (b > 8)).any() and ((a < 8) & (b < 8)).any())
    for got, w in ((da, ga), (db, gb)):
        assert torch.all((got - w).abs() <= 1e-13 * w.abs() + 1e-15)


@pytest.mark.parametrize("family", list(zk.FAMILIES))
def test_model_sum_order_on_several_grids(family):
    """zoo_fit_model's one step over the same loci summed on three grids
    (blocks, loci a thread): fit_grid's (5 blocks, one locus a thread, a
    cluster), two blocks of three loci a thread (the order of a card that
    keeps few blocks resident) and one block of five (past the 4-state
    families' on-chip loci a thread: the global regime's order): each
    loss and gradient within a sum's rounding bound (2 eps N sum|terms|)
    of the others."""
    _, tc = counts(11, n=1200)
    obs = obs_of(tez.IndelPatterns.build(tc, "cpu"))
    f = zk.FAMILIES[family]
    n = len(tc.ref_obs)
    grids = {"fit_grid": fk.fit_grid(n, fk.MAX_BLOCKS, f.on_chip_per)[:2],
             "two": (2, -(-n // (2 * fk.THREADS))),
             "one": (1, -(-n // fk.THREADS))}
    assert grids["fit_grid"] == (-(-n // fk.THREADS), 1)
    assert grids["two"][1] == 3 and grids["one"][1] == 5
    at = zk.state_slots(f)
    x = [-3.0, -5.0, 0.5, -4.0][:f.params]
    c = tez.kernel_consts(family, False)
    out = {k: zk.zoo_fit_model(family, obs, x, c, 1, False, True,
                               grid=g)[0] for k, g in grids.items()}
    r = zk._scalars(f, torch.tensor(x, dtype=torch.float64), dict(
        zip(zk.CONSTS, c)), False)
    terms = zk._terms(f, zk.prep_model(family, obs, c, True), r)
    bound = 2 * EPS * n * terms.abs().sum(dim=1)
    base = out["fit_grid"]
    for k, st in out.items():
        assert abs(float(st[at["v"]] - base[at["v"]])) <= float(bound[0]), k
        # each gradient component is a few sums through the chain's
        # factors: within GRAD_RTOL of the largest, or the bound's scale
        g, g0 = st[at["grad"]], base[at["grad"]]
        tol = max(GRAD_RTOL * float(g0.abs().max()),
                  float(bound[1:].max()) * 10)
        assert float((g - g0).abs().max()) <= tol, k


@pytest.mark.parametrize("family", list(zk.FAMILIES))
@pytest.mark.parametrize("resident", [fk.MAX_BLOCKS, 132, 1])
def test_family_grids_at_their_edges(family, resident):
    """fit_grid with each family's on-chip loci a thread: covers n with
    no empty block and at most `resident` blocks; a cluster up to
    CLUSTER_MAX blocks, the loci on chip up to on_chip_per a thread,
    global past it."""
    f = zk.FAMILIES[family]
    t = fk.THREADS
    limit = resident * t * f.on_chip_per
    for n in (1, 255, 257, t * fk.CLUSTER_MAX, t * fk.CLUSTER_MAX + 1,
              limit, limit + 1, 107_434):
        blocks, per, regime = fk.fit_grid(n, resident, f.on_chip_per)
        assert blocks * per * t >= n > (blocks - 1) * per * t
        assert blocks <= resident
        want = ("global" if n > limit else
                "cluster" if blocks <= fk.CLUSTER_MAX else "grid")
        assert regime == want, n


def test_family_layouts():
    """FAMILIES' layouts: the kernel holds each family's rows on chip in
    96 KB a block (two blocks an SM), its sums fit a warp, and the state
    holds the parameters, Adam's moments, the last loss and gradient and
    the final loss."""
    for name, f in zk.FAMILIES.items():
        assert f.on_chip_per == (96 * 1024) // (f.rows * 8 * fk.THREADS)
        assert f.on_chip_per >= 3 and f.sums <= 32
        at = zk.state_slots(f)
        assert at["final"] == f.state - 1
        assert len(tez._LIMITS[name]) == f.params


@pytest.mark.parametrize("fn,noisy_slot", [
    ("fit_indel_binom_mixture", 2), ("fit_indel_binom_mixture_noovl", 1)])
@pytest.mark.parametrize("finals,pick", [((5.0, 4.0), 1), ((4.0, 5.0), 0),
                                         ((4.0, 4.0), 0)])
def test_binomial_mixtures_pick_the_lower_final_loss(monkeypatch, fn,
                                                     noisy_slot, finals,
                                                     pick):
    """The binomial mixtures run two starts (noisy 0.9, then 1e-2) and
    keep the start of lower final loss, the first on a tie."""
    _, tc = counts(5)
    starts = []

    def fake(family, counts_list, steps, lock_theta, is_insert, dev, plain):
        x0s = tez.fit_starts(family)
        starts.extend(np.array(x) for x in x0s)
        return [[(np.array(x) + k + 1, finals[k])
                 for k, x in enumerate(x0s)] for _ in counts_list]
    monkeypatch.setattr(tez, "_fit_starts", fake)
    args = (tc,) if fn == "fit_indel_binom_mixture" else (tc, True)
    got = getattr(tez, fn)(*args, steps=3, device="cpu")
    assert len(starts) == 2
    assert [tez._host_bounded(s[noisy_slot], 1.0) for s in starts] == \
        pytest.approx([0.9, 1e-2], rel=1e-12)
    x = starts[pick] + pick + 1
    assert got["noisy_locus_rate"] == tez._host_bounded(x[noisy_slot], 1.0)
    assert got["log_lhood"] == -finals[pick]


def test_kernel_consts_fold_what_the_plain_version_folds():
    """kernel_consts: a locked theta's priors as _priors folds them (the
    4-state families with the alt-het state's theta^2), the clean locus's
    ln ref rate as each mixture writes it, each parameter's ln limit."""
    for family in zk.FAMILIES:
        four = zk.FAMILIES[family].kernel == "KZ-4"
        c = dict(zip(zk.CONSTS, tez.kernel_consts(family, True, 0.05)))
        assert [c["prior_hom"], c["prior_het"], c["prior_noindel"],
                c["prior_althet"]] == list(tez._priors(
                    tez.DEFAULT_LOG_THETA, four))
        lc = float(np.log(tez.CLEAN_LOCUS_INDEL_RATE))
        assert c["log_clean"] == lc
        assert c["log_clean_ref"] == (
            float(np.log(1.0 - tez.CLEAN_LOCUS_INDEL_RATE)) if four
            else math.log1p(-math.exp(lc)))
        lims = [c[f"lim{i}"] for i in range(4)]
        want = [float(np.log(x)) for x in tez._LIMITS[family]]
        assert lims == want + [0.0] * (4 - len(want))
        free = dict(zip(zk.CONSTS, tez.kernel_consts(family, False)))
        assert free["prior_noindel"] == 0.0 and free["lr"] == 0.05


def test_cpu_fits_never_reach_the_kernel(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("a CPU fit reached KZ's wrapper")
    monkeypatch.setattr(zk, "ZooBatch", boom)
    monkeypatch.setattr(zk, "ZooRun", boom)
    zk.reset()
    _, tc = counts(5)
    for name, (fn, args, _) in FITS.items():
        getattr(tez, fn)(tc, *args, steps=3, device="cpu")
    assert zk.LAUNCHES == {"KZ-4": 0, "KZ-3": 0, "KZ-B": 0}
    assert zk.PLAIN_ON_CUDA == {"zoo_fit": 0}


def _no_card(monkeypatch, tmp_path):
    """Fits asked for on "cuda" get the meta device (not the CPU), and the
    kernel library cannot be built (no nvcc)."""
    monkeypatch.setattr(tez.devmod, "resolve",
                        lambda device=None: torch.device("meta"))
    monkeypatch.setattr(zk, "_BOUND", {})
    monkeypatch.setattr(zk, "_RESIDENT", {})
    from strelka_tpu_torch import _build
    monkeypatch.setattr(_build, "nvcc_path", lambda: None)
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(_build, "_LIBS", {})


@pytest.mark.parametrize("name", list(FITS))
def test_device_fit_without_a_built_kernel_raises(monkeypatch, tmp_path,
                                                  name):
    """A fit whose tensors are not on the CPU goes to KZ, and where the
    kernel cannot be built it raises: the plain version never runs in its
    place and nothing is counted."""
    calls = []
    monkeypatch.setattr(tez, "_fit_plain", lambda *a, **k: calls.append(1))
    _no_card(monkeypatch, tmp_path)
    zk.reset()
    _, tc = counts(5)
    fn, args, _ = FITS[name]
    with pytest.raises(RuntimeError, match="nvcc"):
        getattr(tez, fn)(tc, *args, steps=3, device="cuda")
    assert not calls
    assert zk.LAUNCHES == {"KZ-4": 0, "KZ-3": 0, "KZ-B": 0}


def test_plain_flag_runs_the_plain_version_off_the_cpu(monkeypatch,
                                                       tmp_path):
    """plain=True takes the plain version on any device, and never the
    kernel."""
    def boom(*a, **k):
        raise AssertionError("plain=True reached KZ's wrapper")
    seen = []
    monkeypatch.setattr(zk, "ZooBatch", boom)
    monkeypatch.setattr(tez, "_fit_plain", lambda loss_fn, x0, steps, lr,
                        dev: (seen.append(dev.type), (np.asarray(x0), 1.0))[1])
    _no_card(monkeypatch, tmp_path)
    _, tc = counts(5)
    tez.fit_indel_indy(tc, steps=3, device="cuda", plain=True)
    tez.fit_indel_binom_mixture_noovl(tc, True, steps=3, device="cuda",
                                      plain=True)
    assert seen == ["meta"] * 3


def test_zoo_run_rejects_what_the_kernel_does_not_take(monkeypatch):
    """ZooRun raises on what the kernel does not take before any build: a
    wrong dtype, shape or layout, N = 0, too few constants, n_steps < 1,
    a grid that does not cover the loci or is out of its regime."""
    def boom(*a, **k):
        raise AssertionError("a rejected call reached the build")
    monkeypatch.setattr(zk, "function", boom)
    monkeypatch.setattr(zk, "resident_blocks", lambda f, dev: 264)
    _, tc = counts(5)
    obs = obs_of(tez.IndelPatterns.build(tc, "cpu"))
    c = tez.kernel_consts("indy", False)
    x0 = [0.0, 0.0, 0.0]
    zk.reset()

    def run(o=obs, consts=c, steps=4, grid=None):
        return zk.ZooRun("indy", o, x0, consts, steps, False, grid=grid)
    ref, alt, inst, m1, m2 = obs
    with pytest.raises(ValueError, match="float64"):
        run((ref, alt.float(), inst, m1, m2))
    with pytest.raises(ValueError, match="int64"):
        run((ref, alt, inst, m1.int(), m2))
    with pytest.raises(ValueError, match="shape"):
        run((ref, alt[:, :5].contiguous(), inst, m1, m2))
    with pytest.raises(ValueError, match="shape"):
        run((ref, alt, inst, m1, m2[:-1].contiguous()))
    with pytest.raises(ValueError, match="contiguous"):
        run((ref, alt.T.contiguous().T, inst, m1, m2))
    with pytest.raises(ValueError, match="N >= 1"):
        run(tuple(o[:0] for o in obs))
    with pytest.raises(ValueError, match="constants"):
        run(consts=c[:-1])
    with pytest.raises(ValueError, match="n_steps"):
        run(steps=0)
    with pytest.raises(ValueError, match="grid"):
        run(grid=(1, 5, "cluster"))
    with pytest.raises(ValueError, match="grid"):
        run(grid=(0, 1, "cluster"))
    assert zk.LAUNCHES == {"KZ-4": 0, "KZ-3": 0, "KZ-B": 0}


@pytest.mark.parametrize("family,n,resident,regime", [
    ("binom_mixture", 300, fk.MAX_BLOCKS, "cluster"),
    ("indy_noovl", 5000, fk.MAX_BLOCKS, "cluster"),
    ("beta_binomial", 40_000, fk.MAX_BLOCKS, "grid"),
    ("indy_noovl", 40_000, 1, "global")])
def test_zoo_run_operands_by_regime(monkeypatch, family, n, resident,
                                    regime):
    """ZooRun's host side, on CPU tensors with the card's parts stubbed:
    the grid from kz_grid(N, resident_blocks, family) (a 16-block
    cluster at several loci a thread past 4,096 patterns), the start
    parameters and zero moments, the bias table of Python's ** and the
    barrier's zero counters in one buffer, the partials past the cluster
    regime and loc in the global regime; each launch passes them to its
    regime's C entry in its argument order (the cluster regime's the
    batched entry, with one work row: the kernel that a tool run
    launches), and reset() puts the start back."""
    monkeypatch.setattr(zk, "resident_blocks", lambda f, dev: resident)
    launched = []
    monkeypatch.setattr(zk, "function", lambda name: lambda *a: launched.append(
        (name, a)) or 0)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: type("S", (), {"cuda_stream": 7})())
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    tc = fk.synthetic_counts(4, 3 * n, 200)
    p = tez.IndelPatterns.build(tc, "cpu")
    obs = tuple(o[:n].contiguous() for o in obs_of(p))
    f = zk.FAMILIES[family]
    c = tez.kernel_consts(family, True)
    x0 = torch.arange(f.params, dtype=torch.float64) - 5.0
    run = zk.ZooRun(family, obs, x0, c, 7, True, False)
    blocks, per, got = run.grid
    assert (got, run.grid) == (regime, zk.kz_grid(n, resident, f))
    assert torch.equal(run.state[:f.params], x0)
    assert not run.state[f.params:].any()
    b1, b2 = c[zk.CONSTS.index("b1")], c[zk.CONSTS.index("b2")]
    bias = run._io[f.state:f.state + 14].view(7, 2)
    assert bias.tolist() == [[1 - b1 ** t, 1 - b2 ** t] for t in range(1, 8)]
    assert run._io[-1].item() == 0.0
    assert (run.partials is None) == (regime == "cluster")
    if run.partials is not None:
        assert run.partials.shape == (2, blocks, f.sums)
    assert (run.loc is None) == (regime != "global")
    if run.loc is not None:
        assert run.loc.shape == (f.rows, n)
    with pytest.raises(ValueError, match="unsupported device"):
        run.launch()
    monkeypatch.setattr(run, "dev", torch.device("cuda", 0))
    run.launch()
    entry, args = launched[0]
    assert args[:2] == (zk.KINDS[f.kernel], int(f.clean))
    assert args[2:7] == tuple(o.data_ptr() for o in obs)
    if regime == "cluster":
        assert entry == "zoo_fit_batch_launch"
        assert run.work.tolist() == [0, n, blocks, per, 0]
        assert args[7:12] == (run.work.data_ptr(), 1, blocks, per, 7)
        rest = args[15:]
        assert rest == (bias.data_ptr(), run.state.data_ptr(), 7)
    else:
        assert entry == "zoo_fit_launch"
        assert args[7:11] == (n, blocks, per, 7)
        rest = args[14:]
        assert rest == (bias.data_ptr(), run.state.data_ptr(),
                        None if run.loc is None else run.loc.data_ptr(),
                        run.partials.data_ptr(), run._io[-1:].data_ptr(), 7)
    host, flags = args[len(args) - len(rest) - 3], \
        args[len(args) - len(rest) - 2:len(args) - len(rest)]
    assert list(host) == [float(x) for x in c]
    assert flags == (1, 0)
    assert zk.LAUNCHES[f.kernel] >= 1
    start = run._io.clone()
    run._io.normal_()
    run.reset()
    assert torch.equal(run._io, start)
