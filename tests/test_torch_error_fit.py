"""The port's indel error-model fit (strelka_tpu_torch/models/error_fit.py)
against the JAX package's on the CPU, on counts simulated from a numpy
seed (a copy of tests/test_error_fit.py's generator).

Bounds, from measurement (this CPU, jax 0.9.0, torch 2.13):
- the smoother's triggers: bit for bit with jnp.log(1e-3), jnp.log(0.8);
- the loss: within LOSS_RTOL (measured 2e-16); its gradient within
  GRAD_RTOL of the gradient's largest component (measured 2e-14: the
  sums over loci run in torch's order, not XLA's);
- fitted log-rates after 600 Adam steps: within RATE_RTOL (measured
  1e-14; the Adam step itself is bit for bit, tests/test_torch_special.py)
  where the optimum is sharp;
- where it is flat (a context with few indel observations, as the
  estimation's model has), within FLAT_RTOL (measured 1.3e-7). There
  the trajectories still agree within 1e-13 for all 600 steps, but the
  fit keeps the step of least loss, and the last ~50 steps' losses tie
  within 1e-13 relative, so an ulp picks another step. The JAX package
  is not stable at that level itself: the same JAX loop that also
  returns its gradient picks another step than fit_context. So the
  flat case also checks the optimum: the JAX loss at the port's fitted
  rates is within LOSS_AT_FIT_RTOL of the JAX loss at its own.
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

LOSS_RTOL = 1e-14
GRAD_RTOL = 1e-12
RATE_RTOL = 1e-10
FLAT_RTOL = 1e-6
LOSS_AT_FIT_RTOL = 1e-12
RATES = ("log_error_rate", "log_noisy_locus_rate", "log_insert_rate",
         "log_delete_rate")


def simulate_context(rng, n_loci, depth, error_rate, noisy_rate,
                     theta=0.001):
    """(ref, alt[6]) observations under the model-3 generative process:
    noisy loci get indel errors at error_rate, clean at 1e-8; a small
    fraction of loci carry true het/hom indels at theta."""
    ref = np.zeros(n_loci, np.int64)
    alt = np.zeros((n_loci, 6), np.int64)
    for i in range(n_loci):
        d = depth
        r = rng.random()
        if r < theta / 2:      # hom indel
            alt[i, 0] = rng.binomial(d, 0.99)
            ref[i] = d - alt[i, 0]
        elif r < theta * 1.5:  # het indel
            alt[i, 0] = rng.binomial(d, 0.5)
            ref[i] = d - alt[i, 0]
        else:
            is_noisy = rng.random() < noisy_rate
            e = error_rate if is_noisy else 1e-8
            n_ins = rng.binomial(d, e)
            n_del = rng.binomial(d, e)
            alt[i, 0] = n_ins
            alt[i, 3] = n_del
            ref[i] = d - n_ins - n_del
    return ref, alt


def both_counts(rng, *args, **kw):
    ref, alt = simulate_context(rng, *args, **kw)
    return jef.dedupe_counts(ref, alt), tef.dedupe_counts(ref, alt)


def test_smoother_triggers_bit_identical():
    assert tef.LOG_RATE_TRIGGER == float(jnp.log(1e-3))
    assert tef.LOG_LOCUS_TRIGGER == float(jnp.log(0.8))
    assert tef.LOG_RATE_TRIGGER == float(jax.jit(lambda: jnp.log(1e-3))())
    assert tef.LOG_LOCUS_TRIGGER == float(jax.jit(lambda: jnp.log(0.8))())


def test_dedupe_counts_equal():
    rng = np.random.default_rng(5)
    jc, tc = both_counts(rng, 800, 30, 1e-2, 0.5)
    for f in ("ref_obs", "alt_obs", "instance_count"):
        np.testing.assert_array_equal(getattr(tc, f), getattr(jc, f))
    assert tc.total_instances == jc.total_instances == 800


@pytest.mark.parametrize("point", [
    (math.log(1e-3), math.log(1e-3), math.log(0.5)),   # the fit's start
    (-4.0, -5.0, -1.2),
    (-2.0, -9.0, -0.05),           # past the rate trigger, near the cap
    (-8.0, -3.0, 0.4),             # the locus rate folded back
])
def test_lhood_value_and_grad_match_jax(point):
    rng = np.random.default_rng(6)
    jc, tc = both_counts(rng, 1500, 40, 2e-2, 0.3, theta=0.01)
    lt = float(np.log(0.002))
    r, a, n = (np.asarray(x, np.float64) for x in
               (jc.ref_obs, jc.alt_obs, jc.instance_count))

    def jloss(p):
        li = jef._rate_smoother(p[0], jef.MAX_LOG_RATE)
        ld = jef._rate_smoother(p[1], jef.MAX_LOG_RATE)
        ln = jef._rate_smoother(p[2], jef.MAX_LOG_LOCUS_RATE)
        return -jef.context_log_lhood(li, ld, ln, jnp.float64(lt),
                                      jnp.asarray(r), jnp.asarray(a),
                                      jnp.asarray(n))
    jv, jg = jax.jit(jax.value_and_grad(jloss))(jnp.asarray(point))

    x = torch.tensor(point, dtype=torch.float64, requires_grad=True)
    li = tef._rate_smoother(x[0], tef.MAX_LOG_RATE)
    ld = tef._rate_smoother(x[1], tef.MAX_LOG_RATE)
    ln = tef._rate_smoother(x[2], tef.MAX_LOG_LOCUS_RATE)
    tv = -tef.context_log_lhood(li, ld, ln, lt, torch.tensor(r),
                                torch.tensor(a), torch.tensor(n))
    tg, = torch.autograd.grad(tv, x)
    assert float(tv.detach()) == pytest.approx(float(jv), rel=LOSS_RTOL,
                                               abs=0)
    jg = np.asarray(jg)
    np.testing.assert_allclose(tg.numpy(), jg, rtol=0,
                               atol=GRAD_RTOL * np.abs(jg).max())


@pytest.mark.parametrize("case", [
    dict(seed=0, n=2000, depth=30, rate=5e-3, noisy=1.0, theta=0.001,
         log_theta=np.log(0.001)),
    dict(seed=1, n=2500, depth=40, rate=2e-2, noisy=0.3, theta=0.001,
         log_theta=np.log(0.002)),
])
def test_fit_context_matches_jax(case):
    rng = np.random.default_rng(case["seed"])
    jc, tc = both_counts(rng, case["n"], case["depth"], case["rate"],
                         case["noisy"], theta=case["theta"])
    want = jef.fit_context(jc, float(case["log_theta"]))
    got = tef.fit_context(tc, float(case["log_theta"]), device="cpu")
    assert got.acceptable == want.acceptable
    assert got.n_instances == want.n_instances
    for f in RATES:
        assert getattr(got, f) == pytest.approx(getattr(want, f),
                                                rel=RATE_RTOL, abs=0), f


def test_fit_context_empty_and_steps_counted():
    before = dict(tef.FIT_STATS)
    got = tef.fit_context(tef.ContextCounts(), -3.0, device="cpu")
    want = jef.fit_context(jef.ContextCounts(), -3.0)
    assert (got.acceptable, got.n_instances) == (want.acceptable,
                                                 want.n_instances) == (False, 0)
    assert all(getattr(got, f) == -np.inf for f in RATES)
    rng = np.random.default_rng(7)
    _, tc = both_counts(rng, 200, 20, 1e-2, 1.0)
    tef.fit_context(tc, -6.0, n_steps=25, device="cpu")
    assert tef.FIT_STATS["fits"] == before["fits"] + 1
    assert tef.FIT_STATS["steps"] == before["steps"] + 25


def test_estimate_indel_error_model_matches_jax():
    """The model dict: the same keys, motif order, isStatic and
    acceptable flag, rates within RATE_RTOL. Contexts with too few
    instances fall back to the static model in both packages: the
    non-STR one clears the acceptable flag, an STR one does not (its
    flag is taken before the fallback)."""
    rng = np.random.default_rng(2)
    jctx, tctx = {}, {}
    for key, rate, n in [((1, 1), 1e-4, 60), ((1, 2), 5e-4, 600),
                         ((1, 16), 2e-2, 600), ((2, 2), 1e-3, 600),
                         ((2, 9), 1e-2, 60)]:
        jctx[key], tctx[key] = both_counts(rng, n, 30, rate, 1.0)
    want, wok = jef.estimate_indel_error_model(jctx)
    got, gok = tef.estimate_indel_error_model(tctx, device="cpu")
    assert gok == wok is False
    assert list(got) == list(want) == ["sample"]
    (gs,), (ws,) = got["sample"], want["sample"]
    assert list(gs) == list(ws)
    assert gs["sampleName"] == ws["sampleName"]
    assert gs["isStatic"] is ws["isStatic"] is False
    assert len(gs["motif"]) == len(ws["motif"]) == 1 + 15 + 1 + 8
    for gm, wm in zip(gs["motif"], ws["motif"]):
        assert list(gm) == list(wm)
        assert (gm["repeatPatternSize"], gm["repeatCount"]) == \
            (wm["repeatPatternSize"], wm["repeatCount"])
        for f in ("indelRate", "noisyLocusRate"):
            assert gm[f] == pytest.approx(wm[f], rel=FLAT_RTOL, abs=0), f


def test_flat_optimum_same_loss():
    """A context with few indel observations (rate 5e-4 at 30x): the
    fitted rates agree within FLAT_RTOL, and the JAX package's loss at
    the port's rates equals its loss at its own within
    LOSS_AT_FIT_RTOL."""
    rng = np.random.default_rng(2)
    both_counts(rng, 60, 30, 1e-4, 1.0)        # the stream of the test above
    jc, tc = both_counts(rng, 600, 30, 5e-4, 1.0)
    lt = float(np.log(HPOL_THETA[LOW_REPEAT_COUNT - 1]))
    want = jef.fit_context(jc, lt)
    got = tef.fit_context(tc, lt, device="cpu")
    for f in RATES:
        assert getattr(got, f) == pytest.approx(getattr(want, f),
                                                rel=FLAT_RTOL, abs=0), f
    args = [jnp.asarray(np.asarray(x, np.float64)) for x in
            (jc.ref_obs, jc.alt_obs, jc.instance_count)]

    def loss(fit):
        return -float(jef.context_log_lhood(
            fit.log_insert_rate, fit.log_delete_rate,
            fit.log_noisy_locus_rate, jnp.float64(lt), *args))
    assert loss(got) == pytest.approx(loss(want), rel=LOSS_AT_FIT_RTOL,
                                      abs=0)
