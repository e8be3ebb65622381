"""The port's error-model zoo (strelka_tpu_torch/models/error_zoo.py)
against the JAX package's on the CPU: the seven likelihoods (value and
gradient, theta locked and free), every fit at reduced steps and one at
full steps, and indel_model1_report. Counts come from numpy seeds.

Bounds, from measurement (this CPU, jax 0.9.0, torch 2.13):
- likelihood values within LOSS_RTOL (measured 8.2e-16) and gradients
  within GRAD_RTOL of their largest component (measured 1.2e-13):
  torch's sums over patterns against XLA's, torch's exp/log/lgamma
  against XLA's;
- fitted values (these fits keep their last step, so no best-step pick
  is involved) within FIT_RTOL (measured 2.8e-15; the Adam step is bit
  for bit, tests/test_torch_special.py);
- indel_model1_report: equal (host numpy and scipy in both).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import strelka_tpu  # noqa: F401  (enables x64)
from strelka_tpu.models import error_zoo as jez
from strelka_tpu.models.error_fit import ContextCounts as JCounts
from strelka_tpu_torch.models import error_zoo as tez
from strelka_tpu_torch.models.error_fit import ContextCounts as TCounts

LOSS_RTOL = 1e-14
GRAD_RTOL = 1e-11
FIT_RTOL = 1e-10


def counts(seed, n=60):
    """Indel patterns: reference depth 5-60, Poisson alt noise in every
    signal slot, a few variant-like patterns, multiplicities 1-50."""
    rng = np.random.default_rng(seed)
    ref = rng.integers(5, 60, n)
    alt = rng.poisson(0.6, (n, 6))
    alt[:6, rng.integers(0, 6, 6)] += ref[:6] // 2
    alt[6:9] = 0                                  # patterns with no alt
    alt[9, :] = 3                                 # a six-way tie
    inst = rng.integers(1, 50, n)
    arrays = dict(ref_obs=ref.astype(np.int64), alt_obs=alt.astype(np.int64),
                  instance_count=inst.astype(np.int64))
    return JCounts(**arrays), TCounts(**arrays)


def snv_patterns(seed, n=80, q=(12, 20, 30, 38)):
    rng = np.random.default_rng(seed)
    Q = len(q)
    ref_count = rng.integers(10, 80, n).astype(np.float64)
    alt = rng.poisson(0.3, (n, Q)).astype(np.float64)
    alt[:5, -1] += ref_count[:5] // 2
    hist = rng.integers(1000, 100000, Q).astype(np.float64)
    inst = rng.integers(1, 40, n).astype(np.float64)
    levels = np.asarray(q, np.int64)
    jp = jez.SnvPatterns(levels, jnp.asarray(hist), jnp.asarray(ref_count),
                         jnp.asarray(alt), jnp.asarray(inst))
    tp = tez.SnvPatterns(levels, torch.tensor(hist), torch.tensor(ref_count),
                         torch.tensor(alt), torch.tensor(inst))
    return jp, tp


def check_value_grad(jf, tf, x):
    """jf(x) (jnp) and tf(x) (torch): value within LOSS_RTOL, gradient
    within GRAD_RTOL of its largest component."""
    jv, jg = jax.jit(jax.value_and_grad(jf))(jnp.asarray(x))
    xt = torch.tensor(x, dtype=torch.float64, requires_grad=True)
    tv = tf(xt)
    tg, = torch.autograd.grad(tv, xt)
    assert float(tv.detach()) == pytest.approx(float(jv), rel=LOSS_RTOL,
                                               abs=0)
    jg = np.asarray(jg)
    np.testing.assert_allclose(tg.numpy(), jg, rtol=0,
                               atol=GRAD_RTOL * np.abs(jg).max())


LT = jez.DEFAULT_LOG_THETA


def _theta(mod, x, i, free):
    return mod._ln_bounded(x[i], 0.3) if free else LT


@pytest.mark.parametrize("free", [False, True])
def test_indel_lhoods_match_jax(free):
    """The five indel likelihoods at two points each: indy, binomial
    mixture, beta-binomial (insert and delete), and the two NoOverlap
    variants (insert and delete)."""
    jc, tc = counts(3)
    jp, tp = jez.IndelPatterns.build(jc), tez.IndelPatterns.build(tc, "cpu")
    for x in ([-8.0, -7.0, -1.0, -8.5], [-3.0, -9.0, 1.5, -5.0]):
        check_value_grad(
            lambda x: jez.indel_indy_lhood(jp, jez._ln_bounded(x[0], 0.5),
                                           jez._ln_bounded(x[1], 0.5),
                                           _theta(jez, x, 3, free)),
            lambda x: tez.indel_indy_lhood(tp, tez._ln_bounded(x[0], 0.5),
                                           tez._ln_bounded(x[1], 0.5),
                                           _theta(tez, x, 3, free)), x)
        check_value_grad(
            lambda x: jez.indel_binom_mixture_lhood(
                jp, jez._ln_bounded(x[0], 0.5), jez._ln_bounded(x[1], 0.5),
                jez._ln_bounded(x[2], 1.0), _theta(jez, x, 3, free)),
            lambda x: tez.indel_binom_mixture_lhood(
                tp, tez._ln_bounded(x[0], 0.5), tez._ln_bounded(x[1], 0.5),
                tez._ln_bounded(x[2], 1.0), _theta(tez, x, 3, free)), x)
        for ins in (True, False):
            check_value_grad(
                lambda x: jez.indel_beta_binom_lhood(
                    jp, jez._ln_bounded(x[0], 0.5),
                    jez._ln_bounded(x[2] + 5.0, jez.MAX_CONCENTRATION), ins,
                    _theta(jez, x, 3, free)),
                lambda x: tez.indel_beta_binom_lhood(
                    tp, tez._ln_bounded(x[0], 0.5),
                    tez._ln_bounded(x[2] + 5.0, tez.MAX_CONCENTRATION), ins,
                    _theta(tez, x, 3, free)), x)
            check_value_grad(
                lambda x: jez.indel_indy_noovl_lhood(
                    jp, jez._ln_bounded(x[0], 0.5), ins,
                    _theta(jez, x, 3, free)),
                lambda x: tez.indel_indy_noovl_lhood(
                    tp, tez._ln_bounded(x[0], 0.5), ins,
                    _theta(tez, x, 3, free)), x)
            check_value_grad(
                lambda x: jez.indel_binom_mixture_noovl_lhood(
                    jp, jez._ln_bounded(x[1], 0.5),
                    jez._ln_bounded(x[2], 1.0), ins,
                    _theta(jez, x, 3, free)),
                lambda x: tez.indel_binom_mixture_noovl_lhood(
                    tp, tez._ln_bounded(x[1], 0.5),
                    tez._ln_bounded(x[2], 1.0), ins,
                    _theta(tez, x, 3, free)), x)


@pytest.mark.parametrize("free", [False, True])
def test_snv_lhoods_match_jax(free):
    """snv_indy_lhood and snv_binom_mixture_lhood, per-qual rates."""
    jsp, tsp = snv_patterns(4)
    Q = len(jsp.qual_levels)
    x = np.concatenate([np.linspace(-7, -4, Q), [0.3, 1.0, -8.0]])
    check_value_grad(
        lambda x: jez.snv_indy_lhood(jsp, jez._ln_bounded(x[:Q], 0.5),
                                     _theta(jez, x, Q + 2, free)),
        lambda x: tez.snv_indy_lhood(tsp, tez._ln_bounded(x[:Q], 0.5),
                                     _theta(tez, x, Q + 2, free)), x)

    def args(mod, x):
        le = mod._ln_bounded(x[:Q], 0.5)
        factor = 1.0 + (jnp.exp(x[Q]) if mod is jez else torch.exp(x[Q]))
        return (le, le * factor, mod._ln_bounded(x[Q + 1], 1.0),
                _theta(mod, x, Q + 2, free))
    check_value_grad(lambda x: jez.snv_binom_mixture_lhood(jsp, *args(jez, x)),
                     lambda x: tez.snv_binom_mixture_lhood(tsp, *args(tez, x)),
                     x)


def assert_fit_close(got, want):
    assert list(got) == list(want)
    for k, w in want.items():
        g = got[k]
        if isinstance(w, list):
            assert len(g) == len(w), k
            if k == "qual_levels":
                assert g == w
            else:
                np.testing.assert_allclose(g, w, rtol=FIT_RTOL, atol=0,
                                           err_msg=k)
        else:
            assert g == pytest.approx(w, rel=FIT_RTOL, abs=0), k


STEPS = 40


@pytest.mark.parametrize("lock", [False, True])
@pytest.mark.parametrize("name,args", [
    ("fit_indel_indy", ()),
    ("fit_indel_binom_mixture", ()),
    ("fit_indel_beta_binomial", (True,)),
    ("fit_indel_beta_binomial", (False,)),
    ("fit_indel_indy_noovl", (True,)),
    ("fit_indel_binom_mixture_noovl", (False,)),
])
def test_indel_fits_match_jax(name, args, lock):
    jc, tc = counts(5, n=120)
    want = getattr(jez, name)(jc, *args, lock_theta=lock, steps=STEPS)
    got = getattr(tez, name)(tc, *args, lock_theta=lock, steps=STEPS,
                             device="cpu")
    assert_fit_close(got, want)


@pytest.mark.parametrize("name", ["fit_snv_indy", "fit_snv_binom_mixture"])
def test_snv_fits_match_jax(name):
    jsp, tsp = snv_patterns(6)
    want = getattr(jez, name)(jsp, steps=STEPS)
    got = getattr(tez, name)(tsp, steps=STEPS, device="cpu")
    assert_fit_close(got, want)


def test_indel_indy_fit_full_steps_matches_jax():
    jc, tc = counts(7, n=200)
    assert_fit_close(tez.fit_indel_indy(tc, device="cpu"),
                     jez.fit_indel_indy(jc))


@pytest.mark.parametrize("ins", [True, False])
def test_indel_model1_report_equal(ins):
    jc, tc = counts(8, n=300)
    for kw in ({}, dict(max_alt_frac=0.2, min_depth=10)):
        assert tez.indel_model1_report(tc, ins, **kw) == \
            jez.indel_model1_report(jc, ins, **kw)
    empty_j, empty_t = JCounts(), TCounts()
    assert tez.indel_model1_report(empty_t, ins) == \
        jez.indel_model1_report(empty_j, ins)


def test_max_allele_masks_equal():
    jc, _ = counts(9, n=400)
    for a, b in zip(tez._max_allele_masks(jc.alt_obs),
                    jez._max_allele_masks(jc.alt_obs)):
        np.testing.assert_array_equal(a, b)
