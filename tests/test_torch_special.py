"""The port's copy of the JAX math the error-model fits reach
(strelka_tpu_torch/utils/special.py) against JAX on the CPU: values and
gradients of logsumexp, logaddexp, log_sigmoid and betaln over seeded
grids, and the port's Adam against optax.adam(0.05) over 600 steps.

Bounds, from measurement (this CPU, jax 0.9.0, torch 2.13):
- Adam: bit for bit over 600 steps. XLA runs the jitted update with its
  simplifier's fold of the bias corrections and LLVM's FMAs; the port
  emulates the f64 FMA exactly (special.fma, itself held to exact
  rational arithmetic below).
- logsumexp, logaddexp, log_sigmoid: values and gradients within
  ELEM_RTOL (measured up to 6.4e-16 relative, a few ulps, from torch's
  exp/log/log1p against XLA's); logaddexp's gradient exp(x - out)
  within ELEM_RTOL * (1 + |out|), as an ulp of out moves it by that
  much (measured 3.6e-15 at out = -28.6).
- betaln: value and gradient within BETALN_RTOL relative (measured
  5.6e-13 and 7.3e-13: torch's lgamma and digamma are libm's, XLA's
  its own Lanczos series), over a grid that crosses b = 8 and reaches
  counts of 10^6.
"""
from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import strelka_tpu  # noqa: F401  (enables x64)
from strelka_tpu_torch.utils import special as sp

ELEM_RTOL = 1e-15
BETALN_RTOL = 2e-12


def t(a, grad=False):
    return torch.tensor(np.asarray(a, np.float64), requires_grad=grad)


def close(got, want, rtol):
    got, want = np.asarray(got), np.asarray(want)
    scale = np.maximum(np.abs(want), np.abs(want).max() * 1e-300)
    assert ((np.abs(got - want) <= rtol * scale)
            | (got == want)).all(), np.max(np.abs(got - want) / scale / (
                rtol / np.max(rtol)))


def jax_value_grad(f, *args):
    """f's value and the gradient of sum(f) with respect to each arg."""
    v = jax.jit(f)(*args)
    g = jax.jit(jax.grad(lambda *a: jnp.sum(f(*a)),
                         argnums=tuple(range(len(args)))))(*args)
    return np.asarray(v), [np.asarray(x) for x in g]


def torch_value_grad(f, *args):
    xs = [t(a, True) for a in args]
    v = f(*xs)
    g = torch.autograd.grad(v.sum(), xs)
    return v.detach().numpy(), [x.numpy() for x in g]


def test_logsumexp_value_and_grad():
    rng = np.random.default_rng(0)
    a = rng.normal(-50, 30, (4, 2000))
    a[:, :5] = [[-np.inf], [-3.0], [-3.0], [-np.inf]]    # ties, -inf terms
    a[1, 10] = 700.0
    jv, (jg,) = jax_value_grad(lambda x: jax.scipy.special.logsumexp(x, 0), a)
    tv, (tg,) = torch_value_grad(lambda x: sp.logsumexp(x, 0), a)
    close(tv, jv, ELEM_RTOL)
    close(tg, jg, ELEM_RTOL)


def test_logaddexp_value_and_grad():
    rng = np.random.default_rng(1)
    x1 = rng.normal(-20, 40, 5000)
    x2 = rng.normal(-20, 40, 5000)
    x2[:100] = x1[:100]                                   # equal terms
    x1[100:110] = -np.inf
    jv, jg = jax_value_grad(jnp.logaddexp, x1, x2)
    tv, tg = torch_value_grad(sp.logaddexp, x1, x2)
    close(tv, jv, ELEM_RTOL)
    for a, b in zip(tg, jg):
        close(a, b, ELEM_RTOL * (1 + np.abs(jv)))


def test_log_sigmoid_value_and_grad():
    x = np.concatenate([np.linspace(-60, 60, 4001),
                        np.random.default_rng(2).normal(0, 8, 2000)])
    jv, (jg,) = jax_value_grad(jax.nn.log_sigmoid, x)
    tv, (tg,) = torch_value_grad(sp.log_sigmoid, x)
    close(tv, jv, ELEM_RTOL)
    close(tg, jg, ELEM_RTOL)


@pytest.mark.parametrize("scale", [1.0, 1e3, 1e6])
def test_betaln_value_and_grad(scale):
    """Both of JAX's branches (b < 8 through lgamma differences, b >= 8
    through algdiv), their boundary and counts up to 10^6, with a <= b
    and a > b (the min/max swap) and a == b (the tie's split
    gradient)."""
    rng = np.random.default_rng(int(scale))
    a = np.concatenate([rng.random(3000) * 12 + 1e-3,
                        rng.random(3000) * scale + 1e-3,
                        [7.999, 8.0, 8.001, 5.0, 1e6]])
    b = np.concatenate([rng.random(3000) * 12 + 1e-3,
                        rng.random(3000) * scale + 1e-3,
                        [8.0, 8.0, 8.0, 5.0, 3.0]])
    assert ((b < 8) & (a < 8)).any() and (np.maximum(a, b) >= 8).any()
    jv, jg = jax_value_grad(jax.scipy.special.betaln, a, b)
    tv, tg = torch_value_grad(sp.betaln, a, b)
    close(tv, jv, BETALN_RTOL)
    for x, y in zip(tg, jg):
        close(x, y, BETALN_RTOL)


def test_fma_is_exact():
    """special.fma rounds a*b + c once: equal to exact rational
    arithmetic on random operands, on exact cancellations and on sums
    that fall halfway between two doubles."""
    rng = np.random.default_rng(3)
    n = 20000
    a = rng.normal(size=n) * np.exp(rng.normal(0, 10, n))
    b = rng.normal(size=n) * np.exp(rng.normal(0, 10, n))
    c = rng.normal(size=n) * np.exp(rng.normal(0, 10, n))
    c[:5000] = -(a[:5000] * b[:5000])
    ab = a[5000:10000] * b[5000:10000]
    c[5000:10000] = -ab + np.spacing(ab) * 0.5
    a[10000:12000] = 1 + 2.0 ** -30 * rng.integers(1, 1000, 2000)
    b[10000:12000] = 1 + 2.0 ** -23 * rng.integers(1, 1000, 2000)
    c[10000:12000] = 2.0 ** -53 * rng.integers(-5, 5, 2000)
    got = sp.fma(t(a), t(b), t(c)).numpy()
    want = np.array([float(Fraction(x) * Fraction(y) + Fraction(z))
                     for x, y, z in zip(a, b, c)])
    np.testing.assert_array_equal(got, want)


def test_adam_bit_identical_to_optax():
    """600 steps of optax.adam(0.05), jitted as the fits jit it, on a
    fixed sequence of f64 gradients spanning many magnitudes, against
    special.Adam: every step's parameters bit for bit, and the bias
    corrections' powers equal XLA's."""
    rng = np.random.default_rng(4)
    G = rng.normal(0, 1, (600, 5)) * np.exp(rng.normal(0, 3, (600, 5)))
    p0 = rng.normal(size=5)
    opt = optax.adam(0.05)

    @jax.jit
    def step(p, st, g):
        u, st = opt.update(g, st)
        return optax.apply_updates(p, u), st

    p, st = jnp.asarray(p0), opt.init(jnp.asarray(p0))
    tp = t(p0)
    adam = sp.Adam(tp, 0.05)
    for i in range(600):
        p, st = step(p, st, jnp.asarray(G[i]))
        tp = adam.step(tp, t(G[i]))
        np.testing.assert_array_equal(tp.numpy(), np.asarray(p),
                                      err_msg=f"step {i}")
    assert adam.count == int(st[0].count) == 600
    counts = jnp.arange(1, 601, dtype=jnp.int32)
    for b in (0.9, 0.999):
        want = np.asarray(jax.jit(lambda c, b=b: 1 - b ** c)(counts))
        np.testing.assert_array_equal(
            [1 - b ** k for k in range(1, 601)], want)
