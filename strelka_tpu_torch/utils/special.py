"""The JAX math that the error-model fits reach, as torch functions.

Each function computes what its JAX counterpart computes, with the same
expression graph, so the same gradient formula comes out of
torch.autograd (or, for logaddexp, out of the custom backward that
mirrors JAX's custom JVP):

- logsumexp: jax.scipy.special.logsumexp (a max held out of the
  gradient, the terms summed in order);
- logaddexp: jax.numpy.logaddexp, ``amax + log1p(exp(-|delta|))`` and
  its custom JVP;
- log_sigmoid: jax.nn.log_sigmoid, ``-softplus(-x)`` with softplus as
  ``logaddexp(x, 0)`` (not torch.nn.functional.logsigmoid);
- betaln: jax.scipy.special.betaln of jax 0.9.0
  (jax/_src/third_party/scipy/betaln.py:50-65), lgamma differences for
  b < 8 and algdiv for b >= 8;
- Adam: optax 0.2.6's adam (scale_by_adam, then scale(-lr)) in optax's
  order of operations (not torch.optim.Adam, which folds the bias
  corrections in another order).

The elementwise primitives (exp, log, log1p, lgamma, digamma) are
torch's, which may differ from XLA's by an ulp; tests/test_torch_special.py
measures that against JAX.
"""
from __future__ import annotations

import numpy as np
import torch


def _sum_in_order(x, dim: int):
    """x summed along `dim` one term at a time, in index order."""
    x = x.movedim(dim, 0)
    s = x[0]
    for i in range(1, x.shape[0]):
        s = s + x[i]
    return s


def logsumexp(a, dim: int = 0):
    """log(sum(exp(a), dim)) as jax.scipy.special.logsumexp computes it:
    the max (0 where it is not finite) is detached, so the gradient is
    exp(a - amax) / sumexp, and the terms are added in index order (XLA's
    sum over a short leading axis)."""
    amax = torch.amax(a, dim=dim).detach()
    amax = torch.where(torch.isfinite(amax), amax, torch.zeros_like(amax))
    exp_a = torch.exp(a - amax.unsqueeze(dim))
    sumexp = torch.abs(_sum_in_order(exp_a, dim))
    return torch.log(sumexp) + amax


def _replace_inf(x):
    return torch.where(x == float("inf"), torch.zeros_like(x), x)


def _logaddexp_value(x1, x2):
    amax = torch.maximum(x1, x2)
    delta = x1 - x2
    return torch.where(torch.isnan(delta), x1 + x2,
                       amax + torch.log1p(torch.exp(-torch.abs(delta))))


class _LogAddExp(torch.autograd.Function):
    """jax.numpy.logaddexp with its custom JVP: the tangent is
    t1 * exp(x1 - out) + t2 * exp(x2 - out), infinities replaced by 0."""

    @staticmethod
    def forward(ctx, x1, x2):
        out = _logaddexp_value(x1, x2)
        ctx.save_for_backward(x1, x2, out)
        return out

    @staticmethod
    def backward(ctx, g):
        x1, x2, out = ctx.saved_tensors
        ro = _replace_inf(out)
        g1 = g2 = None
        if ctx.needs_input_grad[0]:
            g1 = g * torch.exp(_replace_inf(x1) - ro)
        if ctx.needs_input_grad[1]:
            g2 = g * torch.exp(_replace_inf(x2) - ro)
        return g1, g2


def logaddexp(x1, x2):
    """log(exp(x1) + exp(x2)) as jax.numpy.logaddexp computes it, value
    and gradient. Either argument may be a Python float."""
    x1 = torch.as_tensor(x1, dtype=torch.float64,
                         device=x2.device if torch.is_tensor(x2) else None)
    x2 = torch.as_tensor(x2, dtype=x1.dtype, device=x1.device)
    x1, x2 = torch.broadcast_tensors(x1, x2)
    return _LogAddExp.apply(x1, x2)


def softplus(x):
    """jax.nn.softplus: logaddexp(x, 0)."""
    return logaddexp(x, torch.zeros_like(x))


def log_sigmoid(x):
    """jax.nn.log_sigmoid: -softplus(-x)."""
    return -softplus(-x)


def _algdiv(a, b):
    """jax's algdiv (from scipy's cdflib): log(gamma(b)) - log(gamma(a+b))
    for b >= 8 and a <= b, in its order of operations."""
    c0 = 0.833333333333333e-01
    c1 = -0.277777777760991e-02
    c2 = 0.793650666825390e-03
    c3 = -0.595202931351870e-03
    c4 = 0.837308034031215e-03
    c5 = -0.165322962780713e-02
    h = a / b
    c = h / (1 + h)
    x = h / (1 + h)
    d = b + (a - 0.5)
    x2 = x * x
    s3 = 1.0 + (x + x2)
    s5 = 1.0 + (x + x2 * s3)
    s7 = 1.0 + (x + x2 * s5)
    s9 = 1.0 + (x + x2 * s7)
    s11 = 1.0 + (x + x2 * s9)
    t = (1.0 / b) ** 2
    w = ((((c5 * s11 * t + c4 * s9) * t + c3 * s7) * t + c2 * s5) * t
         + c1 * s3) * t + c0
    w = w * (c / b)
    u = d * torch.log1p(a / b)
    v = a * (torch.log(b) - 1.0)
    return torch.where(u <= v, (w - v) - u, (w - u) - v)


def betaln(a, b):
    """log B(a, b) as jax.scipy.special.betaln (jax 0.9.0) computes it:
    a, b = min, max; lgamma(a) + (lgamma(b) - lgamma(a + b)) for b < 8,
    lgamma(a) + algdiv(a, b) otherwise (both branches evaluated, as
    jnp.where does, so the gradient is JAX's too)."""
    a, b = torch.broadcast_tensors(a, b)
    a, b = torch.minimum(a, b), torch.maximum(a, b)
    small_b = torch.lgamma(a) + (torch.lgamma(b) - torch.lgamma(a + b))
    large_b = torch.lgamma(a) + _algdiv(a, b)
    return torch.where(b < 8, small_b, large_b)


_SPLIT = 134217729.0     # 2^27 + 1, Veltkamp's splitter for f64


def _two_sum(a, b):
    """s + e == a + b exactly, s = RN(a + b) (Knuth)."""
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _two_prod(a, b):
    """p + e == a * b exactly, p = RN(a * b) (Dekker, with Veltkamp's
    split; exact while nothing overflows or underflows)."""
    p = a * b
    ca = _SPLIT * a
    ah = ca - (ca - a)
    al = a - ah
    cb = _SPLIT * b
    bh = cb - (cb - b)
    bl = b - bh
    return p, ((ah * bh - p) + ah * bl + al * bh) + al * bl


def _add_round_odd(a, b):
    """a + b rounded to odd: RN(a + b), moved one ulp toward the exact
    sum when that is inexact and its last bit is even."""
    s, e = _two_sum(a, b)
    even = (s.view(torch.int64) & 1) == 0
    inf = torch.full_like(s, float("inf"))
    toward = torch.nextafter(s, torch.where(e > 0, inf, -inf))
    return torch.where((e != 0) & even, toward, s)


def fma(a, b, c):
    """a * b + c rounded once, in f64, from separate f64 operations
    (Boldo and Melquiond's emulation: TwoProd, TwoSum, one addition
    rounded to odd, then one rounded to nearest). XLA's CPU backend
    contracts a multiply and an add into an FMA; torch has no f64 FMA
    op on both devices. a, b, c broadcast; Python floats are taken as
    f64 on the tensors' device."""
    ref = next(x for x in (a, b, c) if torch.is_tensor(x))
    a, b, c = (torch.as_tensor(x, dtype=torch.float64, device=ref.device)
               for x in (a, b, c))
    a, b, c = torch.broadcast_tensors(a, b, c)
    uh, ul = _two_prod(a, b)
    th, tl = _two_sum(c, uh)
    return th + _add_round_odd(tl, ul)


def sqrt_rn(x):
    """sqrt(x) correctly rounded, as XLA's (and IEEE's) sqrt: torch's
    f64 sqrt on the CPU is not always (its AVX-512 kernel can miss by an
    ulp), numpy's is, and CUDA's is."""
    if x.device.type == "cpu":
        return torch.from_numpy(np.sqrt(x.detach().numpy()))
    return torch.sqrt(x)


class Adam:
    """optax.adam(lr) (b1 0.9, b2 0.999, eps 1e-8, eps_root 0) on one f64
    parameter tensor, in optax 0.2.6's order:

        mu = (1 - b1) * g + b1 * mu
        nu = (1 - b2) * g**2 + b2 * nu
        count += 1                      (an int, incremented first)
        mu_hat = mu / (1 - b1**count)
        nu_hat = nu / (1 - b2**count)
        update = -lr * (mu_hat / (sqrt(nu_hat + 0) + eps))
        params = params + update

    as XLA's CPU backend runs the jitted update, bit for bit with it
    (tests/test_torch_special.py): its simplifier folds (mu / c1) /
    (sqrt(nu_hat) + eps) into mu / (c1 * (sqrt(nu_hat) + eps)) and drops
    the + 0, and LLVM contracts each moment's update and the last add
    into an FMA (fma(g, 1 - b1, b1 * mu), fma(g*g, 1 - b2, b2 * nu),
    fma(update, -lr, params)). The bias corrections' powers are Python's
    (libm's pow, as XLA's).
    """

    B1, B2, EPS = 0.9, 0.999, 1e-8      # optax.adam's defaults

    def __init__(self, params, lr: float, b1: float = B1, b2: float = B2,
                 eps: float = EPS):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.mu = torch.zeros_like(params)
        self.nu = torch.zeros_like(params)
        self.count = 0

    def step(self, params, g):
        """The parameters after one step with gradient g."""
        b1, b2 = self.b1, self.b2
        self.mu = fma(g, 1 - b1, self.mu * b1)
        self.nu = fma(g * g, 1 - b2, self.nu * b2)
        self.count += 1
        c1 = 1 - b1 ** self.count
        # a tensor divisor: torch divides by a Python scalar as a
        # multiply by its reciprocal
        nu_hat = self.nu / torch.full_like(self.nu, 1 - b2 ** self.count)
        update = self.mu / (c1 * (sqrt_rn(nu_hat) + self.eps))
        return fma(update, -self.lr, params)
