"""KE-F, the indel error fit's step as one CUDA kernel
(csrc/error_fit_step.cu), and a torch model of its arithmetic.

KE-F replaces the step that the JAX package's fit_context jits
(value_and_grad of the mixture's negative log likelihood, then optax's
Adam update; XLA, no Pallas). Its plain version in the port is
models/error_fit.fit_step_plain, the loss as torch ops, torch.autograd's
backward and utils/special.Adam. Two entries of one source:

- error_fit_prep, once a fit: loc [12, N] float64, each locus's
  parameter-free values (the rows of ROWS), bit for bit with
  models/error_fit.fit_prep_plain;
- error_fit_step, once an Adam step: the loss and its gradient in closed
  form summed over the loci in one fixed order (step_grid; no float
  atomics), Adam and the best-step rule, in the fit's state buffer on the
  card (STATE), one launch a step.

models/error_fit.fit_context runs the plain step on CPU tensors and KE-F
on any other device. A wrapper here checks its operands, builds and binds
the library (_build.load) and launches on the tensors' card and its
current stream, and raises on what it does not take and where the build,
the load or the launch fails: nothing falls back to the plain step.
LAUNCHES counts each entry's launches; PLAIN_ON_CUDA counts the plain
versions' runs on a card, which no CLI path makes.

fit_step_model, adam_model and fit_model are KE-F's arithmetic as torch
ops: the same elementwise expressions, the closed-form gradient and the
kernel's order of the sums over loci (grid_sum). The tests hold them
against the JAX package on the CPU, and the kernel against them on the
card; no path runs them.
"""
from __future__ import annotations

import ctypes

import torch

from ..utils import special as sp

REPLACES = {"error_fit_step": "strelka_tpu/models/error_fit.py:171",
            "error_fit_prep": "strelka_tpu/models/error_fit.py:171"}
SOURCE = "error_fit_step"
LAUNCHES = {"error_fit_prep": 0, "error_fit_step": 0}
PLAIN_ON_CUDA = {"error_fit_prep": 0, "error_fit_step": 0}

# the host doubles that both entries take, in csrc's Consts order
CONSTS = ("log_hom_alt", "log_hom_ref", "log_het", "log_clean",
          "log_clean_ref", "prior_hom", "prior_het", "prior_noindel",
          "prior_althet", "trig_rate", "trig_locus", "max_rate", "max_locus",
          "lr", "b1", "b2", "omb1", "omb2", "eps")
# loc's rows
ROWS = ("ref", "ins_tot", "del_tot", "rem_ins", "rem_del", "rem_ins2",
        "rem_del2", "hom_pre", "het_pre", "alt_pre", "clean_mix", "inst")
# the state buffer's float64 slots: the parameters, Adam's moments, the
# best loss and the parameters after its step, the last step's loss and
# gradient (at the parameters before it)
PARAMS, MU, NU = slice(0, 3), slice(3, 6), slice(6, 9)
BEST_V, BEST_PARAMS, V, GRAD = 9, slice(10, 13), 13, slice(14, 17)
STATE = 17

THREADS = 256
WARPS = THREADS // 32
MAX_BLOCKS = 264          # two blocks an SM on the H100's 132
SUMS = 6                  # loss, d/dli, d/dld, d/dlr, d/dlcl, d/dln

_vp, _ll, _i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_CD = ctypes.POINTER(ctypes.c_double)
_ARGTYPES = {
    "error_fit_prep": [_vp, _vp, _vp, _ll, _CD, _vp, _vp],
    "error_fit_step": [_vp, _ll, _i, _i, _CD, _vp, _i, _vp, _vp, _vp, _vp],
}
_BOUND: dict = {}


def reset() -> None:
    """Set every launch and plain-version counter to 0."""
    for d in (LAUNCHES, PLAIN_ON_CUDA):
        for k in d:
            d[k] = 0


def count_plain(name: str, dev) -> None:
    """Count a run of entry `name`'s plain version where it is on a card."""
    if torch.device(dev).type == "cuda":
        PLAIN_ON_CUDA[name] += 1


def function(name: str):
    """Entry `name`'s launch function, bound with ctypes; builds
    csrc/error_fit_step.cu first if stale. Raises where the build or the
    load fails."""
    if name not in _BOUND:
        from .. import _build
        fn = getattr(_build.load(SOURCE), f"{name}_launch")
        fn.restype = ctypes.c_int
        fn.argtypes = _ARGTYPES[name]
        _BOUND[name] = fn
    return _BOUND[name]


def step_grid(n: int) -> tuple[int, int]:
    """(blocks, loci a thread) of error_fit_step over n loci: one locus a
    thread up to MAX_BLOCKS blocks, more a thread past them."""
    per = max(1, -(-n // (THREADS * MAX_BLOCKS)))
    return -(-n // (THREADS * per)), per


def _host_consts(consts):
    if len(consts) != len(CONSTS):
        raise ValueError(f"KE-F takes {len(CONSTS)} constants, got "
                         f"{len(consts)}")
    return (ctypes.c_double * len(CONSTS))(*map(float, consts))


def _check(name, dev, specs):
    """Each (label, tensor, shape) float64 on `dev`, of `shape` and
    contiguous."""
    for label, t, shape in specs:
        if t.device != dev:
            raise ValueError(f"{name}: {label} is on {t.device}, the first "
                             f"input on {dev}")
        if t.dtype != torch.float64:
            raise ValueError(f"{name}: {label} must be float64, got "
                             f"{t.dtype}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: {label} has shape {tuple(t.shape)}, "
                             f"wants {tuple(shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {label} must be contiguous")


def _launch(name, dev, args):
    """Bind entry `name` and launch it on `dev` and its current stream;
    raises where the build or the load fails, `dev` is no card or the
    launch fails."""
    fn = function(name)
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    with torch.cuda.device(dev):
        rc = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")
    LAUNCHES[name] += 1


def error_fit_prep(ref_obs, alt_obs, inst, consts):
    """KE-F's prep entry: loc [12, N] float64 (ROWS) of fit_prep_plain.
    ref_obs [N], alt_obs [N, 6] and inst [N] float64 on one card, N >= 1;
    consts the CONSTS doubles."""
    name = "error_fit_prep"
    dev = ref_obs.device
    n = ref_obs.shape[0] if ref_obs.dim() == 1 else -1
    if n < 1:
        raise ValueError(f"{name}: ref_obs must be [N], N >= 1, got "
                         f"{tuple(ref_obs.shape)}")
    _check(name, dev, [("ref_obs", ref_obs, (n,)),
                       ("alt_obs", alt_obs, (n, 6)), ("inst", inst, (n,))])
    host = _host_consts(consts)
    loc = torch.empty((len(ROWS), n), dtype=torch.float64, device=dev)
    _launch(name, dev, [ref_obs.data_ptr(), alt_obs.data_ptr(),
                        inst.data_ptr(), n, host, loc.data_ptr()])
    return loc


class StepBuffers:
    """One fit's operands of KE-F's step entry on loc's card, checked and
    bound once: loc [12, N] float64 (error_fit_prep's), the CONSTS
    doubles, the bias corrections [n_steps, 2] (1 - b1**t, 1 - b2**t by
    Python's **, as special.Adam takes them), the state (STATE float64:
    the parameters, zero moments), the block partials [blocks, 6] and the
    ticket (one int32, the kernel's unsigned counter, 0 between
    launches), with the grid (step_grid)."""

    def __init__(self, loc, params, consts, n_steps: int):
        name = "error_fit_step"
        if loc.dim() != 2 or loc.shape[0] != len(ROWS) or loc.shape[1] < 1:
            raise ValueError(f"{name}: loc must be [{len(ROWS)}, N], N >= 1, "
                             f"got {tuple(loc.shape)}")
        if n_steps < 1:
            raise ValueError(f"{name}: n_steps must be >= 1, got {n_steps}")
        c = dict(zip(CONSTS, consts))
        host = _host_consts(consts)
        dev = loc.device
        n = loc.shape[1]
        _check(name, dev, [("loc", loc, (len(ROWS), n))])
        self.loc, self.dev, self.n_steps = loc, dev, n_steps
        self.blocks, self.per = step_grid(n)
        self.bias = torch.tensor(
            [(1 - c["b1"] ** t, 1 - c["b2"] ** t)
             for t in range(1, n_steps + 1)], dtype=torch.float64).to(dev)
        state = torch.zeros(STATE, dtype=torch.float64)
        state[PARAMS] = params.detach().cpu()
        self.state = state.to(dev)
        self.partials = torch.empty((self.blocks, SUMS), dtype=torch.float64,
                                    device=dev)
        self.ticket = torch.zeros(1, dtype=torch.int32).to(dev)
        self._args = ([loc.data_ptr(), n, self.blocks, self.per, host,
                       self.bias.data_ptr()],
                      [self.state.data_ptr(), self.partials.data_ptr(),
                       self.ticket.data_ptr()])


def error_fit_step(bufs: StepBuffers, t: int) -> None:
    """KE-F's step entry: step t (1..n_steps) of the fit in `bufs` (its
    state updated on the card: the loss and gradient at the parameters,
    Adam's step, the best step)."""
    if not 1 <= t <= bufs.n_steps:
        raise ValueError(f"error_fit_step: step {t} outside "
                         f"1..{bufs.n_steps}")
    head, tail = bufs._args
    _launch("error_fit_step", bufs.dev, [*head, t, *tail])


# --------------------------------------------------------------------------
# the kernel's arithmetic as torch ops (tests and chip_smoke.py only)
# --------------------------------------------------------------------------

def grid_sum(terms, n_blocks: int, per: int):
    """The sums of terms [K, N] over N in error_fit_step's order: thread
    t of block b adds loci (b * per + i) * THREADS + t from 0.0 (+0.0 past
    N), a warp's lanes fold by halves (xor shuffles), a block adds its
    warps in order, then the blocks in order. Returns (totals [K],
    partials [n_blocks, K])."""
    k, n = terms.shape
    pad = torch.zeros((k, n_blocks * per * THREADS), dtype=terms.dtype,
                      device=terms.device)
    pad[:, :n] = terms
    x = pad.view(k, n_blocks, per, THREADS)
    acc = torch.zeros((k, n_blocks, THREADS), dtype=terms.dtype,
                      device=terms.device)
    for i in range(per):
        acc = acc + x[:, :, i]
    acc = acc.view(k, n_blocks, WARPS, 32)
    w = 32
    while w > 1:
        w //= 2
        acc = acc[..., :w] + acc[..., w:2 * w]
    acc = acc[..., 0]
    part = acc[..., 0]
    for i in range(1, WARPS):
        part = part + acc[..., i]
    tot = part[:, 0]
    for b in range(1, n_blocks):
        tot = tot + part[:, b]
    return tot, part.T


def _smooth(a, trig, mx):
    """_rate_smoother's (x, b, d, c) as the kernel keeps them."""
    x = a - trig
    b = torch.where(a > trig, torch.log1p(x) + trig, a)
    d = b - mx
    return x, b, d, torch.where(b > mx, mx - torch.abs(d), b)


def _smooth_grad(a, x, b, d, trig, mx, g):
    zero = torch.zeros_like(g)
    fold = b > mx
    gb = (-torch.where(fold, g, zero)) * torch.sign(d) + torch.where(
        fold, zero, g)
    up = a > trig
    return (torch.where(up, gb, zero) / (x + 1.0)
            + torch.where(up, zero, gb))


def _lse4(t):
    """(log|s| + m, the exps [4, N], s) of special.logsumexp over t [4, N]."""
    m = torch.amax(t, dim=0)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    e = torch.exp(t - m)
    s = ((e[0] + e[1]) + e[2]) + e[3]
    return torch.log(torch.abs(s)) + m, e, s


def fit_step_model(loc, params, consts, grid=None) -> dict:
    """KE-F's loss and gradient at params [3] float64 as torch ops on
    loc's device: the kernel's per-locus terms and closed-form gradient,
    summed in its order (grid_sum on `grid`, default step_grid(N)).
    Returns {"v": loss, "g": gradient [3], "totals": the six sums,
    "terms": the per-locus terms [6, N] (the first mix * inst), "scale":
    each gradient component's sums of |term| carried through the rate
    chain's factors [3] (a rounding bound of another sum order is
    2 eps N scale), "rates": (li, ld, ln)}."""
    c = dict(zip(CONSTS, consts))
    p = params.to(loc.device, torch.float64)
    si = _smooth(p[0], c["trig_rate"], c["max_rate"])
    sd = _smooth(p[1], c["trig_rate"], c["max_rate"])
    sn = _smooth(p[2], c["trig_locus"], c["max_locus"])
    li, ld, ln = si[3], sd[3], sn[3]
    e_li, e_ld, e_ln = torch.exp(li), torch.exp(ld), torch.exp(ln)
    vr = (1.0 - e_li) - e_ld
    lr = torch.log(vr)
    u = -e_ln
    lcl = torch.log1p(u)
    (ref, ins, dele, ri, rd, ri2, rd2, hom_pre, het_pre, alt_pre, clean,
     w) = loc
    pi, pd = li * ri, ld * rd
    t = torch.stack([
        ((hom_pre + pi) + pd) + c["prior_hom"],
        ((het_pre + pi) + pd) + c["prior_het"],
        ((li * ins + ld * dele) + lr * ref) + c["prior_noindel"],
        ((alt_pre + li * ri2) + ld * rd2) + c["prior_althet"]])
    noisy, e, s = _lse4(t)
    x1, x2 = lcl + clean, ln + noisy
    d = x1 - x2
    mix = torch.where(torch.isnan(d), x1 + x2, torch.maximum(x1, x2)
                      + torch.log1p(torch.exp(-torch.abs(d))))
    g = -w
    inf = float("inf")
    zero = torch.zeros_like(mix)
    ro = torch.where(mix == inf, zero, mix)
    g1 = g * torch.exp(torch.where(x1 == inf, zero, x1) - ro)
    g2 = g * torch.exp(torch.where(x2 == inf, zero, x2) - ro)
    gs = (g2 / torch.abs(s)) * torch.sign(s)
    gk = gs * e
    terms = torch.stack([
        mix * w,
        ((gk[0] * ri + gk[1] * ri) + gk[2] * ins) + gk[3] * ri2,
        ((gk[0] * rd + gk[1] * rd) + gk[2] * dele) + gk[3] * rd2,
        gk[2] * ref, g1, g2])
    blocks, per = grid if grid is not None else step_grid(loc.shape[1])
    tot, _ = grid_sum(terms, blocks, per)
    q = -(tot[3] / vr)
    g_li = tot[1] + q * e_li
    g_ld = tot[2] + q * e_ld
    g_ln = tot[5] + (-(tot[4] / (u + 1.0))) * e_ln
    grad = torch.stack([
        _smooth_grad(p[0], *si[:3], c["trig_rate"], c["max_rate"], g_li),
        _smooth_grad(p[1], *sd[:3], c["trig_rate"], c["max_rate"], g_ld),
        _smooth_grad(p[2], *sn[:3], c["trig_locus"], c["max_locus"], g_ln)])
    a = terms.abs().sum(dim=1)
    scale = torch.stack([a[1] + a[3] * e_li / torch.abs(vr),
                         a[2] + a[3] * e_ld / torch.abs(vr),
                         a[5] + a[4] * e_ln / torch.abs(u + 1.0)])
    return {"v": -tot[0], "g": grad, "totals": tot, "terms": terms,
            "scale": scale, "rates": (li, ld, ln)}


def adam_model(params, mu, nu, g, t: int, consts):
    """KE-F's Adam step t (1-based) as torch ops: (params, mu, nu) after
    it, with 1 - b1**t and 1 - b2**t by Python's ** as the host's table
    holds them (special.Adam's order; its FMAs exact)."""
    c = dict(zip(CONSTS, consts))
    c1, c2 = 1 - c["b1"] ** t, 1 - c["b2"] ** t
    mu = sp.fma(g, c["omb1"], mu * c["b1"])
    nu = sp.fma(g * g, c["omb2"], nu * c["b2"])
    nu_hat = nu / torch.full_like(nu, c2)
    upd = mu / (c1 * (sp.sqrt_rn(nu_hat) + c["eps"]))
    return sp.fma(upd, -c["lr"], params), mu, nu


def keeps_step(t: int, v: float, best_v) -> bool:
    """KE-F's best-step rule: step t (1-based) with loss v replaces the
    best so far where it is the first, or on a strict v < best_v (ties
    keep the earlier step; a NaN never wins, and a first NaN stays)."""
    return t == 1 or v < best_v


def fit_model(loc, params, consts, n_steps: int, grid=None):
    """A whole fit through fit_step_model, adam_model and the best-step
    rule (the first step kept, then a strict v < best; the parameters
    after the step kept): (best loss, best parameters [3], the losses of
    every step [n_steps])."""
    p = params.to(loc.device, torch.float64).clone()
    mu, nu = torch.zeros_like(p), torch.zeros_like(p)
    best_v, best_p, losses = None, None, []
    for t in range(1, n_steps + 1):
        out = fit_step_model(loc, p, consts, grid)
        p, mu, nu = adam_model(p, mu, nu, out["g"], t, consts)
        v = float(out["v"])
        losses.append(v)
        if keeps_step(t, v, best_v):
            best_v, best_p = v, p.clone()
    return best_v, best_p, torch.tensor(losses, dtype=torch.float64)


def step_work(n: int) -> tuple[int, int]:
    """(bytes, float64 operations) that one step's function (the loss,
    its gradient, Adam and the best step; the JAX package's jitted step)
    needs at the least over n loci: the observations read once (ref_obs,
    alt_obs' 6 slots and inst, OBS_ROWS float64 a locus; not loc, whose
    other rows are KE-F's own) and the state read and written (not the
    partials, KE-F's own); F64_PER_LOCUS operations a locus (each exp,
    log, log1p and division one; the prep's hoisted work not counted)
    and the tail's."""
    blocks, _ = step_grid(n)
    nbytes = OBS_ROWS * 8 * n + 2 * STATE * 8
    return nbytes, F64_PER_LOCUS * n + SUMS * blocks + F64_TAIL


def synthetic_counts(seed: int, n: int, ref_max: int):
    """Deduplicated counts (models/error_fit.ContextCounts) of n seeded
    loci with wide random alt rows, so that most patterns stay apart (n
    60,000 and ref_max 300: over 50,000 patterns; n 130,000 and ref_max
    500: over 100,000, past one locus a thread)."""
    import numpy as np
    from ..models import error_fit as ef
    rng = np.random.default_rng(seed)
    ref = rng.integers(0, ref_max, n)
    alt = rng.poisson(rng.choice([0.3, 2.0, 6.0], (n, 1)), (n, 6))
    return ef.dedupe_counts(ref, alt)


# float64 values a locus of the step's observations: ref_obs, the six
# alt_obs slots and inst
OBS_ROWS = 1 + 6 + 1


# float64 operations of error_fit_step, counted from its source (each exp,
# log, log1p, division and square root one, an FMA two; compares,
# selects, abs and negations not counted). A locus's forward: 7 products
# and 12 adds of the four terms, 3 max, 4 differences, 4 exps, 3 adds,
# log and add, 2 adds, difference, exp, log1p, max, add and the loss
# term's product (43); its backward: 2 x (difference, exp, product),
# division and product, 4 products, 2 x (4 products and 3 adds) and one
# product (27); 6 adds into the sums. The tail: the rates (3 smoothers'
# 5, 3 exps, 2 differences, log, log1p: 22), the chain (9), 3 smoothers'
# backward (15) and Adam (3 x 14).
F64_PER_LOCUS = 43 + 27 + 6
F64_TAIL = 22 + 9 + 15 + 3 * 14
