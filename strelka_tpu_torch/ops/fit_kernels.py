"""KE-F, the indel error fit as one CUDA kernel a fit
(csrc/error_fit_step.cu), and a torch model of its arithmetic.

KE-F replaces the step that the JAX package's fit_context jits
(value_and_grad of the mixture's negative log likelihood, then optax's
Adam update; XLA, no Pallas). Its plain version in the port is
models/error_fit.fit_step_plain, the loss as torch ops, torch.autograd's
backward and utils/special.Adam. Two entries of one source:

- error_fit_run, once a fit: n_steps Adam steps in one launch (FitRun):
  each locus's parameter-free values computed once and held on chip,
  then a step's loss and its gradient in closed form summed over the
  loci in one fixed order (fit_grid; no float atomics), Adam and the
  best-step rule, the blocks meeting at one barrier a step, and the
  state (STATE) written once at the end;
- error_fit_prep: the same parameter-free values as loc [12, N] float64
  (the rows of ROWS), bit for bit with models/error_fit.fit_prep_plain;
  the tested form of the fit entry's prep, on no CLI path.

models/error_fit.fit_context runs the plain step on CPU tensors and KE-F
on any other device. A wrapper here checks its operands, builds and binds
the library (_build.load) and launches on the tensors' card and its
current stream, and raises on what it does not take and where the build,
the load or the launch fails (a cluster or cooperative launch that the
card cannot place among them): nothing falls back to the plain step.
LAUNCHES counts each entry's launches; PLAIN_ON_CUDA counts the plain
versions' runs on a card, which no CLI path makes.

fit_step_model, adam_model and fit_model are KE-F's arithmetic as torch
ops: the same elementwise expressions, the closed-form gradient and the
kernel's order of the sums over loci (grid_sum on fit_grid's blocks and
loci a thread). The tests hold them against the JAX package on the CPU,
and the kernel against them on the card; no path runs them.
"""
from __future__ import annotations

import ctypes

import torch

from ..utils import special as sp

REPLACES = {"error_fit_run": "strelka_tpu/models/error_fit.py:171",
            "error_fit_prep": "strelka_tpu/models/error_fit.py:171"}
SOURCE = "error_fit_step"
LAUNCHES = {"error_fit_prep": 0, "error_fit_run": 0}
# the plain versions: fit_prep_plain, and fit_step_plain once a step
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
SUMS = 6                  # loss, d/dli, d/dld, d/dlr, d/dlcl, d/dln
# the fit entry's grid (csrc's kMaxBlocks, kOnChipPer): at most
# MAX_BLOCKS blocks, two an SM on the H100's 132 (the card's own
# co-resident count where lower, resident_blocks); up to ON_CHIP_PER loci
# a thread held in shared memory (96 KB a block); the whole grid one
# thread-block cluster up to CLUSTER_MAX blocks (the H100's largest
# cluster)
MAX_BLOCKS = 264
ON_CHIP_PER = 4
CLUSTER_MAX = 16
REGIMES = ("cluster", "grid", "global")
# the barrier's counter reaches n_steps * blocks
MAX_ARRIVALS = 2**32 - 1

_vp, _ll, _i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_CD = ctypes.POINTER(ctypes.c_double)
# the C functions of csrc/error_fit_step.cu
_ARGTYPES = {
    "error_fit_prep_launch": [_vp, _vp, _vp, _ll, _CD, _vp, _vp],
    "error_fit_run_launch": [_vp, _vp, _vp, _ll, _i, _i, _i, _i, _CD, _vp,
                             _vp, _vp, _vp, _vp, _vp],
    "error_fit_resident_blocks": [ctypes.POINTER(ctypes.c_int)],
}
_BOUND: dict = {}
_RESIDENT: dict = {}


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
    """C function `name` of csrc/error_fit_step.cu (_ARGTYPES), bound
    with ctypes; builds the source first if stale. Raises where the
    build or the load fails."""
    if name not in _BOUND:
        from .. import _build
        fn = getattr(_build.load(SOURCE), name)
        fn.restype = ctypes.c_int
        fn.argtypes = _ARGTYPES[name]
        _BOUND[name] = fn
    return _BOUND[name]


def fit_grid(n: int, resident: int = MAX_BLOCKS,
             on_chip_per: int = ON_CHIP_PER) -> tuple[int, int, str]:
    """(blocks, loci a thread, regime) of error_fit_run over n loci on a
    card that keeps `resident` of its blocks at once (resident_blocks):
    one locus a thread up to `resident` blocks, more a thread past them,
    no empty block. The regime: "cluster" up to CLUSTER_MAX blocks (the
    grid one thread-block cluster), "grid" past it (a cooperative launch
    with a barrier on a counter), both with the loci in shared memory;
    "global" past on_chip_per loci a thread (ON_CHIP_PER for KE-F: n >
    resident * THREADS * ON_CHIP_PER, 270,336 on the H100), the loci
    read from global memory every step. csrc/fit_grid.cuh runs the same
    grids for KZ (ops/zoo_kernels), whose kernels hold other numbers of
    loci a thread on chip."""
    if n < 1 or resident < 1:
        raise ValueError(f"fit_grid: wants n >= 1 and resident >= 1, got "
                         f"{n}, {resident}")
    per = max(1, -(-n // (THREADS * resident)))
    blocks = -(-n // (THREADS * per))
    if per > on_chip_per:
        regime = "global"
    else:
        regime = "cluster" if blocks <= CLUSTER_MAX else "grid"
    return blocks, per, regime


def resident_blocks(dev) -> int:
    """The fit entry's blocks that card `dev` keeps co-resident (the
    occupancy of its grid kernels times the SMs, at most MAX_BLOCKS),
    asked once a card; builds the library first. Raises where the card
    keeps none."""
    dev = torch.device(dev)
    if dev not in _RESIDENT:
        fn = function("error_fit_resident_blocks")
        if dev.type != "cuda":
            raise ValueError(f"error_fit_run: unsupported device {dev}")
        out = ctypes.c_int(0)
        with torch.cuda.device(dev):
            rc = fn(ctypes.byref(out))
        if rc != 0 or out.value < 1:
            raise RuntimeError(f"error_fit_run: the card keeps "
                               f"{out.value} blocks resident (CUDA error "
                               f"{rc})")
        _RESIDENT[dev] = out.value
    return _RESIDENT[dev]


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


def _check_obs(name, ref_obs, alt_obs, inst) -> int:
    """ref_obs [N], alt_obs [N, 6] and inst [N] float64 on one device,
    N >= 1: returns N."""
    n = ref_obs.shape[0] if ref_obs.dim() == 1 else -1
    if n < 1:
        raise ValueError(f"{name}: ref_obs must be [N], N >= 1, got "
                         f"{tuple(ref_obs.shape)}")
    _check(name, ref_obs.device, [("ref_obs", ref_obs, (n,)),
                                  ("alt_obs", alt_obs, (n, 6)),
                                  ("inst", inst, (n,))])
    return n


def _launch(name, dev, args):
    """Bind entry `name` and launch it on `dev` and its current stream;
    raises where the build or the load fails, `dev` is no card or the
    launch fails."""
    fn = function(f"{name}_launch")
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
    n = _check_obs(name, ref_obs, alt_obs, inst)
    host = _host_consts(consts)
    dev = ref_obs.device
    loc = torch.empty((len(ROWS), n), dtype=torch.float64, device=dev)
    _launch(name, dev, [ref_obs.data_ptr(), alt_obs.data_ptr(),
                        inst.data_ptr(), n, host, loc.data_ptr()])
    return loc


def _check_grid(name, grid, n: int) -> None:
    """A (blocks, loci a thread, regime) whose buffers FitRun can make
    over n loci: blocks covering n, the regime one of REGIMES and
    "global" just where per > ON_CHIP_PER. The C entry refuses more than
    MAX_BLOCKS blocks, and the card a grid it cannot place, at the
    launch."""
    blocks, per, regime = grid
    if not (blocks >= 1 and per >= 1
            and blocks * per * THREADS >= n and regime in REGIMES
            and (regime == "global") == (per > ON_CHIP_PER)):
        raise ValueError(f"{name}: grid {tuple(grid)} does not cover {n} "
                         f"loci in a regime of the entry")


def bias_table(n_steps: int, b1: float, b2: float):
    """Adam's bias corrections of steps 1..n_steps, [n_steps * 2] float64
    on the host: 1 - b1**t, 1 - b2**t by Python's **, as special.Adam
    takes them."""
    return torch.tensor(
        [x for t in range(1, n_steps + 1) for x in (1 - b1 ** t, 1 - b2 ** t)],
        dtype=torch.float64)


def start_io(params, state: int, n_steps: int, b1: float, b2: float):
    """The host buffer that a csrc/fit_grid.cuh fit starts from: its state
    [state] (the parameters params first, zero past them: Adam's moments),
    the bias corrections [n_steps, 2] (bias_table) and the barrier's two
    uint32 counters at 0 (one float64)."""
    p = torch.as_tensor(params, dtype=torch.float64).cpu()
    io = torch.zeros(state + 2 * n_steps + 1, dtype=torch.float64)
    io[:p.numel()] = p
    io[state:state + 2 * n_steps] = bias_table(n_steps, b1, b2)
    return io


class FitRun:
    """One fit's operands of KE-F's fit entry on the observations' card,
    checked, allocated and bound once, holding the observations; launch()
    runs the whole fit from the state as it stands, reset() puts the
    start back (the parameters, zero moments and counters) for another
    launch of the same fit. ref_obs [N], alt_obs [N, 6] and inst [N]
    float64 on one card, N >= 1; params [3] the start; the CONSTS
    doubles; n_steps >= 1. On the card: the state (STATE float64: the
    parameters, zero moments; every slot after a launch), the bias
    corrections [n_steps, 2] (1 - b1**t, 1 - b2**t by Python's **, as
    special.Adam takes them) and the barrier's two counters (the kernel
    leaves them at 0), copied up in one buffer; the block partials [2,
    blocks, 6] past the cluster regime, loc [12, N] in the global regime.
    The grid is fit_grid(N, resident_blocks(card)): the loci stay on chip
    up to resident * 256 * ON_CHIP_PER of them (270,336 on the H100 at
    two blocks an SM); past that they are read from loc every step.
    `grid` (blocks, per, regime) replaces fit_grid's to measure a regime
    where fit_grid picks another; a grid that the card cannot place makes
    the launch raise."""

    def __init__(self, ref_obs, alt_obs, inst, params, consts, n_steps: int,
                 grid=None):
        name = "error_fit_run"
        n = _check_obs(name, ref_obs, alt_obs, inst)
        if n_steps < 1:
            raise ValueError(f"{name}: n_steps must be >= 1, got {n_steps}")
        host = _host_consts(consts)
        dev = ref_obs.device
        if grid is None:
            grid = fit_grid(n, resident_blocks(dev))
        _check_grid(name, grid, n)
        self.grid = tuple(grid)
        blocks, per, regime = self.grid
        if n_steps * blocks > MAX_ARRIVALS:
            raise ValueError(f"{name}: {n_steps} steps of {blocks} blocks "
                             f"overflow the barrier's counter")
        c = dict(zip(CONSTS, consts))
        io = start_io(params, STATE, n_steps, c["b1"], c["b2"])
        self._start, io = io, io.to(dev, copy=True)
        self.dev, self.n_steps = dev, n_steps
        # the launch reads these through their addresses
        self._obs = (ref_obs, alt_obs, inst)
        self.state = io[:STATE]
        f64 = dict(dtype=torch.float64, device=dev)
        self.partials = (torch.empty((2, blocks, SUMS), **f64)
                         if regime != "cluster" else None)
        self.loc = (torch.empty((len(ROWS), n), **f64)
                    if regime == "global" else None)

        def ptr(t):
            return None if t is None else t.data_ptr()
        self._args = [ref_obs.data_ptr(), alt_obs.data_ptr(),
                      inst.data_ptr(), n, blocks, per, n_steps,
                      int(regime == "cluster"), host,
                      io[STATE:].data_ptr(), self.state.data_ptr(),
                      ptr(self.loc), ptr(self.partials),
                      io[STATE + 2 * n_steps:].data_ptr()]
        self._io = io

    def launch(self) -> None:
        """One launch of the whole fit on the state as it stands."""
        _launch("error_fit_run", self.dev, self._args)

    def reset(self) -> None:
        """The state, bias table and counters as before the first launch
        (one copy from the host on the card's current stream)."""
        self._io.copy_(self._start)


def error_fit_run(ref_obs, alt_obs, inst, params, consts,
                  n_steps: int) -> FitRun:
    """KE-F's fit entry: a fit of n_steps Adam steps from params in one
    launch (FitRun's operands); the result is its .state (fk.BEST_V,
    fk.BEST_PARAMS, ...) on the card and its .grid."""
    run = FitRun(ref_obs, alt_obs, inst, params, consts, n_steps)
    run.launch()
    return run


# --------------------------------------------------------------------------
# the kernel's arithmetic as torch ops (tests and chip_smoke.py only)
# --------------------------------------------------------------------------

def grid_sum(terms, n_blocks: int, per: int):
    """The sums of terms [K, N] over N in error_fit_run's order (and
    every csrc/fit_grid.cuh fit's): thread
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
    summed in its order (grid_sum on `grid`, (blocks, loci a thread),
    default fit_grid(N)'s).
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
    blocks, per = grid if grid is not None else fit_grid(loc.shape[1])[:2]
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
    return adam_update(params, mu, nu, g, t, dict(zip(CONSTS, consts)))


def adam_update(params, mu, nu, g, t: int, c: dict):
    """csrc/fit_grid.cuh's Adam step t as torch ops, with the constants
    lr, b1, b2, omb1, omb2 and eps of the dict c (adam_model's)."""
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
    """A whole fit (error_fit_run's) through fit_step_model on `grid`,
    adam_model and the best-step rule (the first step kept, then a strict
    v < best; the parameters after the step kept): (best loss, best
    parameters [3], the losses of every step [n_steps], the state [STATE]
    that the fit entry writes at the end)."""
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
    state = torch.cat([p, mu, nu, torch.tensor([best_v], dtype=p.dtype,
                                               device=p.device),
                       best_p, out["v"].reshape(1), out["g"]])
    return best_v, best_p, torch.tensor(losses, dtype=torch.float64), state


def fit_work(n: int, n_steps: int) -> tuple[int, int]:
    """(bytes, float64 operations) that a fit's function (n_steps of the
    loss, its gradient, Adam and the best step; the JAX package's jitted
    step n_steps times) needs at the least over n loci: the observations
    read once (ref_obs, alt_obs' 6 slots and inst, OBS_ROWS float64 a
    locus), the bias table read and the state read and written (not loc
    or the partials, KE-F's own); each locus's parameter-free values once
    (PREP_F64_PER_LOCUS) and F64_PER_LOCUS operations a locus a step
    (each exp, log, log1p and division one), and each step's tail."""
    blocks = fit_grid(n)[0]
    nbytes = OBS_ROWS * 8 * n + 2 * 8 * n_steps + 2 * STATE * 8
    return nbytes, (PREP_F64_PER_LOCUS * n
                    + n_steps * (F64_PER_LOCUS * n + SUMS * blocks
                                 + F64_TAIL))


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


# float64 operations of a step of error_fit_run, counted from its source
# (each exp, log, log1p, division and square root one, an FMA two;
# compares, selects, abs and negations not counted). A locus's forward: 7 products
# and 12 adds of the four terms, 3 max, 4 differences, 4 exps, 3 adds,
# log and add, 2 adds, difference, exp, log1p, max, add and the loss
# term's product (43); its backward: 2 x (difference, exp, product),
# division and product, 4 products, 2 x (4 products and 3 adds) and one
# product (27); 6 adds into the sums. The tail: the rates (3 smoothers'
# 5, 3 exps, 2 differences, log, log1p: 22), the chain (9), 3 smoothers'
# backward (15) and Adam (3 x 14).
F64_PER_LOCUS = 43 + 27 + 6
F64_TAIL = 22 + 9 + 15 + 3 * 14
# float64 operations a locus of the prep (prep_locus), counted from its
# source (each exp and log one; compares and selects not counted): the
# count sums and rems (9), the three prefixes (9), the clean mixture's
# four terms (21) and its logsumexp (16)
PREP_F64_PER_LOCUS = 9 + 9 + 21 + 16
