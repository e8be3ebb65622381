"""KZ, the error-model zoo's indel fits as CUDA kernels
(csrc/error_zoo_fit.cu: a tool run's fit starts side by side, one
thread-block cluster a start), and a torch model of their arithmetic.

KZ replaces the step that the JAX package's error_zoo._fit jits
(value_and_grad of a model's negative log likelihood, then optax's Adam
update; XLA, no Pallas). Its plain version in the port is
models/error_zoo._fit_plain: the loss as torch ops, torch.autograd's
backward and utils/special.Adam. Three kernels, each a policy of
csrc/fit_grid.cuh (KE-F's fit, generalised), fit the five families that
`tools estimate-parameters` runs on the device (FAMILIES):

- KZ-4 <clean>: the 4-state mixture, indelIndy (ins, del, theta) and
  indelBinomialMixture (ins, del, noisy, theta);
- KZ-3 <clean>: the NoOverlap 3-state mixture on one indel type,
  indelIndyNoOverlap* (rate, theta) and indelBinomialMixtureNoOverlap*
  (rate, noisy, theta);
- KZ-B: the beta-binomial, indelBetaBinomial* (mean, conc, theta).

A fit start runs whole in its blocks: each locus's parameter-free values
held on chip, n_steps Adam steps (the loss and its closed-form gradient
summed over the loci in fit_grid's order, no float atomics; theta's slot
left as it is where theta is locked), the last step kept, and the loss
once more at the final parameters. A tool run fits every context of a
counts file at once (ZooBatch, from models/error_zoo.fit_contexts): the
patterns uploaded once, concatenated; a work list of every (context,
start) in context and start order, each start on KZ's grid (kz_grid);
the starts that one cluster holds run side by side in one batched launch
padded to the widest of their clusters (cluster c of the launch runs
start c of its list; the clusters need nothing of each other, so a
launch past the card's resident clusters runs them in waves;
launch_groups); each larger start is one launch of its own (ZooRun, the
grid regimes); all on one stream, then one wait. The tool run's
launches: tool_launches, one batched launch plus one a large start. A
start alone in the cluster regime (ZooRun) is a batched launch of one.
A binomial mixture keeps the start of lower final loss, the first on a
tie.

models/error_zoo.fit_contexts runs the plain version on CPU tensors and
KZ on any other device. A wrapper here checks its operands, builds and
binds the library (_build.load) and launches on the tensors' card and its
current stream, and raises on what it does not take and where the build,
the load or the launch fails: nothing falls back to the plain version.
LAUNCHES counts each kernel's launches (batched or not); PLAIN_ON_CUDA
counts the autograd fits run on a card (the plain version asked for
there, and the SNV fits, which have no kernel), which no CLI path makes.

KZ's grid rule (kz_grid): a context stays one cluster of up to 16 blocks
(the H100's non-portable cluster), at up to its family's cluster_per loci
a thread (at most its on_chip_per), before it goes to fit_kernels.fit_grid
(the grid regime, or the global one past what the card holds on chip).
cluster_per is set by measurement: a step of each family in a 16-block
cluster against the grid regime on the same seeded patterns, in turns
(chip_smoke.py phase 15c's kz_rule, NVIDIA H100 80GB HBM3 at 700 W;
PERF.md section 6):
a 16-block cluster at two loci a thread saves 0.25 us a step against
20 grid blocks at 5,000 patterns for indelIndyNoOverlap and ties for
indelIndy (4.509 against 4.504 us), and loses 0.8-3.7 us for the
clean-locus and beta-binomial families, whose terms cost more a locus
than the barrier saves; at three loci a thread or more the cluster
loses for every family. So cluster_per is 2 for KZ-4 <false> and KZ-3
<false>, 1 (the cluster up to 4,096 patterns, as fit_kernels.fit_grid)
for the rest.

zoo_fit_model is KZ's arithmetic as torch ops: the same elementwise
expressions, digamma by the kernel's own algorithm (ATen's, every product
and sum rounded on its own), lgamma, exp, log and log1p as torch's, the
closed-form gradient and the kernel's order of the sums over loci
(fit_kernels.grid_sum on fit_grid's blocks). The tests hold it against the
JAX package on the CPU, and the kernels against it on the card; no path
runs it.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from . import fit_kernels as fk

REPLACES = "strelka_tpu/models/error_zoo.py:294-297"
SOURCE = "error_zoo_fit"
# the kernels, by the C entry's kind
KINDS = {"KZ-4": 0, "KZ-3": 1, "KZ-B": 2}
LAUNCHES = {"KZ-4": 0, "KZ-3": 0, "KZ-B": 0}
PLAIN_ON_CUDA = {"zoo_fit": 0}

# the host doubles of every kernel, in csrc's ZooConsts order: the zoo's
# genotype constants and ln 2, the clean locus's ln rate and ln ref rate,
# the priors of a locked theta, ln of each parameter's limit (in x's
# order; 0 past the family's parameters) and Adam's
CONSTS = ("log_hom_alt", "log_hom_ref", "log_het", "ln2", "log_clean",
          "log_clean_ref", "prior_hom", "prior_het", "prior_noindel",
          "prior_althet", "lim0", "lim1", "lim2", "lim3", "lr", "b1", "b2",
          "omb1", "omb2", "eps")


@dataclass(frozen=True)
class Family:
    """A zoo family's kernel and layout (csrc's zoo_fit_layout): the
    kernel, its clean flag, the rows held a locus, the sums a step, the
    parameters (theta last), the state's doubles, the loci a thread held
    on chip, and KZ's grid rule: the loci a thread that a cluster of
    CLUSTER_MAX blocks takes before the grid regime (kz_grid)."""
    kernel: str
    clean: bool
    rows: int
    sums: int
    params: int
    on_chip_per: int
    cluster_per: int

    @property
    def state(self) -> int:
        return 4 * self.params + 2


def _on_chip_per(rows: int) -> int:
    """csrc/fit_grid.cuh's on_chip_per: 96 KB of loci a block."""
    return (96 * 1024) // (rows * 8 * fk.THREADS)


def _family(kernel, clean, rows, sums, params, cluster_per):
    on_chip = _on_chip_per(rows)
    return Family(kernel, clean, rows, sums, params, on_chip,
                  min(cluster_per, on_chip))


CLUSTER_MAX = fk.CLUSTER_MAX
# KZ's grid rule by family: the loci a thread a 16-block cluster takes
# (measured, see the module's docstring)
FAMILIES = {
    "indy": _family("KZ-4", False, 11, 8, 3, 2),
    "binom_mixture": _family("KZ-4", True, 15, 10, 4, 1),
    "indy_noovl": _family("KZ-3", False, 5, 6, 2, 2),
    "binom_mixture_noovl": _family("KZ-3", True, 6, 8, 3, 1),
    "beta_binomial": _family("KZ-B", False, 5, 6, 3, 1),
}


def kz_grid(n: int, resident: int, f: Family) -> tuple[int, int, str]:
    """(blocks, loci a thread, regime) of a fit start of family f over n
    patterns, KZ's rule: one cluster of up to CLUSTER_MAX blocks at the
    fewest loci a thread that it takes, while that is at most
    f.cluster_per; past it fit_kernels.fit_grid on a card that keeps
    `resident` of the kernel's blocks at once."""
    if n < 1:
        raise ValueError(f"kz_grid: wants n >= 1, got {n}")
    per = -(-n // (fk.THREADS * CLUSTER_MAX))
    if per <= f.cluster_per:
        return -(-n // (fk.THREADS * per)), per, "cluster"
    return fk.fit_grid(n, resident, f.on_chip_per)


def state_slots(f: Family) -> dict:
    """The state buffer's slots: the parameters, Adam's moments, the last
    step's loss (at the parameters before it) and gradient, the final
    loss (at the final parameters)."""
    p = f.params
    return {"params": slice(0, p), "mu": slice(p, 2 * p),
            "nu": slice(2 * p, 3 * p), "v": 3 * p,
            "grad": slice(3 * p + 1, 4 * p + 1), "final": 4 * p + 1}


_vp, _ll, _i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_CD = ctypes.POINTER(ctypes.c_double)
_IP = ctypes.POINTER(ctypes.c_int)
# the C functions of csrc/error_zoo_fit.cu
_ARGTYPES = {
    "zoo_fit_layout": [_i, _i, _IP],
    "zoo_fit_resident_blocks": [_i, _i, _IP],
    "zoo_fit_launch": [_i, _i, _vp, _vp, _vp, _vp, _vp, _ll, _i, _i, _i,
                       _CD, _i, _i, _vp, _vp, _vp, _vp, _vp, _vp],
    "zoo_fit_batch_launch": [_i, _i, _vp, _vp, _vp, _vp, _vp, _vp, _i, _i,
                             _i, _i, _CD, _i, _i, _vp, _vp, _vp],
}
_BOUND: dict = {}
_RESIDENT: dict = {}


def reset() -> None:
    """Set every launch and plain-version counter to 0."""
    for d in (LAUNCHES, PLAIN_ON_CUDA):
        for k in d:
            d[k] = 0


def count_plain(dev) -> None:
    """Count an autograd fit where it runs on a card."""
    if torch.device(dev).type == "cuda":
        PLAIN_ON_CUDA["zoo_fit"] += 1


def _c_args(f: Family):
    return KINDS[f.kernel], int(f.clean)


def function(name: str):
    """C function `name` of csrc/error_zoo_fit.cu (_ARGTYPES), bound with
    ctypes; builds the source first if stale, and at the first bind holds
    FAMILIES' layouts to the library's. Raises where the build, the load
    or that check fails."""
    if name not in _BOUND:
        from .. import _build
        lib = _build.load(SOURCE)
        for n, types in _ARGTYPES.items():
            fn = getattr(lib, n)
            fn.restype = ctypes.c_int
            fn.argtypes = types
        out = (ctypes.c_int * 5)()
        for key, f in FAMILIES.items():
            rc = lib.zoo_fit_layout(*_c_args(f), out)
            want = [f.rows, f.sums, f.params, f.state, f.on_chip_per]
            if rc != 0 or list(out) != want:
                raise RuntimeError(f"KZ: csrc's layout of {key} is "
                                   f"{list(out)} (rc {rc}), FAMILIES has "
                                   f"{want}")
        for n in _ARGTYPES:
            _BOUND[n] = getattr(lib, n)
    return _BOUND[name]


def resident_blocks(f: Family, dev) -> int:
    """The co-resident blocks of f's kernel on card `dev` (at most
    fit_kernels.MAX_BLOCKS), asked once a card and kernel; builds the
    library first. Raises where the card keeps none."""
    dev = torch.device(dev)
    key = (dev, f.kernel, f.clean)
    if key not in _RESIDENT:
        fn = function("zoo_fit_resident_blocks")
        if dev.type != "cuda":
            raise ValueError(f"{f.kernel}: unsupported device {dev}")
        out = ctypes.c_int(0)
        with torch.cuda.device(dev):
            rc = fn(*_c_args(f), ctypes.byref(out))
        if rc != 0 or out.value < 1:
            raise RuntimeError(f"{f.kernel}: the card keeps {out.value} "
                               f"blocks resident (CUDA error {rc})")
        _RESIDENT[key] = out.value
    return _RESIDENT[key]


def _check_obs(name, obs) -> int:
    """obs = (ref_obs [N], alt_obs [N, 6], inst [N] float64, max1 [N],
    max2 [N] int64) contiguous on one device, N >= 1: returns N."""
    if len(obs) != 5:
        raise ValueError(f"{name}: wants (ref_obs, alt_obs, inst, max1, "
                         f"max2), got {len(obs)} tensors")
    ref = obs[0]
    n = ref.shape[0] if ref.dim() == 1 else -1
    if n < 1:
        raise ValueError(f"{name}: ref_obs must be [N], N >= 1, got "
                         f"{tuple(ref.shape)}")
    for label, t, shape, dtype in zip(
            ("ref_obs", "alt_obs", "inst", "max1", "max2"), obs,
            ((n,), (n, 6), (n,), (n,), (n,)),
            (torch.float64,) * 3 + (torch.int64,) * 2):
        if t.device != ref.device:
            raise ValueError(f"{name}: {label} is on {t.device}, ref_obs on "
                             f"{ref.device}")
        if t.dtype != dtype:
            raise ValueError(f"{name}: {label} must be {dtype}, got "
                             f"{t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: {label} has shape {tuple(t.shape)}, "
                             f"wants {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {label} must be contiguous")
    return n


def _host_consts(consts):
    if len(consts) != len(CONSTS):
        raise ValueError(f"KZ takes {len(CONSTS)} constants, got "
                         f"{len(consts)}")
    return (ctypes.c_double * len(CONSTS))(*map(float, consts))


class ZooRun:
    """One fit start's operands of family `family`'s kernel on the
    observations' card, checked, allocated and bound once, holding the
    observations; launch() runs the whole fit from the state as it
    stands, reset() puts the start back for another launch. obs as
    _check_obs takes it; params [f.params] the start; the CONSTS doubles;
    n_steps >= 1; lock_theta and is_insert the kernel's flags. On the
    card: the state (f.state float64, state_slots: the parameters, zero
    moments; every slot after a launch), the bias corrections [n_steps, 2]
    (1 - b1**t, 1 - b2**t by Python's **) and the barrier's two counters
    in one buffer; in the cluster regime the work row of a batched launch
    of one start (zoo_fit_batch_launch: the kernel that the tool runs),
    past it the block partials [2, blocks, f.sums] and, in the global
    regime, loc [f.rows, N] (zoo_fit_launch). The grid is kz_grid(N,
    resident_blocks, f); `grid` (blocks, per, regime) replaces it (a
    batch's large starts, and to measure a regime where kz_grid picks
    another)."""

    def __init__(self, family: str, obs, params, consts, n_steps: int,
                 lock_theta: bool, is_insert: bool = True, grid=None):
        f = FAMILIES[family]
        name = f.kernel
        n = _check_obs(name, obs)
        if n_steps < 1:
            raise ValueError(f"{name}: n_steps must be >= 1, got {n_steps}")
        host = _host_consts(consts)
        dev = obs[0].device
        if grid is None:
            grid = kz_grid(n, resident_blocks(f, dev), f)
        blocks, per, regime = grid
        if not (blocks >= 1 and per >= 1 and blocks * per * fk.THREADS >= n
                and regime in fk.REGIMES
                and (regime == "global") == (per > f.on_chip_per)):
            raise ValueError(f"{name}: grid {tuple(grid)} does not cover "
                             f"{n} loci in a regime of the kernel")
        if (n_steps + 1) * blocks > fk.MAX_ARRIVALS:
            raise ValueError(f"{name}: {n_steps} steps of {blocks} blocks "
                             f"overflow the barrier's counter")
        self.family, self.grid, self.dev = f, tuple(grid), dev
        self.n_steps, self.host = n_steps, host
        self.flags = (int(lock_theta), int(is_insert))
        c = dict(zip(CONSTS, consts))
        io = fk.start_io(params, f.state, n_steps, c["b1"], c["b2"])
        self._start, io = io, io.to(dev, copy=True)
        # the launch reads these through their addresses
        self._obs = tuple(obs)
        self.state = io[:f.state]
        self.bias = io[f.state:f.state + 2 * n_steps]
        self.arrivals = io[f.state + 2 * n_steps:]
        f64 = dict(dtype=torch.float64, device=dev)
        self.partials = (torch.empty((2, blocks, f.sums), **f64)
                         if regime != "cluster" else None)
        self.loc = (torch.empty((f.rows, n), **f64)
                    if regime == "global" else None)
        self.work = (torch.tensor([0, n, blocks, per, 0], dtype=torch.int64,
                                  device=dev)
                     if regime == "cluster" else None)
        obs_at = [o.data_ptr() for o in obs]
        if regime == "cluster":
            self._entry = "zoo_fit_batch_launch"
            self._args = [*_c_args(f), *obs_at, self.work.data_ptr(), 1,
                          blocks, per, n_steps, host, *self.flags,
                          self.bias.data_ptr(), self.state.data_ptr()]
        else:
            self._entry = "zoo_fit_launch"
            self._args = [*_c_args(f), *obs_at, n, blocks, per, n_steps,
                          host, *self.flags, self.bias.data_ptr(),
                          self.state.data_ptr(),
                          None if self.loc is None else self.loc.data_ptr(),
                          self.partials.data_ptr(),
                          self.arrivals.data_ptr()]
        self._io = io

    def launch(self) -> None:
        """One launch of the whole fit start on the state as it stands;
        raises where the build or the load fails, the tensors are on no
        card or the launch fails."""
        name = self.family.kernel
        fn = function(self._entry)
        if self.dev.type != "cuda":
            raise ValueError(f"{name}: unsupported device {self.dev}")
        with torch.cuda.device(self.dev):
            rc = fn(*self._args,
                    torch.cuda.current_stream(self.dev).cuda_stream)
        if rc != 0:
            what = "batched launch" if self.work is not None else "launch"
            raise RuntimeError(f"{name} {what} failed: CUDA error {rc}")
        LAUNCHES[name] += 1

    def reset(self) -> None:
        """The state, bias table and counters as before the first launch
        (one copy from the host on the card's current stream)."""
        self._io.copy_(self._start)


@dataclass(frozen=True)
class Start:
    """A fit start of a tool run's work list: its context and start (in
    the run's order), its patterns' first row in the concatenated
    observations, its patterns and its grid (kz_grid)."""
    context: int
    start: int
    offset: int
    n: int
    grid: tuple


def work_list(family: str, sizes, starts: int, resident: int) -> list:
    """Every (context, start) of a tool run over contexts of `sizes`
    patterns (in the counts file's order) with `starts` starts each, in
    context order and start order, each on kz_grid(n, resident, f)."""
    f = FAMILIES[family]
    out, offset = [], 0
    for i, n in enumerate(sizes):
        grid = kz_grid(n, resident, f)
        out += [Start(i, k, offset, n, grid) for k in range(starts)]
        offset += n
    return out


def launch_groups(work):
    """A work list's launches: (the batched launch's cluster width, its
    start indices, the indices of the starts launched alone). The
    cluster-regime starts go side by side in one batched launch at the
    widest of their clusters (0 where there is none), in work order, a
    narrower start's extra blocks only meeting its barriers; each start
    of another regime is one launch of its own, in work order. (One
    padded launch took 2.03-7.60 ms where one batched launch a cluster
    width took 3.61-13.80, on an H100 at 700 W, phase 15's files;
    PERF.md section 6.)"""
    cluster = [i for i, w in enumerate(work) if w.grid[2] == "cluster"]
    large = [i for i, w in enumerate(work) if w.grid[2] != "cluster"]
    width = max((work[i].grid[0] for i in cluster), default=0)
    return width, cluster, large


def tool_launches(family: str, sizes, starts: int, resident: int) -> int:
    """KZ's launches in a tool run of `family` over contexts of `sizes`
    patterns with `starts` starts each, on a card that keeps `resident`
    of the kernel's blocks at once: one batched launch of its
    cluster-regime starts, plus one a large fit start (launch_groups)."""
    _, batched, large = launch_groups(work_list(family, sizes, starts,
                                                resident))
    return int(bool(batched)) + len(large)


class ZooBatch:
    """A tool run's fit starts of family `family`'s kernel on card `dev`,
    bound once: obs, each context's (ref_obs [n], alt_obs [n, 6], inst [n]
    float64, max1, max2 [n] int64) on the host, n >= 1; starts, the start
    parameters (each [f.params]), run on every context in order; the
    CONSTS doubles, n_steps >= 1 and the kernel's flags as ZooRun's. The
    work list is work_list's (kz_grid on the card's resident blocks), its
    launches launch_groups'. On the card, uploaded once: the observations
    concatenated, every start's state ([starts in the list, f.state]:
    the parameters, zero moments) and the bias corrections in one float64
    buffer, the alt slots' indices and the batched launch's work rows
    (fit_grid.cuh's kWorkCols: first pattern, patterns, blocks, loci a
    thread, state slot) in one int64 buffer; a large start's operands as
    ZooRun's, on slices of the same observations. launch() runs every
    start, ends() waits once and reads them back, reset() puts every
    start back. Raises where the build or the load fails (first, at the
    resident blocks' query), the tensors are on no card or a launch
    fails: nothing falls back."""

    def __init__(self, family: str, obs, starts, consts, n_steps: int,
                 lock_theta: bool, is_insert: bool, dev):
        f = FAMILIES[family]
        dev = torch.device(dev)
        if not obs or not starts:
            raise ValueError(f"{f.kernel}: wants a context and a start")
        if n_steps < 1:
            raise ValueError(f"{f.kernel}: n_steps must be >= 1, got "
                             f"{n_steps}")
        host = _host_consts(consts)
        resident = resident_blocks(f, dev)
        cols = [[torch.as_tensor(a) for a in o] for o in obs]
        sizes = [len(o[0]) for o in cols]
        if min(sizes) < 1:
            raise ValueError(f"{f.kernel}: a context has no pattern")
        self.family, self.dev, self.n_steps = f, dev, n_steps
        self.work = work_list(family, sizes, len(starts), resident)
        self.width, self.batched, large = launch_groups(self.work)
        n, items, st = sum(sizes), len(self.work), f.state
        c = dict(zip(CONSTS, consts))
        f64 = torch.zeros(8 * n + items * st + 2 * n_steps,
                          dtype=torch.float64)
        f64[:n] = torch.cat([o[0] for o in cols])
        f64[n:7 * n] = torch.cat([o[1] for o in cols]).reshape(-1)
        f64[7 * n:8 * n] = torch.cat([o[2] for o in cols])
        states = f64[8 * n:8 * n + items * st].view(items, st)
        for i, w in enumerate(self.work):
            states[i, :f.params] = torch.as_tensor(starts[w.start],
                                                   dtype=torch.float64)
        f64[8 * n + items * st:] = fk.bias_table(n_steps, c["b1"], c["b2"])
        rows = [[w.offset, w.n, w.grid[0], w.grid[1], i]
                for i in self.batched for w in (self.work[i],)]
        i64 = torch.cat([torch.cat([o[3] for o in cols]),
                         torch.cat([o[4] for o in cols]),
                         torch.tensor(rows, dtype=torch.int64).reshape(-1)])
        self._start = states.clone()
        fd, idev = f64.to(dev), i64.to(dev)
        self._bufs = (fd, idev)
        self.obs = (fd[:n], fd[n:7 * n].view(n, 6), fd[7 * n:8 * n],
                    idev[:n], idev[n:2 * n])
        self.states = fd[8 * n:8 * n + items * st].view(items, st)
        bias = fd[8 * n + items * st:]
        self._args = [
            *_c_args(f), *(o.data_ptr() for o in self.obs),
            idev[2 * n:].data_ptr(), len(rows), self.width,
            max((r[3] for r in rows), default=0), n_steps, host,
            int(lock_theta), int(is_insert), bias.data_ptr(),
            self.states.data_ptr()] if rows else None
        self.large = [(i, ZooRun(family, tuple(
            o[w.offset:w.offset + w.n] for o in self.obs),
            starts[w.start], consts, n_steps, lock_theta, is_insert,
            grid=w.grid)) for i in large for w in (self.work[i],)]

    @property
    def launches(self) -> int:
        """A launch() call's launches (tool_launches)."""
        return int(self._args is not None) + len(self.large)

    def launch(self) -> None:
        """Every start from its state as it stands, on the card's current
        stream: the batched launch, then each large start's (its state
        copied into its slot of .states)."""
        name = self.family.kernel
        fn = function("zoo_fit_batch_launch")
        if self.dev.type != "cuda":
            raise ValueError(f"{name}: unsupported device {self.dev}")
        if self._args is not None:
            with torch.cuda.device(self.dev):
                rc = fn(*self._args,
                        torch.cuda.current_stream(self.dev).cuda_stream)
            if rc != 0:
                raise RuntimeError(f"{name} batched launch failed: CUDA "
                                   f"error {rc}")
            LAUNCHES[name] += 1
        for i, run in self.large:
            run.launch()
            self.states[i].copy_(run.state)

    def ends(self) -> list:
        """Each context's starts after launch(), in start order: [[(the
        parameters [f.params] float64 numpy, the final loss)]], read back
        in one copy."""
        st = self.states.cpu()
        at = state_slots(self.family)
        out: list = [[] for _ in range(self.work[-1].context + 1)]
        for w, row in zip(self.work, st):
            out[w.context].append((row[at["params"]].numpy(),
                                   float(row[at["final"]])))
        return out

    def reset(self) -> None:
        """Every start's state as before the first launch."""
        self.states.copy_(self._start)
        for _, run in self.large:
            run.reset()


# --------------------------------------------------------------------------
# the kernels' arithmetic as torch ops (tests and chip_smoke.py only)
# --------------------------------------------------------------------------

PSI_10 = 2.25175258906672110764
_DIGAMMA_A = (8.33333333333333333333E-2, -2.10927960927960927961E-2,
              7.57575757575757575758E-3, -4.16666666666666666667E-3,
              3.96825396825396825397E-3, -8.33333333333333333333E-3,
              8.33333333333333333333E-2)


def digamma(x):
    """KZ's digamma: ATen's algorithm (the recurrence up to x >= 10,
    PSI_10 at 10, the asymptotic series past it), every product and sum
    rounded on its own; -inf at 0, NaN below 0 (which the fits never
    reach) and at NaN."""
    z0 = x == 0
    ok = x > 0
    result = torch.zeros_like(x)
    for _ in range(10):
        m = x < 10
        result = torch.where(m, result - 1.0 / x, result)
        x = torch.where(m, x + 1.0, x)
    z = 1.0 / (x * x)
    p = torch.zeros_like(x)
    for a in _DIGAMMA_A:
        p = p * z + a
    y = torch.where(x < 1e17, z * p, torch.zeros_like(x))
    out = ((result + torch.log(x)) - 0.5 / x) - y
    out = torch.where(x == 10, result + PSI_10, out)
    out = torch.where(ok, out, torch.full_like(x, float("nan")))
    return torch.where(z0, torch.full_like(x, -float("inf")), out)


def algdiv_grad(a, b):
    """special._algdiv(a, b) in its order (b >= 8, a <= b) and its partial
    derivatives in a and b, as csrc's algdiv."""
    c0, c1, c2 = 0.833333333333333e-01, -0.277777777760991e-02, \
        0.793650666825390e-03
    c3, c4, c5 = -0.595202931351870e-03, 0.837308034031215e-03, \
        -0.165322962780713e-02
    h = a / b
    op = 1.0 + h
    x = h / op
    d = b + (a - 0.5)
    x2 = x * x
    s3 = 1.0 + (x + x2)
    s5 = 1.0 + (x + x2 * s3)
    s7 = 1.0 + (x + x2 * s5)
    s9 = 1.0 + (x + x2 * s7)
    s11 = 1.0 + (x + x2 * s9)
    rb = 1.0 / b
    t = rb * rb
    wp = (c5 * s11) * t + c4 * s9
    wp = wp * t + c3 * s7
    wp = wp * t + c2 * s5
    wp = wp * t + c1 * s3
    wp = wp * t + c0
    q = x / b
    w = wp * q
    lp = torch.log1p(a / b)
    u = d * lp
    lb = torch.log(b)
    v = a * (lb - 1.0)
    val = torch.where(u <= v, (w - v) - u, (w - u) - v)
    x2d = 2.0 * x
    ds3 = 1.0 + x2d
    ds5 = 1.0 + (x2d * s3 + x2 * ds3)
    ds7 = 1.0 + (x2d * s5 + x2 * ds5)
    ds9 = 1.0 + (x2d * s7 + x2 * ds7)
    ds11 = 1.0 + (x2d * s9 + x2 * ds9)
    wx = (c5 * ds11) * t + c4 * ds9
    wx = wx * t + c3 * ds7
    wx = wx * t + c2 * ds5
    wx = wx * t + c1 * ds3
    wx = wx * t
    wt = (5.0 * c5) * (s11 * t) + 4.0 * (c4 * s9)
    wt = wt * t + 3.0 * (c3 * s7)
    wt = wt * t + 2.0 * (c2 * s5)
    wt = wt * t + c1 * s3
    dh_db = -(h * rb)
    dx_dh = 1.0 / (op * op)
    dx_da, dx_db = dx_dh * rb, dx_dh * dh_db
    dt_db = -((2.0 * t) * rb)
    dw_da = (wx * dx_da) * q + wp * (dx_da * rb)
    dw_db = (wx * dx_db + wt * dt_db) * q + wp * (dx_db * rb - q * rb)
    du_da = lp + d * (rb / op)
    du_db = lp + d * (dh_db / op)
    da = (dw_da - (lb - 1.0)) - du_da
    db = (dw_db - a * rb) - du_db
    return val, da, db


def betaln_grad(x, y):
    """special.betaln(x, y) (both branches evaluated, the one taken kept)
    and its partial derivatives in x and y through the branch taken and
    torch.minimum/maximum (halves on a tie), as csrc's betaln."""
    a, b = torch.minimum(x, y), torch.maximum(x, y)
    lga = torch.lgamma(a)
    s = a + b
    ps = digamma(s)
    pa = digamma(a)
    small = b < 8
    ad, ada, adb = algdiv_grad(a, b)
    val = torch.where(small, lga + (torch.lgamma(b) - torch.lgamma(s)),
                      lga + ad)
    ga = torch.where(small, pa - ps, pa + ada)
    gb = torch.where(small, digamma(b) - ps, adb)
    tie = ga * 0.5 + gb * 0.5
    lt = x < y
    dx = torch.where(x == y, tie, torch.where(lt, ga, gb))
    dy = torch.where(x == y, tie, torch.where(lt, gb, ga))
    return val, dx, dy


def _replace_inf(x):
    return torch.where(x == float("inf"), torch.zeros_like(x), x)


def bounded(x, lim: float):
    """(lnb, dx, e) of a parameter x (0-d float64): lnb = lim +
    log_sigmoid(x) as error_zoo._ln_bounded computes it, dx = d lnb / d x
    (special._LogAddExp's backward), e = exp(lnb)."""
    x1 = -x
    d = x1 - 0.0
    sp = torch.where(torch.isnan(d), x1 + 0.0,
                     torch.maximum(x1, torch.zeros_like(x1))
                     + torch.log1p(torch.exp(-torch.abs(d))))
    lnb = lim + (-sp)
    return lnb, torch.exp(_replace_inf(x1) - _replace_inf(sp)), \
        torch.exp(lnb)


def _lse(t):
    """(log|s| + m, the exps [K, N], s) of special.logsumexp over t [K,
    N]: the max (0 where not finite), the exps summed in order."""
    m = torch.amax(t, dim=0)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    e = torch.exp(t - m)
    s = e[0]
    for k in range(1, t.shape[0]):
        s = s + e[k]
    return torch.log(torch.abs(s)) + m, e, s


def _lse_grad(g, s, e):
    return ((g / torch.abs(s)) * torch.sign(s)) * e


def _mix2(x1, x2, g):
    """jnp.logaddexp(x1, x2) and its custom JVP's factors times g."""
    d = x1 - x2
    mix = torch.where(torch.isnan(d), x1 + x2, torch.maximum(x1, x2)
                      + torch.log1p(torch.exp(-torch.abs(d))))
    ro = _replace_inf(mix)
    return (mix, g * torch.exp(_replace_inf(x1) - ro),
            g * torch.exp(_replace_inf(x2) - ro))


def prep_model(family: str, obs, consts, is_insert: bool = True):
    """The loci's parameter-free rows [f.rows, N] of family's kernel (its
    prep), as torch ops on obs's device."""
    f = FAMILIES[family]
    c = dict(zip(CONSTS, consts))
    ref, alt, inst, m1, m2 = obs
    ins = (alt[:, 0] + alt[:, 1]) + alt[:, 2]
    dele = (alt[:, 3] + alt[:, 4]) + alt[:, 5]
    lha, lhr, lh = c["log_hom_alt"], c["log_hom_ref"], c["log_het"]
    lc, lcr = c["log_clean"], c["log_clean_ref"]
    if f.kernel == "KZ-4":
        zero = torch.zeros_like(ref)
        a1 = torch.gather(alt, 1, m1[:, None])[:, 0]
        a2 = torch.gather(alt, 1, m2[:, None])[:, 0]
        ri1 = ins - torch.where(m1 < 3, a1, zero)
        rd1 = dele - torch.where(m1 < 3, zero, a1)
        ri2 = ri1 - torch.where(m2 < 3, a2, zero)
        rd2 = rd1 - torch.where(m2 < 3, zero, a2)
        hom = lha * a1 + lhr * ref
        het = lh * (ref + a1)
        alth = lh * (a1 + a2) + lhr * ref
        rows = [ref, ins, dele, ri1, rd1, ri2, rd2, hom, het, alth, inst]
        if f.clean:
            rows += [(hom + lc * ri1) + lc * rd1, (het + lc * ri1) + lc * rd1,
                     (lc * ins + lc * dele) + lcr * ref,
                     (alth + lc * ri2) + lc * rd2]
    else:
        k = ins if is_insert else dele
        rows = [ref, k, lh * (ref + k), lha * k + lhr * ref, inst]
        if f.clean:
            rows.append(lc * k + lcr * ref)
    return torch.stack(rows)


def _terms(f: Family, v, r):
    """The per-locus terms [f.sums, N] at the step's scalars r."""
    g = -v[4] if f.kernel != "KZ-4" else -v[10]
    pr = r["prior"]
    if f.kernel == "KZ-4":
        (ref, ins, dele, ri1, rd1, ri2, rd2, hom, het, alth, w) = v[:11]
        li, ld = r["lnb"][0], r["lnb"][1]
        pi, pd = li * ri1, ld * rd1
        noisy, e, s = _lse(torch.stack([
            pr[0] + ((hom + pi) + pd), pr[1] + ((het + pi) + pd),
            pr[2] + ((li * ins + ld * dele) + r["lref"] * ref),
            pr[3] + ((alth + li * ri2) + ld * rd2)]))
        if f.clean:
            clean, ec, sc = _lse(torch.stack([pr[k] + v[11 + k]
                                              for k in range(4)]))
            mix, g1, g2 = _mix2(r["lcl"] + clean, r["lnb"][2] + noisy, g)
            gc = _lse_grad(g1, sc, ec)
        else:
            mix, g2 = noisy, g
        gk = _lse_grad(g2, s, e)
        out = [mix * w, ((gk[0] * ri1 + gk[1] * ri1) + gk[2] * ins)
               + gk[3] * ri2,
               ((gk[0] * rd1 + gk[1] * rd1) + gk[2] * dele) + gk[3] * rd2,
               gk[2] * ref]
        out += [gk[k] + gc[k] if f.clean else gk[k] for k in range(4)]
        if f.clean:
            out += [g1, g2]
        return torch.stack(out)
    ref, k, het, hom, w = v[:5]
    if f.kernel == "KZ-3":
        t = [pr[0] + hom, pr[1] + het,
             pr[2] + (r["lnb"][0] * k + r["lref"] * ref)]
        noisy, e, s = _lse(torch.stack(t))
        if f.clean:
            clean, ec, sc = _lse(torch.stack(t[:2] + [pr[2] + v[5]]))
            mix, g1, g2 = _mix2(r["lcl"] + clean, r["lnb"][1] + noisy, g)
            gc = _lse_grad(g1, sc, ec)
        else:
            mix, g2 = noisy, g
        gk = _lse_grad(g2, s, e)
        out = [mix * w, gk[2] * k, gk[2] * ref]
        out += [gk[j] + gc[j] if f.clean else gk[j] for j in range(3)]
        if f.clean:
            out += [g1, g2]
        return torch.stack(out)
    bl, da, db = betaln_grad(k + r["alpha"], ref + r["beta"])
    mix, e, s = _lse(torch.stack([pr[0] + hom, pr[1] + het,
                                  pr[2] + (bl - r["b0"])]))
    gk = _lse_grad(g, s, e)
    return torch.stack([mix * w, gk[2] * da, gk[2] * db, gk[2], gk[0],
                        gk[1]])


def _theta_chain(ph, pe, pn, pa, r, slot: int, alt_het: bool):
    th = r["e"][slot]
    h = -(pn / r["wt"])
    if alt_het:
        gth = h * 1.5 + (h * th + h * th)
        return ((ph + pe) + pa * 2.0) + gth * th
    return (ph + pe) + (h * 1.5) * th


def _chain(f: Family, i: int, tot, r):
    """d loss / d lnb_i from the step's sums tot (csrc's chain)."""
    theta = f.params - 1
    e = r["e"]
    if f.kernel == "KZ-4":
        if i < 2:
            return tot[1 + i] + (-(tot[3] / r["wr"])) * e[i]
        if f.clean and i == 2:
            return tot[9] + (-(tot[8] / r["wc"])) * e[2]
        return _theta_chain(tot[4], tot[5], tot[6], tot[7], r, theta, True)
    if f.kernel == "KZ-3":
        if i == 0:
            return tot[1] + (-(tot[2] / r["wr"])) * e[0]
        if f.clean and i == 1:
            return tot[7] + (-(tot[6] / r["wc"])) * e[1]
        return _theta_chain(tot[3], tot[4], tot[5], None, r, theta, False)
    if i < 2:
        ga = tot[1] - tot[3] * r["db0a"]
        gb = tot[2] - tot[3] * r["db0b"]
        mean, conc = e[0], e[1]
        if i == 0:
            return (ga * conc + (-(gb * conc))) * mean
        return (ga * mean + gb * (1.0 - mean)) * conc
    return _theta_chain(tot[4], tot[5], tot[3], None, r, theta, False)


def combine_lanes(f: Family, e) -> dict:
    """csrc's combine spread over warp 0's lanes: each independent
    transcendental of the next step's scalars on its own lane, from the
    parameters' e = exp(lnb) (0-d float64 each), {lane: value}: KZ-4
    log(wr), log(wc) on lanes 0 and 1; KZ-3 log1p(-e_rate),
    log1p(-e_noisy); KZ-B lgamma of betaln(alpha, beta)'s a, b and s on
    lanes 0-2 (algdiv(a, b)'s value and partials on lane 1 past b < 8)
    and digamma of a, b and s on lanes 3-5; the no-indel prior's log(wt)
    on lane 2 (KZ-4, KZ-3) or 6 (KZ-B). Lanes whose value the join does
    not read (a branch not taken, a clean locus or theta the family has
    not) are computed all the same, as on the card."""
    th = e[-1]
    if f.kernel == "KZ-4":
        wt = 1.0 - (th * 1.5 + th * th)
        wc = 1.0 - e[2] if f.clean else torch.ones_like(th)
        return {0: torch.log((1.0 - e[0]) - e[1]), 1: torch.log(wc),
                2: torch.log(wt)}
    wt = 1.0 - th * 1.5
    if f.kernel == "KZ-3":
        return {0: torch.log1p(-e[0]), 1: torch.log1p(-e[1]),
                2: torch.log(wt)}
    alpha, beta = e[0] * e[1], e[1] * (1.0 - e[0])
    a, b = torch.minimum(alpha, beta), torch.maximum(alpha, beta)
    s = a + b
    lanes = {0: torch.lgamma(a), 2: torch.lgamma(s), 3: digamma(a),
             4: digamma(b), 5: digamma(s), 6: torch.log(wt)}
    lanes[1] = (algdiv_grad(a, b) if not bool(b < 8)
                else (torch.lgamma(b), None, None))
    return lanes


def _join_beta(x, y, lanes):
    """betaln(x, y) and its partials from combine_lanes' KZ-B lanes, in
    csrc's betaln_join order."""
    a, b = torch.minimum(x, y), torch.maximum(x, y)
    lg1, ada, adb = lanes[1]
    if bool(b < 8):
        val = lanes[0] + (lg1 - lanes[2])
        ga, gb = lanes[3] - lanes[5], lanes[4] - lanes[5]
    else:
        val = lanes[0] + lg1
        ga, gb = lanes[3] + ada, adb
    if bool(x == y):
        return val, ga * 0.5 + gb * 0.5, ga * 0.5 + gb * 0.5
    return (val, ga, gb) if bool(x < y) else (val, gb, ga)


def _scalars(f: Family, x, c: dict, lock_theta: bool) -> dict:
    """A step's scalars from the parameters x [f.params] (csrc's bounded
    on each parameter, then combine: combine_lanes' values joined by lane
    0)."""
    r = {"lnb": [], "dx": [], "e": []}
    for i in range(f.params):
        lnb, dx, e = bounded(x[i], c[f"lim{i}"])
        r["lnb"].append(lnb)
        r["dx"].append(dx)
        r["e"].append(e)
    e = r["e"]
    lanes = combine_lanes(f, e)
    if f.kernel == "KZ-4":
        r["wr"] = (1.0 - e[0]) - e[1]
        r["lref"] = lanes[0]
        if f.clean:
            r["wc"] = 1.0 - e[2]
            r["lcl"] = lanes[1]
    elif f.kernel == "KZ-3":
        r["wr"] = (-e[0]) + 1.0
        r["lref"] = lanes[0]
        if f.clean:
            r["wc"] = (-e[1]) + 1.0
            r["lcl"] = lanes[1]
    else:
        r["alpha"] = e[0] * e[1]
        r["beta"] = e[1] * (1.0 - e[0])
        r["b0"], r["db0a"], r["db0b"] = _join_beta(r["alpha"], r["beta"],
                                                   lanes)
    if lock_theta:
        r["prior"] = [c["prior_hom"], c["prior_het"], c["prior_noindel"],
                      c["prior_althet"]]
    else:
        lt, th = r["lnb"][-1], e[-1]
        r["wt"] = (1.0 - (th * 1.5 + th * th) if f.kernel == "KZ-4"
                   else 1.0 - th * 1.5)
        r["prior"] = [lt - c["ln2"], lt, lanes[6 if f.kernel == "KZ-B"
                                                else 2], lt * 2.0]
    return r


def zoo_fit_model(family: str, obs, params, consts, n_steps: int,
                  lock_theta: bool, is_insert: bool = True, grid=None):
    """A whole fit start of family's kernel as torch ops on obs's device:
    prep_model's rows, n_steps steps of the per-locus terms summed by
    fit_kernels.grid_sum on `grid` ((blocks, loci a thread); default
    kz_grid(N, MAX_BLOCKS, f)'s), the chains, Adam
    (fit_kernels.adam_update; theta's slot left where lock_theta) and the
    final loss. Returns (the state [f.state] that the kernel writes, the
    losses of every step [n_steps])."""
    f = FAMILIES[family]
    c = dict(zip(CONSTS, consts))
    v = prep_model(family, obs, consts, is_insert)
    dev = v.device
    if grid is None:
        grid = kz_grid(v.shape[1], fk.MAX_BLOCKS, f)[:2]
    x = torch.as_tensor(params, dtype=torch.float64).to(dev).clone()
    mu, nu = torch.zeros_like(x), torch.zeros_like(x)
    zero = torch.zeros((), dtype=torch.float64, device=dev)
    theta = f.params - 1
    r = _scalars(f, x, c, lock_theta)
    losses = []
    for t in range(1, n_steps + 2):
        tot, _ = fk.grid_sum(_terms(f, v, r), *grid)
        if t > n_steps:
            final = -tot[0]
            break
        losses.append(-tot[0])
        # a locked theta's gradient is 0, with which Adam leaves its
        # parameter and zero moments as they are: the kernel's skip
        grad = torch.stack([
            zero if lock_theta and i == theta
            else _chain(f, i, tot, r) * r["dx"][i]
            for i in range(f.params)])
        x, mu, nu = fk.adam_update(x, mu, nu, grad, t, c)
        r = _scalars(f, x, c, lock_theta)
    state = torch.cat([x, mu, nu, losses[-1].reshape(1), grad,
                       final.reshape(1)])
    return state, torch.stack(losses)


# --------------------------------------------------------------------------
# the bound
# --------------------------------------------------------------------------

# float64 values a locus read once: ref_obs, alt_obs' six slots, inst,
# max1 and max2 (int64)
OBS_ROWS = 1 + 6 + 1 + 2

# float64 operations a locus a step, counted from csrc/error_zoo_fit.cu
# (each exp, log, log1p, lgamma, digamma and division one; compares,
# selects, abs and negations not counted), the adds into the sums among
# them. KZ-4: the four terms (7 products, 12 adds), the logsumexp (3 max,
# 4 differences, 4 exps, 3 adds, log, add: 16) and the loss term's
# product (36); the backward (a division and 5 products, 2 x (4 products
# and 3 adds), a product: 21); 8 sums; the clean locus adds its four terms
# (4), logsumexp (16), the two mixtures' inputs (2), the logaddexp (5),
# its factors (2 x 3), the clean logsumexp's backward (6), 4 adds and 2
# sums. KZ-3: 3 terms (2 products, 4 adds), logsumexp (12), the product
# (19); backward (a division and 4 products, 2 products: 7); 6 sums; the
# clean locus: its term (1), logsumexp (12), inputs (2), logaddexp (5),
# factors (6), backward (5), 3 adds, 2 sums. KZ-B without betaln: 2 adds
# into its arguments, the difference with betaln(alpha, beta), 3 terms,
# logsumexp (12), the product, backward (a division and 3 products, 2
# products) and 6 sums (32); betaln itself by its branch (BETALN_*).
F64_PER_LOCUS = {
    "indy": 36 + 21 + 8,
    "binom_mixture": 36 + 21 + 8 + 4 + 16 + 2 + 5 + 6 + 6 + 4 + 2,
    "indy_noovl": 19 + 7 + 6,
    "binom_mixture_noovl": 19 + 7 + 6 + 1 + 12 + 2 + 5 + 6 + 5 + 3 + 2,
    "beta_binomial": 32,
}
# betaln by its branch: below 8, 3 lgamma, 3 adds, 3 digamma and 2
# differences; past it, lgamma, algdiv's value (48) and derivatives (82),
# 2 adds and a digamma; a tie's halves 3 more
BETALN_SMALL = 3 + 3 + 3 + 2
BETALN_LARGE = 1 + 48 + 82 + 2 + 1
# float64 operations of a step's tail a parameter: its bounded scalars
# (8), its chain (up to 9), the chain's product and Adam (14); then the
# family's scalars (at most 12 without betaln)
F64_TAIL_PER_PARAM = 8 + 9 + 1 + 14
F64_TAIL = 12


def fit_work(family: str, n: int, n_steps: int,
             large: int = 0) -> tuple[int, int]:
    """(bytes, float64 operations) that a fit start's function (n_steps
    of the loss, its gradient and Adam, and the final loss; the JAX
    package's jitted step n_steps times) needs at the least over n loci:
    the observations read once (OBS_ROWS a locus), the bias table read and
    the state read and written; F64_PER_LOCUS a locus a step and the
    final pass, the sums' fold over the blocks and the tail. KZ-B adds
    betaln a locus a step, `large` of the loci on its algdiv branch (at
    the fit's final parameters: the branch the data takes there) and the
    rest on its lgamma branch, and betaln(alpha, beta) once a step."""
    f = FAMILIES[family]
    blocks = kz_grid(n, fk.MAX_BLOCKS, f)[0]
    nbytes = OBS_ROWS * 8 * n + 2 * 8 * n_steps + 2 * f.state * 8
    per_locus = F64_PER_LOCUS[family]
    tail = f.params * F64_TAIL_PER_PARAM + F64_TAIL
    ops = (n_steps + 1) * (per_locus * n + f.sums * blocks)
    if f.kernel == "KZ-B":
        ops += (n_steps + 1) * (large * BETALN_LARGE
                                + (n - large) * BETALN_SMALL)
        tail += BETALN_LARGE
    return nbytes, ops + n_steps * tail
