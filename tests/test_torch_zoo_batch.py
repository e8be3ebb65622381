"""The batched path of KZ (strelka_tpu_torch/ops/zoo_kernels.py: a tool
run's fit starts side by side, one thread-block cluster a start) on the
CPU: the work list, KZ's grid rule and the launches a run makes; tools
estimate-parameters against the JAX package's on a multi-context counts
file; ZooBatch and models/error_zoo.fit_contexts on a fake card whose C
entries run zoo_fit_model (the launches counted, a failed launch raising
with no fallback); and the lane-split combine of the step's tail against
the one-lane order it replaced, bit for bit; and a flat fit, whose
field moves with the order of the loss's sums alone. The kernels
themselves run on a card only (tests/test_torch_cuda.py -k kz).

Bounds: the tool's fields within FIT_RTOL of the JAX package's, as
tests/test_torch_error_zoo.py states it (the plain fit's sums against
XLA's), but a flat fit's listed field, which is held between FIT_RTOL
and KZ_FLAT_RTOL; everything else here is exact.
"""
import contextlib
import ctypes
import json

import numpy as np
import pytest
import torch

import strelka_tpu  # noqa: F401  (enables x64)
from strelka_tpu.models import error_zoo as jez
from strelka_tpu.workflow.tools import main as jax_tools
from strelka_tpu_torch.__main__ import main as torch_main
from strelka_tpu_torch.models import error_zoo as tez
from strelka_tpu_torch.models.error_fit import ContextCounts
from strelka_tpu_torch.ops import fit_kernels as fk
from strelka_tpu_torch.ops import zoo_kernels as zk
from strelka_tpu_torch.pipeline import allele_counts as tac
from strelka_tpu_torch.workflow import tools
from tests.test_torch_error_zoo import FIT_RTOL, counts

FAMILIES = list(zk.FAMILIES)
CARD = torch.device("cuda", 0)
RESIDENT = fk.MAX_BLOCKS
# the JAX package's fit function of each family (the tool's calls)
JAX_FITS = {"indy": "fit_indel_indy", "binom_mixture":
            "fit_indel_binom_mixture", "beta_binomial":
            "fit_indel_beta_binomial", "indy_noovl": "fit_indel_indy_noovl",
            "binom_mixture_noovl": "fit_indel_binom_mixture_noovl"}
KIND_FAMILY = {(zk.KINDS[f.kernel], int(f.clean)): k
               for k, f in zk.FAMILIES.items()}


def cut(cc, n):
    return ContextCounts(cc.ref_obs[:n], cc.alt_obs[:n],
                         cc.instance_count[:n])


@pytest.mark.parametrize("family", FAMILIES)
def test_kz_grid_rule_at_its_edges(family):
    """kz_grid: one cluster of up to 16 blocks at the fewest loci a
    thread it takes (ceil(n / 4096)), no empty block, while that is at
    most the family's cluster_per (itself at most on_chip_per); past it
    fit_kernels.fit_grid's grid, which KE-F keeps."""
    f = zk.FAMILIES[family]
    assert 1 <= f.cluster_per <= f.on_chip_per
    cap = fk.THREADS * zk.CLUSTER_MAX * f.cluster_per
    for n in (1, 255, 256, 257, 4096, 4097, 8192, 8193, cap, cap + 1,
              107_434):
        blocks, per, regime = zk.kz_grid(n, RESIDENT, f)
        if n <= cap:
            assert regime == "cluster", n
            assert per == -(-n // (fk.THREADS * zk.CLUSTER_MAX)), n
            assert blocks <= zk.CLUSTER_MAX
            assert blocks * per * fk.THREADS >= n > (blocks - 1) * per \
                * fk.THREADS
        else:
            assert (blocks, per, regime) == fk.fit_grid(n, RESIDENT,
                                                        f.on_chip_per), n
    with pytest.raises(ValueError):
        zk.kz_grid(0, RESIDENT, f)


@pytest.mark.parametrize("resident", [RESIDENT, 8])
@pytest.mark.parametrize("family", FAMILIES)
def test_work_list_order_offsets_and_launches(family, resident):
    """work_list: every (context, start) in context order and start
    order, each context's patterns after the last's, on kz_grid (the
    5,000-pattern context a 16-block cluster at two loci a thread where
    the family's cluster_per takes it, else fit_grid's, on a card of the
    H100's 264 resident blocks or of 8); launch_groups: the
    cluster-regime starts in one launch padded to the widest cluster,
    starts in work order, whether or not the card holds all those
    clusters at once; each larger start a launch of its own;
    tool_launches counts them."""
    f = zk.FAMILIES[family]
    starts = len(tez.fit_starts(family))
    sizes = [275, 5000, 93, 40_000, 1, 300]
    work = zk.work_list(family, sizes, starts, resident)
    assert [(w.context, w.start) for w in work] == [
        (i, k) for i in range(len(sizes)) for k in range(starts)]
    offsets = np.cumsum([0] + sizes[:-1])
    for w in work:
        assert w.offset == offsets[w.context]
        assert w.n == sizes[w.context]
        assert w.grid == zk.kz_grid(w.n, resident, f)
    assert work[starts].grid == ((10, 2, "cluster") if f.cluster_per >= 2
                                 else fk.fit_grid(5000, resident,
                                                  f.on_chip_per))
    width, batched, large = zk.launch_groups(work)
    in_cluster = [i for i, w in enumerate(work) if w.grid[2] == "cluster"]
    assert large == [i for i, w in enumerate(work)
                     if w.grid[2] != "cluster"]
    widths = sorted({work[i].grid[0] for i in in_cluster})
    if resident == RESIDENT:
        assert {work[i].context for i in large} == (
            {3} if f.cluster_per >= 2 else {1, 3})
        assert widths == ([1, 2, 10] if f.cluster_per >= 2 else [1, 2])
    else:
        assert len(in_cluster) * widths[-1] > resident
    assert (width, batched) == (widths[-1], in_cluster)
    assert zk.tool_launches(family, sizes, starts, resident) == \
        1 + len(large)
    only_large = [work[i] for i in large]
    assert zk.launch_groups(only_large) == (0, [], list(range(len(large))))


def multi_context(seed):
    """A seeded counts file's contexts: three of tests/test_torch_error_zoo
    's patterns, 25 to 60 patterns each."""
    return {(1, 1): counts(seed, n=60)[1], (1, 2): counts(seed + 1,
                                                          n=40)[1],
            (2, 2): counts(seed + 2, n=25)[1]}


JAX_STEPS = 30


@pytest.mark.parametrize("name", list(tools.FITTED_MODELS))
def test_tool_json_on_cpu_matches_jax(monkeypatch, capfd, tmp_path, name):
    """tools estimate-parameters <name> --device cpu on a three-context
    counts file against the JAX package's tool: the same contexts and
    keys, every field within FIT_RTOL; both at JAX_STEPS Adam steps a
    start (each package's fits called with it, for the time)."""
    family, _ = tools.FITTED_MODELS[name]
    path = str(tmp_path / "counts.npz")
    tac.save_context_counts(path, multi_context(3))
    fn = getattr(jez, JAX_FITS[family])
    monkeypatch.setattr(jez, JAX_FITS[family],
                        lambda *a, **k: fn(*a, **k, steps=JAX_STEPS))
    monkeypatch.setitem(tez.STEPS, family, JAX_STEPS)
    capfd.readouterr()
    assert jax_tools(["estimate-parameters", path, name]) == 0
    want = json.loads(capfd.readouterr().out)
    assert torch_main(["tools", "estimate-parameters", path, name,
                       "--device", "cpu"]) == 0
    got = json.loads(capfd.readouterr().out)
    assert list(got) == list(want) == ["unit1_rep1", "unit1_rep2",
                                       "unit2_rep2"]
    for ctx, w in want.items():
        assert list(got[ctx]) == list(w)
        for k, v in w.items():
            assert got[ctx][k] == pytest.approx(v, rel=FIT_RTOL, abs=0), (
                ctx, k)


# the flat fits: test_torch_cuda's tool-run contexts (its "synthetic"
# data, KZ_TOOL_STEPS steps a start) and the fields that the order of the
# loss's sums moves past FIT_RTOL there (KZ_SUM_ORDER_SENSITIVE)
SUM_ORDER_CASES = [("indelBinomialMixtureNoOverlapInsert", i)
                   for i in range(3)] + [("indelBinomialMixture", 2)]


@pytest.mark.parametrize("name,ctx", SUM_ORDER_CASES)
def test_sum_order_moves_a_flat_fit(name, ctx):
    """A fit through KZ's arithmetic (zoo_fit_model on each start's
    kz_grid, the lower final loss kept: the card's bits) and the JAX
    package's fit, each against the port's plain fit on the CPU, on
    test_torch_cuda's synthetic tool-run contexts: every field within
    FIT_RTOL, but the fields of a fit of KZ_SUM_ORDER_SENSITIVE: there
    each is within KZ_FLAT_RTOL, and the first, along which the loss is
    flat, is past FIT_RTOL through KZ's arithmetic and the JAX package's
    alike (measured 5.86e-8 and 1.90e-8 relative on the 93-pattern
    context's noisy-locus rate), while the log likelihood agrees within
    FIT_RTOL. So the order of the sums alone moves such a field; the
    tool's 1e-10 against the CPU holds only off flat directions."""
    from tests.test_torch_cuda import (KZ_FLAT_RTOL, KZ_SUM_ORDER_SENSITIVE,
                                       KZ_TOOL_STEPS, kz_contexts)
    family, is_insert = tools.FITTED_MODELS[name]
    cc = kz_contexts()[ctx]
    steps = KZ_TOOL_STEPS
    plain = tez.fit_contexts(family, [cc], is_insert, False, steps, "cpu")[0]
    obs = tuple(torch.as_tensor(a) for a in tez._host_obs(cc))
    at = zk.state_slots(zk.FAMILIES[family])
    best = None
    for x0 in tez.fit_starts(family):
        st, _ = zk.zoo_fit_model(family, obs, x0,
                                 tez.kernel_consts(family, False), steps,
                                 False, is_insert)
        end = (st[at["params"]].numpy(), float(st[at["final"]]))
        if best is None or end[1] < best[1]:
            best = end
    kz = tez._result(family, *best, False)
    fn = getattr(jez, JAX_FITS[family])
    args = () if family == "binom_mixture" else (is_insert,)
    jx = fn(cc, *args, steps=steps)
    flat = KZ_SUM_ORDER_SENSITIVE.get(("synthetic", name, ctx), ())
    assert list(kz) == list(plain)
    for k, v in plain.items():
        for other in (kz, jx):
            rel = abs(other[k] - v) / abs(v)
            if k in flat:
                assert rel < KZ_FLAT_RTOL, (k, rel)
                if k == flat[0]:
                    assert rel > FIT_RTOL, (k, rel)
            else:
                assert rel <= FIT_RTOL, (k, rel)
    assert "log_lhood" not in flat


def _array(ptr, n, ctype=ctypes.c_double):
    return torch.from_numpy(np.ctypeslib.as_array(
        (ctype * n).from_address(ptr)).copy())


def _write(ptr, t):
    t = t.contiguous()
    ctypes.memmove(ptr, t.data_ptr(), t.numel() * t.element_size())


def _model_state(kind, clean, ptrs, off, n, grid, steps, host, lock, ins,
                 x0):
    """zoo_fit_model's state of one start from a C entry's pointers."""
    family = KIND_FAMILY[(kind, clean)]
    ref, alt, inst, m1, m2 = ptrs
    obs = (_array(ref, off + n)[off:], _array(alt, 6 * (off + n))
           .view(-1, 6)[off:].contiguous(), _array(inst, off + n)[off:],
           _array(m1, off + n, ctypes.c_int64)[off:],
           _array(m2, off + n, ctypes.c_int64)[off:])
    st, _ = zk.zoo_fit_model(family, obs, x0, list(host), steps, bool(lock),
                             bool(ins), grid=grid)
    return st


class FakeCard:
    """zoo_kernels' C entries on CPU tensors: each launch runs
    zoo_fit_model on the start it is given (its grid, steps, flags and
    start state, read through the pointers) and writes the state; `fail`
    gives a batched launch's CUDA error."""

    def __init__(self, fail=0):
        self.fail, self.calls = fail, []

    def function(self, name):
        return getattr(self, name)

    def zoo_fit_batch_launch(self, kind, clean, *a):
        (*ptrs, work, items, width, max_per, steps, host, lock, ins, _bias,
         states, _stream) = a
        self.calls.append(("batch", width, items))
        if self.fail:
            return self.fail
        f = zk.FAMILIES[KIND_FAMILY[(kind, clean)]]
        rows = _array(work, items * 5, ctypes.c_int64).view(items, 5)
        for off, n, blocks, per, slot in rows.tolist():
            assert blocks <= width and per <= max_per <= f.on_chip_per
            at = states + slot * f.state * 8
            x0 = _array(at, f.params)
            _write(at, _model_state(kind, clean, ptrs, off, n, (blocks, per),
                                    steps, host, lock, ins, x0))
        return 0

    def zoo_fit_launch(self, kind, clean, *a):
        (*ptrs, n, blocks, per, steps, host, lock, ins, _bias, state, _loc,
         _part, _arr, _stream) = a
        self.calls.append(("alone", blocks, per))
        f = zk.FAMILIES[KIND_FAMILY[(kind, clean)]]
        _write(state, _model_state(kind, clean, ptrs, 0, n, (blocks, per),
                                   steps, host, lock, ins,
                                   _array(state, f.params)))
        return 0


@pytest.fixture
def fake_card(monkeypatch):
    """Fits asked for on "cuda" take KZ's path on CPU tensors through a
    FakeCard (the card's streams and resident blocks stubbed)."""
    card = FakeCard()

    class Batch(zk.ZooBatch):
        def __init__(self, *a):
            super().__init__(*a[:-1], "cpu")
            self.dev = a[-1]
            for _, run in self.large:
                run.dev = a[-1]
    monkeypatch.setattr(tez.devmod, "resolve", lambda device=None: CARD)
    monkeypatch.setattr(zk, "ZooBatch", Batch)
    monkeypatch.setattr(zk, "function", lambda name: card.function(name))
    monkeypatch.setattr(zk, "resident_blocks", lambda f, dev: RESIDENT)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: type("S", (), {"cuda_stream": 7})())
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(tez, "_fit_plain", lambda *a, **k: pytest.fail(
        "the plain version ran off the CPU"))
    return card


def fake_contexts():
    """Contexts of 1, 2 and 10 cluster blocks and one past the cluster
    (the grid regime)."""
    big = fk.synthetic_counts(9, 130_000, 500)
    return [counts(5, n=300)[1], cut(big, 5000), counts(6, n=90)[1],
            cut(big, 40_000)]


@pytest.mark.parametrize("name", list(tools.FITTED_MODELS))
def test_fake_card_tool_run_launches_and_picks(fake_card, name):
    """fit_contexts as tools estimate-parameters calls it, on a fake card:
    KZ launched tool_launches times (one padded batched launch, then each
    large start alone), every context's record that of its start of
    lower final loss through zoo_fit_model on that start's kz_grid, in
    the counts file's order."""
    family, is_insert = tools.FITTED_MODELS[name]
    f = zk.FAMILIES[family]
    ctxs = fake_contexts()
    steps = 3
    zk.reset()
    got = tez.fit_contexts(family, ctxs, is_insert, False, steps, "cuda")
    starts = len(tez.fit_starts(family))
    sizes = [len(cc.ref_obs) for cc in ctxs]
    large = 1 if f.cluster_per >= 2 else 2
    want_launches = zk.tool_launches(family, sizes, starts, RESIDENT)
    assert want_launches == 1 + large * starts
    assert zk.LAUNCHES[f.kernel] == sum(zk.LAUNCHES.values()) == \
        want_launches == len(fake_card.calls)
    assert [c[0] for c in fake_card.calls] == ["batch"] + \
        ["alone"] * (large * starts)
    c = tez.kernel_consts(family, False)
    at = zk.state_slots(f)
    for cc, g in zip(ctxs, got):
        obs = tuple(torch.as_tensor(a) for a in tez._host_obs(cc))
        grid = zk.kz_grid(len(cc.ref_obs), RESIDENT, f)[:2]
        best = None
        for x0 in tez.fit_starts(family):
            st, _ = zk.zoo_fit_model(family, obs, x0, c, steps, False,
                                     is_insert, grid=grid)
            end = (st[at["params"]].numpy(), float(st[at["final"]]))
            if best is None or end[1] < best[1]:
                best = end
        assert g == tez._result(family, *best, False)


def test_fake_card_padded_launch_keeps_every_start(fake_card,
                                                  monkeypatch):
    """One padded launch at the widest cluster gives each start the
    state of the same start alone (ZooRun: a batched launch of one at its
    own width), on a card of 264 resident blocks and of 8 (the padded
    launch past what the card holds at once)."""
    family, is_insert = tools.FITTED_MODELS["indelIndy"]
    obs = [tez._host_obs(cc) for cc in fake_contexts()[:3]]
    x0s = tez.fit_starts(family)
    c = tez.kernel_consts(family, True)
    for resident in (RESIDENT, 8):
        monkeypatch.setattr(zk, "resident_blocks", lambda f, dev: resident)
        batch = zk.ZooBatch(family, obs, x0s, c, 2, True, is_insert, CARD)
        del fake_card.calls[:]
        batch.launch()
        assert batch.launches == 1
        assert fake_card.calls == [("batch", 10, 3)]
        for i, w in enumerate(batch.work):
            alone = zk.ZooRun(family, tuple(
                t[w.offset:w.offset + w.n] for t in batch.obs), x0s[w.start],
                c, 2, True, is_insert, grid=w.grid)
            alone.dev = CARD
            alone.launch()
            assert fake_card.calls[-1] == ("batch", w.grid[0], 1)
            assert torch.equal(batch.states[i].view(torch.int64),
                               alone.state.view(torch.int64)), (resident, i)


def test_fake_card_failed_launch_raises(fake_card):
    """A batched launch that the card refuses raises RuntimeError: no
    plain fit runs in its place (the fixture fails on one) and nothing
    is counted."""
    fake_card.fail = 700
    zk.reset()
    with pytest.raises(RuntimeError, match="KZ-B batched launch failed: "
                                           "CUDA error 700"):
        tez.fit_contexts("beta_binomial", fake_contexts()[:2], False,
                         device="cuda", steps=2)
    assert zk.LAUNCHES == {"KZ-4": 0, "KZ-3": 0, "KZ-B": 0}


def test_zoo_batch_rejects_what_the_kernel_does_not_take(monkeypatch):
    """ZooBatch raises before any launch on no context or start, a
    context of no pattern, n_steps < 1 or too few constants."""
    monkeypatch.setattr(zk, "resident_blocks", lambda f, dev: RESIDENT)
    obs = [tez._host_obs(counts(5)[1])]
    x0s = tez.fit_starts("indy")
    c = tez.kernel_consts("indy", False)
    empty = [tuple(a[:0] for a in obs[0])]
    for args, match in (((obs, [], c, 3), "a context and a start"),
                        (([], x0s, c, 3), "a context and a start"),
                        ((empty, x0s, c, 3), "no pattern"),
                        ((obs, x0s, c, 0), "n_steps"),
                        ((obs, x0s, c[:-1], 3), "constants")):
        with pytest.raises(ValueError, match=match):
            zk.ZooBatch("indy", *args, False, True, "cpu")


# --------------------------------------------------------------------------
# the lane-split combine against the one-lane order it replaced
# --------------------------------------------------------------------------

def one_lane_scalars(f, x, c, lock_theta):
    """A step's scalars as one lane computed them before the tail was
    spread over the lanes: bounded on each parameter, then the family's
    logs and betaln(alpha, beta) (betaln_grad: both branches, the taken
    one kept) and the priors in order."""
    r = {"lnb": [], "dx": [], "e": []}
    for i in range(f.params):
        lnb, dx, e = zk.bounded(x[i], c[f"lim{i}"])
        r["lnb"].append(lnb)
        r["dx"].append(dx)
        r["e"].append(e)
    e = r["e"]
    if f.kernel == "KZ-4":
        r["wr"] = (1.0 - e[0]) - e[1]
        r["lref"] = torch.log(r["wr"])
        if f.clean:
            r["wc"] = 1.0 - e[2]
            r["lcl"] = torch.log(r["wc"])
    elif f.kernel == "KZ-3":
        r["wr"] = (-e[0]) + 1.0
        r["lref"] = torch.log1p(-e[0])
        if f.clean:
            r["wc"] = (-e[1]) + 1.0
            r["lcl"] = torch.log1p(-e[1])
    else:
        r["alpha"] = e[0] * e[1]
        r["beta"] = e[1] * (1.0 - e[0])
        r["b0"], r["db0a"], r["db0b"] = zk.betaln_grad(r["alpha"], r["beta"])
    if lock_theta:
        r["prior"] = [c["prior_hom"], c["prior_het"], c["prior_noindel"],
                      c["prior_althet"]]
    else:
        lt, th = r["lnb"][-1], e[-1]
        r["wt"] = (1.0 - (th * 1.5 + th * th) if f.kernel == "KZ-4"
                   else 1.0 - th * 1.5)
        r["prior"] = [lt - c["ln2"], lt, torch.log(r["wt"]), lt * 2.0]
    return r


def bits(v):
    t = torch.as_tensor(v, dtype=torch.float64).reshape(-1)
    return t.view(torch.int64).tolist()


# points in x per family: the fits' start, beta-binomial points on both
# of betaln(alpha, beta)'s branches and on a tie, far points
POINTS = {
    "indy": [(-8.5, -8.5, -8.0), (-3.0, -9.0, -5.0), (2.0, -12.0, 1.0)],
    "binom_mixture": [(-8.5, -8.5, 2.2, -8.0), (-3.0, -9.0, -4.6, -5.0),
                      (-6.0, -5.0, 0.0, 1.0)],
    "beta_binomial": [(-8.5, -2.9, -8.0), (-3.0, 1.5, -5.0),
                      (-6.0, -9.0, 0.5), (-1.0, -6.0, -2.0),
                      (0.0, -5.5, -4.0), (30.0, -7.0, -3.0)],
    "indy_noovl": [(-8.5, -8.0), (-2.0, -4.0), (3.0, 1.0)],
    "binom_mixture_noovl": [(-8.5, 2.2, -8.0), (-3.0, -4.6, -5.0),
                            (-6.0, 0.0, 1.0)],
}


@pytest.mark.parametrize("lock", [False, True])
@pytest.mark.parametrize("family", FAMILIES)
def test_lane_split_combine_bit_for_bit_with_one_lane(monkeypatch, family,
                                                      lock):
    """zoo_fit_model's scalars, combine spread over the lanes
    (combine_lanes, joined by lane 0), equal the one-lane order's bit for
    bit at each of the family's POINTS (the beta-binomial's on both
    betaln branches: b below and past 8), and so does a whole 20-step fit
    start with its state."""
    f = zk.FAMILIES[family]
    c = tez.kernel_consts(family, lock)
    cd = dict(zip(zk.CONSTS, c))
    branches = set()
    for x in POINTS[family]:
        xt = torch.tensor(x, dtype=torch.float64)
        got = zk._scalars(f, xt, cd, lock)
        want = one_lane_scalars(f, xt, cd, lock)
        assert sorted(got) == sorted(want)
        for k in want:
            assert bits(torch.stack([torch.as_tensor(v) for v in got[k]])
                        if isinstance(got[k], list) else got[k]) == bits(
                torch.stack([torch.as_tensor(v) for v in want[k]])
                if isinstance(want[k], list) else want[k]), (x, k)
        if f.kernel == "KZ-B":
            branches.add(bool(torch.maximum(got["alpha"], got["beta"]) < 8))
    if f.kernel == "KZ-B":
        assert branches == {True, False}
    p = tez.IndelPatterns.build(counts(5)[1], "cpu")
    obs = (p.ref_obs, p.alt_obs, p.inst, p.max1, p.max2)
    x0 = tez.fit_starts(family)[0]
    st, losses = zk.zoo_fit_model(family, obs, x0, c, 20, lock, False)
    monkeypatch.setattr(zk, "_scalars", one_lane_scalars)
    st1, losses1 = zk.zoo_fit_model(family, obs, x0, c, 20, lock, False)
    assert bits(st) == bits(st1) and bits(losses) == bits(losses1)
