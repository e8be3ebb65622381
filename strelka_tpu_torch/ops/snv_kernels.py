"""The SNV models' CUDA kernels: KG-H (two entries), KG-SB, KG-R, KS-G
and KS-P.

Each replaces one program that the JAX package jits (XLA, no Pallas) and
gives its plain version's bits on the card in one launch:

- KG-H (csrc/snv_hist_tile.cu), the germline SNV genotype tile, in two
  entries of one source:
  - snv_hist_tile, the dense entry: the tile from its (qscore, base)
    histogram [L, 512] (int8 or int32 counts; 512 or 2,048 bytes a row),
    models/snv_digt.call_snv_hist_tile; plain version
    call_snv_hist_tile_plain;
  - snv_lanes_tile, the lanes entry: the tile from the pileup's lanes,
    base [L, D] int8, qual [L, D] int16 (the native pileup's width) or
    uint8 and mask [L, D] bool (4 bytes a lane at int16 qual), whose
    histogram it counts in shared memory,
    models/snv_digt.call_snv_lanes_tile, the card's germline genotype
    pass; plain version call_snv_lanes_tile_plain (_tile_hist, then
    call_snv_hist_tile_plain's arithmetic).
  Both walk a row's live slots only (a zero count adds exactly nothing:
  the table is finite) and spread the float64 tail over the warp's lanes
  (csrc/snv_tile_tail.cuh). Their least time on the H100 is their bytes',
  but the tail's chain of float64 library calls holds them at 18.6% and
  10.9% of it (PERF.md section 6);
- KG-SB, snv_strand_bias_tile (csrc/snv_strand_bias.cu): the strand bias
  of a germline run's SNP rows, in XLA's CPU arithmetic (RNA mode's
  het-VF terms too), models/snv_digt.snv_strand_bias_tile; plain version
  snv_strand_bias_tile_plain;
- KG-R, snv_rna_tile (csrc/snv_rna_tile.cu): RNA mode's genotype tile
  from the lanes (the histogram product in XLA's dot order, the
  dependent-eprob and het-VF sums in its reduction orders, the
  logsumexp, KG-H's tail), the RNA pass of models/snv_digt.call_snv_tile;
  plain version call_snv_rna_tile_plain. KG-SB and KG-R share
  csrc/snv_xla_math.cuh (XLA's exp, log and sum orders); one warp walks
  a row's calls a window at a time, each call decoded once into a row of
  values in shared memory, its sums several to a lane (a term one read
  of the column that the sum's map gives for the call), the
  logsumexps' exps spread over the lanes;
- KS-G, somatic_grid (csrc/somatic_grid.cu): one sample's somatic
  frequency-grid lhoods, models/somatic_snv.freq_grid_lhoods; plain version
  freq_grid_lhoods_plain;
- KS-P, somatic_posterior (csrc/somatic_posterior.cu): the somatic joint
  posterior, models/somatic_snv.somatic_snv_call; plain version
  somatic_snv_call_plain.

The models' public functions run the plain version on CPU tensors and the
kernel on any other device; a wrapper here checks its operands, builds and
binds its library (csrc/<source>.cu, _build.load) and launches on the
tensors' card and its current stream, and raises on what it does not take
and where the build, the load or the launch fails: nothing falls back to
the plain version. LAUNCHES counts each entry's launches under its own
name (a call with no rows launches nothing and counts nothing);
PLAIN_ON_CUDA counts the plain versions' runs on a card, which no CLI path
makes.
"""
from __future__ import annotations

import ctypes

import torch

# (replaced TPU-side program, csrc source) of each kernel
REPLACES = {
    "snv_hist_tile": "strelka_tpu/models/snv_digt.py:506",
    "snv_lanes_tile": "strelka_tpu/models/snv_digt.py:536",
    "snv_strand_bias_tile": "strelka_tpu/models/snv_digt.py:457",
    "snv_rna_tile": "strelka_tpu/models/snv_digt.py:536",
    "somatic_grid": "strelka_tpu/models/somatic_snv.py:102",
    "somatic_posterior": "strelka_tpu/models/somatic_snv.py:250",
}
# the csrc source of an entry not named after its own
SOURCES = {"snv_lanes_tile": "snv_hist_tile",
           "snv_strand_bias_tile": "snv_strand_bias"}
LAUNCHES = {name: 0 for name in REPLACES}
PLAIN_ON_CUDA = {name: 0 for name in REPLACES}

_vp, _ll, _i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_ARGTYPES = {
    "snv_hist_tile": [_vp, _i, *[_vp] * 9, _ll, *[_vp] * 8, _vp],
    "snv_lanes_tile": [_vp, _vp, _i, _vp, _ll, *[_vp] * 9, _ll, *[_vp] * 8,
                       _vp],
    "snv_strand_bias_tile": [_vp, _vp, _i, _vp, _vp, _ll, *[_vp] * 6, _i,
                             _ll, _vp, _vp],
    "snv_rna_tile": [_vp, _vp, _i, _vp, _ll, _vp, _i, *[_vp] * 9, _ll,
                     *[_vp] * 8, _vp],
    "somatic_grid": [*[_vp] * 5, _ll, _ll, *[_vp] * 6, ctypes.c_float, _vp,
                     _vp],
    "somatic_posterior": [*[_vp] * 6, _ll, *[_vp] * 6, _vp],
}
_BOUND: dict = {}


def reset() -> None:
    """Set every launch and plain-version counter to 0."""
    for d in (LAUNCHES, PLAIN_ON_CUDA):
        for k in d:
            d[k] = 0


def count_plain(name: str, dev) -> None:
    """Count a run of kernel `name`'s plain version where it is on a card."""
    if torch.device(dev).type == "cuda":
        PLAIN_ON_CUDA[name] += 1


def source(name: str) -> str:
    """The csrc source (without .cu) that holds entry `name`."""
    return SOURCES.get(name, name)


def function(name: str):
    """Entry `name`'s launch function, bound with ctypes; builds its
    library (csrc/<source>.cu) first if stale. Raises where the build or
    the load fails."""
    if name not in _BOUND:
        from .. import _build
        fn = getattr(_build.load(source(name)), f"{name}_launch")
        fn.restype = ctypes.c_int
        fn.argtypes = _ARGTYPES[name]
        _BOUND[name] = fn
    return _BOUND[name]


def _check(kernel, dev, specs):
    """Each (label, tensor, dtypes, shape) on `dev`, of one of `dtypes`,
    of `shape` (None: any extent) and contiguous; a None tensor passes."""
    for label, t, dtypes, shape in specs:
        if t is None:
            continue
        if t.device != dev:
            raise ValueError(f"{kernel}: {label} is on {t.device}, the "
                             f"first input on {dev}")
        if t.dtype not in dtypes:
            raise ValueError(f"{kernel}: {label} must be one of "
                             f"{[str(d) for d in dtypes]}, got {t.dtype}")
        if t.dim() != len(shape) or any(
                s is not None and s != n for s, n in zip(shape, t.shape)):
            raise ValueError(f"{kernel}: {label} has shape "
                             f"{tuple(t.shape)}, wants {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{kernel}: {label} must be contiguous")


def _launch(name, dev, args):
    """Bind kernel `name` and launch it on `dev` and its current stream
    (`dev` made current: the runtime launches on the current device's
    context); raises where `dev` is no card or the launch fails."""
    fn = function(name)
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    with torch.cuda.device(dev):
        rc = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")
    LAUNCHES[name] += 1


def _ptr(t):
    return None if t is None else t.data_ptr()


def _aligned(name, label, t):
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: {label} must be 16-byte aligned")


_F32, _F64, _BOOL, _I32 = ((torch.float32,), (torch.float64,),
                           (torch.bool,), (torch.int32,))


_PRIORS = ("genome", "poly", "genome_haploid", "poly_haploid")


def _tile_specs(L, ref_gt, is_haploid, s_mis, tabs):
    """The operand checks that KG-H's two entries share."""
    return [("ref_gt", ref_gt, _I32, (L,)),
            ("is_haploid", is_haploid, _BOOL, (L,)),
            ("s_mis", s_mis, _F32, (L, 4)),
            ("snv_qtab", tabs["snv_qtab"], _F32, (512, 10)),
            ("e0_tab", tabs["e0_tab"], _F32, (4, 10)),
            *[(f"prior_{k}", tabs[f"prior_{k}"], _F64, (5, 10))
              for k in _PRIORS]]


def _tile_launch(name, dev, L, head, ref_gt, is_haploid, s_mis, tabs):
    """Allocate KG-H's outputs and launch entry `name` (KG-H's two, or
    KG-R, whose per-call deltas take s_mis's place) with its own leading
    arguments `head`; returns (lhood, genome_max_gt, poly_max_gt,
    snv_qphred, genome_max_gt_qphred, poly_max_gt_qphred, phred_loghood,
    ln_ref_pprob)."""
    _aligned(name, "snv_qtab", tabs["snv_qtab"])
    i32 = dict(dtype=torch.int32, device=dev)
    lhood = torch.empty((L, 10), dtype=torch.float32, device=dev)
    ints = [torch.empty(L, **i32) for _ in range(5)]
    pl = torch.empty((L, 10), **i32)
    ln_ref = torch.empty(L, dtype=torch.float64, device=dev)
    if L:
        _launch(name, dev, [
            *head, ref_gt.data_ptr(), _ptr(is_haploid), _ptr(s_mis),
            tabs["snv_qtab"].data_ptr(), tabs["e0_tab"].data_ptr(),
            *[tabs[f"prior_{k}"].data_ptr() for k in _PRIORS], L,
            lhood.data_ptr(), *[t.data_ptr() for t in ints], pl.data_ptr(),
            ln_ref.data_ptr()])
    g_max, p_max, g_qref, g_qmax, p_qmax = ints
    return lhood, g_max, p_max, g_qref, g_qmax, p_qmax, pl, ln_ref


def snv_hist_tile(hist, ref_gt, is_haploid, s_mis, tabs):
    """KG-H's dense entry: (lhood [L,10] f32, genome_max_gt, poly_max_gt,
    snv_qphred, genome_max_gt_qphred, poly_max_gt_qphred [L] int32,
    phred_loghood [L,10] int32, ln_ref_pprob [L] f64) of
    call_snv_hist_tile. hist [L, 512] int8 or int32 (16-byte aligned),
    ref_gt [L] int32 in 0..4, is_haploid [L] bool or None, s_mis [L,4]
    f32 or None, tabs = convert.device_tables on the same card."""
    name = "snv_hist_tile"
    dev = hist.device
    L = hist.shape[0]
    _check(name, dev, [
        ("hist", hist, (torch.int8, torch.int32), (None, 512)),
        *_tile_specs(L, ref_gt, is_haploid, s_mis, tabs)])
    _aligned(name, "hist", hist)
    return _tile_launch(name, dev, L, [hist.data_ptr(), hist.element_size()],
                        ref_gt, is_haploid, s_mis, tabs)


def snv_lanes_tile(base_id, qual, mask, ref_gt, is_haploid, s_mis, tabs):
    """KG-H's lanes entry: snv_hist_tile's eight outputs, of the
    histogram of the tile's used calls (_tile_hist: q = clamp(qual, 0,
    127), a call counted where mask and 0 <= base_id < 4), counted by the
    kernel. base_id [L, D] int8, qual [L, D] int16 or uint8, mask [L, D]
    bool (the native pileup's lanes; call_snv_lanes_tile casts other
    widths), any D >= 0; the rest as snv_hist_tile's."""
    name = "snv_lanes_tile"
    dev = base_id.device
    if base_id.dim() != 2:
        raise ValueError(f"{name}: base_id must be [L, D], got "
                         f"{tuple(base_id.shape)}")
    L, D = base_id.shape
    _check(name, dev, [
        ("base_id", base_id, (torch.int8,), (L, D)),
        ("qual", qual, (torch.int16, torch.uint8), (L, D)),
        ("mask", mask, _BOOL, (L, D)),
        *_tile_specs(L, ref_gt, is_haploid, s_mis, tabs)])
    return _tile_launch(
        name, dev, L, [base_id.data_ptr(), qual.data_ptr(),
                       qual.element_size(), mask.data_ptr(), D],
        ref_gt, is_haploid, s_mis, tabs)


# KG-SB's and KG-R's limits (csrc/snv_xla_math.cuh): het-ratio steps
# (KG-SB's call rows in shared memory hold every step's values) and calls
# a row (three window levels)
MAX_STEPS = 40
MAX_DEPTH = 1 << 20


def launch_grid(name, L, n_steps, D, dev=None) -> dict:
    """The grid of entry `name` (snv_strand_bias_tile or snv_rna_tile)
    for L rows at n_steps het-ratio steps and D calls a row (int16 qual)
    on card `dev`: blocks (its grid), per_sm (the blocks an SM holds by
    the occupancy API with the launch's dynamic shared memory) and sms.
    Raises where the query fails."""
    from .. import _build
    fn = getattr(_build.load(source(name)), f"{name}_grid")
    fn.restype = ctypes.c_int
    fn.argtypes = [_ll, _i, _ll, ctypes.POINTER(_ll)]
    out = (_ll * 3)()
    with torch.cuda.device(dev if dev is not None else
                           torch.cuda.current_device()):
        rc = fn(L, n_steps, D, out)
    if rc != 0:
        raise RuntimeError(f"{name} grid query failed: CUDA error {rc}")
    return {"blocks": out[0], "per_sm": out[1], "sms": out[2]}


def _xla_specs(name, dev, base_id, qual, mask, dep_delta, het_vf,
               min_steps):
    """The operand checks that KG-SB and KG-R share: the lanes (int8
    base, int16 or uint8 qual, bool mask [L, D]), the per-call deltas
    ([L, D] f32 or None) and the het-VF table ([n_steps, 4, 256] f32);
    returns (L, D, n_steps)."""
    if base_id.dim() != 2:
        raise ValueError(f"{name}: base_id must be [L, D], got "
                         f"{tuple(base_id.shape)}")
    L, D = base_id.shape
    if het_vf is None and min_steps:
        raise ValueError(f"{name}: the het-VF table is required")
    _check(name, dev, [
        ("base_id", base_id, (torch.int8,), (L, D)),
        ("qual", qual, (torch.int16, torch.uint8), (L, D)),
        ("mask", mask, _BOOL, (L, D)),
        ("dep_delta", dep_delta, _F32, (L, D)),
        ("het_vf", het_vf, _F32, (None, 4, 256))])
    n_steps = 0 if het_vf is None else het_vf.shape[0]
    if not min_steps <= n_steps <= MAX_STEPS:
        raise ValueError(f"{name}: {n_steps} het-ratio steps, the kernel "
                         f"takes {min_steps} to {MAX_STEPS}")
    if D > MAX_DEPTH:
        raise ValueError(f"{name}: D = {D} calls a row, the kernel takes "
                         f"up to {MAX_DEPTH}")
    return L, D, n_steps


def snv_strand_bias_tile(base_id, qual, is_fwd, mask, ref_gt, tgt, lt,
                         dep_delta, xtabs):
    """KG-SB: [L] f32 strand bias of snv_strand_bias_tile. base_id [L, D]
    int8, qual [L, D] int16 or uint8, is_fwd and mask [L, D] bool, ref_gt
    [L] int32 in 0..4, tgt [L] int32 in 0..9, lt [L] f32, dep_delta [L,
    D] f32 or None; xtabs = snv_digt._xla_tables on the same card
    (call_vals, and het_vf or None outside RNA mode)."""
    name = "snv_strand_bias_tile"
    dev = base_id.device
    L, D, n_steps = _xla_specs(name, dev, base_id, qual, mask, dep_delta,
                               xtabs["het_vf"], 0)
    _check(name, dev, [
        ("is_fwd", is_fwd, _BOOL, (L, D)), ("ref_gt", ref_gt, _I32, (L,)),
        ("tgt", tgt, _I32, (L,)), ("lt", lt, _F32, (L,)),
        ("call_vals", xtabs["call_vals"], _F32, (256, 3))])
    out = torch.empty(L, dtype=torch.float32, device=dev)
    if L:
        _launch(name, dev, [
            base_id.data_ptr(), qual.data_ptr(), qual.element_size(),
            is_fwd.data_ptr(), mask.data_ptr(), D, ref_gt.data_ptr(),
            tgt.data_ptr(), lt.data_ptr(), _ptr(dep_delta),
            xtabs["call_vals"].data_ptr(), _ptr(xtabs["het_vf"]), n_steps,
            L, out.data_ptr()])
    return out


def snv_rna_tile(base_id, qual, mask, ref_gt, is_haploid, dep_delta, tabs,
                 het_vf):
    """KG-R: snv_hist_tile's eight outputs for RNA mode's genotype tile
    (call_snv_tile with the het-VF extension). base_id [L, D] int8, qual
    [L, D] int16 or uint8, mask [L, D] bool, ref_gt [L] int32 in 0..4,
    is_haploid [L] bool or None, dep_delta [L, D] f32 or None, tabs =
    convert.device_tables and het_vf [n_steps, 4, 256] f32
    (snv_digt._xla_tables) on the same card."""
    name = "snv_rna_tile"
    dev = base_id.device
    L, D, n_steps = _xla_specs(name, dev, base_id, qual, mask, dep_delta,
                               het_vf, 1)
    _check(name, dev, _tile_specs(L, ref_gt, is_haploid, None, tabs))
    return _tile_launch(
        name, dev, L, [base_id.data_ptr(), qual.data_ptr(),
                       qual.element_size(), mask.data_ptr(), D,
                       het_vf.data_ptr(), n_steps],
        ref_gt, is_haploid, dep_delta, tabs)


_GRID_TABLES = ("grid_ref", "grid_alt", "grid_on_ref", "grid_on_alt",
                "grid_off_ref", "grid_off_alt")


def somatic_grid(base_id, qual, mask, is_fwd, ref_gt, tabs, ln_half):
    """KS-G: [L, 30] f32 grid lhoods of freq_grid_lhoods. base_id [L, D]
    int8, qual [L, D] int16 and ref_gt [L] int32 (the native pileup's
    lanes), mask and is_fwd [L, D] bool, tabs = convert.somatic_grid_tables on the same card, ln_half
    the f32 ln 0.5 that the strand states add."""
    name = "somatic_grid"
    dev = base_id.device
    if base_id.dim() != 2:
        raise ValueError(f"{name}: base_id must be [L, D], got "
                         f"{tuple(base_id.shape)}")
    L, D = base_id.shape
    _check(name, dev, [
        ("base_id", base_id, (torch.int8,), (L, D)),
        ("qual", qual, (torch.int16,), (L, D)),
        ("mask", mask, _BOOL, (L, D)), ("is_fwd", is_fwd, _BOOL, (L, D)),
        ("ref_gt", ref_gt, _I32, (L,)),
        *[(k, tabs[k], _F32, (128, 21 if k in ("grid_ref", "grid_alt")
                              else 9)) for k in _GRID_TABLES]])
    out = torch.empty((L, 30), dtype=torch.float32, device=dev)
    if L:
        _launch(name, dev, [
            base_id.data_ptr(), qual.data_ptr(), mask.data_ptr(),
            is_fwd.data_ptr(), ref_gt.data_ptr(), L, D,
            *[tabs[k].data_ptr() for k in _GRID_TABLES], ln_half,
            out.data_ptr()])
    return out


def somatic_posterior(normal, tumor, pf, gp, eq, off):
    """KS-P: the six SomaticSnvResult fields (qphred, from_ntype_qphred,
    ntype, max_gt [L] int32, strand_bias [L] f32, nonsomatic_qphred [L]
    int32) of somatic_snv_call. normal, tumor [L, 30] f32; pf [3,2,21,21]
    and gp [3,2] f32, eq [21] f32 and off [21,21] f64 from
    somatic_snv._posterior_tables, on the same card."""
    name = "somatic_posterior"
    dev = normal.device
    L = normal.shape[0]
    _check(name, dev, [
        ("normal", normal, _F32, (L, 30)), ("tumor", tumor, _F32, (L, 30)),
        ("joint_pf", pf, _F32, (3, 2, 21, 21)), ("joint_gp", gp, _F32,
                                                  (3, 2)),
        ("eq", eq, _F32, (21,)), ("off", off, _F64, (21, 21))])
    i32 = dict(dtype=torch.int32, device=dev)
    q, qn, ntype, max_gt, qns = (torch.empty(L, **i32) for _ in range(5))
    sb = torch.empty(L, dtype=torch.float32, device=dev)
    if L:
        _launch(name, dev, [
            normal.data_ptr(), tumor.data_ptr(), pf.data_ptr(),
            gp.data_ptr(), eq.data_ptr(), off.data_ptr(), L, q.data_ptr(),
            qn.data_ptr(), ntype.data_ptr(), max_gt.data_ptr(),
            sb.data_ptr(), qns.data_ptr()])
    return q, qn, ntype, max_gt, sb, qns
