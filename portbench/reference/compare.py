"""The comparison that decides ``correct``: the checked calls of the
window against the plain reference (plain.py), one number an entry.

- ``k1_gap`` (nats): over every (pair, read) of every checked K1 call,
  the larger of |best - s(off)| and max_w s(w) - s(off), where s is the
  reference's score and (best, off) what the call returned: a wrong
  score, or an offset that is not a best one, reads as its distance.
- ``kgh_gap`` and ``ksg_gap``: over every lhood of every checked call,
  |got - want| / max(1, |want|); a -inf on one side only reads inf.
- ``kgsb_gap``: over every row of every checked KG-SB call, |got -
  want| / max(1, |lt|, |want + lt|): lt is the row's lhood that the
  strand bias is taken from and want + lt the best strand's, the scale
  of their rounding.
- ``ksp_gap`` (phred units, 10 log10 of a ratio of probabilities): over
  every row of every checked KS-P call, the largest of: each of the
  three qualities' distance from the reference's unrounded quality,
  less the 0.5 of rounding to a whole number (both capped at QCAP, past
  which float64 no longer resolves the complements the model takes);
  the quality of the normal genotype the call chose less that of the
  best one; the log posterior of the state it chose below the best;
  and the strand bias' distance.

``control=True`` puts the reference computed in bfloat16 in the
program's place (its outputs instead of the calls'), the control that
has to fail.
"""
from __future__ import annotations

import inspect
import math

import torch

from . import plain

ARGS = {
    "k1": inspect.Signature([inspect.Parameter(n, inspect.Parameter.
                                               POSITIONAL_OR_KEYWORD)
                             for n in ("codes", "delta", "lnmis", "win_t")]
                            + [inspect.Parameter(
                                "mode", inspect.Parameter.POSITIONAL_OR_KEYWORD,
                                default="exact")]),
    "snv_tiles": inspect.Signature(
        [inspect.Parameter(n, inspect.Parameter.POSITIONAL_OR_KEYWORD)
         for n in ("base_id", "qual", "mask", "ref_gt")]
        + [inspect.Parameter(n, inspect.Parameter.POSITIONAL_OR_KEYWORD,
                             default=d)
           for n, d in (("is_haploid", None), ("theta", 0.001),
                        ("s_mis", None))]),
    "somatic_grid": inspect.Signature(
        [inspect.Parameter(n, inspect.Parameter.POSITIONAL_OR_KEYWORD)
         for n in ("base_id", "qual", "mask", "is_fwd", "ref_gt")]),
}
ARGS["kgsb"] = inspect.Signature(
    [inspect.Parameter(n, inspect.Parameter.POSITIONAL_OR_KEYWORD)
     for n in ("tile", "tgt", "lt")]
    + [inspect.Parameter(n, inspect.Parameter.POSITIONAL_OR_KEYWORD,
                         default=d)
       for n, d in (("dep_delta", None), ("het_vf_extension", 0.0),
                    ("het_vf_increment", 0.0501))])
ARGS["somatic_posterior"] = inspect.Signature(
    [inspect.Parameter(n, inspect.Parameter.POSITIONAL_OR_KEYWORD)
     for n in ("normal_lhood", "tumor_lhood")]
    + [inspect.Parameter(n, inspect.Parameter.POSITIONAL_OR_KEYWORD,
                         default=d)
       for n, d in (("contam_tolerance", 0.15), ("shared_error_rate", 5e-10),
                    ("somatic_rate", 1e-4), ("theta", 0.001),
                    ("sse_strand_fraction", 0.0))])
NUMBERS = {"k1": "k1_gap", "snv_tiles": "kgh_gap", "somatic_grid": "ksg_gap",
           "kgsb": "kgsb_gap", "somatic_posterior": "ksp_gap"}
QCAP = 100.0
DB = 10.0 / math.log(10.0)          # phred units a nat
TINY = torch.finfo(torch.float64).tiny


def _bind(entry, args, kwargs, dev):
    b = ARGS[entry].bind(*args, **kwargs)
    b.apply_defaults()
    return {k: _to(v, dev) for k, v in b.arguments.items()}


def _to(v, dev):
    if isinstance(v, torch.Tensor):
        return v.to(dev)
    if isinstance(v, dict):
        return {k: _to(x, dev) for k, x in v.items()}
    return v


def k1_gap(x, got, control=False) -> float:
    s = plain.k1_scores(x["codes"], x["delta"], x["lnmis"], x["win_t"])
    if control:
        sc = plain.k1_scores(x["codes"], x["delta"], x["lnmis"], x["win_t"],
                             torch.bfloat16)
        best, off = sc.max(dim=-1)
    else:
        best, off = (t.to(s.device) for t in got)
    at = torch.gather(s, -1, off.long()[..., None])[..., 0]
    gap = torch.maximum((best.to(torch.float64) - at).abs(),
                        s.max(dim=-1).values - at)
    return float(gap.max()) if gap.numel() else 0.0


def _rel_gap(got, want) -> float:
    got = got.to(torch.float64)
    both = torch.isinf(got) & torch.isinf(want) & (got == want)
    d = (got - want).abs() / torch.clamp(want.abs(), min=1.0)
    d = torch.where(both, 0.0, d)
    d = torch.where(torch.isnan(d), float("inf"), d)
    return float(d.max()) if d.numel() else 0.0


def kgh_gap(x, got, control=False) -> float:
    want = plain.snv_lhoods(x["base_id"], x["qual"], x["mask"], x["s_mis"])
    if control:
        got = plain.snv_lhoods(x["base_id"], x["qual"], x["mask"],
                               x["s_mis"], torch.bfloat16)
    return _rel_gap(got.to(want.device), want)


def ksg_gap(x, got, control=False) -> float:
    args = [x[k] for k in ("base_id", "qual", "mask", "is_fwd", "ref_gt")]
    want = plain.grid_lhoods(*args)
    if control:
        got = plain.grid_lhoods(*args, dtype=torch.bfloat16)
    return _rel_gap(got.to(want.device), want)


def kgsb_gap(x, got, control=False) -> float:
    t = x["tile"]
    if x["het_vf_extension"] > 0:
        raise ValueError("KG-SB's RNA extension has no reference here")
    args = (t["base_id"], t["qual"], t["is_fwd"], t["mask"], t["ref_gt"],
            x["tgt"], x["lt"], x["dep_delta"])
    want = plain.strand_bias(*args)
    if control:
        got = plain.strand_bias(*args, dtype=torch.bfloat16)
    lt = x["lt"].to(want.device, torch.float64)
    scale = torch.clamp(torch.maximum(lt.abs(), (want + lt).abs()), min=1.0)
    d = (got.to(want.device, torch.float64) - want).abs() / scale
    d = torch.where(torch.isnan(d), float("inf"), d)
    return float(d.max()) if d.numel() else 0.0


def _phred(p):
    q = -10.0 * torch.log10(torch.clamp(p, min=TINY))
    return torch.clamp(torch.nan_to_num(q, nan=0.0), max=QCAP)


BLOCK = 1 << 15                     # KS-P's rows a block of the reference


def ksp_gap(x, got, control=False) -> float:
    """The largest over the call's rows, taken a block of rows at a
    time so that the reference's [rows, 3, 2, 21, 21] terms fit."""
    n = x["normal_lhood"].shape[0]
    worst = 0.0
    for i in range(0, n, BLOCK):
        xb = dict(x, normal_lhood=x["normal_lhood"][i:i + BLOCK],
                  tumor_lhood=x["tumor_lhood"][i:i + BLOCK])
        gb = None if control else {k: v[i:i + BLOCK] for k, v in got.items()}
        worst = max(worst, _ksp_block(xb, gb, control))
    return worst


def _ksp_block(x, got, control) -> float:
    kw = {k: x[k] for k in ("contam_tolerance", "shared_error_rate",
                            "somatic_rate", "theta", "sse_strand_fraction")}
    want = plain.somatic_posterior(x["normal_lhood"], x["tumor_lhood"], **kw)
    if control:
        low = plain.somatic_posterior(x["normal_lhood"], x["tumor_lhood"],
                                      dtype=torch.bfloat16, **kw)
        err = low["err"]
        got = {"qphred": _phred(low["nonsom"]),
               "from_ntype_qphred": _phred(err.min(-1).values),
               "nonsomatic_qphred": _phred(low["nonsom_comp"]),
               "ntype": err.argmin(-1),
               "max_gt": low["log_post"].reshape(-1, 6).argmax(-1),
               "strand_bias": low["strand_bias"]}
    dev = want["nonsom"].device
    got = {k: v.to(dev) for k, v in got.items()}
    err = want["err"]
    parts = []
    for field, p in (("qphred", want["nonsom"]),
                     ("from_ntype_qphred", err.min(-1).values),
                     ("nonsomatic_qphred", want["nonsom_comp"])):
        g = torch.clamp(got[field].to(torch.float64), max=QCAP)
        parts.append(torch.clamp((g - _phred(p)).abs() - 0.5, min=0.0))
    ntype, max_gt = got["ntype"].long(), got["max_gt"].long()
    chosen = torch.gather(err, 1, ntype.clamp(0, 2)[:, None])[:, 0]
    gap = (_phred(chosen) - _phred(err.min(-1).values)).abs()
    parts.append(torch.where((ntype < 0) | (ntype > 2), float("inf"), gap))
    lp = want["log_post"].reshape(-1, 6)
    at = torch.gather(lp, 1, max_gt.clamp(0, 5)[:, None])[:, 0]
    top = lp.max(-1).values
    gap = torch.where(torch.isneginf(top), 0.0, DB * (top - at))
    parts.append(torch.where((max_gt < 0) | (max_gt > 5), float("inf"),
                             gap))
    parts.append(DB * (got["strand_bias"].to(torch.float64)
                       - want["strand_bias"]).abs())
    d = torch.stack(parts)
    d = torch.where(torch.isnan(d), float("inf"), d)
    return float(d.max()) if d.numel() else 0.0


GAPS = {"k1": k1_gap, "snv_tiles": kgh_gap, "somatic_grid": ksg_gap,
        "kgsb": kgsb_gap, "somatic_posterior": ksp_gap}


def compare(captured: dict, device, control: bool = False) -> dict:
    """{number: (largest reading, calls compared)} over the checked
    calls of each entry that has any; K1 calls in another mode than
    "exact" are not K1's path and are left out."""
    out = {}
    for entry, calls in captured.items():
        worst, n = 0.0, 0
        for args, kwargs, got in calls:
            x = _bind(entry, args, kwargs, device)
            if entry == "k1" and x["mode"] != "exact":
                continue
            worst = max(worst, GAPS[entry](x, got, control))
            n += 1
        if n:
            out[NUMBERS[entry]] = (worst, n)
    return out
