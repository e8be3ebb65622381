"""The plain reference of the device layers that the comparison covers.

Straightforward float64 implementations of what each device entry
computes, written from the model's definitions and not from the port
(this file imports neither the port nor JAX):

- K1, read x haplotype scoring: for each (pair b, read r) and window
  offset w, the sum over the read's bases l whose code (0..3) equals the
  window's base at l of the base's log-ratio delta, plus the read's
  mismatch term lnmis. The scoring model quantizes each delta to
  2^-11 nats, truncated toward zero, so the reference sums the
  quantized deltas (exactly, in float64).
- KG-H's lanes entry, the germline SNV genotype lhoods: for each site
  and each of the 10 diploid genotypes, the sum over its used calls
  (mask set, base 0..3, qscore q clamped to 0..127, e = 10^(-q/10)) of
  ln(e/3) where the genotype holds no copy of the base, ln((1-e)/2 +
  e/6) where it holds one and ln(1-e) where it holds two (e and 1-e
  floored at 1e-35), plus each site's dependent-error deltas s_mis[l, b]
  on the genotypes that hold no copy of b.
- KS-G, one sample's somatic frequency-grid lhoods: for each site, the
  21 pre-strand allele frequencies f (0, 1, 0.5, 0.05..0.45,
  0.55..0.95) and the sum over its used calls of ln((1-e)(1-f) + e/3 f)
  for a call of the reference base and ln((1-e) f + e/3 (1-f)) for
  another; then the 9 strand states at r = 0.05..0.45: on one strand
  the calls take frequency r, on the other ln(1-e) (reference) or
  ln(e/3), the two strands combined by logaddexp and halved.
- KG-SB, the germline SNV strand bias: for each site, its genotype g
  (``tgt``) and its lhood there (``lt``), the larger over the two
  strands of the lhood of g with that strand's calls free and the other
  strand's calls scored against the hom-ref genotype, less ``lt``. A
  call with k copies of its base in a genotype scores ln(e/3) (k = 0,
  plus its dependent-error delta where given), ln((1-e)/2 + e/6)
  (k = 1) or ln(1-e) (k = 2), qscores clamped to 0..255; a reference
  base N is scored as T, as the model clamps it.
- KS-P, the somatic joint posterior of a tumour/normal site from the
  two samples' 21 pre-strand lhoods (Strelka's qscore_calculator): the
  prior over (normal genotype, somatic or not, normal frequency,
  tumour frequency), the six states' log posteriors, Q(somatic),
  Q(somatic and the normal genotype), the normal genotype and the
  state of most posterior, the tumour's strand bias (its best strand
  state less its best symmetric het state, at least 0) and the
  non-somatic quality (a flat prior over equal frequencies in the
  tumour's valid range).

Each function takes ``dtype``: float64 for the reference, bfloat16 for
the control (the tables and the inputs rounded to bfloat16, the result
rounded to it too).
"""
from __future__ import annotations

import math

import torch

QUANT = 2048.0                   # 2^11: K1's delta quantum is 1/QUANT
Q_MAX = 127
FLOOR = 1e-35
# diploid genotypes over A, C, G, T and the copies of each base they hold
GENOTYPES = ("AA", "CC", "GG", "TT", "AC", "AG", "AT", "CG", "CT", "GT")
COPIES = torch.tensor([[g.count(b) for b in "ACGT"] for g in GENOTYPES],
                      dtype=torch.int64)                        # [10, 4]
FRACTIONS = ([0.0, 1.0, 0.5] + [0.05 * i for i in range(1, 10)]
             + [0.05 * i for i in range(11, 20)])
STRAND_RATIOS = [0.05 * i for i in range(1, 10)]


LN_HALF = math.log(0.5)
SB_Q_MAX = 255
# the somatic model's states: reference, hom and het normal genotypes;
# non-somatic and somatic
REF, HOM, HET = 0, 1, 2
NON_SOMATIC, SOMATIC = 0, 1
PRESTRAND = len(FRACTIONS)                                     # 21


def _round(x, dtype):
    return x.to(dtype).to(torch.float64)


def k1_scores(codes, delta, lnmis, win_t, dtype=torch.float64):
    """[B, R, W] float64 scores of every window offset."""
    B, R, L = codes.shape
    d = _round(delta.to(torch.float64), dtype)
    d = torch.trunc(d * QUANT)
    c = codes.to(torch.int64)
    w = win_t.to(torch.int64)
    s = torch.zeros((B, R, w.shape[2]), dtype=torch.float64,
                    device=codes.device)
    for base in range(4):
        a = torch.where(c == base, d, 0.0)                       # [B,R,L]
        s += torch.bmm(a, (w == base).to(torch.float64))         # [B,R,W]
    s = s / QUANT + _round(lnmis.to(torch.float64), dtype)[..., None]
    return _round(s, dtype)


def snv_lhoods(base_id, qual, mask, s_mis=None, dtype=torch.float64):
    """[L, 10] float64 genotype log lhoods of a germline SNV tile."""
    dev = base_id.device
    q = torch.arange(Q_MAX + 1, dtype=torch.float64, device=dev)
    e = torch.pow(10.0, -q / 10.0)
    ce = 1.0 - e
    vals = torch.stack([
        torch.log(torch.clamp(e, min=FLOOR)) + math.log(1.0 / 3.0),
        torch.log(ce + e / 3.0) + math.log(0.5),
        torch.log(torch.clamp(ce, min=FLOOR))], dim=1)           # [Q, 3]
    vals = _round(vals, dtype)
    tab = vals[:, COPIES.to(dev).t()]                            # [Q, 4, 10]
    b = base_id.to(torch.int64)
    used = mask.to(torch.bool) & (b >= 0) & (b < 4)
    qi = torch.clamp(qual.to(torch.int64), 0, Q_MAX)
    slot = torch.where(used, qi * 4 + torch.clamp(b, 0, 3),
                       (Q_MAX + 1) * 4)
    L = b.shape[0]
    hist = torch.zeros((L, (Q_MAX + 1) * 4 + 1), dtype=torch.float64,
                       device=dev)
    hist.scatter_add_(1, slot, torch.ones_like(slot, dtype=torch.float64))
    lh = hist[:, :-1] @ tab.reshape(-1, 10)
    if s_mis is not None:
        none = (COPIES.to(dev) == 0).to(torch.float64)           # [10, 4]
        lh = lh + _round(s_mis.to(torch.float64), dtype) @ none.t()
    return _round(lh, dtype)


def _grid_tables(dev, dtype):
    q = torch.arange(Q_MAX + 1, dtype=torch.float64, device=dev)
    e = torch.pow(10.0, -q / 10.0)[:, None]
    ce = 1.0 - e
    f = torch.tensor(FRACTIONS, dtype=torch.float64, device=dev)[None]
    r = torch.tensor(STRAND_RATIOS, dtype=torch.float64, device=dev)[None]
    ones = torch.ones_like(r)
    t = {"ref": torch.log(ce * (1 - f) + e / 3.0 * f),
         "alt": torch.log(ce * f + e / 3.0 * (1 - f)),
         "on_ref": torch.log(ce * (1 - r) + e / 3.0 * r),
         "on_alt": torch.log(ce * r + e / 3.0 * (1 - r)),
         "off_ref": torch.log(ce) * ones,
         "off_alt": torch.log(e / 3.0) * ones}
    return {k: _round(v, dtype) for k, v in t.items()}


def _dot(counts, tab):
    """counts [L, Q] @ tab [Q, F] where tab may hold -inf (and a zero
    count of it adds nothing)."""
    fin = torch.where(torch.isinf(tab), 0.0, tab)
    out = counts @ fin
    hit = (counts > 0).to(torch.float64) @ torch.isinf(tab).to(
        torch.float64)
    return torch.where(hit > 0, float("-inf"), out)


def grid_lhoods(base_id, qual, mask, is_fwd, ref_gt, dtype=torch.float64):
    """[L, 30] float64 frequency-grid log lhoods of one sample."""
    dev = base_id.device
    t = _grid_tables(dev, dtype)
    b = base_id.to(torch.int64)
    m = mask.to(torch.bool)
    rg = ref_gt.to(torch.int64)[:, None]
    fwd = is_fwd.to(torch.bool)
    qi = torch.clamp(qual.to(torch.int64), 0, Q_MAX)
    L = b.shape[0]

    def counts(sel):
        h = torch.zeros((L, Q_MAX + 2), dtype=torch.float64, device=dev)
        idx = torch.where(sel, qi, Q_MAX + 1)
        h.scatter_add_(1, idx, torch.ones_like(idx, dtype=torch.float64))
        return h[:, :-1]
    is_ref = (b == rg) & m
    is_alt = (b != rg) & m
    fr, fa = counts(is_ref & fwd), counts(is_alt & fwd)
    rr, ra = counts(is_ref & ~fwd), counts(is_alt & ~fwd)
    lh = _dot(fr + rr, t["ref"]) + _dot(fa + ra, t["alt"])
    lh_f = (_dot(fr, t["on_ref"]) + _dot(fa, t["on_alt"])
            + _dot(rr, t["off_ref"]) + _dot(ra, t["off_alt"]))
    lh_r = (_dot(rr, t["on_ref"]) + _dot(ra, t["on_alt"])
            + _dot(fr, t["off_ref"]) + _dot(fa, t["off_alt"]))
    strand = torch.logaddexp(lh_f, lh_r) + math.log(0.5)
    return _round(torch.cat([lh, strand], dim=1), dtype)


def strand_bias(base_id, qual, is_fwd, mask, ref_gt, tgt, lt,
                dep_delta=None, dtype=torch.float64):
    """[L] float64 strand bias of germline SNV rows (KG-SB)."""
    dev = base_id.device
    q = torch.arange(SB_Q_MAX + 1, dtype=torch.float64, device=dev)
    e = torch.pow(10.0, -q / 10.0)
    ce = 1.0 - e
    vals = _round(torch.stack([
        torch.log(torch.clamp(e, min=FLOOR)) + math.log(1.0 / 3.0),
        torch.log(ce + e / 3.0) + math.log(0.5),
        torch.log(torch.clamp(ce, min=FLOOR))], dim=1), dtype)  # [Q, 3]
    qi = torch.clamp(qual.to(torch.int64), 0, SB_Q_MAX)
    v = vals[qi]                                                # [L, D, 3]
    if dep_delta is not None:
        v = v.clone()
        v[..., 0] += _round(dep_delta.to(torch.float64), dtype)
    b = torch.clamp(base_id.to(torch.int64), 0, 3)
    used = mask.to(torch.bool)
    copies = COPIES.to(dev)                                     # [10, 4]
    g = tgt.to(torch.int64)[:, None].expand_as(b)
    k_free = copies[g, b]                                       # [L, D]
    ref = torch.clamp(ref_gt.to(torch.int64), 0, 3)[:, None]
    k_ref = torch.where(b == ref, 2, 0)
    s_free = torch.gather(v, 2, k_free[..., None])[..., 0]
    s_ref = torch.gather(v, 2, k_ref[..., None])[..., 0]
    fwd = is_fwd.to(torch.bool)
    zero = torch.zeros((), dtype=torch.float64, device=dev)

    def lhood(free):
        return (torch.where(used & free, s_free, zero).sum(1)
                + torch.where(used & ~free, s_ref, zero).sum(1))
    best = torch.maximum(lhood(fwd), lhood(~fwd))
    return _round(best - _round(lt.to(torch.float64), dtype), dtype)


def joint_prior(contam_tolerance, shared_error_rate, somatic_rate, theta,
                sse_strand_fraction, dev="cpu"):
    """The somatic model's prior: ln P(fn, ft | normal genotype, somatic
    or not) [3, 2, 21, 21] (-inf where excluded) and ln P(genotype,
    somatic or not) [3, 2], float64."""
    err = -math.log(PRESTRAND - 1)
    ln_sse = (math.log(shared_error_rate * (1.0 - sse_strand_fraction))
              if shared_error_rate * (1.0 - sse_strand_fraction) > 0
              else float("-inf"))
    ln_csse = math.log1p(-shared_error_rate)
    pf = torch.full((3, 2, PRESTRAND, PRESTRAND), float("-inf"),
                    dtype=torch.float64)
    for ngt in range(3):
        for ft in range(PRESTRAND):
            contam = contam_tolerance * FRACTIONS[ft] >= 0.05
            for fn in range(PRESTRAND):
                if fn == ft:
                    pf[ngt, NON_SOMATIC, fn, ft] = (
                        ln_csse if fn == ngt else ln_sse + err)
                elif ngt != REF:
                    if fn == ngt:
                        pf[ngt, SOMATIC, fn, ft] = err
                elif not contam:
                    if fn == REF:
                        pf[ngt, SOMATIC, fn, ft] = err
                elif fn in (REF, 3):        # normal at 0 or at 0.05
                    pf[ngt, SOMATIC, fn, ft] = err + LN_HALF
    g = torch.tensor([math.log1p(-1.5 * theta), math.log(theta / 2.0),
                      math.log(theta)], dtype=torch.float64)
    s = torch.tensor([math.log1p(-somatic_rate), math.log(somatic_rate)],
                     dtype=torch.float64)
    return pf.to(dev), (g[:, None] + s[None, :]).to(dev)


def somatic_posterior(normal_lhood, tumor_lhood, contam_tolerance=0.15,
                      shared_error_rate=5e-10, somatic_rate=1e-4,
                      theta=0.001, sse_strand_fraction=0.0,
                      dtype=torch.float64) -> dict:
    """KS-P's quantities a site, float64: ``log_post`` [L, 3, 2] (ngt,
    somatic or not), the probabilities behind the three qualities
    (``nonsom``: not somatic; ``err`` [L, 3]: not (somatic and normal
    genotype n); ``nonsom_comp``: one less the non-somatic share) and
    ``strand_bias``."""
    dev = normal_lhood.device
    pf, gp = joint_prior(contam_tolerance, shared_error_rate, somatic_rate,
                         theta, sse_strand_fraction, dev)
    pf, gp = _round(pf, dtype), _round(gp, dtype)
    nl = _round(normal_lhood.to(torch.float64), dtype)
    tl = _round(tumor_lhood.to(torch.float64), dtype)
    n21, t21 = nl[:, :PRESTRAND], tl[:, :PRESTRAND]
    L = nl.shape[0]
    joint = (pf[None] + n21[:, None, None, :, None]
             + t21[:, None, None, None, :])                  # [L,3,2,21,21]
    log_post = _round(torch.logsumexp(joint.reshape(L, 3, 2, -1), -1)
                      + gp[None], dtype)
    flat = log_post.reshape(L, 6)
    p = torch.exp(flat - flat.max(-1, keepdim=True).values)
    p = (p / p.sum(-1, keepdim=True)).reshape(L, 3, 2)
    nonsom = p[:, :, NON_SOMATIC].sum(-1)
    som = p[:, :, SOMATIC]
    err = nonsom[:, None] + (som.sum(-1, keepdim=True) - som)
    sb = torch.clamp(tl[:, PRESTRAND:].max(-1).values
                     - tl[:, 3:PRESTRAND].max(-1).values, min=0.0)
    f = torch.tensor(FRACTIONS, dtype=torch.float64, device=dev)
    valid = (f >= 0.1 - 1e-4) & (f <= 0.9 + 1e-4)
    valid[:2] = True
    diag = torch.where(valid[None], n21 + t21,
                       torch.tensor(float("-inf"), dtype=torch.float64,
                                    device=dev))
    lse_diag = _round(torch.logsumexp(diag, -1), dtype)
    off_prior = torch.full((PRESTRAND, PRESTRAND), float("-inf"),
                           dtype=torch.float64, device=dev)
    off_prior[:2, :] = LN_HALF
    off_prior[:, ~valid] = float("-inf")
    off_prior.fill_diagonal_(float("-inf"))
    off = (n21[:, :, None] + t21[:, None, :] + _round(off_prior, dtype)[None])
    denom = torch.logaddexp(lse_diag, torch.logsumexp(off.reshape(L, -1),
                                                      -1))
    nonsom_comp = 1.0 - torch.exp(lse_diag - denom)
    return {"log_post": log_post, "nonsom": nonsom, "err": err,
            "nonsom_comp": nonsom_comp, "strand_bias": _round(sb, dtype)}
