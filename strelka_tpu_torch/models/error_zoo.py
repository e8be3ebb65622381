"""Research-grade error-model zoo: parameter estimation from allele
counts.

Reference: applications/EstimateParametersFromAlleleCounts/ — a family
of maximum-likelihood fits of sequencing error parameters from the
binary allele-count files, spanning indel models
{independent-error (indelModelVariantAndIndyError.cpp:54-183),
 binomial-mixture (indelModelVariantAndBinomialMixtureError.cpp:181-235),
 beta-binomial (indelModelVariantAndBetaBinomialError.cpp:80-208)}
and the SNV independent-error model
(snvModelVariantAndIndyError.cpp:43-108). The reference minimizes each
with CodeMin conjugate directions; here every context's observation
patterns evaluate as one vectorized log-likelihood and Adam drives the
ML fit.

All models share the germline genotype mixture over
{no-variant, het, hom(, alt-het)} with theta priors
(logHomPrior = ln theta - ln 2, logHetPrior = ln theta,
logAltHetPrior = 2 ln theta) and the approximation that the most
frequent alt observation is the candidate variant allele.

Port of strelka_tpu/models/error_zoo.py: the likelihoods are f64 torch
ops on the fit's device with the JAX package's association order, the
gradients come from torch.autograd, and the optimizer is optax's Adam
in optax's order (utils/special.Adam). A theta given as a float (the
locked DEFAULT_LOG_THETA) folds on the host, as XLA folds the JAX
package's constant. That is the plain version of an indel fit
(_fit_plain), which fit_contexts runs on the CPU; on any other device
fit_contexts runs KZ (ops/zoo_kernels.ZooBatch: csrc/error_zoo_fit.cu),
every start of every context it is given side by side, and raises where
it cannot: nothing falls back. tools estimate-parameters hands it all of
a counts file's contexts at once; the per-context fit_indel_* functions
are its one-context case. The SNV fits, which no entry point calls, run
the plain version on any device.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from .. import device as devmod
from ..ops import zoo_kernels as zk
from ..utils.special import Adam, betaln, log_sigmoid, logaddexp, logsumexp

LN2 = float(np.log(2.0))
LOG_HOM_ALT = float(np.log(0.99))
LOG_HOM_REF = float(np.log(0.01))
LOG_HET = float(np.log(0.5))
DEFAULT_LOG_THETA = float(np.log(1e-4))


def _dev(device):
    return devmod.current() if device is None else devmod.resolve(device)


def _exp(x):
    """exp of a float on the host (a folded constant) or of a tensor."""
    return math.exp(x) if isinstance(x, float) else torch.exp(x)


def _log(x):
    return math.log(x) if isinstance(x, float) else torch.log(x)


def _rate(x, like):
    """A rate argument as a 0-d f64 tensor on `like`'s device."""
    return torch.as_tensor(x, dtype=torch.float64, device=like.device)


# ---------------------------------------------------------------------------
# parameter smoothers (error_minfunc::argToParameters): the minimizer
# works on unconstrained values; rates fold back below ln(0.5), theta
# below ln(0.3), with a log1p softening above the trigger
# ---------------------------------------------------------------------------

def _smooth(a, trigger: float, limit: float):
    lt = float(np.log(trigger))
    ll = float(np.log(limit))
    a = torch.where(a > lt, torch.log1p(a - lt) + lt, a)
    return torch.where(a > ll, ll - torch.abs(a - ll), a)


def rate_smoother(a, trigger: float = 1e-3):
    return _smooth(a, trigger, 0.5)


def theta_smoother(a):
    return _smooth(a, 1e-3, 0.3)


# The reference's fold-back smoothers suit CodeMin's line searches but
# create a sawtooth that traps momentum-based optimizers; the fits use
# an equivalent smooth bounded parameterization instead:
# rate = limit * sigmoid(x)  <=>  ln rate = ln limit + log_sigmoid(x).

def _ln_bounded(x, limit: float):
    return float(np.log(limit)) + log_sigmoid(x)


def _bounded_init(rate0: float, limit: float) -> float:
    q = min(max(rate0 / limit, 1e-12), 1 - 1e-12)
    return float(np.log(q / (1.0 - q)))


def _host_bounded(x, limit: float):
    """exp(_ln_bounded(x, limit)) of host values, as floats."""
    v = np.exp(_ln_bounded(torch.as_tensor(np.asarray(x, np.float64)),
                           limit).numpy())
    return float(v) if v.ndim == 0 else v


# ---------------------------------------------------------------------------
# shared genotype-mixture observation likelihood (indel)
# ---------------------------------------------------------------------------

def _alt_split(alt_obs):
    """(total_ins, total_del) per pattern; signal types 0-2 are
    insertions, 3-5 deletions (INDEL_SIGNAL_TYPE)."""
    return alt_obs[:, :3].sum(dim=1), alt_obs[:, 3:].sum(dim=1)


def _max_allele_masks(alt_obs: np.ndarray):
    """Indices of the most / second-most frequent alt signal per
    pattern with the reference's first-wins tie break (strict > scans
    in index order). Returns numpy int arrays (host-side precompute)."""
    n, k = alt_obs.shape
    max1 = np.zeros(n, dtype=np.int64)
    for j in range(1, k):
        upd = alt_obs[:, j] > alt_obs[np.arange(n), max1]
        max1[upd] = j
    max2 = np.where(max1 == 0, 1, 0).astype(np.int64)
    for j in range(1, k):
        cand = (j != max1) & (j > max2) & \
            (alt_obs[:, j] > alt_obs[np.arange(n), max2])
        max2[cand] = j
    return max1, max2


@dataclass
class IndelPatterns:
    """Device-ready observation patterns for one context."""
    ref_obs: torch.Tensor       # [N] f64
    alt_obs: torch.Tensor       # [N, 6] f64
    inst: torch.Tensor          # [N] f64 pattern multiplicities
    max1: torch.Tensor          # [N] most frequent alt index
    max2: torch.Tensor          # [N] second most frequent alt index

    @classmethod
    def build(cls, counts, device=None) -> "IndelPatterns":
        dev = _dev(device)

        def f64(a):
            return torch.as_tensor(np.asarray(a, np.float64), device=dev)
        m1, m2 = _max_allele_masks(np.asarray(counts.alt_obs))
        return cls(ref_obs=f64(counts.ref_obs), alt_obs=f64(counts.alt_obs),
                   inst=f64(counts.instance_count),
                   max1=torch.as_tensor(m1, device=dev),
                   max2=torch.as_tensor(m2, device=dev))


def _take(alt_obs, idx):
    return torch.gather(alt_obs, 1, idx[:, None])[:, 0]


def _priors(ln_theta, het_alt: bool):
    """(hom, het, no-variant, alt-het) log priors; the no-variant prior
    leaves theta**2 for the alt-het state only where the model has one."""
    theta = _exp(ln_theta)
    if het_alt:
        log_noindel_prior = _log(1.0 - (theta * 1.5 + theta * theta))
    else:
        log_noindel_prior = _log(1.0 - theta * 1.5)
    return ln_theta - LN2, ln_theta, log_noindel_prior, ln_theta * 2.0


def _indel_obs_mix(p: IndelPatterns, li, ld, lref, priors):
    """Per-pattern 4-state genotype mixture [N]."""
    log_hom_prior, log_het_prior, log_noindel_prior, log_althet_prior = priors
    tot_ins, tot_del = _alt_split(p.alt_obs)
    noindel = li * tot_ins + ld * tot_del + lref * p.ref_obs
    zero = torch.zeros_like(tot_ins)
    is_ins1 = p.max1 < 3
    a1 = _take(p.alt_obs, p.max1)
    rem_ins1 = tot_ins - torch.where(is_ins1, a1, zero)
    rem_del1 = tot_del - torch.where(is_ins1, zero, a1)
    het = LOG_HET * (p.ref_obs + a1) + li * rem_ins1 + ld * rem_del1
    hom = (LOG_HOM_ALT * a1 + LOG_HOM_REF * p.ref_obs
           + li * rem_ins1 + ld * rem_del1)
    is_ins2 = p.max2 < 3
    a2 = _take(p.alt_obs, p.max2)
    rem_ins2 = rem_ins1 - torch.where(is_ins2, a2, zero)
    rem_del2 = rem_del1 - torch.where(is_ins2, zero, a2)
    althet = (LOG_HET * (a1 + a2) + LOG_HOM_REF * p.ref_obs
              + li * rem_ins2 + ld * rem_del2)
    return logsumexp(torch.stack([log_hom_prior + hom,
                                  log_het_prior + het,
                                  log_noindel_prior + noindel,
                                  log_althet_prior + althet]), dim=0)


def _indel_mixture_lhood(p: IndelPatterns, ln_ins, ln_del,
                         ln_noindel_ref, ln_theta):
    """Sum over patterns of the 4-state genotype mixture
    (getObsLogLhood of indelModelVariantAndIndyError.cpp:54-183)."""
    mix = _indel_obs_mix(p, ln_ins, ln_del, ln_noindel_ref,
                         _priors(ln_theta, True))
    return torch.sum(mix * p.inst)


# ---------------------------------------------------------------------------
# model 1: independent per-observation error rates
# ---------------------------------------------------------------------------

def indel_indy_lhood(p: IndelPatterns, ln_ins, ln_del, ln_theta):
    ln_ins, ln_del = _rate(ln_ins, p.inst), _rate(ln_del, p.inst)
    ln_ref = torch.log(1.0 - torch.exp(ln_ins) - torch.exp(ln_del))
    return _indel_mixture_lhood(p, ln_ins, ln_del, ln_ref, ln_theta)


# ---------------------------------------------------------------------------
# model 3: binomial mixture of clean / noisy loci
# ---------------------------------------------------------------------------

CLEAN_LOCUS_INDEL_RATE = 1e-8


def indel_binom_mixture_lhood(p: IndelPatterns, ln_ins, ln_del,
                              ln_noisy, ln_theta):
    """Per-pattern mixture of a noisy locus (fitted rates) and a clean
    locus (1e-8 rates) (indelModelVariantAndBinomialMixtureError.cpp
    :181-235). Note the per-pattern mix happens before the instance
    weighting, so this cannot reuse _indel_mixture_lhood's sum."""
    ln_ins, ln_del = _rate(ln_ins, p.inst), _rate(ln_del, p.inst)
    ln_noisy = _rate(ln_noisy, p.inst)
    priors = _priors(ln_theta, True)
    ln_ref = torch.log(1.0 - torch.exp(ln_ins) - torch.exp(ln_del))
    noisy = _indel_obs_mix(p, ln_ins, ln_del, ln_ref, priors)
    lc = float(np.log(CLEAN_LOCUS_INDEL_RATE))
    lcr = float(np.log(1.0 - CLEAN_LOCUS_INDEL_RATE))
    clean = _indel_obs_mix(p, lc, lc, lcr, priors)
    ln_clean_locus = torch.log(1.0 - torch.exp(ln_noisy))
    mix = logaddexp(ln_clean_locus + clean, ln_noisy + noisy)
    return torch.sum(mix * p.inst)


# ---------------------------------------------------------------------------
# model 4: beta-binomial error distribution (per indel type)
# ---------------------------------------------------------------------------

def _three_state_mix(priors, noindel, het, hom):
    log_hom_prior, log_het_prior, log_noindel_prior, _ = priors
    return logsumexp(torch.stack([log_hom_prior + hom, log_het_prior + het,
                                  log_noindel_prior + noindel]), dim=0)


def indel_beta_binom_lhood(p: IndelPatterns, ln_mean, ln_conc,
                           is_insert: bool, ln_theta):
    """3-state mixture with a beta-binomial no-indel likelihood
    (indelModelVariantAndBetaBinomialError.cpp:80-208)."""
    mean = torch.exp(_rate(ln_mean, p.inst))
    conc = torch.exp(_rate(ln_conc, p.inst))
    alpha = mean * conc
    beta = conc * (1.0 - mean)

    tot_ins, tot_del = _alt_split(p.alt_obs)
    k = tot_ins if is_insert else tot_del
    n_ref = p.ref_obs
    noindel = betaln(k + alpha, n_ref + beta) - betaln(alpha, beta)
    het = LOG_HET * (n_ref + k)
    hom = LOG_HOM_ALT * k + LOG_HOM_REF * n_ref
    mix = _three_state_mix(_priors(ln_theta, False), noindel, het, hom)
    return torch.sum(mix * p.inst)


# ---------------------------------------------------------------------------
# SNV independent-error model (per-qual error rates)
# ---------------------------------------------------------------------------

@dataclass
class SnvPatterns:
    """Basecall observation patterns: per-qual alt counts + ref count,
    deduplicated with multiplicities (BasecallCounts export analog)."""
    qual_levels: np.ndarray     # [Q] phred levels
    ref_qual_hist: torch.Tensor  # [Q] total ref basecalls by qual
    ref_count: torch.Tensor     # [N] ref basecalls per pattern
    alt_count: torch.Tensor     # [N, Q] alt basecalls by qual
    inst: torch.Tensor          # [N]

    def to(self, device) -> "SnvPatterns":
        return SnvPatterns(self.qual_levels, self.ref_qual_hist.to(device),
                           self.ref_count.to(device),
                           self.alt_count.to(device), self.inst.to(device))


def snv_indy_lhood(sp: SnvPatterns, ln_err_q, ln_theta):
    """snvModelVariantAndIndyError.cpp:43-108 vectorized."""
    ln_err_q = _rate(ln_err_q, sp.inst)
    ref_total = torch.sum(sp.ref_qual_hist)
    ref_err_factor = torch.sum(sp.ref_qual_hist * torch.exp(ln_err_q))
    ln_novar_ref = torch.log(1.0 - ref_err_factor / ref_total)

    alt_tot = sp.alt_count.sum(dim=1)
    novar = (ln_novar_ref * sp.ref_count
             + torch.sum(sp.alt_count * ln_err_q[None, :], dim=1))
    het = LOG_HET * (sp.ref_count + alt_tot)
    hom = LOG_HOM_ALT * alt_tot + LOG_HOM_REF * sp.ref_count
    mix = _three_state_mix(_priors(ln_theta, False), novar, het, hom)
    return torch.sum(mix * sp.inst)


# ---------------------------------------------------------------------------
# Adam fits
# ---------------------------------------------------------------------------

def _fit_plain(loss_fn, x0: np.ndarray, steps: int = 600, lr: float = 0.05,
               device=None) -> tuple[np.ndarray, float]:
    """`steps` Adam steps on loss_fn from x0 on `device` through
    torch.autograd (the plain version); returns the final parameters
    (host f64) and the loss there."""
    dev = _dev(device)
    zk.count_plain(dev)
    x = torch.as_tensor(np.asarray(x0, np.float64), device=dev)
    opt = Adam(x, lr)
    for _ in range(steps):
        xg = x.detach().requires_grad_(True)
        g, = torch.autograd.grad(loss_fn(xg), xg)
        x = opt.step(x, g)
    with torch.no_grad():
        final = float(loss_fn(x))
    return x.cpu().numpy(), final


def kernel_consts(family: str, lock_theta: bool, lr: float = 0.05):
    """The CONSTS doubles of ops/zoo_kernels for `family`'s fit: the
    genotype constants and ln 2, the clean locus's ln rates (log(1 -
    rate) of the 4-state mixture, log1p(-rate) of the NoOverlap one), a
    locked theta's priors folded on the host as the plain version folds
    them, ln of each parameter's limit and Adam's."""
    four = zk.FAMILIES[family].kernel == "KZ-4"
    lc = float(np.log(CLEAN_LOCUS_INDEL_RATE))
    lcr = (float(np.log(1.0 - CLEAN_LOCUS_INDEL_RATE)) if four
           else math.log1p(-math.exp(lc)))
    priors = (_priors(DEFAULT_LOG_THETA, four) if lock_theta
              else (0.0, 0.0, 0.0, 0.0))
    lims = [float(np.log(x)) for x in _LIMITS[family]]
    lims += [0.0] * (4 - len(lims))
    b1, b2 = Adam.B1, Adam.B2
    return (LOG_HOM_ALT, LOG_HOM_REF, LOG_HET, LN2, lc, lcr, *priors, *lims,
            lr, b1, b2, 1 - b1, 1 - b2, Adam.EPS)


def _loss(family: str, p: IndelPatterns, lock_theta: bool,
          is_insert: bool = True):
    """The negative log likelihood of family's fit on p at x (torch), the
    plain version's loss."""
    def theta(x, i):
        return DEFAULT_LOG_THETA if lock_theta else _ln_bounded(x[i], 0.3)
    if family == "indy":
        return lambda x: -indel_indy_lhood(
            p, _ln_bounded(x[0], 0.5), _ln_bounded(x[1], 0.5), theta(x, 2))
    if family == "binom_mixture":
        return lambda x: -indel_binom_mixture_lhood(
            p, _ln_bounded(x[0], 0.5), _ln_bounded(x[1], 0.5),
            _ln_bounded(x[2], 1.0), theta(x, 3))
    if family == "beta_binomial":
        return lambda x: -indel_beta_binom_lhood(
            p, _ln_bounded(x[0], 0.5), _ln_bounded(x[1], MAX_CONCENTRATION),
            is_insert, theta(x, 2))
    if family == "indy_noovl":
        return lambda x: -indel_indy_noovl_lhood(
            p, _ln_bounded(x[0], 0.5), is_insert, theta(x, 1))
    if family == "binom_mixture_noovl":
        return lambda x: -indel_binom_mixture_noovl_lhood(
            p, _ln_bounded(x[0], 0.5), _ln_bounded(x[1], 1.0), is_insert,
            theta(x, 2))
    raise ValueError(f"unknown zoo family: {family}")


def _host_obs(counts):
    """A context's observations as KZ takes them, on the host: ref_obs,
    alt_obs, inst float64 and the two most frequent alt slots int64."""
    alt = np.asarray(counts.alt_obs, np.float64)
    m1, m2 = _max_allele_masks(np.asarray(counts.alt_obs))
    return (np.asarray(counts.ref_obs, np.float64), alt,
            np.asarray(counts.instance_count, np.float64), m1, m2)


def _fit_starts(family: str, counts_list, steps: int, lock_theta: bool,
                is_insert: bool, dev: torch.device,
                plain: bool) -> list:
    """Every start (fit_starts) of family's fit on each context of
    counts_list, `steps` Adam steps each: [[(the final parameters, host
    f64; the loss there)] a start] a context. The plain version, start by
    start, on the CPU or where `plain`; else KZ, every start of every
    context in one ZooBatch on the card (launched, then one wait), which
    raises where it cannot build, load or launch."""
    x0s = fit_starts(family)
    if plain or dev.type == "cpu":
        out = []
        for cc in counts_list:
            p = IndelPatterns.build(cc, dev)
            loss = _loss(family, p, lock_theta, is_insert)
            out.append([_fit_plain(loss, x0, steps, LR, dev) for x0 in x0s])
        return out
    batch = zk.ZooBatch(family, [_host_obs(cc) for cc in counts_list], x0s,
                        kernel_consts(family, lock_theta, LR), steps,
                        lock_theta, is_insert, dev)
    batch.launch()
    return batch.ends()


def _result(family: str, x: np.ndarray, neg: float,
            lock_theta: bool) -> dict:
    """A fit's record: each fitted value (_FIELDS, bounded by _LIMITS),
    theta (1e-4 where locked) and the log likelihood."""
    out = {name: _host_bounded(x[i], lim)
           for i, (name, lim) in enumerate(zip(_FIELDS[family],
                                               _LIMITS[family]))}
    out["theta"] = 1e-4 if lock_theta else _host_bounded(x[-1], 0.3)
    out["log_lhood"] = -neg
    return out


def fit_contexts(family: str, counts_list, is_insert: bool = True,
                 lock_theta: bool = False, steps: int | None = None,
                 device=None, plain: bool = False) -> list[dict]:
    """ML fits of family (a key of ops/zoo_kernels.FAMILIES) on each
    context of counts_list, STEPS[family] Adam steps a start unless
    `steps`, on `device`: each context's record (_result) of its start of
    lower final loss, the first on a tie (the binomial mixtures run two
    starts, NOISY_STARTS: the mixture surface is bimodal). `plain`: the
    plain version on any device (_fit_starts)."""
    dev = _dev(device)
    steps = STEPS[family] if steps is None else steps
    out = []
    for ends in _fit_starts(family, counts_list, steps, lock_theta,
                            is_insert, dev, plain):
        best = ends[0]
        for x, neg in ends[1:]:
            if neg < best[1]:
                best = (x, neg)
        out.append(_result(family, *best, lock_theta))
    return out


def fit_indel_indy(counts, lock_theta: bool = False, steps: int = 600,
                   device=None, plain: bool = False):
    """ML fit of {insert rate, delete rate, theta}; `plain`: the plain
    version on any device (fit_contexts)."""
    return fit_contexts("indy", [counts], True, lock_theta, steps, device,
                        plain)[0]


def fit_indel_binom_mixture(counts, lock_theta: bool = False,
                            steps: int = 1500, device=None,
                            plain: bool = False):
    """ML fit of {insert rate, delete rate, noisy-locus rate, theta}.

    Multi-start on the noisy-locus rate (the mixture surface is
    bimodal: all-noisy recovers the indy model; the minimizer can get
    trapped on either side): the start of lower final loss, the first on
    a tie. `plain` as fit_indel_indy's."""
    return fit_contexts("binom_mixture", [counts], True, lock_theta, steps,
                        device, plain)[0]


MAX_CONCENTRATION = 2000.0
LR = 0.05

# each indel fit's parameter limits in x's order (_ln_bounded's), theta's
# last, by its ops/zoo_kernels family; the names of its fitted values in
# the same order (theta's not among them); its Adam steps a start
_LIMITS = {"indy": (0.5, 0.5, 0.3), "binom_mixture": (0.5, 0.5, 1.0, 0.3),
           "beta_binomial": (0.5, MAX_CONCENTRATION, 0.3),
           "indy_noovl": (0.5, 0.3), "binom_mixture_noovl": (0.5, 1.0, 0.3)}
_FIELDS = {"indy": ("insert_rate", "delete_rate"),
           "binom_mixture": ("insert_rate", "delete_rate",
                             "noisy_locus_rate"),
           "beta_binomial": ("mean", "concentration"),
           "indy_noovl": ("indel_rate",),
           "binom_mixture_noovl": ("indel_rate", "noisy_locus_rate")}
STEPS = {"indy": 600, "binom_mixture": 1500, "beta_binomial": 600,
         "indy_noovl": 600, "binom_mixture_noovl": 1500}
# the binomial mixtures' noisy-locus starts (the mixture surface is
# bimodal), in the order they run
NOISY_STARTS = (0.9, 1e-2)


def fit_starts(family: str) -> list[np.ndarray]:
    """The starts in x of `family`'s fit, in _LIMITS' order: rates at
    1e-4, the concentration at 100, theta at 1e-4, and one start a
    NOISY_STARTS rate for the binomial mixtures."""
    rate, theta = _bounded_init(1e-4, 0.5), _bounded_init(1e-4, 0.3)
    if family == "indy":
        return [np.array([rate, rate, theta])]
    if family == "binom_mixture":
        return [np.array([rate, rate, _bounded_init(n0, 1.0), theta])
                for n0 in NOISY_STARTS]
    if family == "beta_binomial":
        return [np.array([rate, _bounded_init(100.0, MAX_CONCENTRATION),
                          theta])]
    if family == "indy_noovl":
        return [np.array([rate, theta])]
    if family == "binom_mixture_noovl":
        return [np.array([rate, _bounded_init(n0, 1.0), theta])
                for n0 in NOISY_STARTS]
    raise ValueError(f"unknown zoo family: {family}")


def fit_indel_beta_binomial(counts, is_insert: bool,
                            lock_theta: bool = False, steps: int = 600,
                            device=None, plain: bool = False):
    """ML fit of the beta-binomial {mean, concentration, theta} for one
    indel type; `plain` as fit_indel_indy's."""
    return fit_contexts("beta_binomial", [counts], is_insert, lock_theta,
                        steps, device, plain)[0]


def fit_snv_indy(sp: SnvPatterns, lock_theta: bool = False,
                 steps: int = 600, device=None):
    """ML fit of per-qual basecall error rates + theta."""
    sp = sp.to(_dev(device))
    Q = len(sp.qual_levels)
    r0 = np.power(10.0, -np.asarray(sp.qual_levels, dtype=np.float64) / 10.0)
    x0 = np.array([_bounded_init(r, 0.5) for r in r0]
                  + [_bounded_init(1e-4, 0.3)])

    def loss(x):
        le = _ln_bounded(x[:Q], 0.5)
        lt = DEFAULT_LOG_THETA if lock_theta else _ln_bounded(x[Q], 0.3)
        return -snv_indy_lhood(sp, le, lt)

    x, neg = _fit_plain(loss, x0, steps, device=device)
    rates = _host_bounded(x[:Q], 0.5)
    return {
        "qual_levels": [int(q) for q in sp.qual_levels],
        "error_rates": [float(r) for r in rates],
        "theta": (1e-4 if lock_theta else float(np.exp(theta_smoother(
            torch.as_tensor(np.float64(x[Q]))).numpy()))),
        "log_lhood": -neg,
    }


# ---------------------------------------------------------------------------
# NoOverlap variants: one indel type, one error rate, 3-state mixture
# (the reference fits these on counts exported without overlapping
# loci; the same pattern arrays serve here — overlap filtering is a
# counts-export concern, not a likelihood concern)
# ---------------------------------------------------------------------------

def indel_indy_noovl_lhood(p: IndelPatterns, ln_indel, is_insert: bool,
                           ln_theta):
    """indelModelVariantAndIndyErrorNoOverlap.cpp:55-112: single indel
    error rate for one indel type, {homref, het, hom} mixture."""
    ln_indel = _rate(ln_indel, p.inst)
    ln_ref = torch.log1p(-torch.exp(ln_indel))

    tot_ins, tot_del = _alt_split(p.alt_obs)
    k = tot_ins if is_insert else tot_del
    noindel = ln_indel * k + ln_ref * p.ref_obs
    het = LOG_HET * (p.ref_obs + k)
    hom = LOG_HOM_ALT * k + LOG_HOM_REF * p.ref_obs
    mix = _three_state_mix(_priors(ln_theta, False), noindel, het, hom)
    return torch.sum(mix * p.inst)


def indel_binom_mixture_noovl_lhood(p: IndelPatterns, ln_indel, ln_noisy,
                                    is_insert: bool, ln_theta):
    """indelModelVariantAndBinomialMixtureErrorNoOverlap.cpp:64-160:
    per-locus mixture of a clean locus (rate 1e-8) and a noisy locus
    (fitted rate), single indel type."""
    priors = _priors(ln_theta, False)
    tot_ins, tot_del = _alt_split(p.alt_obs)
    k = tot_ins if is_insert else tot_del

    def obs(li):
        lref = torch.log1p(-torch.exp(li)) if torch.is_tensor(li) else \
            math.log1p(-math.exp(li))
        noindel = li * k + lref * p.ref_obs
        het = LOG_HET * (p.ref_obs + k)
        hom = LOG_HOM_ALT * k + LOG_HOM_REF * p.ref_obs
        return _three_state_mix(priors, noindel, het, hom)

    noisy = obs(_rate(ln_indel, p.inst))
    clean = obs(float(np.log(CLEAN_LOCUS_INDEL_RATE)))
    ln_noisy = _rate(ln_noisy, p.inst)
    ln_clean_locus = torch.log1p(-torch.exp(ln_noisy))
    mix = logaddexp(ln_clean_locus + clean, ln_noisy + noisy)
    return torch.sum(mix * p.inst)


def fit_indel_indy_noovl(counts, is_insert: bool,
                         lock_theta: bool = False, steps: int = 600,
                         device=None, plain: bool = False):
    """ML fit of {indel rate, theta} for one indel type; `plain` as
    fit_indel_indy's."""
    return fit_contexts("indy_noovl", [counts], is_insert, lock_theta, steps,
                        device, plain)[0]


def fit_indel_binom_mixture_noovl(counts, is_insert: bool,
                                  lock_theta: bool = False,
                                  steps: int = 1500, device=None,
                                  plain: bool = False):
    """ML fit of {indel rate, noisy-locus rate, theta} for one indel
    type; multi-start on the noisy-locus rate (bimodal surface, see
    fit_indel_binom_mixture); `plain` as fit_indel_indy's."""
    return fit_contexts("binom_mixture_noovl", [counts], is_insert,
                        lock_theta, steps, device, plain)[0]


# ---------------------------------------------------------------------------
# SNV binomial-mixture model: per-qual noisy rates + per-site
# clean/noisy mixture with clean rates tied to noisy rates by a
# log-space exponent (snvModelVariantAndBinomialMixtureError.cpp)
# ---------------------------------------------------------------------------

def snv_binom_mixture_lhood(sp: SnvPatterns, ln_err_q, ln_clean_q,
                            ln_noisy, ln_theta):
    """getObsLogLhood of snvModelVariantAndBinomialMixtureError.cpp
    :60-155 (the strand-combined branch the reference compiles) summed
    over patterns: the no-variant state is a per-SITE clean/noisy
    mixture; het/hom states are rate-free as in the indy model."""
    ln_err_q = _rate(ln_err_q, sp.inst)
    ln_clean_q = _rate(ln_clean_q, sp.inst)
    ln_noisy = _rate(ln_noisy, sp.inst)
    ref_total = torch.sum(sp.ref_qual_hist)
    ln_novar_ref = torch.log1p(
        -torch.sum(sp.ref_qual_hist * torch.exp(ln_err_q)) / ref_total)
    ln_novar_clean_ref = torch.log1p(
        -torch.sum(sp.ref_qual_hist * torch.exp(ln_clean_q)) / ref_total)
    ln_clean_locus = torch.log1p(-torch.exp(ln_noisy))

    novar_noise = (ln_novar_ref * sp.ref_count
                   + torch.sum(sp.alt_count * ln_err_q[None, :], dim=1))
    novar_clean = (ln_novar_clean_ref * sp.ref_count
                   + torch.sum(sp.alt_count * ln_clean_q[None, :], dim=1))
    novar = logaddexp(ln_noisy + novar_noise, ln_clean_locus + novar_clean)

    alt_tot = sp.alt_count.sum(dim=1)
    het = LOG_HET * (sp.ref_count + alt_tot)
    hom = LOG_HOM_ALT * alt_tot + LOG_HOM_REF * sp.ref_count
    mix = _three_state_mix(_priors(ln_theta, False), novar, het, hom)
    return torch.sum(mix * sp.inst)


def fit_snv_binom_mixture(sp: SnvPatterns, lock_theta: bool = False,
                          steps: int = 1500, device=None):
    """ML fit of per-qual noisy rates, the clean-rate exponent
    (logClean = logNoisy * factor, factor > 1 => cleaner,
    getLogCleanLocusBaseErrorRate :50-55), the noisy-locus rate, and
    theta."""
    sp = sp.to(_dev(device))
    Q = len(sp.qual_levels)
    r0 = np.power(10.0, -np.asarray(sp.qual_levels, dtype=np.float64) / 10.0)

    def loss(x):
        le = _ln_bounded(x[:Q], 0.5)
        factor = 1.0 + torch.exp(x[Q])
        lc = le * factor
        ln = _ln_bounded(x[Q + 1], 1.0)
        lt = DEFAULT_LOG_THETA if lock_theta else _ln_bounded(x[Q + 2], 0.3)
        return -snv_binom_mixture_lhood(sp, le, lc, ln, lt)

    best = None
    for noisy0 in (0.9, 1e-2):
        x0 = np.array([_bounded_init(r, 0.5) for r in r0]
                      + [float(np.log(1.0)),
                         _bounded_init(noisy0, 1.0),
                         _bounded_init(1e-4, 0.3)])
        xi, negi = _fit_plain(loss, x0, steps, device=device)
        if best is None or negi < best[1]:
            best = (xi, negi)
    x, neg = best
    rates = _host_bounded(x[:Q], 0.5)
    return {
        "qual_levels": [int(q) for q in sp.qual_levels],
        "error_rates": [float(r) for r in rates],
        "clean_rate_exponent": float(1.0 + np.exp(x[Q])),
        "noisy_locus_rate": _host_bounded(x[Q + 1], 1.0),
        "theta": 1e-4 if lock_theta else _host_bounded(x[Q + 2], 0.3),
        "log_lhood": -neg,
    }


# ---------------------------------------------------------------------------
# model 1: direct summary rates with noisy-locus exclusion
# ---------------------------------------------------------------------------

def indel_model1_report(counts, is_insert: bool,
                        max_alt_frac: float = 0.05,
                        min_depth: int = 25) -> dict:
    """indelModel1.cpp:60-100 reportExtendedContext: exclude loci that
    are shallow or noisy (altFrac > 5%), report the pooled error rate
    and its 95% Clopper-Pearson upper bound."""
    from scipy.stats import beta as beta_dist

    ref = np.asarray(counts.ref_obs, dtype=np.float64)
    alt6 = np.asarray(counts.alt_obs, dtype=np.float64)
    inst = np.asarray(counts.instance_count, dtype=np.float64)
    alt = alt6[:, :3].sum(axis=1) if is_insert else alt6[:, 3:].sum(axis=1)
    total = ref + alt
    used = (total >= min_depth) & \
        (np.divide(alt, np.maximum(total, 1)) <= max_alt_frac)
    sig_ref = float((ref[used] * inst[used]).sum())
    sig_alt = float((alt[used] * inst[used]).sum())
    sig_tot = sig_ref + sig_alt
    alpha = 0.05
    if sig_tot <= 0:
        upper = 1.0
    elif sig_alt >= sig_tot:
        upper = 1.0
    else:
        upper = float(beta_dist.ppf(1.0 - alpha, sig_alt + 1,
                                    sig_tot - sig_alt))
    return {
        "loci": float(inst.sum()),
        "used_loci": float(inst[used].sum()),
        "ref_reads": sig_ref,
        "alt_reads": sig_alt,
        "rate": sig_alt / sig_tot if sig_tot > 0 else 0.0,
        "rate_95pct_upper_bound": upper,
    }
