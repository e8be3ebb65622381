"""Adaptive indel error-rate estimation: counts + vectorized ML fit.

Reference: applications/EstimateVariantErrorRates/IndelModelProduction.cpp
(getObsLogLhood :57-170, contextLogLhood :176-229, parameter smoothers
:260-345, estimateModelParams :411-436, estimateIndelErrorRates
:462-505) and the GetSequenceAlleleCounts counting app
(SequenceAlleleCountsPosProcessor.cpp).

Port of strelka_tpu/models/error_fit.py. The counts are host numpy (the
same dataclass and dedupe); the likelihood runs as f64 torch ops on the
fit's device. On the CPU each step is fit_step_plain: the loss as
torch ops, its gradient from torch.autograd, and optax's Adam in optax's
order (utils/special.Adam), so every expression keeps the JAX package's
association order. On a card the whole fit is one launch of KE-F
(ops/fit_kernels, csrc/error_fit_step.cu): the same elementwise values,
the gradient in closed form, the same Adam bit for bit, the best step
kept on the card. What differs from the JAX package is the order of the
sums over loci (torch's or KE-F's reductions against XLA's) and the
elementwise primitives, each an ulp at most
(tests/test_torch_error_fit.py and tests/test_torch_error_fit_kernel.py
measure the drift).
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from .. import device as devmod
from ..utils.special import Adam, logaddexp, logsumexp

# INDEL_SIGNAL_TYPE: INSERT_1, INSERT_2, INSERT_GE3, DELETE_1, DELETE_2, DELETE_GE3
N_SIGNAL = 6
INSERT_SLOTS = slice(0, 3)
DELETE_SLOTS = slice(3, 6)

LOW_REPEAT_COUNT = 2                    # AdaptiveIndelErrorModel::lowRepeatCount
MAX_REPEAT_COUNTS = {1: 16, 2: 9}      # _maxRepeatCounts
HOM_ALT_RATE = 0.99
CLEAN_LOCUS_INDEL_RATE = 1e-8
MAX_LOG_RATE = float(np.log(0.5))
MAX_LOG_LOCUS_RATE = float(np.log(1.0))

# the smoother's triggers: jnp.log(1e-3) and jnp.log(0.8) in f64 (libm's
# log, bit for bit; tests/test_torch_error_fit.py)
LOG_RATE_TRIGGER = math.log(1e-3)
LOG_LOCUS_TRIGGER = math.log(0.8)

# Work of the fits in this process, for the smoke's log: fits run, Adam
# steps taken, wall seconds inside fit_context.
FIT_STATS = {"fits": 0, "steps": 0, "seconds": 0.0}


def signal_index(is_insertion: bool, length: int) -> int:
    base = 0 if is_insertion else 3
    return base + min(length, 3) - 1


@dataclass
class ContextCounts:
    """Deduplicated locus observation patterns for one STR context."""
    ref_obs: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    alt_obs: np.ndarray = field(default_factory=lambda: np.zeros((0, N_SIGNAL), np.int64))
    instance_count: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))

    @property
    def total_instances(self) -> int:
        return int(self.instance_count.sum())


def dedupe_counts(ref_obs: np.ndarray, alt_obs: np.ndarray) -> ContextCounts:
    """Compress identical (ref, alt[6]) patterns into instance counts
    (the reference's context/observation compression)."""
    rows = np.concatenate([ref_obs[:, None], alt_obs], axis=1)
    uniq, counts = np.unique(rows, axis=0, return_counts=True)
    return ContextCounts(ref_obs=uniq[:, 0], alt_obs=uniq[:, 1:],
                         instance_count=counts)


# --------------------------------------------------------------------------
# likelihood (exact transcription of getObsLogLhood + contextLogLhood)
# --------------------------------------------------------------------------

def _theta_priors(log_theta):
    """(hom, het, noindel, althet) log priors. A float log_theta gives
    floats, as XLA folds the JAX package's constant theta on the host."""
    if isinstance(log_theta, float):
        theta = math.exp(log_theta)
        return (log_theta - math.log(2.0), log_theta, math.log(
            1 - (theta * 3.0 / 2.0 + theta * theta)), log_theta * 2)
    theta = torch.exp(log_theta)
    return (log_theta - math.log(2.0), log_theta,
            torch.log(1 - (theta * 3.0 / 2.0 + theta * theta)),
            log_theta * 2)


def _obs_counts(alt_obs):
    """Each locus's (ins_tot, del_tot, max_val, rem_ins, rem_del,
    max2_val, rem_ins2, rem_del2) from its alt slots: the most frequent
    alt (the first max) as the candidate allele, the second for alt-het
    (max2 clamped at 0), and the counts left after each."""
    ins_tot = torch.sum(alt_obs[:, INSERT_SLOTS], dim=1)
    del_tot = torch.sum(alt_obs[:, DELETE_SLOTS], dim=1)
    max_idx = torch.argmax(alt_obs, dim=1)
    max_val = torch.amax(alt_obs, dim=1)
    is_ins_max = max_idx < 3
    zero = torch.zeros_like(max_val)
    rem_ins = ins_tot - torch.where(is_ins_max, max_val, zero)
    rem_del = del_tot - torch.where(is_ins_max, zero, max_val)
    one_hot = torch.nn.functional.one_hot(max_idx, N_SIGNAL).to(torch.bool)
    masked = torch.where(one_hot, torch.full_like(alt_obs, -1), alt_obs)
    max2_idx = torch.argmax(masked, dim=1)
    max2_val = torch.maximum(torch.amax(masked, dim=1), zero)
    is_ins_max2 = max2_idx < 3
    rem_ins2 = rem_ins - torch.where(is_ins_max2, max2_val, zero)
    rem_del2 = rem_del - torch.where(is_ins_max2, zero, max2_val)
    return (ins_tot, del_tot, max_val, rem_ins, rem_del, max2_val, rem_ins2,
            rem_del2)


def _obs_log_lhood(log_ins, log_del, log_ref_rate, ref_obs, alt_obs,
                   log_theta):
    """Vectorized per-locus genotype-marginalized log lhood [N]."""
    log_hom_prior, log_het_prior, log_noindel_prior, log_althet_prior = \
        _theta_priors(log_theta)

    log_hom_alt = math.log(HOM_ALT_RATE)
    log_hom_ref = math.log(1 - HOM_ALT_RATE)
    log_het = math.log(0.5)

    (ins_tot, del_tot, max_val, rem_ins, rem_del, max2_val, rem_ins2,
     rem_del2) = _obs_counts(alt_obs)

    noindel = log_ins * ins_tot + log_del * del_tot + log_ref_rate * ref_obs
    het = (log_het * (ref_obs + max_val) + log_ins * rem_ins + log_del * rem_del)
    hom = (log_hom_alt * max_val + log_hom_ref * ref_obs +
           log_ins * rem_ins + log_del * rem_del)
    althet = (log_het * (max_val + max2_val) + log_hom_ref * ref_obs +
              log_ins * rem_ins2 + log_del * rem_del2)

    stacked = torch.stack([
        log_hom_prior + hom, log_het_prior + het,
        log_noindel_prior + noindel, log_althet_prior + althet], dim=0)
    return logsumexp(stacked, dim=0)


def context_log_lhood(log_ins, log_del, log_noisy, log_theta,
                      ref_obs, alt_obs, instance_count):
    """contextLogLhood: noisy/clean mixture summed over loci. The rates
    are 0-d f64 tensors; the observations f64 tensors on their device."""
    log_ref_rate = torch.log(1 - torch.exp(log_ins) - torch.exp(log_del))
    log_clean = math.log(CLEAN_LOCUS_INDEL_RATE)
    log_clean_ref = math.log(1 - CLEAN_LOCUS_INDEL_RATE)
    log_clean_locus = torch.log1p(-torch.exp(log_noisy))

    noisy_mix = _obs_log_lhood(log_ins, log_del, log_ref_rate,
                               ref_obs, alt_obs, log_theta)
    clean_mix = _obs_log_lhood(log_clean, log_clean, log_clean_ref,
                               ref_obs, alt_obs, log_theta)
    mix = logaddexp(log_clean_locus + clean_mix, log_noisy + noisy_mix)
    return torch.sum(mix * instance_count)


def _rate_smoother(a, max_log):
    trigger = LOG_RATE_TRIGGER if max_log == MAX_LOG_RATE else LOG_LOCUS_TRIGGER
    a = torch.where(a > trigger, torch.log1p(a - trigger) + trigger, a)
    return torch.where(a > max_log, max_log - torch.abs(a - max_log), a)


@dataclass
class FitResult:
    log_error_rate: float
    log_noisy_locus_rate: float
    log_insert_rate: float
    log_delete_rate: float
    acceptable: bool
    n_instances: int


def _neg_lhood(params, lt, ref_obs, alt_obs, inst):
    li = _rate_smoother(params[0], MAX_LOG_RATE)
    ld = _rate_smoother(params[1], MAX_LOG_RATE)
    ln = _rate_smoother(params[2], MAX_LOG_LOCUS_RATE)
    return -context_log_lhood(li, ld, ln, lt, ref_obs, alt_obs, inst)


def fit_step_plain(params, opt: Adam, lt: float, ref_obs, alt_obs, inst):
    """KE-F's plain version: one step of the fit as torch ops, the loss
    at `params`, its gradient by torch.autograd, then opt's Adam step.
    Returns (the parameters after the step, the loss (0-d), the
    gradient)."""
    from ..ops import fit_kernels as fk
    fk.count_plain("error_fit_step", params.device)
    x = params.detach().requires_grad_(True)
    v = _neg_lhood(x, lt, ref_obs, alt_obs, inst)
    g, = torch.autograd.grad(v, x)
    return opt.step(params, g), v.detach(), g


def fit_prep_plain(ref_obs, alt_obs, inst, log_theta: float):
    """KE-F prep's plain version: loc [12, N] float64, each locus's
    parameter-free values in ops/fit_kernels.ROWS's order, as the plain
    expressions of _obs_log_lhood compute them (_obs_counts, the hom, het
    and alt-het sums' parameter-free left prefixes, the whole clean
    mixture)."""
    from ..ops import fit_kernels as fk
    fk.count_plain("error_fit_prep", ref_obs.device)
    log_hom_alt = math.log(HOM_ALT_RATE)
    log_hom_ref = math.log(1 - HOM_ALT_RATE)
    log_het = math.log(0.5)
    (ins_tot, del_tot, max_val, rem_ins, rem_del, max2_val, rem_ins2,
     rem_del2) = _obs_counts(alt_obs)
    clean = _obs_log_lhood(math.log(CLEAN_LOCUS_INDEL_RATE),
                           math.log(CLEAN_LOCUS_INDEL_RATE),
                           math.log(1 - CLEAN_LOCUS_INDEL_RATE), ref_obs,
                           alt_obs, float(log_theta))
    return torch.stack([
        ref_obs, ins_tot, del_tot, rem_ins, rem_del, rem_ins2, rem_del2,
        log_hom_alt * max_val + log_hom_ref * ref_obs,
        log_het * (ref_obs + max_val),
        log_het * (max_val + max2_val) + log_hom_ref * ref_obs, clean,
        inst])


def kernel_consts(log_theta: float, lr: float) -> tuple:
    """KE-F's host doubles (ops/fit_kernels.CONSTS) for a fit at
    log_theta with Adam at learning rate lr (its other settings Adam's
    defaults, as the plain fit takes them): the log constants and priors
    as the plain version's floats (_theta_priors of a float)."""
    b1, b2 = Adam.B1, Adam.B2
    return (math.log(HOM_ALT_RATE), math.log(1 - HOM_ALT_RATE),
            math.log(0.5), math.log(CLEAN_LOCUS_INDEL_RATE),
            math.log(1 - CLEAN_LOCUS_INDEL_RATE),
            *_theta_priors(float(log_theta)), LOG_RATE_TRIGGER,
            LOG_LOCUS_TRIGGER, MAX_LOG_RATE, MAX_LOG_LOCUS_RATE, lr, b1, b2,
            1 - b1, 1 - b2, Adam.EPS)


def _fit_plain(params, lr, n_steps, lt, obs):
    """The fit through fit_step_plain: (best loss, its parameters)."""
    opt = Adam(params, lr)
    best = None
    for _ in range(n_steps):
        params, v, _ = fit_step_plain(params, opt, lt, *obs)
        v = float(v)
        if best is None or v < best[0]:
            best = (v, params.cpu().numpy())
    return best


def _fit_kernel(params, lr, n_steps, lt, obs):
    """The fit through KE-F on the observations' card: one launch of its
    fit entry (the n_steps Adam steps and the best step on the card), one
    read of the state at the end: (best loss, its parameters)."""
    from ..ops import fit_kernels as fk
    run = fk.error_fit_run(*obs, params, kernel_consts(lt, lr), n_steps)
    state = run.state.cpu()
    return float(state[fk.BEST_V]), state[fk.BEST_PARAMS].numpy()


def _fit(counts: ContextCounts, log_theta: float, n_steps: int, lr: float,
         device, fit) -> FitResult:
    """The fit on `device` through `fit` (_fit_kernel or _fit_plain; the
    CPU always takes _fit_plain)."""
    if counts.total_instances == 0:
        return FitResult(-np.inf, -np.inf, -np.inf, -np.inf, False, 0)
    dev = devmod.current() if device is None else devmod.resolve(device)
    t0 = time.perf_counter()

    def f64(a):
        return torch.as_tensor(np.asarray(a, np.float64), device=dev)
    obs = (f64(counts.ref_obs), f64(counts.alt_obs),
           f64(counts.instance_count))
    params = f64([np.log(1e-3), np.log(1e-3), np.log(0.5)])
    run = _fit_plain if dev.type == "cpu" else fit
    best = run(params, lr, n_steps, float(log_theta), obs)
    FIT_STATS["fits"] += 1
    FIT_STATS["steps"] += n_steps
    FIT_STATS["seconds"] += time.perf_counter() - t0
    p = torch.as_tensor(best[1])
    li = float(_rate_smoother(p[0], MAX_LOG_RATE))
    ld = float(_rate_smoother(p[1], MAX_LOG_RATE))
    ln = float(_rate_smoother(p[2], MAX_LOG_LOCUS_RATE))
    log_err = (li + ld) / 2.0
    return FitResult(log_err, ln, li, ld, True, counts.total_instances)


def fit_context(counts: ContextCounts, log_theta: float,
                n_steps: int = 600, lr: float = 0.05,
                device=None) -> FitResult:
    """ML fit of (ln insert, ln delete, ln noisy-locus) rates with the
    reference's smoother reparameterization; theta locked. Runs on
    `device` (default: the current device): on the CPU through the
    plain step (fit_step_plain), on a card through KE-F's fit entry, one
    launch a fit (ops/fit_kernels.error_fit_run).

    As in the JAX package, each step evaluates the loss and gradient at
    the parameters, then takes the Adam step; the best loss seen (strict
    <, so ties keep the earlier step) keeps the parameters *after* its
    step."""
    return _fit(counts, log_theta, n_steps, lr, device, _fit_kernel)


def fit_context_plain(counts: ContextCounts, log_theta: float,
                      n_steps: int = 600, lr: float = 0.05,
                      device=None) -> FitResult:
    """fit_context through the plain step on any device: on a card, the
    version that KE-F is held against."""
    return _fit(counts, log_theta, n_steps, lr, device, _fit_plain)


def _linear_fit(x, x1, y1, x2, y2):
    return ((x2 - x) * y1 + (x - x1) * y2) / (x2 - x1)


def estimate_indel_error_model(
    counts_by_context: dict[tuple[int, int], ContextCounts],
    thetas: dict[int, np.ndarray] | None = None,
    sample_name: str = "Sample000",
    min_instances: int = 100,
    device=None,
):
    """Full estimation pipeline -> model dict in the engine's JSON
    format (estimateIndelErrorRates + generateIndelErrorModelJson).
    Returns (model_dict, acceptable). The fits run on `device`."""
    from .indel_genotype import THETA_TABLES
    if thetas is None:
        thetas = THETA_TABLES

    from .error_model import adaptive_default_error_model
    static = adaptive_default_error_model()

    motifs = []
    acceptable = True

    def fit(key, log_theta):
        return fit_context(counts_by_context.get(key, ContextCounts()),
                           log_theta, device=device)

    def fallback(fit: FitResult, ps: int, rc: int) -> FitResult:
        """Static-model substitution when a context fit fails
        (strelkaGermlineWorkflow.py:280-301 validation rule)."""
        if fit.acceptable and fit.n_instances >= min_instances and \
                np.isfinite(fit.log_error_rate):
            return fit
        rate = float(static.get_rate(ps, rc, "I"))
        return FitResult(np.log(rate), np.log(1e-9), np.log(rate),
                         np.log(rate), False, fit.n_instances)

    # non-STR context (1, 1)
    non_str = fit((1, 1), float(np.log(thetas[1][0])))
    non_str = fallback(non_str, 1, 1)
    acceptable &= non_str.acceptable

    for ps, high in MAX_REPEAT_COUNTS.items():
        theta = thetas[ps]
        motifs.append({"repeatPatternSize": ps, "repeatCount": 1,
                       "indelRate": float(np.exp(non_str.log_error_rate)),
                       "noisyLocusRate": float(np.exp(non_str.log_noisy_locus_rate))})
        low = fit((ps, LOW_REPEAT_COUNT),
                  float(np.log(theta[LOW_REPEAT_COUNT - 1])))
        hi = fit((ps, high), float(np.log(theta[high - 1])))
        acceptable &= low.acceptable and hi.acceptable
        low = fallback(low, ps, LOW_REPEAT_COUNT)
        hi = fallback(hi, ps, high)
        for rc in range(LOW_REPEAT_COUNT, high + 1):
            if rc >= high:
                le, ln = hi.log_error_rate, hi.log_noisy_locus_rate
            else:
                le = _linear_fit(rc, LOW_REPEAT_COUNT, low.log_error_rate,
                                 high, hi.log_error_rate)
                ln = _linear_fit(rc, LOW_REPEAT_COUNT, low.log_noisy_locus_rate,
                                 high, hi.log_noisy_locus_rate)
            motifs.append({"repeatPatternSize": ps, "repeatCount": rc,
                           "indelRate": float(np.exp(le)),
                           "noisyLocusRate": float(np.exp(ln))})

    model = {"sample": [{"sampleName": sample_name, "motif": motifs,
                         "isStatic": False}]}
    return model, acceptable
