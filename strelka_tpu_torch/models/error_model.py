"""STR-context indel error rates.

Reference: calibration/IndelErrorModel.cpp|hh + IndelErrorRateSet.hh.
Rates are stored as dense [patternSize, repeatCount] numpy tables so
whole batches of indels can be rate-looked-up with a single gather
(and shipped to device as constant tensors for the realignment kernel).
"""
from __future__ import annotations

import json

import numpy as np


class IndelErrorRateSet:
    """Dense (patternSize, repeatCount) -> (ins_rate, del_rate) tables
    with the reference's clamping semantics (IndelErrorRateSet.hh
    getRate: unknown pattern size -> baseline (1,1); repeat count
    clamped to max defined)."""

    def __init__(self):
        self._rates: dict[int, dict[int, tuple[float, float, float]]] = {}
        self._tables = None

    def add_rate(self, pattern_size: int, repeat_count: int,
                 ins_rate: float, del_rate: float, noisy_rate: float = 0.0):
        self._rates.setdefault(pattern_size, {})[repeat_count] = (
            ins_rate, del_rate, noisy_rate)
        self._tables = None

    def finalize(self):
        """Build dense per-pattern-size arrays."""
        sizes = sorted(self._rates)
        assert sizes and sizes == list(range(1, len(sizes) + 1)), \
            "pattern sizes must be contiguous from 1"
        tables = []
        for ps in sizes:
            counts = sorted(self._rates[ps])
            assert counts == list(range(1, len(counts) + 1)), \
                f"repeat counts for pattern size {ps} must be contiguous"
            arr = np.array([self._rates[ps][c] for c in counts])  # [C, 3]
            tables.append(arr)
        self._tables = tables
        return self

    def get_rate(self, pattern_size, repeat_count, indel_type: str):
        """indel_type: 'I' or 'D'. Vectorized over numpy inputs."""
        assert self._tables is not None, "finalize() first"
        if isinstance(pattern_size, (int, np.integer)) and \
                isinstance(repeat_count, (int, np.integer)):
            # scalar fast path: the per-locus callers hit this with a
            # handful of distinct (ps, rc) keys per region
            cache = getattr(self, "_scalar_cache", None)
            if cache is None:
                cache = self._scalar_cache = {}
            key = (int(pattern_size), int(repeat_count), indel_type)
            v = cache.get(key)
            if v is None:
                col = 0 if indel_type == "I" else 1
                n_sizes = len(self._tables)
                ps, rc = key[0], key[1]
                if ps > n_sizes:
                    ps, rc = 1, 1
                ps = max(ps, 1)
                rc = max(rc, 1)
                tab = self._tables[ps - 1]
                v = float(tab[min(rc - 1, len(tab) - 1), col])
                cache[key] = v
            return v
        pattern_size = np.asarray(pattern_size)
        repeat_count = np.asarray(repeat_count)
        col = 0 if indel_type == "I" else 1
        n_sizes = len(self._tables)
        # unknown pattern size -> baseline (1,1)
        unknown = pattern_size > n_sizes
        ps = np.where(unknown, 1, np.maximum(pattern_size, 1))
        rc = np.where(unknown, 1, np.maximum(repeat_count, 1))
        out = np.empty(np.broadcast(ps, rc).shape, dtype=np.float64)
        ps_b = np.broadcast_to(ps, out.shape)
        rc_b = np.broadcast_to(rc, out.shape)
        for s in range(1, n_sizes + 1):
            m = ps_b == s
            if not m.any():
                continue
            tab = self._tables[s - 1]
            idx = np.minimum(rc_b[m] - 1, len(tab) - 1)
            out[m] = tab[idx, col]
        return out if out.shape else float(out)


def _linear_fit(x, x1, y1, x2, y2):
    return ((x2 - x) * y1 + (x - x1) * y2) / (x2 - x1)


def log_linear_error_model() -> IndelErrorRateSet:
    """The v2.7.x log-linear hpol ramp, always used for candidacy
    (IndelErrorModel.cpp getLogLinearIndelErrorModel:40-66)."""
    rates = IndelErrorRateSet()
    log_low = np.log(5e-5)
    log_high = np.log(3e-4)
    switch = 15
    for rc in range(1, switch + 2):
        frac = min(rc - 1, switch) / switch
        rate = float(np.exp((1 - frac) * log_low + frac * log_high))
        rates.add_rate(1, rc, rate, rate)
    return rates.finalize()


def adaptive_default_error_model() -> IndelErrorRateSet:
    """'adaptiveDefault' static model
    (IndelErrorModel.cpp getSimplifiedAdaptiveParameters:69-124):
    non-STR rate 8e-3; hpol ramp 4.9e-3..4.5e-2 over counts 2..16;
    dinuc ramp 1.0e-2..1.8e-2 over counts 2..9."""
    rates = IndelErrorRateSet()
    non_str = 8e-3
    params = [  # (pattern_size, log_low, log_high, switch_count)
        (1, np.log(4.9e-3), np.log(4.5e-2), 16),
        (2, np.log(1.0e-2), np.log(1.8e-2), 9),
    ]
    low_repeat_count = 2  # AdaptiveIndelErrorModel::lowRepeatCount
    for ps, log_low, log_high, switch in params:
        rates.add_rate(ps, 1, non_str, non_str)
        for rc in range(low_repeat_count, switch + 1):
            if rc >= switch:
                r = float(np.exp(log_high))
            else:
                r = float(np.exp(_linear_fit(rc, low_repeat_count, log_low,
                                             switch, log_high)))
            rates.add_rate(ps, rc, r, r)
    return rates.finalize()


def load_error_model_json(path: str) -> dict[str, IndelErrorRateSet]:
    """Load sample->rates from the engine's JSON model format, which
    mirrors the reference's (IndelErrorModelJson.hh|cpp): motif list of
    {indelRate, noisyLocusRate, repeatCount, repeatPatternSize}."""
    with open(path) as f:
        doc = json.load(f)
    from .schema import validate_model
    validate_model(doc, "indel-error", source=path)
    out = {}
    for sample in doc["sample"]:
        rates = IndelErrorRateSet()
        for m in sample["motif"]:
            rates.add_rate(m["repeatPatternSize"], m["repeatCount"],
                           m["indelRate"], m["indelRate"],
                           m.get("noisyLocusRate", 0.0))
        out[sample.get("sampleName", "default")] = rates.finalize()
    return out


class IndelErrorModel:
    """Top-level error model (IndelErrorModel.cpp ctor semantics):
    named static models or per-sample JSON files; candidacy rates always
    use the log-linear ramp."""

    def __init__(self, n_samples: int, model_name: str = "adaptiveDefault",
                 model_files: list[str] | None = None):
        self.n_samples = n_samples
        self.candidate_rates = log_linear_error_model()
        if not model_files:
            if model_name == "logLinear":
                shared = log_linear_error_model()
            elif model_name == "adaptiveDefault":
                shared = adaptive_default_error_model()
            else:
                raise ValueError(f"unknown indel error model: {model_name}")
            self._sample_rates = [shared]
            self._per_sample = False
        else:
            loaded = [load_error_model_json(p) for p in model_files]
            if len(loaded) == 1 and list(loaded[0]) == ["default"]:
                self._sample_rates = [loaded[0]["default"]]
                self._per_sample = False
            else:
                self._sample_rates = [
                    next(iter(d.values())) for d in loaded]
                self._per_sample = True
                assert len(self._sample_rates) == n_samples

    def rates_for_sample(self, sample_index: int) -> IndelErrorRateSet:
        return self._sample_rates[sample_index if self._per_sample else 0]

    def get_rates(self, sample_index, pattern_size, ref_repeat_count,
                  indel_repeat_count, is_insertion, is_candidate=False):
        """(ref->indel, indel->ref) error prob arrays
        (IndelErrorModel.cpp getIndelErrorRate:228-275)."""
        rs = self.candidate_rates if is_candidate else self.rates_for_sample(sample_index)
        is_ins = np.asarray(is_insertion)
        fwd_i = rs.get_rate(pattern_size, ref_repeat_count, "I")
        fwd_d = rs.get_rate(pattern_size, ref_repeat_count, "D")
        rev_i = rs.get_rate(pattern_size, indel_repeat_count, "I")
        rev_d = rs.get_rate(pattern_size, indel_repeat_count, "D")
        ref_to_indel = np.where(is_ins, fwd_i, fwd_d)
        indel_to_ref = np.where(is_ins, rev_d, rev_i)
        return ref_to_indel, indel_to_ref
