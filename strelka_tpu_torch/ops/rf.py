"""Vectorized random-forest inference for empirical variant scoring.

Reference: calibration/RandomForestModel.cpp (Deserialize :108-176,
getDecisionTreeProb :180-210, getProb :214-230) and
VariantScoringModelServer.hh (scale/power calibration :52).

TPU-native re-design: the forest is flattened into dense per-node
arrays [n_trees, max_nodes] (feature index, threshold, children, leaf
prob) and evaluated for whole variant batches by iterating gather steps
to max depth — no per-variant tree walks. Runs in numpy.
"""
from __future__ import annotations

import json
from dataclasses import dataclass

import numpy as np


@dataclass
class Forest:
    feature_idx: np.ndarray  # [T, N] int32 (-1 at leaves)
    threshold: np.ndarray    # [T, N] f64
    left: np.ndarray         # [T, N] int32 (-1 at leaves)
    right: np.ndarray        # [T, N] int32
    leaf_prob: np.ndarray    # [T, N] f64 (vote.left / total at leaves)
    max_depth: int
    features: list[str]
    prob_scale: float = 1.0
    prob_pow: float = 1.0
    filter_cutoff: float = 0.0

    @property
    def n_trees(self) -> int:
        return self.feature_idx.shape[0]

    def predict_prob(self, x: np.ndarray) -> np.ndarray:
        """x: [B, F] feature matrix -> [B] mean leaf probability."""
        x = np.asarray(x, dtype=np.float64)
        B = x.shape[0]
        T, N = self.feature_idx.shape
        node = np.zeros((B, T), dtype=np.int64)
        for _ in range(self.max_depth + 1):
            fi = self.feature_idx[np.arange(T)[None, :], node]      # [B, T]
            thr = self.threshold[np.arange(T)[None, :], node]
            is_leaf = fi < 0
            fv = np.take_along_axis(x, np.maximum(fi, 0), axis=1)
            go_left = fv <= thr
            nxt = np.where(go_left,
                           self.left[np.arange(T)[None, :], node],
                           self.right[np.arange(T)[None, :], node])
            node = np.where(is_leaf, node, nxt)
        probs = self.leaf_prob[np.arange(T)[None, :], node]
        return probs.mean(axis=1)

    def score_phred(self, x: np.ndarray, max_score: float = 60.0) -> np.ndarray:
        """Calibrated phred EVS (somaticAlleleUtil.cpp:33-37)."""
        p = np.clip(self.prob_scale * np.power(self.predict_prob(x),
                                               self.prob_pow), 0.0, 1.0)
        tiny = np.finfo(np.float64).tiny
        return np.minimum(-10.0 * np.log10(np.maximum(p, tiny)), max_score)


def _max_tree_depth(left, right):
    # iterative depth computation over the dense child arrays
    n = len(left)
    depth = np.zeros(n, dtype=np.int64)
    order = range(n)
    changed = True
    it = 0
    while changed and it < n:
        changed = False
        it += 1
        for i in order:
            for c in (left[i], right[i]):
                if c >= 0 and depth[c] < depth[i] + 1:
                    depth[c] = depth[i] + 1
                    changed = True
    return int(depth.max()) if n else 0


def load_forest_json(doc: dict) -> Forest:
    """Build a Forest from one model dict with Features/Model/
    Calibration keys (the reference's scoring-model JSON layout)."""
    features = doc["Features"]
    trees = doc["Model"]
    T = len(trees)
    N = max(max(int(k) for k in t["tree"]) + 1 for t in trees)
    fi = np.full((T, N), -1, dtype=np.int32)
    thr = np.zeros((T, N), dtype=np.float64)
    left = np.full((T, N), -1, dtype=np.int32)
    right = np.full((T, N), -1, dtype=np.int32)
    prob = np.zeros((T, N), dtype=np.float64)
    max_depth = 0
    for ti, t in enumerate(trees):
        for k, (l, r) in t["tree"].items():
            i = int(k)
            if l != -1:
                left[ti, i] = l
                right[ti, i] = r
        for k, (f, c) in t["decisions"].items():
            i = int(k)
            if left[ti, i] >= 0:
                fi[ti, i] = int(f)
                thr[ti, i] = float(c)
        for k, (lv, rv) in t["node_votes"].items():
            i = int(k)
            total = lv + rv
            prob[ti, i] = lv / total if total > 0 else 0.0
        max_depth = max(max_depth, _max_tree_depth(left[ti], right[ti]))
    cal = doc.get("Calibration", {})
    return Forest(
        feature_idx=fi, threshold=thr, left=left, right=right,
        leaf_prob=prob, max_depth=max_depth, features=features,
        prob_scale=float(cal.get("Scale", 1.0)),
        prob_pow=float(cal.get("Power", 1.0)),
        filter_cutoff=float(doc.get("FilterCutoff", 0.0)),
    )


def load_scoring_model(path: str, variant_type: str,
                       category: str | None = None) -> Forest:
    """Load e.g. ('SNV'|'Indel') model from a scoring-model JSON file
    (VariantScoringModelServer semantics: CalibrationModels ->
    <category> -> <type>)."""
    with open(path) as f:
        doc = json.load(f)
    from ..models.schema import validate_model
    validate_model(doc, "evs", source=path)
    models = doc["CalibrationModels"]
    if category is None:
        category = next(iter(models))
    return load_forest_json(models[category][variant_type])
