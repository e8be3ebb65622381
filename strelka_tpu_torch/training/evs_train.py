"""EVS model training: labeled feature matrix -> random forest -> JSON.

Reference: src/python/scoringModelTraining/{germline,somatic}/bin/
evs_learn.py + evs_exportmodel.py — sklearn RandomForestClassifier
trained on truth-labeled variant feature CSVs, exported to the
scoring-model JSON consumed at runtime (calibration/RandomForestModel).

The exported JSON round-trips through ops/rf.py: sklearn's tree arrays
(children_left/right, feature, threshold, value) map directly onto the
TREE/DECISION/VOTE node dictionaries.

Port of strelka_tpu/training/evs_train.py (host code: sklearn, imported
where a forest is trained, and the port's io.vcf and ops.rf).
"""
from __future__ import annotations

import datetime
import json

import numpy as np


def train_forest(features: np.ndarray, labels: np.ndarray,
                 n_trees: int = 100, max_depth: int | None = None,
                 random_state: int = 0):
    """labels: 1 = true variant, 0 = false positive."""
    from sklearn.ensemble import RandomForestClassifier

    clf = RandomForestClassifier(
        n_estimators=n_trees, max_depth=max_depth,
        random_state=random_state, n_jobs=-1)
    clf.fit(features, labels)
    return clf


def sklearn_tree_to_json(tree) -> dict:
    """One sklearn decision tree -> {tree, decisions, node_votes}."""
    t = tree.tree_
    tree_map = {}
    decisions = {}
    votes = {}
    for i in range(t.node_count):
        left = int(t.children_left[i])
        right = int(t.children_right[i])
        tree_map[str(i)] = [left if left != -1 else -1,
                            right if right != -1 else -1]
        if left != -1:
            decisions[str(i)] = [int(t.feature[i]), float(t.threshold[i])]
        # value[i] = class counts [n_fp, n_tp]; leaf prob of FP =
        # votes.left/(left+right) to match getDecisionTreeProb
        v = t.value[i][0]
        if len(v) == 1:
            fp_count, tp_count = float(v[0]), 0.0
        else:
            fp_count, tp_count = float(v[0]), float(v[1])
        votes[str(i)] = [fp_count, tp_count]
    return {"tree": tree_map, "decisions": decisions, "node_votes": votes}


def export_model_json(clf, feature_names: list[str], variant_type: str,
                      category: str = "Somatic", filter_cutoff: float = 7.0,
                      scale: float = 1.0, power: float = 1.0) -> dict:
    trees = [sklearn_tree_to_json(est) for est in clf.estimators_]
    return {
        "CalibrationModels": {
            category: {
                variant_type: {
                    "Features": feature_names,
                    "Calibration": {"Scale": scale, "Power": power},
                    "FilterCutoff": filter_cutoff,
                    "ModelType": "RandomForest",
                    "Date": datetime.datetime.now(datetime.timezone.utc)
                    .isoformat(),
                    "Model": trees,
                },
            },
        },
    }


def train_and_export(features: np.ndarray, labels: np.ndarray,
                     feature_names: list[str], out_path: str,
                     variant_type: str = "SNV", category: str = "Somatic",
                     filter_cutoff: float = 7.0, **kw) -> None:
    clf = train_forest(features, labels, **kw)
    doc = export_model_json(clf, feature_names, variant_type, category,
                            filter_cutoff)
    with open(out_path, "w") as f:
        json.dump(doc, f)


def evaluate_precision_recall(forest, features: np.ndarray,
                              labels: np.ndarray, thresholds=None):
    """PR curve over phred EVS thresholds (evs_pr.py analog)."""
    scores = forest.score_phred(features)
    if thresholds is None:
        thresholds = np.arange(0, 41, 1)
    out = []
    pos = labels.sum()
    for t in thresholds:
        called = scores >= t
        tp = int((called & (labels == 1)).sum())
        fp = int((called & (labels == 0)).sum())
        prec = tp / max(tp + fp, 1)
        rec = tp / max(pos, 1)
        out.append((float(t), prec, rec))
    return out


def read_evsf_vcf(path: str, variant_type: str | None = None):
    """Yield EVSF feature vectors from a --report-evs-features run
    (vcf_to_feature_csv.py analog). variant_type: "SNV"/"INDEL"/None."""
    from ..io.vcf import _open_maybe_gz

    with _open_maybe_gz(path) as f:
        for line in f:
            if line.startswith("#"):
                continue
            fields = line.rstrip("\n").split("\t")
            ref, alts = fields[3], fields[4].split(",")
            is_snv = len(ref) == 1 and all(len(a) == 1 for a in alts)
            if variant_type == "SNV" and not is_snv:
                continue
            if variant_type == "INDEL" and is_snv:
                continue
            for kv in fields[7].split(";"):
                if kv.startswith("EVSF="):
                    vals = [float(x) for x in kv[5:].split(",")]
                    yield (fields[0], int(fields[1]), ref, fields[4],
                           "SNV" if is_snv else "INDEL", vals)
                    break


def vcf_to_feature_csv(tp_vcfs: list[str], fp_vcfs: list[str],
                       out_path: str, variant_type: str | None = None,
                       feature_names: list[str] | None = None) -> int:
    """Labeled training CSV from EVSF-annotated VCFs
    (scoringModelTraining/somatic/bin/vcf_to_feature_csv.py analog:
    TP/FP label comes from which input set a record belongs to)."""
    n = 0
    width = None
    with open(out_path, "w") as out:
        for label, paths in ((1, tp_vcfs), (0, fp_vcfs)):
            for p in paths:
                for chrom, pos, ref, alt, vt, vals in read_evsf_vcf(
                        p, variant_type):
                    if width is None:
                        width = len(vals)
                        names = (feature_names if feature_names else
                                 [f"F{i}" for i in range(width)])
                        out.write("CHROM,POS,TYPE,label,"
                                  + ",".join(names) + "\n")
                    elif len(vals) != width:
                        raise ValueError(
                            f"{p}:{chrom}:{pos}: EVSF width {len(vals)}"
                            f" != {width}; SNV and indel feature sets "
                            "differ — pass variant_type='SNV' or "
                            "'INDEL' to select one")
                    out.write(f"{chrom},{pos},{vt},{label},"
                              + ",".join(repr(v) for v in vals) + "\n")
                    n += 1
    return n


def load_feature_csv(path: str):
    """(features [N,F] f64, labels [N] int, feature_names) from a
    vcf_to_feature_csv output."""
    import csv

    feats, labels = [], []
    with open(path) as f:
        r = csv.reader(f)
        header = next(r)
        names = header[4:]
        for row in r:
            labels.append(int(row[3]))
            feats.append([float(x) for x in row[4:]])
    return (np.array(feats, dtype=np.float64),
            np.array(labels, dtype=np.int64), names)
