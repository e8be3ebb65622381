"""The port's germline CLI with EVS model files (python -m
strelka_tpu_torch germline --device cpu --snv-scoring-model-file
--indel-scoring-model-file) against the JAX package's, on the dryrun
dataset of tests/test_torch_germline_e2e.py, in WGS mode and with
--exome.

The reference ships no germline SNV model and nothing may be
downloaded, so the SNV and indel forests are trained here with
strelka_tpu.training.evs_train on seeded random rows over the germline
feature names (as tests/test_germline_snv_evs.py and
tests/test_germline_indel_evs.py do). variants.vcf.gz and
genome.S1.vcf.gz must be byte-identical after dropping the volatile
header lines.
"""
import gzip
import json
import os

import numpy as np
import pytest

from strelka_tpu.training import evs_train
from strelka_tpu.workflow.germline import run_germline as jax_germline
from strelka_tpu_torch.__main__ import main as torch_main
from strelka_tpu_torch.ops import rf as trf
from tests.test_torch_germline_e2e import DROP, OUTPUTS, dataset  # noqa: F401

GERMLINE_SNV_FEATURES = [
    "SiteHomopolymerLength", "SampleStrandBias",
    "SamplePrimaryAltAlleleDepth", "VariantAlleleQuality",
    "SampleMeanDistanceFromReadEdge", "SamplePrimaryAltAlleleDepthFraction",
    "SampleRMSMappingQuality", "SampleUsedDepthFraction"]
GERMLINE_INDEL_FEATURES = [
    "GenotypeCategory", "SampleIndelRepeatCount",
    "SampleIndelRepeatUnitSize", "SampleIndelAlleleBiasLower",
    "SampleIndelAlleleBias", "SampleProxyRMSMappingQuality",
    "RelativeTotalLocusDepth", "SamplePrimaryAltAlleleDepthFraction",
    "ConservativeGenotypeQuality", "InterruptedHomopolymerLength",
    "ContextCompressability", "IndelCategory",
    "SampleAlleleCountStrandBias", "NormalizedAltHaplotypeCountRatio"]


def train_model(path, features, kind, category, seed, key_col, cut):
    """A 10-tree forest on seeded rows whose label is column key_col >
    cut, exported in the reference's scoring-model JSON."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(1500, len(features)))
    x[:, key_col] = rng.uniform(0, 200, size=1500)
    clf = evs_train.train_forest(x, (x[:, key_col] > cut).astype(int),
                                 n_trees=10, max_depth=5)
    doc = evs_train.export_model_json(clf, features, kind, category, 3.0)
    with open(path, "w") as f:
        json.dump(doc, f)
    return str(path)


@pytest.fixture(scope="module")
def germline_models(tmp_path_factory):
    """(SNV model, indel model) JSONs of the Germline category."""
    d = tmp_path_factory.mktemp("germline_evs")
    return (train_model(d / "germlineSNV.json", GERMLINE_SNV_FEATURES,
                        "SNV", "Germline", 11, 3, 40),
            train_model(d / "germlineIndel.json", GERMLINE_INDEL_FEATURES,
                        "INDEL", "Germline", 12, 8, 30))


def lines(out, name):
    with gzip.open(os.path.join(out, name), "rt") as f:
        return [l for l in f if not l.startswith(DROP)]


def run_both(d, fa, bam, tag, extra, jax_extra=None):
    """Both CLIs on the dataset; returns (jax out, port out)."""
    jout, tout = str(d / f"jax_{tag}"), str(d / f"torch_{tag}")
    assert jax_germline(["--reference", fa, "--align-file", bam,
                         "--output-dir", jout,
                         *(extra if jax_extra is None else jax_extra)]
                        ) in (0, None)
    assert torch_main(["germline", "--reference", fa, "--align-file", bam,
                       "--output-dir", tout, "--device", "cpu",
                       *extra]) == 0
    return jout, tout


def assert_identical(jout, tout):
    for name in OUTPUTS:
        assert lines(jout, name) == lines(tout, name), name


@pytest.mark.parametrize("mode", ["wgs", "exome"])
def test_scoring_model_files_byte_identical_to_jax(dataset, germline_models,
                                                   mode):
    """SNV and indel forests: the VCFs equal the JAX package's, and EVS
    changed them against the run without models (the forests score)."""
    d, fa, bam = dataset
    snv, indel = germline_models
    extra = ["--snv-scoring-model-file", snv,
             "--indel-scoring-model-file", indel]
    if mode == "exome":
        extra.append("--exome")
    jout, tout = run_both(d, fa, bam, f"evs_{mode}", extra)
    assert_identical(jout, tout)
    plain = str(d / f"torch_plain_{mode}")
    assert torch_main(["germline", "--reference", fa, "--align-file", bam,
                       "--output-dir", plain, "--device", "cpu",
                       *(["--exome"] if mode == "exome" else [])]) == 0
    assert lines(plain, "variants.vcf.gz") != lines(tout, "variants.vcf.gz")


def test_single_model_and_disable_evs(dataset, germline_models):
    """The SNV model alone equals the JAX package's run; --disable-evs
    with both models equals the run without any."""
    d, fa, bam = dataset
    snv, indel = germline_models
    assert_identical(*run_both(d, fa, bam, "evs_snv_only",
                               ["--snv-scoring-model-file", snv]))
    _, off = run_both(d, fa, bam, "evs_disabled",
                      ["--snv-scoring-model-file", snv,
                       "--indel-scoring-model-file", indel, "--disable-evs"])
    none = str(d / "torch_no_models")
    assert torch_main(["germline", "--reference", fa, "--align-file", bam,
                       "--output-dir", none, "--device", "cpu"]) == 0
    assert_identical(none, off)


def test_evs_models_rule(tmp_path, germline_models, monkeypatch):
    """The port's model resolution: flags, --disable-evs, and --rna's
    RNAseq models from the flags or $STRELKA_TPU_MODEL_DIR, an error
    where one is missing."""
    from types import SimpleNamespace

    from strelka_tpu_torch.workflow.germline import evs_models
    snv, indel = germline_models

    def args(**kw):
        base = dict(disable_evs=False, rna=False,
                    snv_scoring_model_file=None,
                    indel_scoring_model_file=None)
        return SimpleNamespace(**{**base, **kw})

    def error(msg):
        raise ValueError(msg)
    assert evs_models(args(), error) == (None, None)
    assert evs_models(args(snv_scoring_model_file=snv), error) == (
        (snv, None), None)
    assert evs_models(args(snv_scoring_model_file=snv,
                           indel_scoring_model_file=indel,
                           disable_evs=True), error) == (None, None)
    monkeypatch.delenv("STRELKA_TPU_MODEL_DIR", raising=False)
    with pytest.raises(ValueError, match="--rna requires an SNV"):
        evs_models(args(rna=True), error)
    assert evs_models(args(rna=True, disable_evs=True), error) == (None,
                                                                    None)
    for name in ("RNASNVScoringModels.json", "RNAIndelScoringModels.json"):
        (tmp_path / name).write_text("{}")
    monkeypatch.setenv("STRELKA_TPU_MODEL_DIR", str(tmp_path))
    assert evs_models(args(rna=True), error) == (
        (str(tmp_path / "RNASNVScoringModels.json"), "RNAseq"),
        (str(tmp_path / "RNAIndelScoringModels.json"), "RNAseq"))
    assert evs_models(args(rna=True, snv_scoring_model_file=snv),
                      error)[0] == (snv, "RNAseq")
    os.remove(tmp_path / "RNAIndelScoringModels.json")
    with pytest.raises(ValueError, match="--rna requires an indel"):
        evs_models(args(rna=True), error)
    # a Germline-category file loads as the port's forest
    f = trf.load_scoring_model(snv, "SNV")
    assert f is not None
