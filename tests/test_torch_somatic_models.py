"""The port's somatic CLI against the JAX package's on
tests/test_torch_somatic_e2e.py's dryrun T/N dataset, with
--disable-evs and with somatic scoring model files (small forests
trained here), given by flag or as the packages' default model files.

somatic.snvs.vcf.gz and somatic.indels.vcf.gz must be byte-identical
after dropping the volatile and program-name header lines.
"""
import pytest

from strelka_tpu.workflow.somatic import run_somatic as jax_somatic
from strelka_tpu_torch.__main__ import main as torch_main
from tests.test_torch_somatic_e2e import (OUTPUTS, _args,  # noqa: F401
                                          _lines, _pin_default_models,
                                          check_mode, dataset,
                                          no_default_evs_model)


@pytest.mark.parametrize("mode,extra", [
    pytest.param("disable_evs", ["--disable-evs"], id="disable_evs-extra3")])
def test_outputs_byte_identical_to_jax(dataset, mode, extra):
    check_mode(dataset, mode, extra)


@pytest.fixture(scope="module")
def evs_models(tmp_path_factory):
    """Small somatic SNV and indel forests (10 features each, the first
    being QSS_NT / QSI_NT), trained on random rows with
    strelka_tpu.training.evs_train."""
    import json

    import numpy as np

    from strelka_tpu.training import evs_train
    d = tmp_path_factory.mktemp("somatic_evs")
    paths = []
    for kind, seed in (("SNV", 5), ("INDEL", 6)):
        rng = np.random.default_rng(seed)
        x = rng.normal(size=(1500, 10))
        x[:, 0] = rng.uniform(0, 120, size=1500)
        clf = evs_train.train_forest(x, (x[:, 0] > 30).astype(int),
                                     n_trees=10, max_depth=5)
        doc = evs_train.export_model_json(
            clf, [f"F{i}" for i in range(10)], kind, "Somatic", 5.0)
        path = str(d / f"somatic{kind}.json")
        with open(path, "w") as f:
            json.dump(doc, f)
        paths.append(path)
    return paths


def test_scoring_model_files_byte_identical_to_jax(dataset, evs_models):
    d, fa, nbam, tbam, _ = dataset
    extra = ["--exome", "--somatic-snv-scoring-model-file", evs_models[0],
             "--somatic-indel-scoring-model-file", evs_models[1]]
    jout, tout = str(d / "jax_models"), str(d / "torch_models")
    assert jax_somatic(_args(fa, nbam, tbam, jout, extra)) in (0, None)
    assert torch_main(["somatic", *_args(fa, nbam, tbam, tout, extra),
                       "--device", "cpu"]) == 0
    for name in OUTPUTS:
        a, b = _lines(jout, name), _lines(tout, name)
        assert a == b, name
        recs = [l for l in a if not l.startswith("#")]
        assert recs and all(";SomaticEVS=" in l for l in recs), name


def test_default_models_byte_identical_to_jax(dataset, evs_models,
                                             monkeypatch):
    """With no model flag both packages load their default model files:
    pointed at the same forests, the VCFs are byte-identical and scored
    with EVS."""
    _pin_default_models(monkeypatch, evs_models)
    d, fa, nbam, tbam, _ = dataset
    jout, tout = str(d / "jax_default"), str(d / "torch_default")
    assert jax_somatic(_args(fa, nbam, tbam, jout, ["--exome"])) in (0, None)
    assert torch_main(["somatic", *_args(fa, nbam, tbam, tout, ["--exome"]),
                       "--device", "cpu"]) == 0
    for name in OUTPUTS:
        a, b = _lines(jout, name), _lines(tout, name)
        assert a == b, name
        recs = [l for l in a if not l.startswith("#")]
        assert recs and all(";SomaticEVS=" in l for l in recs), name
