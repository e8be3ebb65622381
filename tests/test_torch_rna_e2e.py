"""RNA mode of the port end to end against the JAX package on the CPU:
the germline CLI with --rna, whose VCFs are byte-identical to
strelka_tpu's (--disable-evs, and RNAseq forests trained here from the
flags and from $STRELKA_TPU_MODEL_DIR). The tile-level rules are
tests/test_torch_rna.py's, the region driver's
tests/test_torch_rna_chunked.py's.
"""
import gzip
import os

import pytest

from strelka_tpu.workflow.germline import run_germline as jax_germline
from strelka_tpu_torch.__main__ import main as torch_main
from tests.test_torch_germline_e2e import DROP, OUTPUTS, dataset  # noqa: F401
from tests.test_torch_germline_evs import (GERMLINE_INDEL_FEATURES,
                                           GERMLINE_SNV_FEATURES,
                                           train_model)


# --- the CLI ----------------------------------------------------------------

@pytest.fixture(scope="module")
def rna_models(tmp_path_factory):
    """RNAseq SNV and indel forests over the germline feature names, in
    a directory laid out as $STRELKA_TPU_MODEL_DIR expects."""
    d = tmp_path_factory.mktemp("rna_models")
    return (d, train_model(d / "RNASNVScoringModels.json",
                           GERMLINE_SNV_FEATURES, "SNV", "RNAseq", 21, 3, 40),
            train_model(d / "RNAIndelScoringModels.json",
                        GERMLINE_INDEL_FEATURES, "INDEL", "RNAseq", 22, 8,
                        30))


def lines(out, name):
    with gzip.open(os.path.join(out, name), "rt") as f:
        return [l for l in f if not l.startswith(DROP)]


def run_both(dataset, tag, extra, env=None, monkeypatch=None):
    d, fa, bam = dataset
    if env:
        for k, v in env.items():
            monkeypatch.setenv(k, v)
    jout, tout = str(d / f"jax_{tag}"), str(d / f"torch_{tag}")
    assert jax_germline(["--reference", fa, "--align-file", bam,
                         "--output-dir", jout, *extra]) in (0, None)
    assert torch_main(["germline", "--reference", fa, "--align-file", bam,
                       "--output-dir", tout, "--device", "cpu",
                       *extra]) == 0
    for name in OUTPUTS:
        assert lines(jout, name) == lines(tout, name), name
    return tout


def test_rna_disable_evs_byte_identical_to_jax(dataset):
    """--rna --disable-evs: the VCFs equal the JAX package's, and the
    extension moved them against the run without --rna."""
    tout = run_both(dataset, "rna_noevs", ["--rna", "--disable-evs"])
    d, fa, bam = dataset
    plain = str(d / "torch_rna_plain")
    assert torch_main(["germline", "--reference", fa, "--align-file", bam,
                       "--output-dir", plain, "--device", "cpu"]) == 0
    assert lines(plain, "genome.S1.vcf.gz") != lines(tout, "genome.S1.vcf.gz")


def test_rna_with_forests_byte_identical_to_jax(dataset, rna_models,
                                                monkeypatch):
    """--rna with RNAseq forests, from the flags and from
    $STRELKA_TPU_MODEL_DIR: the VCFs equal the JAX package's."""
    d, snv, indel = rna_models
    run_both(dataset, "rna_flags", ["--rna", "--snv-scoring-model-file", snv,
                                    "--indel-scoring-model-file", indel])
    run_both(dataset, "rna_envdir", ["--rna"],
             env={"STRELKA_TPU_MODEL_DIR": str(d)}, monkeypatch=monkeypatch)


def test_rna_without_models_is_an_error(dataset, monkeypatch, capsys):
    """--rna without models and without --disable-evs stops with the
    JAX package's message."""
    d, fa, bam = dataset
    monkeypatch.delenv("STRELKA_TPU_MODEL_DIR", raising=False)
    with pytest.raises(SystemExit):
        torch_main(["germline", "--reference", fa, "--align-file", bam,
                    "--output-dir", str(d / "rna_err"), "--device", "cpu",
                    "--rna"])
    assert "--rna requires an SNV EVS model" in capsys.readouterr().err
