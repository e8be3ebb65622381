"""The port's somatic CLI (python -m strelka_tpu_torch somatic --device
cpu) against the JAX package's on the dryrun T/N dataset
(__graft_entry__.py: 60 kb reference with ref_seed 11; normal 25x, seed
21; tumor 50x, seed 22, with somatic SNVs every 1500 bp at VAF 0.35 and
somatic indels every 2100 bp; germline SNVs every 900 bp and indels
every 1200 bp in both), in WGS mode, with --exome, with
--report-evs-features, with --disable-evs, on a --region with the
callable-regions BED and the realigned BAMs, and with somatic scoring
model files (small forests trained here).

somatic.snvs.vcf.gz and somatic.indels.vcf.gz must be byte-identical
after dropping the volatile header lines (##fileDate, ##startTime,
##cmdline) and the program-name lines (##source, ##source_version,
##content).
"""
import gzip
import os

import pytest

from benchmarks import synth as jsynth
from strelka_tpu.io.bam import BamHeader
from strelka_tpu.io.bam_writer import write_bam
from strelka_tpu.workflow.somatic import run_somatic as jax_somatic
from strelka_tpu_torch import NotPortedError
from strelka_tpu_torch.__main__ import main as torch_main

DROP = ("##fileDate", "##startTime", "##cmdline", "##source",
        "##source_version", "##content")
OUTPUTS = ("somatic.snvs.vcf.gz", "somatic.indels.vcf.gz")
CALLABLE = "somatic.callable.regions.bed.gz"
COMMON = dict(L=60_000, snv_every=900, indel_every=1200, ref_seed=11)
NORMAL = dict(COMMON, depth=25, seed=21)
TUMOR = dict(COMMON, depth=50, seed=22, somatic_every=1500,
             somatic_vaf=0.35, somatic_indel_every=2100)


DEFAULT_MODELS = ("DEFAULT_SOMATIC_SNV_MODEL", "DEFAULT_SOMATIC_INDEL_MODEL")


def _pin_default_models(monkeypatch, paths):
    """Point both packages' default somatic SNV and indel model paths at
    `paths` (one per name in DEFAULT_MODELS)."""
    from strelka_tpu.models import evs as jevs
    from strelka_tpu_torch.models import evs as tevs
    for mod in (jevs, tevs):
        for name, path in zip(DEFAULT_MODELS, paths):
            monkeypatch.setattr(mod, name, path)


@pytest.fixture(autouse=True)
def no_default_evs_model(monkeypatch, tmp_path):
    """Both packages score with EVS by default where their default model
    files exist; pin both defaults to an absent file so that they run
    without a model unless a test passes or pins model files."""
    _pin_default_models(monkeypatch, [str(tmp_path / "absent.json")] * 2)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    d = tmp_path_factory.mktemp("dryrun_tn")
    refs, normal, _ = jsynth.generate(**NORMAL)
    _, tumor, truth = jsynth.generate(**TUMOR)
    fa = d / "ref.fa"
    fa.write_text(">syn\n" + refs + "\n")
    hdr = BamHeader(text="", ref_names=["syn"], ref_lengths=[len(refs)])
    nbam, tbam = str(d / "n.bam"), str(d / "t.bam")
    write_bam(nbam, hdr, normal)
    write_bam(tbam, hdr, tumor)
    return d, str(fa), nbam, tbam, truth


def _lines(out, name):
    with gzip.open(os.path.join(out, name), "rt") as f:
        return [l for l in f if not l.startswith(DROP)]


def _args(fa, nbam, tbam, out, extra):
    return ["--reference", fa, "--normal-align-file", nbam,
            "--tumor-align-file", tbam, "--output-dir", out, *extra]


@pytest.mark.parametrize("mode,extra", [
    ("wgs", []), ("exome", ["--exome"]),
    ("evsf", ["--exome", "--report-evs-features"]),
    ("disable_evs", ["--disable-evs"]),
    ("region", ["--exome", "--region", "syn:10001-40000",
                "--output-callable-regions", "--output-realigned-bam"])])
def test_outputs_byte_identical_to_jax(dataset, mode, extra):
    d, fa, nbam, tbam, truth = dataset
    jout, tout = str(d / f"jax_{mode}"), str(d / f"torch_{mode}")
    assert jax_somatic(_args(fa, nbam, tbam, jout, extra)) in (0, None)
    assert torch_main(["somatic", *_args(fa, nbam, tbam, tout, extra),
                       "--device", "cpu"]) == 0
    recs = {}
    for name in OUTPUTS:
        a, b = _lines(jout, name), _lines(tout, name)
        assert a == b, name
        recs[name] = [l.split("\t") for l in a if not l.startswith("#")]
    snvs = recs["somatic.snvs.vcf.gz"]
    assert len(snvs) > 5 and len(recs["somatic.indels.vcf.gz"]) > 2
    # the planted somatic SNVs are called (1-based POS)
    called = {int(r[1]) - 1 for r in snvs}
    lo, hi = (10_000, 40_000) if mode == "region" else (0, 60_000)
    som = [p for p in truth["som_snv"] if lo <= p < hi]
    assert sum(p in called for p in som) >= 0.9 * len(som)
    if mode == "evsf":
        assert all(";EVSF=" in r[7] for r in snvs)
    if mode == "region":
        assert all(lo < int(r[1]) <= hi for r in snvs)
        with gzip.open(os.path.join(jout, CALLABLE), "rb") as f:
            want = f.read()
        with gzip.open(os.path.join(tout, CALLABLE), "rb") as f:
            assert f.read() == want and want
        for label in ("normal", "tumor"):
            name = f"realigned.{label}.bam"
            with open(os.path.join(jout, name), "rb") as f:
                want = f.read()
            with open(os.path.join(tout, name), "rb") as f:
                assert f.read() == want, name


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


@pytest.mark.parametrize("flag", [["--jobs", "2"], ["--process-index", "0"],
                                  ["--merge-only"],
                                  ["--cluster-submit", "qsub"]])
def test_unported_options_raise(dataset, flag):
    d, fa, nbam, tbam, _ = dataset
    with pytest.raises(NotPortedError):
        torch_main(["somatic", *_args(fa, nbam, tbam, str(d / "np"), flag),
                    "--device", "cpu"])
