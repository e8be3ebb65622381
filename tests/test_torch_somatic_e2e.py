"""The port's somatic CLI (python -m strelka_tpu_torch somatic --device
cpu) against the JAX package's on the dryrun T/N dataset
(__graft_entry__.py: 60 kb reference with ref_seed 11; normal 25x, seed
21; tumor 50x, seed 22, with somatic SNVs every 1500 bp at VAF 0.35 and
somatic indels every 2100 bp; germline SNVs every 900 bp and indels
every 1200 bp in both), in WGS mode and with --exome; the other modes
are in tests/test_torch_somatic_modes.py (--report-evs-features, a
--region with the callable-regions BED and the realigned BAMs) and
tests/test_torch_somatic_models.py (--disable-evs, somatic scoring model
files).

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
    ("wgs", []), ("exome", ["--exome"])])
def test_outputs_byte_identical_to_jax(dataset, mode, extra):
    check_mode(dataset, mode, extra)


def check_mode(dataset, mode, extra):
    """Both CLIs with `extra`: byte-identical VCFs, the planted somatic
    SNVs called; per mode, EVSF on every record, or the region's calls,
    callable regions and realigned BAMs."""
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


@pytest.mark.parametrize("flag, path", [
    (["--jobs", "2"], "fanout"),
    (["--process-index", "0", "--process-count", "2"], "device"),
    (["--merge-only"], "no_device"),
    (["--cluster-submit", "qsub"], "device")])
def test_unported_options_raise(dataset, monkeypatch, flag, path):
    """The fan-out options raise NotPortedError no more: each reaches its
    path — the --jobs parent (run_local_jobs, before any device), a
    worker or a plain run (inside the device), the merge (outside it)."""
    from strelka_tpu_torch import device as devmod
    from strelka_tpu_torch.parallel import runner as rn
    from strelka_tpu_torch.workflow import somatic as tsom
    seen = []
    monkeypatch.setattr(rn, "run_local_jobs", lambda module, argv, jobs, *a,
                        **k: seen.append(("fanout", module, jobs,
                                          k["device"])) or 0)
    monkeypatch.setattr(tsom, "_run_somatic", lambda args, argv: seen.append(
        ("device" if devmod._CURRENT is not None else "no_device",)) or 0)
    d, fa, nbam, tbam, _ = dataset
    try:
        rc = torch_main(["somatic", *_args(fa, nbam, tbam, str(d / "np"),
                                           flag), "--device", "cpu"])
    except NotPortedError as e:
        pytest.fail(f"{flag}: {e}")
    assert rc == 0
    assert seen[0][0] == path and len(seen) == 1, seen
    if path == "fanout":
        assert seen[0][1:] == ("strelka_tpu_torch.workflow.somatic", "2",
                               "cpu")
