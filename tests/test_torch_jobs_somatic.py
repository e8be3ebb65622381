"""The port's somatic fan-out against the JAX package's single-process
run on the dryrun T/N dataset (__graft_entry__.py:163-173: 60 kb
reference with ref_seed 11; normal 25x, seed 21; tumor 50x, seed 22,
with somatic SNVs every 1500 bp at VAF 0.35 and somatic indels every
2100 bp), in segments of 15 kb (four segment groups):

- two --process-index workers (--process-count 2) plus --merge-only;
- --jobs 2 (parallel/runner.run_local_jobs).

somatic.snvs.vcf.gz and somatic.indels.vcf.gz must be byte-identical to
the JAX package's after dropping the volatile and program-name header
lines. Both packages' default EVS model paths point at the port's, so
they score with the same model files, or both without one.
"""
import gzip
import os

import pytest

from benchmarks import synth as jsynth
from strelka_tpu.io.bam import BamHeader
from strelka_tpu.io.bam_writer import write_bam
from strelka_tpu.models import evs as jevs
from strelka_tpu.workflow.somatic import run_somatic as jax_somatic
from strelka_tpu_torch.__main__ import main as torch_main
from strelka_tpu_torch.models import evs as tevs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DROP = ("##fileDate", "##startTime", "##cmdline", "##source",
        "##source_version", "##content")
OUTPUTS = ("somatic.snvs.vcf.gz", "somatic.indels.vcf.gz")
COMMON = dict(L=60_000, snv_every=900, indel_every=1200, ref_seed=11)
NORMAL = dict(COMMON, depth=25, seed=21)
TUMOR = dict(COMMON, depth=50, seed=22, somatic_every=1500,
             somatic_vaf=0.35, somatic_indel_every=2100)
SEGMENT = ["--max-region-size", "15000"]


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    d = tmp_path_factory.mktemp("dryrun_tn_jobs")
    refs, normal, _ = jsynth.generate(**NORMAL)
    _, tumor, _ = jsynth.generate(**TUMOR)
    fa = d / "ref.fa"
    fa.write_text(">syn\n" + refs + "\n")
    hdr = BamHeader(text="", ref_names=["syn"], ref_lengths=[len(refs)])
    nbam, tbam = str(d / "n.bam"), str(d / "t.bam")
    write_bam(nbam, hdr, normal)
    write_bam(tbam, hdr, tumor)
    return d, ["--reference", str(fa), "--normal-align-file", nbam,
               "--tumor-align-file", tbam, *SEGMENT]


@pytest.fixture(scope="module")
def jax_outputs(dataset):
    d, args = dataset
    out = str(d / "jax_single")
    mp = pytest.MonkeyPatch()
    try:
        for name in ("DEFAULT_SOMATIC_SNV_MODEL",
                     "DEFAULT_SOMATIC_INDEL_MODEL"):
            mp.setattr(jevs, name, getattr(tevs, name))
        assert jax_somatic([*args, "--output-dir", out]) in (0, None)
    finally:
        mp.undo()
    lines = {name: _lines(out, name) for name in OUTPUTS}
    assert sum(not l.startswith("#") for l in lines[OUTPUTS[0]]) > 10
    return lines


def _lines(out, name):
    with gzip.open(os.path.join(out, name), "rt") as f:
        return [l for l in f if not l.startswith(DROP)]


def _assert_matches(jax_outputs, out):
    for name in OUTPUTS:
        assert _lines(out, name) == jax_outputs[name], name


def test_process_index_workers_and_merge_only(dataset, jax_outputs):
    d, args = dataset
    out = str(d / "multi")
    for idx in ("0", "1"):
        assert torch_main(["somatic", *args, "--output-dir", out,
                           "--device", "cpu", "--process-index", idx,
                           "--process-count", "2"]) == 0
    assert not os.path.exists(os.path.join(out, OUTPUTS[0]))
    tasks = [sorted(l.split('"task": "')[1].split('"')[0] for l in
                    open(os.path.join(out, "workspace",
                                      f"taskstate.p{i}.jsonl")))
             for i in (0, 1)]
    assert tasks == [["seg_0", "seg_2"], ["seg_1", "seg_3"]]
    # the merge touches no device: the default --device cuda runs here
    assert torch_main(["somatic", *args, "--output-dir", out,
                       "--merge-only"]) == 0
    _assert_matches(jax_outputs, out)


def test_jobs_two_byte_identical_to_jax(dataset, jax_outputs, monkeypatch):
    d, args = dataset
    path = os.environ.get("PYTHONPATH")
    monkeypatch.setenv("PYTHONPATH",
                       REPO + (os.pathsep + path if path else ""))
    out = d / "jobs"
    assert torch_main(["somatic", *args, "--output-dir", str(out),
                       "--device", "cpu", "--jobs", "2"]) == 0
    _assert_matches(jax_outputs, str(out))
    for i in (0, 1):
        log = (out / "workspace" / "logs" /
               f"worker.p{i}.stderr.log").read_text()
        assert f"worker {i}/2 done (2 segments)" in log, log[-2000:]
