"""The port's germline fan-out against the JAX package's single-process
run, on the dryrun dataset (__graft_entry__.py: 60 kb contig, 25x, SNVs
every 700 bp, indels every 1000 bp) as two samples that share the
reference and the planted variants (ref_seed 11, read seeds 11 and 12),
called jointly in segments of 15 kb (four segment groups):

- --jobs 2 (parallel/runner.run_local_jobs), two samples;
- two coordinated processes through the STRELKA_TPU_* variables (a gloo
  rendezvous, parallel/runner.init_distributed) plus --merge-only.

variants.vcf.gz, genome.S1.vcf.gz and genome.S2.vcf.gz must be
byte-identical to the JAX package's after dropping the volatile and
program-name header lines. The two cluster modes are in
tests/test_torch_jobs_cluster.py. Also: parallel/hardware.py against the
JAX module, the shared device-memory budget of somatic_snv.rows_per_launch,
and the fan-out parent's refusals (cuda without a GPU, failed workers).
"""
import gzip
import os
import socket
import subprocess
import sys

import pytest
import torch

from benchmarks import synth as jsynth
from strelka_tpu.io.bam import BamHeader
from strelka_tpu.io.bam_writer import write_bam
from strelka_tpu.parallel import hardware as jhw
from strelka_tpu.workflow.germline import run_germline as jax_germline
from strelka_tpu_torch import device as devmod
from strelka_tpu_torch.__main__ import main as torch_main
from strelka_tpu_torch.models import somatic_snv as ss
from strelka_tpu_torch.parallel import hardware as thw

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DROP = ("##fileDate", "##startTime", "##cmdline", "##source",
        "##source_version", "##content")
OUTPUTS = ("variants.vcf.gz", "genome.S1.vcf.gz", "genome.S2.vcf.gz")
DRYRUN = dict(L=60_000, depth=25, snv_every=700, indel_every=1000,
              ref_seed=11)
SEGMENT = ["--max-region-size", "15000"]


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    d = tmp_path_factory.mktemp("dryrun_joint")
    bams = []
    for i, seed in enumerate((11, 12)):
        refs, batch, _ = jsynth.generate(seed=seed, **DRYRUN)
        bam = str(d / f"S{i + 1}.bam")
        write_bam(bam, BamHeader(text="", ref_names=["syn"],
                                 ref_lengths=[len(refs)]), batch)
        bams.append(bam)
    fa = d / "ref.fa"
    fa.write_text(">syn\n" + refs + "\n")
    args = ["--reference", str(fa)]
    for bam in bams:
        args += ["--align-file", bam]
    return d, args + SEGMENT


@pytest.fixture(scope="module")
def jax_outputs(dataset):
    d, args = dataset
    out = str(d / "jax_single")
    assert jax_germline([*args, "--output-dir", out]) in (0, None)
    lines = {name: _lines(out, name) for name in OUTPUTS}
    assert sum(not l.startswith("#") for l in lines[OUTPUTS[0]]) > 20
    return lines


@pytest.fixture
def env(monkeypatch):
    """The workers are `python -m strelka_tpu_torch...` processes: they
    find the port through PYTHONPATH."""
    path = os.environ.get("PYTHONPATH")
    monkeypatch.setenv("PYTHONPATH",
                       REPO + (os.pathsep + path if path else ""))
    monkeypatch.setenv("STRELKA_TPU_CLUSTER_POLL_S", "0.3")
    return dict(os.environ)


def _lines(out, name):
    with gzip.open(os.path.join(out, name), "rt") as f:
        return [l for l in f if not l.startswith(DROP)]


def _assert_matches(jax_outputs, out):
    for name in OUTPUTS:
        assert _lines(out, name) == jax_outputs[name], name


def _germline(args, out, *extra):
    return torch_main(["germline", *args, "--output-dir", str(out),
                       "--device", "cpu", *extra])


def test_jobs_two_samples_byte_identical_to_jax(dataset, jax_outputs, env):
    d, args = dataset
    out = d / "jobs"
    assert _germline(args, out, "--jobs", "2") == 0
    _assert_matches(jax_outputs, out)
    ws = out / "workspace"
    assert sorted(os.listdir(ws / "logs")) == [
        "worker.p0.log", "worker.p0.stderr.log", "worker.p1.log",
        "worker.p1.stderr.log"]
    for i in (0, 1):
        log = (ws / "logs" / f"worker.p{i}.stderr.log").read_text()
        assert f"worker {i}/2 done (2 segments)" in log, log[-2000:]


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_coordinated_processes_match_single(dataset, jax_outputs, env):
    """Two processes rendezvous through STRELKA_TPU_COORDINATOR /
    _NUM_PROCESSES / _PROCESS_ID (no --process-index anywhere) and take
    alternate segment groups; --merge-only then concatenates them."""
    d, args = dataset
    out = d / "coordinated"
    port = _free_port()
    cmd = [sys.executable, "-m", "strelka_tpu_torch", "germline", *args,
           "--output-dir", str(out), "--device", "cpu"]
    procs = [subprocess.Popen(
        cmd, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env=dict(env, STRELKA_TPU_COORDINATOR=f"localhost:{port}",
                            STRELKA_TPU_NUM_PROCESSES="2",
                            STRELKA_TPU_PROCESS_ID=str(pid)))
        for pid in (0, 1)]
    for p in procs:
        _out, err = p.communicate(timeout=300)
        assert p.returncode == 0, err[-2000:]
    tasks = [sorted(l.split('"task": "')[1].split('"')[0] for l in
                    (out / "workspace" / f"taskstate.p{i}.jsonl").open())
             for i in (0, 1)]
    assert tasks == [["seg_0", "seg_2"], ["seg_1", "seg_3"]]
    # the merge touches no device: the default --device cuda runs here
    assert torch_main(["germline", *args, "--output-dir", str(out),
                       "--merge-only"]) == 0
    _assert_matches(jax_outputs, out)


def test_failed_workers_fail_the_run(dataset, env, tmp_path, capfd):
    """A worker that fails twice (one retry round) aborts the merge and
    the run exits non-zero."""
    d, args = dataset
    bad = [a if not a.endswith("S2.bam") else str(tmp_path / "absent.bam")
           for a in args]
    out = tmp_path / "failed"
    assert _germline(bad, out, "--jobs", "2") == 1
    err = capfd.readouterr().err
    assert "failed twice; aborting merge" in err, err[-2000:]
    assert not (out / "variants.vcf.gz").exists()


def test_jobs_cuda_without_gpu_raises_in_parent(dataset, monkeypatch,
                                                tmp_path):
    d, args = dataset
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "nogpu"
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        torch_main(["germline", *args, "--output-dir", str(out),
                    "--jobs", "2"])
    assert not (out / "workspace").exists()  # no worker was spawned


def test_hardware_matches_jax():
    assert thw.LOCAL_JOB_MEM_MB == jhw.LOCAL_JOB_MEM_MB
    assert thw.core_count() == jhw.core_count()
    assert thw.mem_total_mb() == jhw.mem_total_mb()
    for mem in (1, 512, thw.LOCAL_JOB_MEM_MB, 10 ** 5, 10 ** 9):
        assert thw.suggest_jobs(mem) == jhw.suggest_jobs(mem)
    assert thw.suggest_jobs() == jhw.suggest_jobs()
    assert thw.suggest_jobs(mem_per_job_mb=10 ** 9) == 1


@pytest.mark.parametrize("workers", [1, 2, 4])
def test_rows_per_launch_divides_the_card_among_workers(monkeypatch,
                                                        workers):
    """Each of N local workers budgets 1/N of half the card's free
    memory (plus its own idle cache), so N workers measuring together
    stay inside the card."""
    free, reserved, allocated = 60 << 30, 3 << 30, 1 << 30
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda dev=None: (free, 80 << 30))
    monkeypatch.setattr(torch.cuda, "memory_reserved",
                        lambda dev=None: reserved)
    monkeypatch.setattr(torch.cuda, "memory_allocated",
                        lambda dev=None: allocated)
    if workers > 1:
        monkeypatch.setenv(devmod.SHARE_ENV, str(workers))
    else:
        monkeypatch.delenv(devmod.SHARE_ENV, raising=False)
    rows = ss.rows_per_launch("cuda", ss.CALL_ROW_BYTES)
    budget = (free + reserved - allocated) // 2 // workers
    assert rows == min(budget // ss.CALL_ROW_BYTES // 1024 * 1024,
                       ss.MAX_ROWS)
    assert workers * rows * ss.CALL_ROW_BYTES <= (free + reserved
                                                  - allocated) // 2
    # the host budget is not shared
    assert ss.rows_per_launch("cpu", ss.CALL_ROW_BYTES) == \
        ss.HOST_BUDGET_BYTES // ss.CALL_ROW_BYTES // 1024 * 1024
