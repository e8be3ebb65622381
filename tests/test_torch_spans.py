"""The port's span recorder (strelka_tpu_torch/utils/spans.py): nothing
recorded while off; nesting, parent ids, self time, the job and segment
identifiers and per-thread stacks while on; the stages of a germline and
a somatic CLI job on the CPU covering their region spans inside one job
span; STRELKA_TPU_TRACE's Chrome trace of each --jobs worker; and, on a
card, the copy counters against the profiler's memcpy events."""
import glob
import json
import os
import threading
import time

import pytest
import torch

from strelka_tpu_torch import synth
from strelka_tpu_torch.__main__ import main as torch_main
from strelka_tpu_torch.io.bam import BamHeader
from strelka_tpu_torch.io.bam_writer import write_bam
from strelka_tpu_torch.utils import spans

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STAGES = {"region.prep", "region.discover", "region.candidates",
          "region.realign", "region.pileup", "region.genotype"}


@pytest.fixture
def recorder():
    """The recorder on and empty; off and empty after the test."""
    spans.clear()
    spans.enable()
    yield spans
    spans.disable()
    spans.clear()


def _dur(s):
    return s["t1_ns"] - s["t0_ns"]


def test_nothing_is_recorded_while_off():
    spans.disable()
    spans.clear()

    @spans.span("decorated")
    def f(x):
        return x + 1

    with spans.span("a"):
        spans.stage("b")
        assert f(1) == 2
    # the same no-op object at every site of a name
    assert spans.span("a") is spans.span("a")
    assert spans.drain()[0] == []


def test_nesting_parents_and_self_time(recorder):
    @spans.span("leaf", site="x")
    def leaf():
        time.sleep(0.002)

    with spans.span("outer", segment="seg_7") as outer:
        spans.stage("first")
        leaf()
        spans.stage("second")
        time.sleep(0.001)
    got, _ = spans.drain()
    by = {s["name"]: s for s in got}
    assert [s["name"] for s in got] == ["leaf", "first", "second", "outer"]
    assert by["outer"]["parent"] is None and by["outer"]["id"] == outer.id
    assert by["first"]["parent"] == by["second"]["parent"] == outer.id
    assert by["leaf"]["parent"] == by["first"]["id"]
    assert by["leaf"]["attrs"] == {"site": "x"}
    assert {s["segment"] for s in got} == {"seg_7"}
    # the last stage ends with the span around it
    assert by["second"]["t1_ns"] == by["outer"]["t1_ns"]
    self_first = _dur(by["first"]) - _dur(by["leaf"])
    assert 0 <= self_first < _dur(by["first"])
    assert _dur(by["leaf"]) >= 2_000_000


def test_an_exception_closes_the_spans_it_left_open(recorder):
    with pytest.raises(ValueError):
        with spans.span("outer"):
            spans.stage("stage")
            raise ValueError
    with spans.span("next"):
        pass
    got, _ = spans.drain()
    assert [(s["name"], s["parent"] is None) for s in got] == [
        ("stage", False), ("outer", True), ("next", True)]


def test_a_job_numbers_its_spans_and_keeps_its_counters(recorder):
    spans.count("h2d.copies", 2, site="k1")     # before the job
    with spans.job(cmd="x") as j:
        with spans.span("segment", segment="seg_0"):
            with spans.span("region"):
                spans.count("h2d.copies", site="k1")
                spans.count("h2d.bytes", 64, site="k1")
    got, totals = spans.drain()
    assert {s["job"] for s in got} == {j.number}
    assert [s["segment"] for s in got] == ["seg_0", "seg_0", None]
    job = got[-1]
    assert job["name"] == "job" and job["attrs"]["cmd"] == "x"
    assert job["attrs"]["counters"] == {"h2d.copies": {"site=k1": 1},
                                        "h2d.bytes": {"site=k1": 64}}
    assert totals["h2d.copies"] == {"site=k1": 3}


def test_threads_keep_their_own_stacks(recorder):
    go = threading.Barrier(2)

    def work(name):
        with spans.span(name):
            go.wait(timeout=10)
            with spans.span(name + ".inner"):
                go.wait(timeout=10)

    threads = [threading.Thread(target=work, args=(n,)) for n in "ab"]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
        assert not t.is_alive()
    got = {s["name"]: s for s in spans.drain()[0]}
    assert got["a.inner"]["parent"] == got["a"]["id"]
    assert got["b.inner"]["parent"] == got["b"]["id"]
    assert got["a"]["parent"] is None and got["b"]["parent"] is None


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    d = tmp_path_factory.mktemp("spans")
    refs, normal, _ = synth.generate(L=20_000, depth=20, snv_every=500,
                                     indel_every=900, seed=3)
    _, tumor, _ = synth.generate(L=20_000, depth=30, snv_every=500,
                                 indel_every=900, seed=4, ref_seed=3,
                                 somatic_every=700, somatic_vaf=0.4)
    hdr = BamHeader(text="", ref_names=["syn"], ref_lengths=[len(refs)])
    (d / "ref.fa").write_text(">syn\n" + refs + "\n")
    write_bam(str(d / "n.bam"), hdr, normal)
    write_bam(str(d / "t.bam"), hdr, tumor)
    return d


def _cli(d, mode, out):
    if mode == "germline":
        return ["germline", "--reference", str(d / "ref.fa"),
                "--align-file", str(d / "n.bam"), "--output-dir", out,
                "--device", "cpu", "--max-region-size", "10000"]
    return ["somatic", "--reference", str(d / "ref.fa"),
            "--normal-align-file", str(d / "n.bam"),
            "--tumor-align-file", str(d / "t.bam"), "--output-dir", out,
            "--device", "cpu"]


@pytest.mark.parametrize("mode", ["germline", "somatic"])
def test_stages_cover_the_region_spans_of_a_job(dataset, mode, recorder,
                                                tmp_path):
    assert torch_main(_cli(dataset, mode, str(tmp_path / "out"))) == 0
    got, _ = spans.drain()
    jobs = [s for s in got if s["name"] == "job"]
    assert len(jobs) == 1
    job = jobs[0]
    by_id = {s["id"]: s for s in got}
    # every other span lies inside the job span and carries its number
    for s in got:
        assert s["job"] == job["job"], s
        p = s
        while p["parent"] is not None:
            p = by_id[p["parent"]]
        assert p is job
        assert job["t0_ns"] <= s["t0_ns"] <= s["t1_ns"] <= job["t1_ns"]
    names = {s["name"] for s in got}
    assert {"job.setup", "decode", "job.depth", "segment", "region",
            "region.score", "emit", "segment.write", "merge",
            "job.finish"} <= names
    regions = [s for s in got if s["name"] == "region"]
    assert regions
    for r in regions:
        kids = [s for s in got if s["parent"] == r["id"]]
        assert {k["name"] for k in kids} <= STAGES
        assert ("region.discover" in {k["name"] for k in kids}) == (
            mode == "germline")
        assert sum(_dur(k) for k in kids) >= 0.95 * _dur(r)
        assert r["segment"] and r["segment"].startswith("seg_")
    counters = job["attrs"]["counters"]
    assert counters["reads.kept"][""] > 0
    assert counters["snv.sites"][""] == 20_000
    # on the CPU no copy leaves the host
    assert "h2d.copies" not in counters


def test_each_jobs_worker_writes_its_chrome_trace(dataset, tmp_path,
                                                  monkeypatch):
    # this process is the --jobs parent; its workers and the merge are
    # `python -m strelka_tpu_torch.workflow.germline` processes, which
    # find the port through PYTHONPATH and inherit STRELKA_TPU_TRACE
    trace_dir = tmp_path / "trace"
    monkeypatch.setenv("STRELKA_TPU_TRACE", str(trace_dir))
    monkeypatch.setenv("PYTHONPATH", REPO + os.pathsep
                       + os.environ.get("PYTHONPATH", ""))
    argv = _cli(dataset, "germline", str(tmp_path / "out")) + ["--jobs", "2"]
    assert torch_main(argv) == 0
    labels = []
    for path in glob.glob(str(trace_dir / "trace_*.json")):
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        assert {e["ph"] for e in events} <= {"X", "C"}
        assert any(e["name"] == "job" for e in events)
        mine = sorted(e["args"]["segment"] for e in events
                      if e["name"] == "segment")
        if mine:
            labels.append(mine)
    # two workers and the merge; the workers' files hold the segments,
    # one each
    assert len(glob.glob(str(trace_dir / "trace_*.json"))) == 3
    assert sorted(labels) == [["seg_0"], ["seg_1"]]


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["germline", "somatic"])
def test_copy_counters_match_the_profilers_memcpy_events(dataset, mode,
                                                         tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from torch.profiler import ProfilerActivity, profile
    argv = [a if a != "cpu" else "cuda"
            for a in _cli(dataset, mode, str(tmp_path / "warm"))]
    assert torch_main(argv) == 0        # kernels built, tables up
    spans.disable()
    spans.clear()
    argv[argv.index(str(tmp_path / "warm"))] = str(tmp_path / "out")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        assert torch_main(argv) == 0    # the job follows the profiler
    assert not spans.ON
    got, totals = spans.drain()
    trace = str(tmp_path / "trace.json")
    prof.export_chrome_trace(trace)
    with open(trace) as f:
        events = json.load(f)["traceEvents"]
    for kind, tag in (("h2d", "HtoD"), ("d2h", "DtoH")):
        copies = [e for e in events if e.get("cat") == "gpu_memcpy"
                  and tag in e.get("name", "")]
        assert sum(totals[f"{kind}.copies"].values()) == len(copies)
        assert sum(totals[f"{kind}.bytes"].values()) == sum(
            int(e["args"]["bytes"]) for e in copies)
        assert sum(1 for s in got if s["name"] == kind) == len(copies)
