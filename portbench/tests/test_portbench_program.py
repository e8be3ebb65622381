"""The readers of the port's own spans and counters on a recorded run
(data/program_record.json), and their arithmetic."""
import json
import os
import sys

import pytest

from portbench.core import manifest, program

RECORD = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                      "program_record.json")
STAGES = ("prep", "discover", "candidates", "score", "realign", "pileup",
          "genotype")


@pytest.fixture
def run():
    with open(RECORD) as f:
        return json.load(f)


def read(name, run):
    return manifest.reader(name).read(run)


@pytest.mark.parametrize("stage,want", list(zip(
    STAGES, (0.5, 0.5, 0.5, 0.3, 0.5, 0.5, 0.7))))
def test_stage_readers_read_self_time(run, stage, want):
    # one job of 1 Mread; region.candidates holds a region.score span,
    # region.score and region.genotype hold h2d and d2h spans
    assert read(f"region.{stage}.s_per_mread", run) == pytest.approx(want)


def test_stages_and_copies_cover_the_region(run):
    spans = program.spans(run)
    stages = sum(read(f"region.{s}.s_per_mread", run) for s in STAGES)
    waits = read("device_wait.s_per_mread", run)
    region = program.total_s(spans, ("region",))
    assert region == pytest.approx(4.0)
    assert program.self_s(spans, "region") == pytest.approx(0.1)
    assert stages + waits + 0.1 == pytest.approx(region)


def test_device_and_job_readers(run):
    assert read("device_wait.s_per_mread", run) == pytest.approx(0.4)
    assert read("h2d.mb_per_mread", run) == pytest.approx(4.0)
    assert read("h2d.copies_per_mread", run) == pytest.approx(3.0)
    # the job's 10 s less decode 1, region 4, emit 2 and merge 0.5
    assert read("job_host.s_per_mread", run) == pytest.approx(2.5)


def test_a_port_without_the_recorder_reads_nothing(run, monkeypatch):
    monkeypatch.setitem(sys.modules, "strelka_tpu_torch.utils.spans", None)
    del run["program_spans"]
    for name in [f"region.{s}.s_per_mread" for s in STAGES] + [
            "device_wait.s_per_mread", "h2d.mb_per_mread",
            "h2d.copies_per_mread", "job_host.s_per_mread"]:
        assert read(name, dict(run)) is None, name


def test_the_recorder_is_read_inside_the_window():
    from strelka_tpu_torch.utils import spans as sp
    sp.clear()
    sp.enable()
    try:
        with sp.job(cmd="test"):
            sp.count("h2d.copies", site="k1")
            with sp.span("region"):
                pass
    finally:
        sp.disable()
    sp.count("h2d.copies", 5, site="k1")    # outside every job
    s = [x for x in sp._SPANS if x[2] == "job"][0]
    # the harness's job starts before the port's and ends after it
    window = {"reads": 1_000_000,
              "jobs": [{"t0": s[3] * 1e-9 - 1e-6, "t1": s[4] * 1e-9 + 1e-6}]}
    assert read("h2d.copies_per_mread", window) == pytest.approx(1.0)
    assert [x["name"] for x in window["program_spans"]] == ["region", "job"]
    outside = {"reads": 1, "jobs": [{"t0": 0.0, "t1": 1e-9}]}
    assert read("job_host.s_per_mread", outside) is None


def test_idle_by_span_splits_idle_time_at_span_edges():
    # the device busy 2-3 s of a 0-10 s window; a job over 1-9 s
    # holds a region over 4-6 s
    spans = [("job", 1.0, 9.0), ("region", 4.0, 6.0)]
    got = dict(program.idle_by_span([(2e6, 3e6)], 0.0, 10e6, spans, 0.0))
    assert got == pytest.approx({"job": 5.0, "region": 2.0,
                                 "outside the layers": 2.0})
