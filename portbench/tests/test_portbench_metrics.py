"""The per-layer readers on a recorded run (data/run_record.json), the
work counted on live extents, and the trace's reading."""
import json
import os

import pytest
import torch

from portbench.core import manifest, peaks, trace

RECORD = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                      "run_record.json")


@pytest.fixture(scope="module")
def run():
    with open(RECORD) as f:
        return json.load(f)


def read(name, run):
    return manifest.reader(name).read(run)


def test_span_readers(run):
    # two jobs of 500,000 reads: 1 Mread
    assert read("decode.s_per_mread", run) == pytest.approx(1.5)
    # region spans 4 s, the device entries inside them 0.7 s
    assert read("region_host.s_per_mread", run) == pytest.approx(3.3)
    assert read("emit.s_per_mread", run) == pytest.approx(1.0)


def test_device_readers(run):
    k1 = [c for c in run["calls"] if c["entry"] == "k1"]
    want = 100 * sum(peaks.bound_ms(c["nbytes"], c["int8_ops"])
                     for c in k1) * 1e-3 / run["kernel_s"]["k1"]
    assert read("k1_roofline", run) == pytest.approx(want)
    assert read("k1_roofline", run) == pytest.approx(50.0)
    assert read("snv_tiles.host_ms_per_call", run) == pytest.approx(0.45)
    assert read("device.idle_pct", run) == pytest.approx(99.0)


def test_nothing_to_read_gives_none(run):
    empty = {"window_s": 10.0, "reads": 1000, "jobs": [], "spans": [],
             "calls": [], "kernel_s": {}, "busy_s": None}
    for m in manifest.load()["per_layer"]:
        assert read(m["name"], empty) is None, m["name"]
    no_kernel = dict(run, kernel_s={})
    assert read("k1_roofline", no_kernel) is None


def test_k1_work_counts_live_extents_only():
    """Padding (code 4) in reads, bases and offsets adds no work."""
    g = torch.Generator().manual_seed(1)
    B, R, L, W = 3, 5, 7, 6
    codes = torch.randint(0, 4, (B, R, L), generator=g).to(torch.int8)
    win = torch.randint(0, 4, (B, L, W), generator=g).to(torch.int8)
    delta = torch.rand(B, R, L, generator=g)
    lnmis = torch.rand(B, R, generator=g)
    live = peaks.k1_work(codes, delta, lnmis, win)
    pad = lambda t, shape, fill: torch.cat(  # noqa: E731
        [t, torch.full(shape, fill, dtype=t.dtype)], dim=len(shape) - 1)
    codes_p = torch.full((B, R + 3, L + 9), 4, dtype=torch.int8)
    codes_p[:, :R, :L] = codes
    win_p = torch.full((B, L + 9, W + 10), 4, dtype=torch.int8)
    win_p[:, :L, :W] = win
    padded = peaks.k1_work(codes_p, torch.zeros(B, R + 3, L + 9),
                           pad(lnmis, (B, 3), 0.0), win_p)
    assert {k: float(v) for k, v in padded.items()} == \
        {k: float(v) for k, v in live.items()}
    assert float(live["int8_ops"]) == 2 * B * R * L * W
    assert float(live["nbytes"]) == B * (5 * R * L + 12 * R + L * W)


def test_lanes_work_counts_live_rows_and_lanes():
    L, D = 10, 8
    base = torch.zeros(L, D, dtype=torch.int8)
    qual = torch.zeros(L, D, dtype=torch.int16)
    mask = torch.zeros(L, D, dtype=torch.bool)
    mask[:4, :3] = True
    w = peaks.kgh_lanes_work(base, qual, mask, torch.zeros(L))
    assert float(w["f64_ops"]) == peaks.KGH_F64_PER_ROW * 4
    g = peaks.ksg_work(base, qual, mask, mask, torch.zeros(L))
    assert float(g["f32_ops"]) == 2 * 21 * 12


def _ev(name, ts, dur, stream):
    return {"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": dur,
            "args": {"stream": stream}}


def test_trace_leaves_out_the_benchmarks_stream(tmp_path):
    events = [_ev("FillFunctor", 0, 1, 7), _ev("FillFunctor", 5, 1, 13),
              _ev("score_best_offsets_tc_kernel<0>", 10, 4, 7),
              _ev("reduce_kernel", 12, 100, 13),
              {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH",
               "ts": 20, "dur": 3, "args": {"stream": 13}},
              _ev("score_best_offsets_tc_kernel<0>", 30, 6, 7)]
    p = tmp_path / "t.json"
    p.write_text(json.dumps({"traceEvents": events}))
    got, clock = trace.device_events(str(p), side=True)
    assert clock == 0
    assert [e[1] for e in got] == [10, 30]
    assert trace.busy_us(got) == 10
    assert trace.kernel_s(got, "score_best_offsets") == pytest.approx(1e-5)
    got, clock = trace.device_events(str(p), side=False)
    assert len(got) == 5
    # a side marker on the program's stream leaves nothing out
    events[1]["args"]["stream"] = 7
    p.write_text(json.dumps({"traceEvents": events}))
    assert len(trace.device_events(str(p), side=True)[0]) == 4
