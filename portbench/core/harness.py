"""One run of one cell: set-up, the measured window of whole CLI jobs,
the per-layer readings of a traced run, and the comparison that decides
``correct``.

A job is one call of ``strelka_tpu_torch.__main__.main`` on the cell's
inputs with ``--device cuda``, written to a fresh output directory; the
records it wrote are kept for the comparison and the rest removed. Jobs
run one after another (a closed loop of one client); the window opens
when the first timed job starts and closes when the job running at
``--seconds`` finishes.
"""
from __future__ import annotations

import gc
import os
import shutil
import sys
import tempfile
import time
import traceback

from . import instrument, manifest, truth
from ..gen import dataset


def _log(msg: str) -> None:
    print(f"[portbench] {msg}", file=sys.stderr, flush=True)


class Cell:
    """The cell's configuration and traffic, and how a job is called."""

    def __init__(self, man: dict, name: str):
        self.name = name
        self.entry = manifest.workload(man, name)
        self.config = manifest.config(man, self.entry["config"])
        self.traffic = manifest.traffic(self.entry["traffic"])

    def argv(self, data: dict, out: str, device: str) -> list[str]:
        c = self.config
        if c["mode"] == "germline":
            args = ["germline", "--reference", data["fasta"]]
            for s in c["samples"]:
                args += ["--align-file", data["bams"][s["name"]]]
        else:
            normal, tumor = (s["name"] for s in c["samples"])
            args = ["somatic", "--reference", data["fasta"],
                    "--normal-align-file", data["bams"][normal],
                    "--tumor-align-file", data["bams"][tumor]]
        return (args + ["--output-dir", out, "--device", device]
                + list(c.get("cli_args", [])) + list(self.traffic["cli_args"]))


class Run:
    """State of one run; `execute` returns the result line's object."""

    def __init__(self, cell: Cell, seed: int, seconds: float, trace: bool,
                 device: str = "cuda", fault: str = "none",
                 t_start: float | None = None):
        self.cell = cell
        self.seed = seed
        self.seconds = seconds
        self.trace = trace
        self.device = device
        self.fault = fault
        self.t_start = t_start or time.perf_counter()
        self.cuda = device == "cuda"
        self.work = tempfile.mkdtemp(prefix=f"portbench-{cell.name}-")
        self.jobs: list[dict] = []
        self.peak_bytes = 0

    # -- set-up -------------------------------------------------------
    def setup(self) -> None:
        os.environ["STRELKA_TPU_LAUNCH_STATS"] = os.path.join(self.work,
                                                              "launches")
        import torch
        from strelka_tpu_torch.__main__ import main
        self.main = main
        if self.cuda:
            torch.cuda.init()
            torch.empty(1, device="cuda")
        self.data = dataset.make(self.cell.config, self.seed,
                                 os.path.join(self.work, "data"))
        _log(f"inputs: {self.data['reads']} reads in "
             f"{self.data['seconds']:.2f} s")
        self.inst = instrument.Instrument(
            self.seed, float(self.cell.config["check_share"]),
            trace=self.trace)
        self.inst.install()
        if self.fault in instrument.RECORD_FAULTS:
            self.inst.install_record_faults()
        # the warm-up is one whole job on the window's inputs: every
        # shape, kernel and code path of the window's jobs
        rc = self.job("warm", self.data)["rc"]
        if rc != 0:
            raise RuntimeError(f"the warm-up job exited {rc}")
        self.inst.clear()
        self.inst.fault = self.fault          # a fault breaks the window
        if self.cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        gc.collect()
        gc.freeze()

    def job(self, tag, data) -> dict:
        """One CLI job; its records are kept under kept/<tag>."""
        out = os.path.join(self.work, f"out-{tag}")
        t0 = time.perf_counter()
        try:
            rc = self.main(self.cell.argv(data, out, self.device))
            rc = 0 if rc is None else int(rc)
        except Exception:  # noqa: BLE001 - a failed job is counted
            traceback.print_exc()
            rc = 1
        t1 = time.perf_counter()
        keep = os.path.join(self.work, "kept", str(tag))
        os.makedirs(keep, exist_ok=True)
        for name in self.cell.config["outputs"]:
            p = os.path.join(out, name)
            if os.path.exists(p):
                shutil.move(p, os.path.join(keep, name))
        shutil.rmtree(out, ignore_errors=True)
        return {"tag": tag, "rc": rc, "t0": t0, "t1": t1,
                "reads": data["reads"], "keep": keep}

    # -- the window ---------------------------------------------------
    def window(self) -> None:
        dt = None
        if self.trace and self.cuda:
            from .trace import DeviceTrace
            dt = DeviceTrace()
            dt.start(self.inst.side)
        self.setup_s = time.perf_counter() - self.t_start
        w0 = time.perf_counter()
        while True:
            self.jobs.append(self.job(len(self.jobs), self.data))
            if time.perf_counter() - w0 >= self.seconds:
                break
        self.w0, self.w1 = self.jobs[0]["t0"], self.jobs[-1]["t1"]
        self.trace_path = None
        if dt is not None:
            self.trace_path = os.path.join(self.work, "trace.json")
            dt.stop(self.trace_path)
            self.marker_host = dt.marker_host
        if self.cuda:
            import torch
            torch.cuda.synchronize()
            self.peak_bytes = torch.cuda.max_memory_allocated()

    # -- after the window ---------------------------------------------
    def layer_record(self) -> dict:
        """What the per-layer readers read (metrics/*.py)."""
        from . import trace as tr
        window_s = self.w1 - self.w0
        reads = sum(j["reads"] for j in self.jobs)
        rec = {"window_s": window_s, "reads": reads, "jobs": self.jobs,
               "spans": list(self.inst.spans),
               "calls": self.inst.device_calls(), "kernel_s": {},
               "busy_s": None, "breakdown": {"device_ops": [],
                                             "idle_gaps": []}}
        if self.trace_path:
            events, clock = tr.device_events(self.trace_path,
                                             self.inst.side is not None)
            if clock is not None:
                offset = clock - self.marker_host * 1e6
                lo = self.w0 * 1e6 + offset
                hi = self.w1 * 1e6 + offset
                spans = rec["spans"] + [(c["entry"], c["t0"], c["t1"])
                                        for c in rec["calls"]]
                rec["breakdown"]["idle_gaps"] = tr.idle_gaps(
                    events, lo, hi, spans, offset)
            rec["busy_s"] = tr.busy_us(events) * 1e-6
            rec["breakdown"]["device_ops"] = tr.top_ops(events)
            rec["kernel_s"] = {e: tr.kernel_s(events, k)
                               for e, k in instrument.KERNELS.items()}
        return rec

    def readings(self, jobs: list[dict], control: bool = False) -> dict:
        """{number: (reading, calls or jobs compared)}: the checked
        calls against the plain reference, the jobs' records against the
        planted truth."""
        from ..reference import compare
        out = compare.compare(self.inst.captured,
                              "cuda" if self.cuda else "cpu",
                              control=control)
        out.update(truth.numbers(self.cell.config, self.data["genome"],
                                 [j["keep"] for j in jobs]))
        return out

    def close(self) -> None:
        # the port dumps its launch counts at exit into the variable's
        # directory, which goes with the work directory now
        import atexit
        rb = sys.modules.get("strelka_tpu_torch.pipeline.realign_batch")
        if rb is not None:
            atexit.unregister(rb._dump_launch_stats)
        shutil.rmtree(self.work, ignore_errors=True)


def judge(limits: dict, readings: dict, failed: int) -> tuple[bool, dict]:
    """(correct, {number: {value, limit, calls}}): every limit's number
    read and within it, and no job failed."""
    checks, ok = {}, failed == 0
    for number, limit in limits.items():
        value, n = readings.get(number, (None, 0))
        checks[number] = {"value": value, "limit": limit, "calls": n}
        ok = ok and value is not None and value <= limit
    return bool(ok), checks


def execute(cell: Cell, seed: int, seconds: float, trace: bool,
            device: str = "cuda", fault: str = "none",
            control: bool = False, t_start: float | None = None,
            man: dict | None = None) -> dict:
    """One run; returns the result line's object."""
    run = Run(cell, seed, seconds, trace, device, fault, t_start)
    try:
        run.setup()
        run.window()
        run.inst.restore()
        rec = run.layer_record()
        attempted = len(run.jobs)
        failed = sum(j["rc"] != 0 for j in run.jobs)
        metrics = {}
        man = man or manifest.load()
        for m in manifest.metrics_for(man, cell.name, trace):
            if trace:
                v = manifest.reader(m["name"]).read(rec)
            else:
                v = {"reads_per_s": rec["reads"] / rec["window_s"],
                     "setup_s": run.setup_s}.get(m["name"])
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        import torch
        device_rec = {"platform": "gpu" if run.cuda else "cpu",
                      "kind": (torch.cuda.get_device_name(0) if run.cuda
                               else "cpu"),
                      "count": 1 if run.cuda else 0,
                      "memory_peak_bytes": int(run.peak_bytes)}
        if trace:
            device_rec["busy_s"] = rec["busy_s"]
            device_rec["window_s"] = rec["window_s"]
        # the program's state goes before the reference runs
        gc.unfreeze()
        gc.collect()
        if run.cuda:
            torch.cuda.empty_cache()
        readings = run.readings(run.jobs, control)
        ok, checks = judge(cell.config["limits"], readings, failed)
        result = {"correct": ok, "attempted": attempted, "failed": failed,
                  "metrics": metrics, "device": device_rec}
        if trace:
            result["breakdown"] = rec["breakdown"]
        result["diagnostics"] = diagnostics(run, readings,
                                            cell.config["limits"])
        result["checks"] = checks
        return result
    finally:
        run.close()


def diagnostics(run: Run, readings: dict, limits: dict) -> dict:
    """The readings that no limit holds (PERF.md says why), each job's
    wall and the card's name and power limit."""
    out = {k: v[0] for k, v in readings.items() if k not in limits}
    out["job_wall_s"] = [round(j["t1"] - j["t0"], 3) for j in run.jobs]
    if run.cuda:
        from .peaks import card
        out["card"] = card()
    return out
