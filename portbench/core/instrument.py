"""The benchmark's wrappers around the port's calls.

Each wrapper replaces a function of ``strelka_tpu_torch`` in the module
where its caller looks it up, as ``chip_smoke.StreamTimer`` does; the
port itself is not edited. Two kinds:

- checks (every run): a seeded share of the calls of the device entries
  that the comparison covers (K1, KG-H's lanes entry, KG-SB, KS-G,
  KS-P) copy their inputs and outputs to the host, for the plain
  reference after the window (reference/compare.py);
- spans (``--trace 1``): host clock around the layers' calls (decode,
  region callers, output) and around each device entry, with the work
  its inputs need, counted from their live extents (core/peaks.py).

On a card the benchmark's own device work (the checks' copies, the
counting of live extents) runs on a stream of its own, which the
trace's reading leaves out (core/trace.py), so that the program's busy
time and kernel times are the program's.
"""
from __future__ import annotations

import time

import numpy as np

# (module, attribute, layer) of the host spans; a module that imported
# the function by name is listed beside the function's own module
SPANS = (
    ("strelka_tpu_torch.workflow.germline", "read_alignments", "decode"),
    ("strelka_tpu_torch.workflow.somatic", "read_alignments", "decode"),
    ("strelka_tpu_torch.io.bam", "read_alignments_regions", "decode"),
    ("strelka_tpu_torch.pipeline.germline_caller", "call_region", "region"),
    ("strelka_tpu_torch.pipeline.somatic_caller", "call_somatic_region",
     "region"),
    ("strelka_tpu_torch.pipeline.gvcf", "emit_region", "emit"),
    ("strelka_tpu_torch.workflow.somatic", "_emit_somatic_segment", "emit"),
)
# (module, attribute, entry, the name of its kernel in the trace; None:
# checked, no roofline)
ENTRIES = (
    ("strelka_tpu_torch.ops.score_kernel", "score_best_offsets", "k1",
     "score_best_offsets_tc_kernel"),
    ("strelka_tpu_torch.models.snv_digt", "call_snv_lanes_tile",
     "snv_tiles", "snv_lanes_tile_kernel"),
    ("strelka_tpu_torch.models.snv_digt", "snv_strand_bias_tile", "kgsb",
     None),
    ("strelka_tpu_torch.models.somatic_snv", "freq_grid_lhoods",
     "somatic_grid", "somatic_grid_kernel"),
    ("strelka_tpu_torch.models.somatic_snv", "somatic_snv_call",
     "somatic_posterior", "somatic_posterior_kernel"),
)
KERNELS = {e: k for _m, _a, e, k in ENTRIES if k}
CHECKED = tuple(e for _m, _a, e, _k in ENTRIES)
WRITER = ("strelka_tpu_torch.io.tabix", "IndexedVcfWriter")
# faults of the timed path (tests and limit readings only): the checked
# entries' outputs broken underneath, or the records the CLI writes
ENTRY_FAULTS = ("altered", "half", "unchanged")
RECORD_FAULTS = ("records_half", "records_none")
FAULTS = ("none",) + ENTRY_FAULTS + RECORD_FAULTS


def _host(x):
    """A tensor (or a named tuple of them, as a dict) copied to the host."""
    import torch
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True)
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return {k: _host(v) for k, v in zip(x._fields, x)}
    return x


class Instrument:
    """Wrappers of one process. seed and share pick the checked calls
    (an entry's first call since the captures were last cleared, then
    each call with probability `share`, at most CAP an entry); trace
    adds the spans; fault (FAULTS) breaks the timed path underneath."""

    CAP = 64

    def __init__(self, seed: int, share: float, trace: bool = False,
                 fault: str = "none"):
        if fault not in FAULTS:
            raise ValueError(f"fault must be one of {FAULTS}")
        self.rng = np.random.default_rng([int(seed) % (1 << 64), 9])
        self.share = share
        self.trace = trace
        self.fault = fault
        self.captured: dict[str, list] = {e: [] for e in CHECKED}
        self.spans: list[tuple] = []          # (layer, t0, t1)
        self.calls: list[dict] = []           # device entries, traced
        self._patched: list[tuple] = []
        self.side = None                      # the benchmark's stream

    # -- installing ---------------------------------------------------
    def install(self) -> None:
        import importlib

        import torch
        if torch.cuda.is_available():
            self.side = torch.cuda.Stream()
        if self.trace:
            for mod, name, layer in SPANS:
                m = importlib.import_module(mod)
                self._patch(m, name, self._span(getattr(m, name), layer))
        if self.trace:
            tabix = importlib.import_module(WRITER[0])
            self._patch(tabix, WRITER[1],
                        self._writer_span(getattr(tabix, WRITER[1])))
        for mod, name, entry, _kernel in ENTRIES:
            m = importlib.import_module(mod)
            self._patch(m, name, self._entry(getattr(m, name), entry))

    def install_record_faults(self) -> None:
        """The writer's hook of the record faults (a switch of `fault`
        between jobs then reaches it)."""
        import importlib
        cls = getattr(importlib.import_module(WRITER[0]), WRITER[1])
        self._patch(cls, "write_record_line",
                    self._records(cls.write_record_line))

    def restore(self) -> None:
        for m, name, fn in reversed(self._patched):
            setattr(m, name, fn)
        self._patched = []

    def clear(self) -> None:
        """Forget what was recorded (after the warm-up)."""
        for v in self.captured.values():
            v.clear()
        self.spans.clear()
        self.calls.clear()

    def _patch(self, m, name, fn) -> None:
        self._patched.append((m, name, getattr(m, name)))
        setattr(m, name, fn)

    def _on_side(self, tensors):
        """A context that runs on the benchmark's stream after the
        program's work so far, keeping `tensors` alive for it."""
        import contextlib

        import torch
        if self.side is None:
            return contextlib.nullcontext()
        self.side.wait_stream(torch.cuda.current_stream())
        for t in tensors:
            if isinstance(t, torch.Tensor) and t.is_cuda:
                t.record_stream(self.side)
        return torch.cuda.stream(self.side)

    # -- wrappers -----------------------------------------------------
    def _span(self, fn, layer):
        spans = self.spans

        def spanned(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                spans.append((layer, t0, time.perf_counter()))
        return spanned

    def _writer_span(self, cls):
        spans = self.spans

        class Spanned(cls):
            """The merge's concat and bgzf writes of one output file."""

            def __enter__(self):
                self._pb_t0 = time.perf_counter()
                return super().__enter__()

            def __exit__(self, *exc):
                try:
                    return super().__exit__(*exc)
                finally:
                    spans.append(("emit", self._pb_t0,
                                  time.perf_counter()))
        return Spanned

    def _records(self, write):
        """The writer's record line, left out under a record fault:
        every second record ("records_half") or every record
        ("records_none")."""
        inst = self

        def write_record_line(w, line):
            n = getattr(w, "_pb_records", 0)
            w._pb_records = n + 1
            if inst.fault == "records_none" or (
                    inst.fault == "records_half" and n % 2):
                return None
            return write(w, line)
        return write_record_line

    def _entry(self, fn, entry):
        from . import peaks
        inst = self

        def wrapped(*a, **k):
            check = (len(inst.captured[entry]) < inst.CAP
                     and (not inst.captured[entry]
                          or inst.rng.random() < inst.share))
            timed = inst.trace
            t0 = time.perf_counter()
            out = fn(*a, **k)
            t1 = time.perf_counter()
            if inst.fault in ENTRY_FAULTS:
                out = inst._break(entry, out)
            if timed:
                work = {}
                if entry in peaks.WORK:
                    with inst._on_side(_tensors(a, k)):
                        work = peaks.WORK[entry](*a, **k)
                inst.calls.append({"entry": entry, "t0": t0, "t1": t1,
                                   "work": work})
            if check:
                with inst._on_side(_tensors(a, k) + _tensors(out, {})):
                    inst.captured[entry].append(
                        (tuple(_host(x) for x in a),
                         {n: _host(v) for n, v in k.items()},
                         _outputs(entry, out)))
            return out
        return wrapped

    # -- faults (tests and limit readings) ----------------------------
    def _break(self, entry, out):
        """The output of a broken timed path: "altered", one answer
        changed where it is produced; "half", half of the batch left out
        and the mean of the rest in its place; "unchanged", the output
        left as allocated (zeros)."""
        import torch
        if entry == "k1":
            best, off = (t.clone() for t in out)
            if self.fault == "altered":
                best.view(-1)[0] += 1.0
            elif self.fault == "half":
                h = best.shape[0] // 2
                best[h:] = best[:h].mean()
                off[h:] = 0
            else:
                best.zero_()
                off.zero_()
            return best, off
        if entry == "somatic_posterior":
            f = {k: v.clone() for k, v in out._asdict().items()}
            if self.fault == "altered":
                f["strand_bias"].view(-1)[0] += 1.0
            for k, v in f.items():
                if self.fault == "half":
                    h = v.shape[0] // 2
                    mean = v[:h].to(torch.float64).mean()
                    v[h:] = (mean if v.is_floating_point()
                             else mean.round()).to(v.dtype)
                elif self.fault == "unchanged":
                    v.zero_()
            return type(out)(**f)
        lh = (out.lhood if entry == "snv_tiles" else out).clone()
        if self.fault == "altered":
            lh.view(-1)[0] += 1.0
        elif self.fault == "half":
            h = lh.shape[0] // 2
            lh[h:] = lh[:h].mean(dim=0)
        else:
            lh.zero_()
        if entry == "snv_tiles":
            return out._replace(lhood=lh)
        return lh

    # -- reading ------------------------------------------------------
    def device_calls(self) -> list[dict]:
        """The traced device entries' calls: host_ms and the work of
        their live extents as numbers (synchronises)."""
        import torch
        if self.side is not None and self.calls:
            torch.cuda.synchronize()
        out = []
        for rec in self.calls:
            r = {k: v for k, v in rec.items() if k != "work"}
            r["host_ms"] = (rec["t1"] - rec["t0"]) * 1e3
            r.update({k: float(v) for k, v in rec["work"].items()})
            out.append(r)
        return out


def _tensors(a, k) -> list:
    import torch
    out = []
    for x in list(a if isinstance(a, tuple) else (a,)) + list(k.values()):
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, tuple):
            out += _tensors(x, {})
    return out


def _outputs(entry, out):
    """What the comparison reads of an entry's output, on the host: K1's
    best and offset, KG-H's lhood, KG-SB's strand bias, KS-G's lhoods,
    KS-P's fields."""
    if entry == "k1":
        return tuple(_host(x) for x in out)
    if entry == "snv_tiles":
        return _host(out.lhood)
    return _host(out)
