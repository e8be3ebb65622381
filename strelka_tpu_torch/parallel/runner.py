"""Region-sharded run orchestration: the pyflow replacement.

Reference: redist pyflow-1.1.20 (task DAG, retry :939-967, resume from
task-state files :2489-2538,2825), workflowUtil.py getNextGenomeSegment
:182-219 (12Mb segments) + small-contig binning :335-366, and
strelkaSharedWorkflow.py merge/concat tasks :102-148.

TPU-native redesign: instead of one OS process per genome segment, a
single engine process iterates segment tasks (each one a batched device
program), with
  - a checkpointed segment cursor (JSON task-state file) enabling
    interrupt/resume,
  - per-task retry with backoff,
  - run-stats accumulation merged across segments,
  - multi-host operation by deterministic round-robin assignment of
    segments to processes (--process-index) with per-process output shards
    concatenated in segment order (order-critical text merge stays on
    hosts, SURVEY.md §5).

Port of strelka_tpu/parallel/runner.py without its multi-process
launchers (run_local_jobs, the cluster path) and jax.distributed.
"""
from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, field

SCAN_SIZE = 12_000_000          # scanSizeMb (strelkaSharedOptions.py:161)
MIN_SEGMENT_GROUP_SIZE = 200_000  # small-contig grouping target


@dataclass(frozen=True)
class GenomeSegment:
    chrom: str
    begin: int
    end: int

    @property
    def label(self) -> str:
        return f"{self.chrom}_{self.begin}_{self.end}"


def make_genome_segments(chrom_sizes: dict[str, int],
                         scan_size: int = SCAN_SIZE) -> list[GenomeSegment]:
    """Split chromosomes into ~scan_size segments with near-equal sizes
    (workflowUtil.py getNextGenomeSegment semantics)."""
    segments = []
    for chrom, size in chrom_sizes.items():
        n_seg = max(1, (size + scan_size - 1) // scan_size)
        base = size // n_seg
        extra = size % n_seg
        pos = 0
        for i in range(n_seg):
            seg_len = base + (1 if i < extra else 0)
            segments.append(GenomeSegment(chrom, pos, pos + seg_len))
            pos += seg_len
    return segments


def group_segments(segments: list[GenomeSegment],
                   min_group: int = MIN_SEGMENT_GROUP_SIZE):
    """Group small segments into >=min_group work units
    (workflowUtil.py:335-366)."""
    groups: list[list[GenomeSegment]] = []
    cur: list[GenomeSegment] = []
    cur_size = 0
    for seg in segments:
        cur.append(seg)
        cur_size += seg.end - seg.begin
        if cur_size >= min_group:
            groups.append(cur)
            cur = []
            cur_size = 0
    if cur:
        groups.append(cur)
    return groups


def merge_group_spans(groups, halo: int,
                      chrom_lengths: dict[str, int] | None = None):
    """Union of the halo'd genome spans a set of segment groups touches,
    merged per chromosome: the minimal input-read footprint of one
    fan-out process (reference: starling_run.cpp:335-342 supplemental
    region border around each per-process segment)."""
    by_chrom: dict[str, list[tuple[int, int]]] = {}
    for group in groups:
        for seg in group:
            clen = (chrom_lengths or {}).get(seg.chrom)
            beg = max(0, seg.begin - halo)
            end = seg.end + halo if clen is None else min(seg.end + halo, clen)
            by_chrom.setdefault(seg.chrom, []).append((beg, end))
    spans = []
    for chrom, sp in by_chrom.items():
        sp.sort()
        merged: list[list[int]] = []
        for beg, end in sp:
            if merged and beg <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], end)
            else:
                merged.append([beg, end])
        spans.extend((chrom, b, e) for b, e in merged)
    return spans


@dataclass
class RunStats:
    """reference: appstats/RunStats.hh RunStatsData + MergeRunStats."""
    lifetime_sec: float = 0.0
    candidate_indels: int = 0
    noncandidate_indels: int = 0
    segments_completed: int = 0
    reads_processed: int = 0
    extra: dict = field(default_factory=dict)

    def merge(self, other: "RunStats") -> None:
        self.lifetime_sec += other.lifetime_sec
        self.candidate_indels += other.candidate_indels
        self.noncandidate_indels += other.noncandidate_indels
        self.segments_completed += other.segments_completed
        self.reads_processed += other.reads_processed
        for k, v in other.extra.items():
            self.extra[k] = self.extra.get(k, 0) + v

    def to_dict(self):
        return {
            "lifetime_sec": self.lifetime_sec,
            "candidate_indels": self.candidate_indels,
            "noncandidate_indels": self.noncandidate_indels,
            "segments_completed": self.segments_completed,
            "reads_processed": self.reads_processed,
            **self.extra,
        }

    def to_xml(self) -> str:
        """runStats.xml-style report (the reference serializes
        RunStatsData via a boost XML archive into statsDir/runStats.xml,
        strelkaSharedWorkflow.py:250; same field names, simplified
        envelope)."""
        from xml.sax.saxutils import escape
        rows = "".join(
            f"    <{escape(str(k))}>{escape(str(v))}</{escape(str(k))}>\n"
            for k, v in self.to_dict().items())
        return ("<?xml version=\"1.0\" encoding=\"UTF-8\"?>\n"
                "<runStats>\n  <runStatsData>\n"
                f"{rows}"
                "  </runStatsData>\n</runStats>\n")


class TaskStateFile:
    """Checkpointed task completion state (pyflow task-state analog)."""

    def __init__(self, path: str):
        self.path = path
        self._done: dict[str, dict] = {}
        if os.path.exists(path):
            with open(path) as f:
                for line in f:
                    if line.strip():
                        rec = json.loads(line)
                        self._done[rec["task"]] = rec

    def is_complete(self, label: str) -> bool:
        return label in self._done

    def record(self, label: str, info: dict | None = None) -> None:
        rec = {"task": label, "time": time.time(), **(info or {})}
        self._done[label] = rec
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")

    @property
    def completed(self):
        return dict(self._done)


class SegmentRunner:
    """Run a per-segment function over grouped genome segments with
    retry + resume + stats; multi-host segment assignment by process
    index."""

    def __init__(self, workspace_dir: str, max_retries: int = 2,
                 retry_wait_sec: float = 1.0,
                 process_index: int = 0, process_count: int = 1):
        os.makedirs(workspace_dir, exist_ok=True)
        self.workspace = workspace_dir
        self.state = TaskStateFile(os.path.join(
            workspace_dir, f"taskstate.p{process_index}.jsonl"))
        self.max_retries = max_retries
        self.retry_wait = retry_wait_sec
        self.process_index = process_index
        self.process_count = process_count
        self.stats = RunStats()
        # per-worker leveled log (pyflow_log.txt analog, one per worker)
        from ..utils.flowlog import open_flow_log
        self.log = open_flow_log(workspace_dir, process_index)

    def assigned(self, groups: list) -> list[tuple[int, list]]:
        return [(i, g) for i, g in enumerate(groups)
                if i % self.process_count == self.process_index]

    def dry_run(self, groups: list, out=None) -> int:
        """pyflow --dryRun analog: list this host's task schedule
        (label, segment spans, resume state) without executing.
        Returns the number of tasks that WOULD run."""
        import sys
        out = out or sys.stderr
        n_pending = 0
        for gi, group in self.assigned(groups):
            label = f"seg_{gi}"
            done = self.state.is_complete(label)
            spans = ",".join(f"{s.chrom}:{s.begin}-{s.end}" for s in group)
            print(f"[dryrun] task {label} [{spans}] "
                  f"{'COMPLETE (resume skips)' if done else 'PENDING'}",
                  file=out)
            n_pending += 0 if done else 1
        print(f"[dryrun] {n_pending} pending task(s) on process "
              f"{self.process_index}/{self.process_count}", file=out)
        return n_pending

    def run(self, groups: list, task_fn, on_complete=None) -> RunStats:
        """task_fn(group) -> (result, RunStats|None); results passed to
        on_complete(group_index, result) in order for this host."""
        t0 = time.time()
        for gi, group in self.assigned(groups):
            label = f"seg_{gi}"
            if self.state.is_complete(label):
                self.log.info("task %s already complete (resume skips)",
                              label)
                continue
            attempt = 0
            task_t0 = time.time()
            spans = ",".join(f"{s.chrom}:{s.begin}-{s.end}" for s in group)
            self.log.info("task %s begin [%s]", label, spans)
            while True:
                try:
                    result, seg_stats = task_fn(group)
                    break
                except Exception as e:  # noqa: BLE001 — retry any task error
                    attempt += 1
                    if attempt > self.max_retries:
                        self.log.error(
                            "task %s failed after %d attempts: %s",
                            label, attempt, e)
                        raise RuntimeError(
                            f"task {label} failed after {attempt} attempts: {e}"
                        ) from e
                    self.log.warning("task %s attempt %d failed (%s); "
                                     "retrying in %.1fs", label, attempt, e,
                                     self.retry_wait * attempt)
                    time.sleep(self.retry_wait * attempt)
            task_dt = time.time() - task_t0
            self.log.info("task %s complete in %.2fs (attempts=%d)",
                          label, task_dt, attempt + 1)
            if seg_stats is not None:
                self.stats.merge(seg_stats)
            self.stats.segments_completed += 1
            if on_complete is not None:
                on_complete(gi, result)
            # per-task wall time in the state file (SegmentTimeTracker
            # analog; pyflow writes per-task timing logs)
            self.state.record(label, {"wall_sec": round(task_dt, 3),
                                      "attempts": attempt + 1})
        self.stats.lifetime_sec += time.time() - t0
        self.write_stats()
        return self.stats

    def write_stats(self):
        with open(os.path.join(self.workspace,
                               f"runStats.p{self.process_index}.json"), "w") as f:
            json.dump(self.stats.to_dict(), f, indent=1)


def merge_run_stats(workspace_dir: str) -> RunStats:
    """MergeRunStats analog over all host shards."""
    total = RunStats()
    for name in sorted(os.listdir(workspace_dir)):
        if name.startswith("runStats.p") and name.endswith(".json"):
            with open(os.path.join(workspace_dir, name)) as f:
                d = json.load(f)
            rs = RunStats(
                lifetime_sec=d.pop("lifetime_sec", 0.0),
                candidate_indels=d.pop("candidate_indels", 0),
                noncandidate_indels=d.pop("noncandidate_indels", 0),
                segments_completed=d.pop("segments_completed", 0),
                reads_processed=d.pop("reads_processed", 0),
                extra=d,
            )
            total.merge(rs)
    return total


def init_distributed() -> tuple[int, int]:
    """(process_index, process_count) of this process: one process,
    (0, 1). A multi-process run passes --process-index/--process-count
    to the workflow, which overrides this; the coordinated cluster path
    of the JAX package is not ported yet."""
    return 0, 1
