"""Host hardware estimation for local fan-out sizing.

Reference analog: src/python/lib/estimateHardware.py
(getNodeRealCoreCount :34, getNodeHyperthreadCoreCount :84,
getNodeMemMb :122) + strelkaSharedWorkflow.py:308-316 per-job memory
budgeting (callLocalMemMb = 1.5GB per local job,
strelkaSharedOptions.py:153-154).

Copy of strelka_tpu/parallel/hardware.py. `--jobs auto` sizes from host
cores and host memory only; the workers' share of the card is kept by
somatic_snv.rows_per_launch, not by capping the worker count.
"""
from __future__ import annotations

import os

# per local worker process (strelkaSharedOptions.py:154)
LOCAL_JOB_MEM_MB = 1536


def core_count() -> int:
    """Schedulable hyperthread cores (cgroup/affinity aware)."""
    try:
        return len(os.sched_getaffinity(0))
    except (AttributeError, OSError):
        return os.cpu_count() or 1


def mem_total_mb() -> int:
    """MemTotal from /proc/meminfo (estimateHardware.py:122-168);
    0 when unavailable."""
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemTotal:"):
                    return int(line.split()[1]) // 1024
    except OSError:
        pass
    return 0


def suggest_jobs(mem_per_job_mb: int = LOCAL_JOB_MEM_MB) -> int:
    """Local worker count: cores, clamped so that jobs*mem fits
    (strelkaSharedWorkflow.py memory capping of local jobs)."""
    cores = core_count()
    mem = mem_total_mb()
    if mem <= 0:
        return cores
    return max(1, min(cores, mem // max(mem_per_job_mb, 1)))
