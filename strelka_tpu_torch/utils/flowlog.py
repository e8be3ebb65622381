"""Leveled workflow logging with per-worker capture.

Reference: pyflow-1.1.20 pyflow.py WorkflowRunner logging — timestamped
"[time] [host:pid] [level]" lines into pyflow.data/logs/pyflow_log.txt,
per-task stderr capture (:1180-1240), and the end-of-run error/warning
surfacing. Here each --jobs worker writes its own tagged log under
workspace/logs/; the merge step concatenates them into workflow.log and
surfaces warnings/errors so one worker's failure is diagnosable from a
single file.
"""
from __future__ import annotations

import logging
import os
import socket
import sys

LOG_DIR = "logs"


class _FlowFormatter(logging.Formatter):
    """pyflow log line shape: [ISO time] [host:pid] [LEVEL] msg."""

    def __init__(self):
        super().__init__(
            "[%(asctime)s] [" + socket.gethostname()
            + ":%(process)d] [%(levelname)s] %(message)s",
            datefmt="%Y-%m-%dT%H:%M:%S")


def worker_log_path(workspace_dir: str, process_index: int) -> str:
    return os.path.join(workspace_dir, LOG_DIR,
                        f"worker.p{process_index}.log")


def open_flow_log(workspace_dir: str, process_index: int = 0,
                  mirror_level: int = logging.WARNING) -> logging.Logger:
    """Per-worker leveled logger: full log to
    workspace/logs/worker.p<i>.log, WARNING+ mirrored to stderr."""
    os.makedirs(os.path.join(workspace_dir, LOG_DIR), exist_ok=True)
    logger = logging.getLogger(f"strelka_tpu_torch.worker.p{process_index}")
    logger.setLevel(logging.INFO)
    logger.propagate = False
    # reopen cleanly if the same process re-runs a workflow
    for h in list(logger.handlers):
        logger.removeHandler(h)
        h.close()
    fh = logging.FileHandler(worker_log_path(workspace_dir, process_index))
    fh.setFormatter(_FlowFormatter())
    logger.addHandler(fh)
    sh = logging.StreamHandler(sys.stderr)
    sh.setLevel(mirror_level)
    sh.setFormatter(_FlowFormatter())
    logger.addHandler(sh)
    return logger


def merge_worker_logs(workspace_dir: str, out_path: str):
    """Concatenate per-worker logs into one workflow log (worker order,
    like pyflow's single pyflow_log.txt) and return the surfaced
    {"warnings": [...], "errors": [...]} lines."""
    log_dir = os.path.join(workspace_dir, LOG_DIR)
    warnings: list[str] = []
    errors: list[str] = []
    if not os.path.isdir(log_dir):
        return {"warnings": warnings, "errors": errors}
    names = sorted(n for n in os.listdir(log_dir) if n.endswith(".log"))
    with open(out_path, "w") as out:
        for name in names:
            with open(os.path.join(log_dir, name), errors="replace") as f:
                out.write(f"==> {name} <==\n")
                for line in f:
                    out.write(line)
                    if "[WARNING]" in line:
                        warnings.append(line.rstrip("\n"))
                    elif "[ERROR]" in line or "[CRITICAL]" in line:
                        errors.append(line.rstrip("\n"))
    return {"warnings": warnings, "errors": errors}


def tail(path: str, n_lines: int = 25) -> str:
    """Last n lines of a (possibly large) text file, for failure
    surfacing."""
    try:
        with open(path, "rb") as f:
            f.seek(0, os.SEEK_END)
            size = f.tell()
            f.seek(max(0, size - 65536))
            data = f.read().decode(errors="replace")
    except OSError:
        return ""
    return "\n".join(data.splitlines()[-n_lines:])
