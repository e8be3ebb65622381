"""Workflow tools: only the chromosome-depth estimator, which the
germline workflow's WGS mode needs. Port of
strelka_tpu/workflow/tools.py:109-168; the other tool subcommands are
not ported yet.
"""
from __future__ import annotations


def chrom_depth_estimate(batch, chrom_len: int,
                         cell_size: int = 16) -> float:
    """GetChromDepth estimator (ReadChromDepthUtil.cpp DepthTracker):
    each primary, non-duplicate mapped read adds depth over
    [pos, pos+read_size) assuming a perfect in-place alignment (no
    MAPQ filter); per-position depth reads through a 16-position
    compressed cell (depth_buffer.hh:129 rounded cell mean); the
    median is taken over nonzero positions in [first read pos, last
    read pos] with the between-values midpoint rule
    (MedianDepthTracker.hh)."""
    import numpy as np
    if batch is None or batch.n == 0:
        return 0.0
    # starling_read_filter_shared: drop qc-fail/dup/unmapped/
    # secondary/supplementary
    flag = batch.flag
    keep = (flag & (0x4 | 0x100 | 0x200 | 0x400 | 0x800)) == 0
    pos = batch.pos[keep]
    if len(pos) == 0:
        return 0.0
    rsize = (batch.seq_off[1:] - batch.seq_off[:-1])[keep]
    n_cells = (chrom_len + 2 * cell_size) // cell_size + 1
    cells = np.zeros(n_cells, dtype=np.int64)
    # range-add [pos, pos+rsize) per read, accumulated per cell via a
    # per-position diff array folded into cells
    diff = np.zeros(n_cells * cell_size + 1, dtype=np.int64)
    np.add.at(diff, np.minimum(pos, n_cells * cell_size), 1)
    np.add.at(diff, np.minimum(pos + rsize, n_cells * cell_size), -1)
    perpos = np.cumsum(diff[:-1])
    cells = perpos.reshape(n_cells, cell_size).sum(axis=1)
    lo, hi = int(pos.min()), int(pos.max())
    obs_cells = np.arange(lo, hi + 1) // cell_size
    vals = (cells[obs_cells] + cell_size // 2) // cell_size
    vals = vals[vals > 0]
    if len(vals) == 0:
        return 0.0
    # MedianDepthTracker::getMedian with zero removal: when exactly
    # half the nonzero observations lie below the crossing value, the
    # median is the midpoint of the straddling values
    counts = np.bincount(vals.astype(np.int64))
    ztotal = len(vals) + 1
    s = 0
    last_before = 0
    first_after = 0
    for v in range(1, len(counts)):
        c = int(counts[v])
        if c == 0:
            continue
        s += c * 2
        if s >= ztotal:
            first_after = v
            if (ztotal + c * 2) != (s + 1):
                last_before = first_after
            break
        last_before = v
    if last_before == first_after:
        return float(last_before)
    return (last_before + first_after) / 2.0
