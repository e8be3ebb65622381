"""The yardstick of the rooflines: the card's published peaks and the
work each device entry's inputs need.

Copied from ``chip_smoke.py`` (``HBM_BYTES_PER_S`` .. ``F64_OPS_PER_S``,
``k1_bytes``, ``kgh_bytes``, the KS-G bytes of
``phase_somatic_main_shape`` and the per-row operation counts
``KGH_F64_PER_ROW``, ``KSG_F64_PER_ROW``, ``KSP_F64_PER_ROW``,
``KSP_F32_PER_ROW``), counted here on a call's live extents and not on
its launched, bucket-padded shapes: each live input byte is read once
and each live output byte written once, and the operations are those
of the unpadded problem. Where an operation count depends on more of
the data (KG-H's and KS-G's live (qscore, base) slots) only the part
counted here is, so the bound, and the share, is a lower bound there.
On a card the counts are taken on the benchmark's own stream
(core/instrument.py).
"""
from __future__ import annotations

import subprocess

# NVIDIA H100 SXM data sheet, dense, at its 700 W power limit; each
# run reports the card's own limit beside them (card())
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
F32_OPS_PER_S = 67e12
F64_OPS_PER_S = 34e12

KGH_F64_PER_ROW = 2 * (10 + 10 + 10 + 10 + 18 + 2) + 20
KSG_F64_PER_ROW = 9 * 5
KSP_F64_PER_ROW = 2 * (7 * 441 + 21) + 40
KSP_F32_PER_ROW = 6 * 441 * 2 + 441 + 42


def bound_ms(nbytes=0, int8_ops=0, f32_ops=0, f64_ops=0) -> float:
    """The least time the card could take: the larger of the bytes over
    HBM's rate and the operations over their engines' peaks."""
    tb = nbytes / HBM_BYTES_PER_S
    to = (int8_ops / INT8_OPS_PER_S + f32_ops / F32_OPS_PER_S
          + f64_ops / F64_OPS_PER_S)
    return max(tb, to) * 1e3


def _f64(x):
    import torch
    return x.to(torch.float64)


def k1_work(codes, delta, lnmis, win_t, mode="exact") -> dict:
    """K1 on its live extents: a read base is live where its code is a
    base (0..3; padding and N are 4), a read where it has a live base,
    an offset where its window column holds a base. Bytes: 5 a live base
    (code and delta), 12 a live read (lnmis in, best and offset out),
    and a pair's live window rows times its live offsets; operations: 2
    int8 compare-adds a live base and live offset of its pair."""
    live = codes < 4                                        # [B, R, L]
    nb = _f64(live.sum((1, 2)))                             # [B]
    reads = _f64(live.any(2).sum())
    rows = _f64(live.any(1).sum(1))                         # [B]
    offs = _f64((win_t < 4).any(1).sum(1))                  # [B]
    return {"nbytes": 5 * nb.sum() + 12 * reads + (rows * offs).sum(),
            "int8_ops": 2 * (nb * offs).sum()}


def kgh_lanes_work(base_id, qual, mask, ref_gt, is_haploid=None,
                   theta=0.001, s_mis=None) -> dict:
    """KG-H's lanes entry on its live rows (a used call, mask set) and
    lanes: each live lane's base, qual and mask read once, a live row's
    ref_gt, is_haploid and s_mis read and its 108 bytes of outputs
    written once, the tables; the float64 tail and the 80 f32 operations
    a live row (the live slots' products are not counted)."""
    m = mask != 0
    lanes = _f64(m.sum())
    rows = _f64(m.any(1).sum())
    lane = (base_id.element_size() + qual.element_size()
            + mask.element_size())
    nbytes = (lanes * lane + rows * (4 + 1 + 16 + 40 + 20 + 40 + 8)
              + 512 * 10 * 4 + 4 * 10 * 4 + 4 * 5 * 10 * 8)
    return {"nbytes": nbytes, "f32_ops": 80 * rows,
            "f64_ops": KGH_F64_PER_ROW * rows}


def ksg_work(base_id, qual, mask, is_fwd, ref_gt) -> dict:
    """KS-G on its live rows and lanes: each live lane's base, qual,
    mask and strand read once, a live row's ref_gt read and its 30 f32
    lhoods written once, the tables; 2 x 21 f32 operations a live lane
    (its 9 x 2 strand terms a live slot are not counted) and the strand
    logaddexps in float64."""
    m = mask != 0
    lanes = _f64(m.sum())
    rows = _f64(m.any(1).sum())
    nbytes = (lanes * (base_id.element_size() + qual.element_size() + 2)
              + rows * (ref_gt.element_size() + 30 * 4) + 128 * 78 * 4)
    return {"nbytes": nbytes, "f32_ops": 2 * 21 * lanes,
            "f64_ops": KSG_F64_PER_ROW * rows}


def ksp_work(normal_lhood, tumor_lhood, *a, **k) -> dict:
    """KS-P: every row is a site (no padding): two rows of 30 lhoods in,
    six outputs out, the prior tables; its sums in f32 and its
    logsumexps in float64."""
    L = normal_lhood.shape[0]
    nbytes = L * (2 * 30 * 4 + 6 * 4) + 6 * 441 * 4 + 6 * 4 + 21 * 4 \
        + 441 * 8
    return {"nbytes": nbytes, "f32_ops": KSP_F32_PER_ROW * L,
            "f64_ops": KSP_F64_PER_ROW * L}


# an entry's work from its call's arguments
WORK = {"k1": k1_work, "snv_tiles": kgh_lanes_work,
        "somatic_grid": ksg_work, "somatic_posterior": ksp_work}


def card() -> dict:
    """The card's name and power limit by nvidia-smi (empty where it
    cannot be read)."""
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return {}
    line = r.stdout.strip().splitlines()[0] if r.stdout.strip() else ""
    if "," not in line:
        return {}
    name, limit = (x.strip() for x in line.split(",", 1))
    return {"name": name, "power_limit": limit}
