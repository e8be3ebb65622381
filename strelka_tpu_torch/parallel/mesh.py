"""Device-mesh sharding of the calling compute.

Replacement for the reference's process-level genome-segment
parallelism (reference: pyflow fan-out, strelkaSharedWorkflow.py:219-227,
workflowUtil.py:182-219). Locus/read tiles are sharded over a mesh of
local devices:

  axis 'dp' — data parallel over locus tiles (the analog of genome
              segments; each shard holds different active-region work)
  axis 'sp' — sequence parallel over the offset window of the
              read x haplotype scoring (the analog of splitting a long
              DP wavefront); the max over offsets crosses 'sp' shards
              and is combined on the host.

gVCF text emission stays on the host — only likelihood tensors live on
the mesh.

Port of strelka_tpu/parallel/mesh.py. The JAX package hands a
jax.sharding.Mesh to shard_map and XLA; here Mesh is a [dp, sp] grid of
torch.devices, and every shard is one launch on its own device (made
current for the launch), its inputs copied there, its outputs gathered
to the host after every shard has launched. Rows (positions, locus-hap
pairs) are independent and the scoring sums are exact, so a sharded
result is the unsharded one bit for bit. On the CPU a mesh repeats the
one CPU device: the shards then run one after another, which holds the
split and its combine without a card (the analog of the JAX tests'
virtual CPU devices).
"""
from __future__ import annotations

import re

import numpy as np
import torch

AXES = ("dp", "sp")


class Mesh:
    """A [dp, sp] grid of torch.devices with the axis names dp and sp.
    An entry may repeat: a mesh of one card repeated, or of the CPU,
    runs its shards one after another on that device."""

    axis_names = AXES

    def __init__(self, devices):
        rows = [list(r) for r in devices]
        if not rows or not rows[0] or len({len(r) for r in rows}) != 1:
            raise ValueError("a mesh is a non-empty [dp, sp] grid of "
                             "devices")
        arr = np.empty((len(rows), len(rows[0])), dtype=object)
        for i, r in enumerate(rows):
            for j, d in enumerate(r):
                arr[i, j] = torch.device(d)
        if len({d.type for d in arr.flat}) != 1:
            raise ValueError("a mesh's devices must be of one type")
        self.devices = arr

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(AXES, self.devices.shape))

    def flat(self) -> list[torch.device]:
        """The entries in dp-major order (the order of the rows a
        leading axis sharded over both axes gives them)."""
        return list(self.devices.flat)

    def __repr__(self):
        return (f"Mesh(dp={self.shape['dp']}, sp={self.shape['sp']}, "
                f"devices={[str(d) for d in self.devices.flat]})")


def make_mesh(devices=None, dp: int | None = None,
              sp: int | None = None) -> Mesh:
    """A mesh over `devices` (default: every local CUDA device). Without
    dp and sp it favours dp; sp gets a factor of 2 when the device count
    is even."""
    if devices is None:
        devices = local_devices("cuda")
    devices = [torch.device(d) for d in devices]
    n = len(devices)
    if dp is None or sp is None:
        sp = 2 if n % 2 == 0 and n > 1 else 1
        dp = n // sp
    if dp * sp != n:
        raise ValueError(f"dp={dp} x sp={sp} does not cover {n} devices")
    return Mesh([devices[i * sp:(i + 1) * sp] for i in range(dp)])


def local_devices(device=None, n: int | None = None) -> list[torch.device]:
    """The first `n` local devices of `device`'s type (None: every one):
    CUDA cards by index, or the CPU repeated `n` times (torch has one
    CPU device). Raises where more cards are asked for than are
    visible, and on cuda without a GPU."""
    from .. import device as devmod
    dev = devmod.check(device)
    if dev.type == "cpu":
        return [torch.device("cpu")] * (1 if n is None else n)
    count = torch.cuda.device_count()
    want = count if n is None else n
    if want > count:
        raise ValueError(f"the mesh asks for {want} CUDA devices but "
                         f"{count} {'is' if count == 1 else 'are'} visible")
    return [torch.device("cuda", i) for i in range(want)]


def _split(n: int, k: int) -> list[tuple[int, int]]:
    """[start, stop) of k contiguous parts of n rows, ceil(n/k) each but
    the last (parts past the end are dropped; at least one part)."""
    per = max(-(-n // k), 1)
    parts = [(s, min(s + per, n)) for s in range(0, n, per)]
    return parts or [(0, 0)]


def _on(dev):
    """The context in which a shard launches on `dev`: `dev` made the
    current CUDA device, so that the launch, its stream and the kernel's
    attributes are that card's."""
    if dev.type == "cuda":
        return torch.cuda.device(dev)
    import contextlib
    return contextlib.nullcontext()


def _score_and_reduce(delta, lnmis_sum, windows):
    """Core scoring product + offset reduction.

    delta [B, R, L4], windows [B, W, L4] (haplotype windows already
    gathered, offset axis W shardable), -> per-read best score [B, R]
    and full score matrix [B, R, W]. A plain f32 product (TF32 is off
    package-wide); its order of sums is the library's, not XLA's."""
    s = torch.einsum("brk,bwk->brw", delta, windows)
    s = s + lnmis_sum[..., None]
    return torch.max(s, dim=-1).values, s


def _region_step(snv_base, snv_qual, snv_fwd, snv_mask, snv_ref,
                 delta, lnmis_sum, windows):
    """One fused 'call step' on one device: batched SNV genotyping +
    read x haplotype scoring. This is the per-iteration device program
    of the engine (the analog of a framework's training step)."""
    from ..models import snv_digt
    tile = snv_digt.SnvPileupTile(
        base_id=snv_base, qual=snv_qual, is_fwd=snv_fwd,
        mask=snv_mask, ref_gt=snv_ref)
    snv_res = snv_digt.call_snv_tile(tile, theta=0.001)
    best, _ = _score_and_reduce(delta, lnmis_sum, windows)
    return snv_res.snv_qphred, snv_res.genome_max_gt, best


def make_sharded_call_step(mesh: Mesh):
    """The region call step sharded over `mesh`: the SNV tile rows,
    delta and lnmis split over dp (leading axis), the windows over dp
    and, on their offset axis W, over sp (each size a multiple of its
    factor, as shard_map asks). Part (i, 0) runs _region_step on device
    (i, 0); parts (i, j > 0) score their window slice on their own
    device; the best score is the max over the sp parts. Returns host
    tensors (snv_qphred [n], genome_max_gt [n], best [B, R])."""
    dp, sp = mesh.shape["dp"], mesh.shape["sp"]

    def step(snv_base, snv_qual, snv_fwd, snv_mask, snv_ref,
             delta, lnmis_sum, windows):
        snv = (snv_base, snv_qual, snv_fwd, snv_mask, snv_ref)
        n, B, W = snv_base.shape[0], delta.shape[0], windows.shape[1]
        for name, size, k in (("loci", n, dp), ("B", B, dp), ("W", W, sp)):
            if size % k:
                raise ValueError(f"{name}={size} is not a multiple of {k}")
        nl, bl, ws = n // dp, B // dp, W // sp
        launched = []
        for i in range(dp):
            rows, pairs = slice(i * nl, (i + 1) * nl), slice(i * bl,
                                                             (i + 1) * bl)
            for j in range(sp):
                dev = mesh.devices[i, j]
                score = (delta[pairs].to(dev), lnmis_sum[pairs].to(dev),
                         windows[pairs, j * ws:(j + 1) * ws].to(dev))
                with _on(dev):
                    if j == 0:
                        launched.append(_region_step(
                            *(t[rows].to(dev) for t in snv), *score))
                    else:
                        launched.append((None, None,
                                         _score_and_reduce(*score)[0]))
        qs, gts, best = [], [], []
        for i in range(dp):
            part = launched[i * sp:(i + 1) * sp]
            qs.append(part[0][0].cpu())
            gts.append(part[0][1].cpu())
            best.append(torch.stack([p[2].cpu() for p in part]).amax(dim=0))
        return torch.cat(qs), torch.cat(gts), torch.cat(best)

    return step


def example_region_inputs(n_loci=64, depth=32, n_tiles=8, reads=16,
                          read_l4=128 * 4, n_windows=64, rng_seed=0):
    """Tiny example inputs for compile checks (shapes divisible by
    typical mesh factors), host tensors drawn from a numpy seed as the
    JAX package draws them."""
    rng = np.random.default_rng(rng_seed)

    def t(a, dtype):
        return torch.from_numpy(np.asarray(a).astype(dtype))
    snv_base = t(rng.integers(0, 4, (n_loci, depth)), np.int32)
    snv_qual = t(rng.integers(10, 41, (n_loci, depth)), np.int32)
    snv_fwd = t(rng.random((n_loci, depth)) < 0.5, np.bool_)
    snv_mask = t(rng.random((n_loci, depth)) < 0.9, np.bool_)
    snv_ref = t(rng.integers(0, 4, n_loci), np.int32)
    delta = t(rng.normal(size=(n_tiles, reads, read_l4)), np.float32)
    lnmis = t(rng.normal(size=(n_tiles, reads)), np.float32)
    windows = t(rng.random((n_tiles, n_windows, read_l4)) < 0.25, np.float32)
    return (snv_base, snv_qual, snv_fwd, snv_mask, snv_ref,
            delta, lnmis, windows)


def dryrun(n_devices: int, device=None):
    """Run one sharded call step on a mesh of `n_devices` local devices
    of `device`'s type (default cuda; the CPU repeated on cpu). Returns
    its (snv_qphred, genome_max_gt, best) host tensors."""
    mesh = make_mesh(local_devices(device, n_devices))
    step = make_sharded_call_step(mesh)
    args = example_region_inputs(
        n_loci=max(8, n_devices) * 8, n_tiles=max(8, n_devices))
    q, gt, best = step(*args)
    assert q.shape[0] == args[0].shape[0]
    return q, gt, best


# --- engine mesh: opt-in multi-device sharding of the production call
# path (CLI --mesh). The fan-out default stays one device per process
# (the analog of the reference's one core per process); the engine mesh
# instead spreads each process's kernel launches over its local
# devices, dp-sharding the batch axis (no cross-shard collectives in
# the scoring kernel: offsets reduce within a shard).

_ENGINE_MESH: Mesh | None = None


def set_engine_mesh(mesh: Mesh | None) -> None:
    global _ENGINE_MESH
    _ENGINE_MESH = mesh


def engine_mesh() -> Mesh | None:
    return _ENGINE_MESH


def engine_mesh_from_spec(spec: str | None, device=None) -> Mesh | None:
    """--mesh parsing: "auto" = every local device of `device`'s type
    (dp only; one on the CPU), "N" = the first N, "DPxSP" = explicit
    factors. On cuda the entries are the first dp*sp cards, and a spec
    that asks for more than torch.cuda.device_count() raises (it never
    shrinks); on cpu they repeat the CPU. Raises ValueError on a
    malformed spec."""
    if not spec:
        return None
    if spec == "auto":
        devs = local_devices(device)
        return Mesh([[d] for d in devs])
    m = re.fullmatch(r"(\d+)(?:x(\d+))?", spec)
    if m is None:
        raise ValueError(f"expected auto, N or DPxSP, got {spec!r}")
    dp = int(m.group(1))
    sp = int(m.group(2)) if m.group(2) is not None else 1
    if dp < 1 or sp < 1:
        raise ValueError(f"the factors of {spec!r} must be at least 1")
    devs = local_devices(device, dp * sp)
    return Mesh([devs[i * sp:(i + 1) * sp] for i in range(dp)])


def chunk_sharder(device=None):
    """Row shards of fixed-shape position chunks: returns shards(start,
    stop) -> [(device, start_i, stop_i), ...]. With an engine mesh set,
    the rows [start, stop) are split in order over every mesh device
    (dp-major), ceil(n / devices) rows a shard; positions are
    independent, so each shard runs the genotyping/grid programs on its
    own device with no collectives and the caller concatenates the rows
    in order. Without a mesh it is one shard on `device`. There is
    always at least one shard (an empty range gives one empty shard)."""
    mesh = _ENGINE_MESH
    if mesh is None:
        return lambda start, stop: [(device, start, stop)]
    devs = mesh.flat()

    def shards(start, stop):
        return [(devs[k], start + a, start + b)
                for k, (a, b) in enumerate(_split(stop - start, len(devs)))]
    return shards


def sharded_best_offsets(kernel, mesh: Mesh):
    """Wrap a best-offsets kernel (codes, delta, lnmis, win_t) -> (best,
    off) to run sharded over `mesh`:

      dp — leading batch (locus-hap pair) axis, B a multiple of dp;
           pairs are independent, no collectives.
      sp — the offset axis of `win_t` [B, L, W], W a multiple of sp
           (sequence parallelism over the scoring wavefront): each sp
           shard scores a contiguous slice of offsets (its own
           contiguous copy), its offsets shifted by the slice's start
           in int32; the global best is the max over sp with argmax's
           first-occurrence tie-break (padding windows can tie the best
           real offset, and all-N reads tie everywhere at lnmis, so the
           combine keeps the LOWEST winning offset to match the
           unsharded first max bit for bit; the scores are exact sums,
           so the tie test is exact).

    Every shard is one call of `kernel` on its device, made current for
    the launch; a shard that fails raises. The outputs of every shard
    come to the host after all shards have launched. Returns host
    tensors (best [B,R] f32, off [B,R] int32)."""
    dp, sp = mesh.shape["dp"], mesh.shape["sp"]

    def fn(codes, delta, lnmis, win_t):
        B = codes.shape[0]
        W = win_t.shape[2]
        if B % dp:
            raise ValueError(f"B={B} is not a multiple of dp={dp}")
        if W % sp:
            raise ValueError(f"W={W} is not a multiple of sp={sp}")
        bl, ws = B // dp, W // sp
        launched = []
        for i in range(dp):
            rows = slice(i * bl, (i + 1) * bl)
            for j in range(sp):
                dev = mesh.devices[i, j]
                win = win_t[rows]
                if sp > 1:
                    win = win[:, :, j * ws:(j + 1) * ws].contiguous()
                # a blocking copy from the host: no host buffer is
                # read after it returns
                ops = (codes[rows].to(dev), delta[rows].to(dev),
                       lnmis[rows].to(dev), win.to(dev))
                with _on(dev):
                    launched.append(kernel(*ops))
        host = [(b.cpu(), o.cpu()) for b, o in launched]
        out_b, out_o = [], []
        for i in range(dp):
            part = host[i * sp:(i + 1) * sp]
            if sp == 1:
                out_b.append(part[0][0])
                out_o.append(part[0][1])
                continue
            bests = torch.stack([b for b, _ in part])          # [sp,bl,R]
            offs = torch.stack([o + j * ws            # stays int32
                                for j, (_, o) in enumerate(part)])
            gbest = bests.amax(dim=0)
            # the first slice that reaches the max holds the lowest
            # winning offset
            k = (bests == gbest[None]).to(torch.int8).argmax(dim=0)
            out_b.append(torch.gather(bests, 0, k[None])[0])
            out_o.append(torch.gather(offs, 0, k[None])[0])
        return torch.cat(out_b), torch.cat(out_o)

    return fn
