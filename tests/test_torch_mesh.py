"""The port's engine mesh (strelka_tpu_torch/parallel/mesh.py) against
the JAX package's (strelka_tpu/parallel/mesh.py) on the CPU: the JAX
side on the 8 virtual CPU devices of tests/conftest.py, the port's on a
mesh that repeats the CPU device (its shards run one after another, the
split and the combine are the same).

sharded_best_offsets is held bit for bit (scores and first-max offsets,
ties included): K1's sums are exact. _score_and_reduce and the call
step's best score are a plain f32 product whose order of sums differs
between torch and XLA, held to 1e-5 relative and 1e-5 absolute (the JAX
package's own test allows 1e-3); the call step's SNV fields are integers
and held equal. The mesh's SNV and somatic chunks, and the germline and
somatic CLIs with --mesh, give the unsharded results exactly.
"""
import gzip
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from strelka_tpu.ops import pallas_readlik as pk
from strelka_tpu.parallel import mesh as jm
from strelka_tpu_torch.ops import score_kernel as sk
from strelka_tpu_torch.parallel import mesh as tm

RTOL = ATOL = 1e-5
DROP = ("##fileDate", "##startTime", "##cmdline", "##source",
        "##source_version", "##content")


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread a test: the suite runs several test processes
    at once, and torch's CPU thread pool, oversubscribed, turns each of
    the many small ops of the sharded chunks into a wait (the results do
    not depend on the thread count)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_devices():
    devs = jax.devices()
    if len(devs) < 8:
        pytest.skip("needs 8 virtual devices")
    return devs


@pytest.fixture
def engine_mesh():
    """Install a spec's engine mesh for the test; none afterwards."""
    def install(spec):
        tm.set_engine_mesh(tm.engine_mesh_from_spec(spec, "cpu"))
    yield install
    tm.set_engine_mesh(None)


@pytest.mark.parametrize("n", [1, 2, 3, 4, 6, 8])
def test_make_mesh_shapes_match_jax(jax_devices, n):
    j = jm.make_mesh(jax_devices[:n])
    t = tm.make_mesh(["cpu"] * n)
    assert t.devices.shape == j.devices.shape
    assert t.shape == dict(j.shape)
    assert t.axis_names == tuple(j.axis_names) == ("dp", "sp")
    t2 = tm.make_mesh(["cpu"] * 8, dp=8, sp=1)
    assert t2.devices.shape == (8, 1)
    with pytest.raises(ValueError):
        tm.make_mesh(["cpu"] * 8, dp=3, sp=2)


def test_engine_mesh_from_spec_parsing(monkeypatch):
    assert tm.engine_mesh_from_spec(None, "cpu") is None
    assert tm.engine_mesh_from_spec("", "cpu") is None
    m = tm.engine_mesh_from_spec("auto", "cpu")
    assert m.shape == {"dp": 1, "sp": 1}
    m4 = tm.engine_mesh_from_spec("4", "cpu")
    assert m4.shape == {"dp": 4, "sp": 1}
    assert m4.flat() == [torch.device("cpu")] * 4
    m22 = tm.engine_mesh_from_spec("2x2", "cpu")
    assert m22.shape == {"dp": 2, "sp": 2}
    for bad in ("x2", "2x", "two", "0", "2x0", "-1"):
        with pytest.raises(ValueError):
            tm.engine_mesh_from_spec(bad, "cpu")
    # on cuda the entries are the first dp*sp cards, which must exist
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    m = tm.engine_mesh_from_spec("auto", "cuda")
    assert m.flat() == [torch.device("cuda", 0), torch.device("cuda", 1)]
    m = tm.engine_mesh_from_spec("1x2", "cuda")
    assert m.shape == {"dp": 1, "sp": 2}
    for spec in ("4", "2x2", "3"):
        with pytest.raises(ValueError, match="2 are visible"):
            tm.engine_mesh_from_spec(spec, "cuda")


def _tie_inputs():
    """tests/test_mesh.py's inputs: padding windows that tie real
    offsets, and all-N reads that tie everywhere at lnmis."""
    rng = np.random.default_rng(7)
    B, R, L, W = 8, 16, 32, 64
    codes = rng.integers(0, 5, (B, R, L)).astype(np.int8)
    delta = rng.uniform(0.5, 20, (B, R, L)).astype(np.float32)
    delta[codes >= 4] = 0.0
    lnmis = rng.normal(-50, 5, (B, R)).astype(np.float32)
    win = rng.integers(0, 5, (B, L, W)).astype(np.int8)
    win[:, :, W // 2:] = 4
    codes[:, :2] = 4
    delta[:, :2] = 0.0
    return codes, delta, lnmis, win


@pytest.mark.parametrize("dp,sp,n", [(4, 2, 8), (2, 2, 4), (1, 4, 4),
                                     (8, 1, 8), (2, 1, 2)])
def test_sharded_best_offsets_bit_identical_to_jax(jax_devices, dp, sp, n):
    arrs = _tie_inputs()
    ref_best, ref_off = pk.exact_best_offsets(*map(jnp.asarray, arrs))
    jfn = jm.sharded_best_offsets(
        pk.exact_best_offsets, jm.make_mesh(jax_devices[:n], dp=dp, sp=sp))
    jb, jo = jfn(*map(jnp.asarray, arrs))
    tfn = tm.sharded_best_offsets(
        sk.score_best_offsets, tm.make_mesh(["cpu"] * n, dp=dp, sp=sp))
    tb, to = tfn(*map(torch.from_numpy, arrs))
    assert tb.dtype == torch.float32 and to.dtype == torch.int32
    for want_b, want_o in ((ref_best, ref_off), (jb, jo)):
        assert np.array_equal(tb.numpy(), np.asarray(want_b)), (dp, sp)
        assert np.array_equal(to.numpy(), np.asarray(want_o)), (dp, sp)
    # the ties are there: all-N reads at offset 0, padding offsets tied
    assert (to.numpy()[:, :2] == 0).all()


def test_sharded_best_offsets_rejects_uneven_shapes():
    t = [torch.from_numpy(a) for a in _tie_inputs()]
    with pytest.raises(ValueError, match="multiple of dp"):
        tm.sharded_best_offsets(sk.score_best_offsets,
                                tm.make_mesh(["cpu"] * 3, dp=3, sp=1))(*t)
    with pytest.raises(ValueError, match="multiple of sp"):
        tm.sharded_best_offsets(sk.score_best_offsets,
                                tm.make_mesh(["cpu"] * 3, dp=1, sp=3))(*t)


def test_score_and_reduce_matches_jax():
    rng = np.random.default_rng(0)
    B, R, L4, W = 8, 16, 64, 32
    delta = rng.normal(size=(B, R, L4)).astype(np.float32)
    lnmis = rng.normal(size=(B, R)).astype(np.float32)
    win = rng.normal(size=(B, W, L4)).astype(np.float32)
    jb, js = jm._score_and_reduce(*map(jnp.asarray, (delta, lnmis, win)))
    tb, ts = tm._score_and_reduce(*map(torch.from_numpy,
                                       (delta, lnmis, win)))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("dp,sp", [(4, 2), (8, 1), (1, 1)])
def test_sharded_call_step_matches_jax(jax_devices, dp, sp):
    args = tm.example_region_inputs()
    jargs = jm.example_region_inputs()
    for a, b in zip(args, jargs):
        assert np.array_equal(a.numpy(), np.asarray(b))
    jmesh = jm.make_mesh(jax_devices[:dp * sp], dp=dp, sp=sp)
    with jmesh:
        jq, jgt, jbest = jm.make_sharded_call_step(jmesh)(*jargs)
    q, gt, best = tm.make_sharded_call_step(
        tm.make_mesh(["cpu"] * (dp * sp), dp=dp, sp=sp))(*args)
    assert np.array_equal(q.numpy(), np.asarray(jq))
    assert np.array_equal(gt.numpy(), np.asarray(jgt))
    np.testing.assert_allclose(best.numpy(), np.asarray(jbest), rtol=RTOL,
                               atol=ATOL)
    # sharding moves no bit of the port's own step
    one = tm.make_sharded_call_step(tm.make_mesh(["cpu"]))(*args)
    for a, b in zip((q, gt, best), one):
        assert torch.equal(a, b)


def test_dryrun_matches_jax(jax_devices):
    jm.dryrun(8)
    q, gt, best = tm.dryrun(8, "cpu")
    jargs = jm.example_region_inputs(n_loci=64, n_tiles=8)
    jmesh = jm.make_mesh(jax_devices)
    with jmesh:
        jq, jgt, jbest = jm.make_sharded_call_step(jmesh)(*jargs)
    assert np.array_equal(q.numpy(), np.asarray(jq))
    assert np.array_equal(gt.numpy(), np.asarray(jgt))
    np.testing.assert_allclose(best.numpy(), np.asarray(jbest), rtol=RTOL,
                               atol=ATOL)


def _snv_tile():
    from strelka_tpu_torch.models import snv_digt as sd
    rng = np.random.default_rng(3)
    L = sd.SNV_TILE_L * 2 + 1000  # 2 full chunks + partial tail
    D = 32
    ref = rng.integers(0, 4, L).astype(np.int32)
    base = np.broadcast_to(ref[:, None], (L, D)).astype(np.int8).copy()
    idx = rng.choice(L, 200, replace=False)
    base[idx, :10] = (ref[idx][:, None] + 1) % 4
    return sd.SnvPileupTile(
        base_id=base, qual=np.full((L, D), 35, np.int16),
        is_fwd=(rng.random((L, D)) < 0.5), mask=(rng.random((L, D)) < 0.7),
        ref_gt=ref)


def test_mesh_chunked_snv_identical(monkeypatch, engine_mesh):
    """call_snv_tile_chunked with each chunk's rows split over a 4-way
    mesh equals the unsharded torch tiles in every field, bit for bit
    (with a mesh the CPU runs the torch tiles, not the native tail, as
    the JAX package runs its XLA tiles; the unsharded run is made to
    take the same path)."""
    from strelka_tpu_torch.models import snv_digt as sd
    tile = _snv_tile()
    native = sd.call_snv_tile_chunked(tile, device="cpu")
    monkeypatch.setattr(sd, "_call_snv_tile_native", lambda *a, **k: None)
    plain = sd.call_snv_tile_chunked(tile, device="cpu")
    engine_mesh("4")
    sd.LAUNCH_STATS.clear()
    meshed = sd.call_snv_tile_chunked(tile, device="cpu")
    # 3 chunks, 4 shards each
    assert sum(v for k, v in sd.LAUNCH_STATS.items()
               if k[0] == "tile") == 12
    for f in ("lhood", "genome_max_gt", "poly_max_gt", "snv_qphred",
              "genome_max_gt_qphred", "poly_max_gt_qphred",
              "phred_loghood", "ln_ref_pprob", "strand_bias"):
        a, b = np.asarray(getattr(plain, f)), np.asarray(getattr(meshed, f))
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    for f in ("genome_max_gt", "poly_max_gt", "snv_qphred",
              "genome_max_gt_qphred", "poly_max_gt_qphred",
              "phred_loghood"):
        assert np.array_equal(np.asarray(getattr(native, f)),
                              np.asarray(getattr(meshed, f))), f


def test_mesh_somatic_chunks_identical(monkeypatch, engine_mesh):
    """The tier1 and tier2 somatic SNV chunks with each chunk's rows
    split over a 4-way mesh equal the unsharded ones, over two full
    chunks and a partial tail."""
    from strelka_tpu_torch.models import somatic_snv as ss
    from strelka_tpu_torch.pipeline import somatic_caller as sc
    rng = np.random.default_rng(5)
    L, D = 2500, 32

    def pileup(depth_alt):
        base = rng.integers(0, 4, (L, D)).astype(np.int8)
        base[:, depth_alt:] = 0
        return types.SimpleNamespace(
            base_id=base, qual=rng.integers(5, 41, (L, D)).astype(np.int16),
            is_fwd=rng.random((L, D)) < 0.5, valid=rng.random((L, D)) < 0.9,
            used=rng.random((L, D)) < 0.8, tier2_used=rng.random((L, D)) < 0.9)
    pus = [pileup(3), pileup(12)]
    ref_gt = np.zeros(L, np.int32)

    def run(nlh, tlh):
        return ss.somatic_snv_call_capped(nlh, tlh)
    monkeypatch.setattr(sc, "_tile_rows", lambda pus, dev: 1000)
    cpu = torch.device("cpu")
    rows = np.nonzero(rng.random(L) < 0.5)[0]
    plain = (sc._snv_tier1_fused(pus, ref_gt, run, cpu),
             sc._snv_tier2_rows(pus, ref_gt, rows, run, cpu))
    engine_mesh("2x2")
    meshed = (sc._snv_tier1_fused(pus, ref_gt, run, cpu),
              sc._snv_tier2_rows(pus, ref_gt, rows, run, cpu))
    for a, b in zip(plain, meshed):
        for f in ss.SomaticSnvResult._fields:
            x, y = getattr(a, f), getattr(b, f)
            assert x.dtype == y.dtype and np.array_equal(x, y), f
    assert (plain[0].qphred > 0).any()


def _lines(out, name):
    with gzip.open(os.path.join(out, name), "rt") as f:
        return [l for l in f if not l.startswith(DROP)]


def test_germline_cli_mesh_byte_identical(tmp_path, monkeypatch):
    """The port's germline --device cpu --mesh 4 on a 200 kb synthetic
    contig: byte-identical to its run without --mesh and to the JAX
    package's --mesh 4 run (tests/test_mesh.py's dataset)."""
    from benchmarks import synth
    from strelka_tpu.io.bam import BamHeader
    from strelka_tpu.io.bam_writer import write_bam
    from strelka_tpu.workflow.germline import run_germline
    from strelka_tpu_torch.__main__ import main as torch_main

    refs, batch, _ = synth.generate(L=200_000, depth=25, snv_every=800,
                                    indel_every=1100, seed=21)
    fa = tmp_path / "ref.fa"
    fa.write_text(">syn\n" + refs + "\n")
    bam = str(tmp_path / "s.bam")
    write_bam(bam, BamHeader(text="", ref_names=["syn"],
                             ref_lengths=[len(refs)]), batch)
    common = ["--reference", str(fa), "--align-file", bam, "--exome"]
    outs = {k: str(tmp_path / k) for k in ("jax", "plain", "mesh")}
    try:
        assert run_germline([*common, "--output-dir", outs["jax"],
                             "--mesh", "4"]) in (0, None)
    finally:
        jm.set_engine_mesh(None)
    assert torch_main(["germline", *common, "--output-dir", outs["plain"],
                       "--device", "cpu"]) == 0
    shards = []
    orig = tm.sharded_best_offsets

    def counted(kernel, mesh):
        shards.append(mesh.shape)
        return orig(kernel, mesh)
    monkeypatch.setattr(tm, "sharded_best_offsets", counted)
    assert torch_main(["germline", *common, "--output-dir", outs["mesh"],
                       "--device", "cpu", "--mesh", "4"]) == 0
    assert shards and all(c == {"dp": 4, "sp": 1} for c in shards)
    assert tm.engine_mesh() is None     # the CLI took its mesh down
    for name in ("variants.vcf.gz", "genome.S1.vcf.gz"):
        j, p, m = (_lines(outs[k], name) for k in ("jax", "plain", "mesh"))
        assert m == p, name
        assert m == j, name
    assert sum(not l.startswith("#")
               for l in _lines(outs["mesh"], "variants.vcf.gz")) > 100


def test_somatic_cli_mesh_byte_identical(tmp_path, monkeypatch):
    """The port's somatic --device cpu --mesh 2x2 on a 30 kb synthetic
    T/N contig (the dryrun T/N set's generator settings, cut to 30 kb):
    byte-identical to its run without --mesh and to the JAX package's
    --mesh 4 run."""
    from benchmarks import synth
    from strelka_tpu.io.bam import BamHeader
    from strelka_tpu.io.bam_writer import write_bam
    from strelka_tpu.models import evs as jevs
    from strelka_tpu.workflow.somatic import run_somatic
    from strelka_tpu_torch.__main__ import main as torch_main
    from strelka_tpu_torch.models import evs as tevs

    # both packages without a default EVS model (as
    # tests/test_torch_somatic_e2e.py pins them)
    for mod in (jevs, tevs):
        for name in ("DEFAULT_SOMATIC_SNV_MODEL",
                     "DEFAULT_SOMATIC_INDEL_MODEL"):
            monkeypatch.setattr(mod, name, str(tmp_path / "absent.json"))
    common = dict(L=30_000, snv_every=900, indel_every=1200, ref_seed=11)
    refs, normal, _ = synth.generate(depth=25, seed=21, **common)
    _, tumor, _ = synth.generate(depth=50, seed=22, somatic_every=1500,
                                 somatic_vaf=0.35, somatic_indel_every=2100,
                                 **common)
    fa = tmp_path / "ref.fa"
    fa.write_text(">syn\n" + refs + "\n")
    hdr = BamHeader(text="", ref_names=["syn"], ref_lengths=[len(refs)])
    nbam, tbam = str(tmp_path / "n.bam"), str(tmp_path / "t.bam")
    write_bam(nbam, hdr, normal)
    write_bam(tbam, hdr, tumor)
    args = ["--reference", str(fa), "--normal-align-file", nbam,
            "--tumor-align-file", tbam]
    outs = {k: str(tmp_path / k) for k in ("jax", "plain", "mesh")}
    try:
        assert run_somatic([*args, "--output-dir", outs["jax"], "--mesh",
                            "4"]) in (0, None)
    finally:
        jm.set_engine_mesh(None)
    for k, extra in (("plain", []), ("mesh", ["--mesh", "2x2"])):
        assert torch_main(["somatic", *args, "--output-dir", outs[k],
                           "--device", "cpu", *extra]) == 0
    for name in ("somatic.snvs.vcf.gz", "somatic.indels.vcf.gz"):
        j, p, m = (_lines(outs[k], name) for k in ("jax", "plain", "mesh"))
        assert m == p, name
        assert m == j, name
    assert sum(not l.startswith("#")
               for l in _lines(outs["mesh"], "somatic.snvs.vcf.gz")) > 10


def test_cli_mesh_spec_errors_exit_2(tmp_path, capsys):
    from strelka_tpu_torch.__main__ import main as torch_main
    rc = torch_main(["germline", "--reference", "x.fa", "--align-file",
                     "x.bam", "--output-dir", str(tmp_path), "--device",
                     "cpu", "--mesh", "2y2"])
    assert rc == 2
    assert "--mesh 2y2" in capsys.readouterr().err
    assert tm.engine_mesh() is None
