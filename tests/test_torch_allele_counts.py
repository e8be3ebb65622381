"""The port's allele counting (strelka_tpu_torch/pipeline/allele_counts.py)
against the JAX package's on the dryrun dataset (benchmarks/synth.py, as
tests/test_torch_germline_e2e.py makes it): STR context tracks, the
per-context indel observation counts and the basecall patterns, whole
and per segment, are equal (integers, or f64 copies of integers); the
counts files round-trip through save, load and merge, with equal arrays
across the two packages.
"""
import numpy as np
import pytest

from benchmarks import synth as jsynth
from strelka_tpu.io.fasta import encode_bases as jencode
from strelka_tpu.pipeline import allele_counts as jac
from strelka_tpu.pipeline import reads as jrd
from strelka_tpu_torch import synth as tsynth
from strelka_tpu_torch.io.fasta import encode_bases as tencode
from strelka_tpu_torch.pipeline import allele_counts as tac
from strelka_tpu_torch.pipeline import reads as trd
from tests.test_torch_germline_e2e import DRYRUN

SEGMENTS = [(0, 60_000), (0, 20_000), (20_000, 41_000), (41_000, 60_000)]


@pytest.fixture(scope="module")
def dryrun():
    refs, jbatch, _ = jsynth.generate(**DRYRUN)
    _, tbatch, _ = tsynth.generate(**DRYRUN)
    out = {}
    for name, batch, rd, enc in (("jax", jbatch, jrd, jencode),
                                 ("torch", tbatch, trd, tencode)):
        keep, level = rd.filter_and_classify_reads(batch, 20)
        bk = batch.select(keep)
        out[name] = (bk, rd.expand_alignments(bk), level[keep], enc(refs))
    return out


def counts_equal(a, b):
    assert list(a) == list(b)
    for key in a:
        for f in ("ref_obs", "alt_obs", "instance_count"):
            x, y = getattr(a[key], f), getattr(b[key], f)
            np.testing.assert_array_equal(x, y, err_msg=f"{key} {f}")
            assert x.dtype == y.dtype


def test_str_context_tracks_equal():
    rng = np.random.default_rng(0)
    seqs = ["CGTAAAAAGTACACACGT", "A" * 40, "AC" * 15 + "N" + "AC" * 6,
            "".join(rng.choice(list("ACGT"), 3000)),
            "".join(rng.choice(list("AC"), 2000)), "AAN", "", "A"]
    for s in seqs:
        j, t = jac.str_context_tracks(jencode(s)), tac.str_context_tracks(
            tencode(s))
        assert list(j) == list(t) == [1, 2]
        for ps in j:
            np.testing.assert_array_equal(t[ps], j[ps])


@pytest.mark.parametrize("seg", SEGMENTS)
def test_collect_context_counts_equal(dryrun, seg):
    beg, end = seg
    j = jac.collect_context_counts(*dryrun["jax"][:3], dryrun["jax"][3][beg:end],
                                   beg, beg, end)
    t = tac.collect_context_counts(*dryrun["torch"][:3],
                                   dryrun["torch"][3][beg:end], beg, beg, end)
    assert len(t) >= 10
    counts_equal(t, j)


@pytest.mark.parametrize("seg", SEGMENTS[:2])
def test_collect_basecall_counts_equal(dryrun, seg):
    beg, end = seg
    jb, _, jl, jref = dryrun["jax"]
    tb, _, tl, tref = dryrun["torch"]
    j = jac.collect_basecall_counts(jb, jl, jref, 0, beg, end)
    t = tac.collect_basecall_counts(tb, tl, tref, 0, beg, end, device="cpu")
    np.testing.assert_array_equal(t.qual_levels, j.qual_levels)
    for f in ("ref_qual_hist", "ref_count", "alt_count", "inst"):
        x = getattr(t, f)
        assert x.device.type == "cpu" and str(x.dtype) == "torch.float64"
        np.testing.assert_array_equal(x.numpy(), np.asarray(getattr(j, f)),
                                      err_msg=f)
    assert float(x.sum()) > 1000


def test_basecall_counts_of_no_reads_is_none(dryrun):
    tb, _, tl, tref = dryrun["torch"]
    none = tb.select(np.zeros(tb.n, bool))
    assert tac.collect_basecall_counts(none, tl[:0], tref, 0, 0, 100,
                                       device="cpu") is None


def test_save_load_merge_round_trip(dryrun, tmp_path):
    """Each package saves its segment counts; each loads both files;
    the merged counts (of the segments, and of the loaded files) equal
    the JAX package's; the saved npz arrays are equal."""
    segs = {name: [] for name in ("jax", "torch")}
    for beg, end in SEGMENTS[1:]:
        for name, mod in (("jax", jac), ("torch", tac)):
            b, ea, lvl, ref = dryrun[name]
            segs[name].append(mod.collect_context_counts(
                b, ea, lvl, ref[beg:end], beg, beg, end))
    paths = {}
    for name, mod in (("jax", jac), ("torch", tac)):
        for i, cc in enumerate(segs[name]):
            p = str(tmp_path / f"{name}{i}.npz")
            mod.save_context_counts(p, cc)
            paths.setdefault(name, []).append(p)
    for pj, pt in zip(paths["jax"], paths["torch"]):
        with np.load(pj) as a, np.load(pt) as b:
            assert a.files == b.files
            for k in a.files:
                np.testing.assert_array_equal(b[k], a[k], err_msg=k)
        counts_equal(tac.load_context_counts(pj),
                     jac.load_context_counts(pj))
        counts_equal(tac.load_context_counts(pt),
                     jac.load_context_counts(pt))
    want = jac.merge_context_counts(segs["jax"])
    counts_equal(tac.merge_context_counts(segs["torch"]), want)
    counts_equal(tac.merge_context_counts(
        [tac.load_context_counts(p) for p in paths["torch"]]), want)
    mj, mt = str(tmp_path / "mj.npz"), str(tmp_path / "mt.npz")
    jac.save_context_counts(mj, want)
    tac.save_context_counts(mt, tac.merge_context_counts(segs["torch"]))
    with np.load(mj) as a, np.load(mt) as b:
        assert a.files == b.files
        for k in a.files:
            np.testing.assert_array_equal(b[k], a[k], err_msg=k)
