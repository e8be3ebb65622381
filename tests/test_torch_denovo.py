"""The port's denovo subcommand (strelka_tpu_torch/workflow/denovo.py)
against the JAX package's (strelka_tpu/workflow/denovo.py): the
transmission matrix and the de novo posterior bit for bit (host float64
in both), and the CLI's outputs, identical once decompressed, and exit
codes, in per-sample gVCF mode on a synthetic trio that the port's
germline calls on the CPU and in multi-sample mode on its joint VCF.
"""
import gzip
import os

import numpy as np
import pytest

from strelka_tpu.workflow import denovo as jdn
from strelka_tpu_torch.__main__ import main as torch_main
from strelka_tpu_torch.workflow import denovo as tdn

TRIO = ("mother", "father", "proband")


@pytest.mark.parametrize("mu", [0.0, 1e-8, 1e-6, 1e-3, 0.25, 0.5])
def test_transmission_matrix_equal(mu):
    a, b = jdn.transmission_matrix(mu), tdn.transmission_matrix(mu)
    assert a.dtype == b.dtype and np.array_equal(a, b)
    np.testing.assert_allclose(b.sum(axis=2), 1.0)


def _random_pls(rng, n):
    """[n, 3] PL triplets: random phreds, exact zeros, huge PLs (whose
    likelihoods underflow to 0) and all-zero rows."""
    pl = rng.integers(0, 300, (n, 3))
    pl[rng.random((n, 3)) < 0.3] = 0
    big = rng.random((n, 3)) < 0.05
    pl[big] = rng.integers(3000, 100_000, big.sum())
    pl[rng.random(n) < 0.02] = 0
    return pl


@pytest.mark.parametrize("theta,mu", [(0.001, 1e-8), (0.01, 1e-6)])
def test_denovo_posterior_bit_for_bit(theta, mu):
    rng = np.random.default_rng(0)
    c, m, f = (_random_pls(rng, 10_000) for _ in range(3))
    # the corners: a confident de novo, all-zero trios, huge-PL parents
    c[:3] = [[200, 0, 200], [0, 0, 0], [200, 0, 200]]
    m[:3] = [[0, 200, 400], [0, 0, 0], [0, 99_999, 99_999]]
    f[:3] = [[0, 200, 400], [0, 0, 0], [99_999, 99_999, 0]]
    a = jdn.denovo_posterior(c, m, f, theta=theta, mu=mu)
    b = tdn.denovo_posterior(c, m, f, theta=theta, mu=mu)
    assert a.dtype == b.dtype == np.float64
    assert np.array_equal(a, b)
    tiny = np.finfo(np.float64).tiny
    dq = np.minimum(np.round(-10 * np.log10(np.maximum(1 - b, tiny))), 999)
    assert np.isfinite(b).all() and dq[0] >= 20


@pytest.fixture(scope="module")
def trio(tmp_path_factory):
    """Three samples of one 60 kb contig (ref_seed 11: one reference and
    one planted het set), the parents at 60x from seeds 31 and 32 (deep
    enough that their hom-ref blocks' GQX outweighs a het parent), the
    proband at 25x from seed 33 with private het SNVs (synth's somatic
    SNVs at VAF 0.5); each called by the port's germline on the CPU,
    and the three jointly."""
    from strelka_tpu_torch import synth
    from strelka_tpu_torch.io.bam import BamHeader
    from strelka_tpu_torch.io.bam_writer import write_bam
    d = tmp_path_factory.mktemp("trio")
    bams = []
    for name, kw in zip(TRIO, (dict(seed=31, depth=60),
                               dict(seed=32, depth=60),
                               dict(seed=33, depth=25, somatic_every=4000,
                                    somatic_vaf=0.5))):
        refs, batch, truth = synth.generate(
            L=60_000, snv_every=900, indel_every=1300, ref_seed=11, **kw)
        bam = str(d / f"{name}.bam")
        write_bam(bam, BamHeader(text="", ref_names=["syn"],
                                 ref_lengths=[len(refs)]), batch)
        bams.append(bam)
    fa = d / "ref.fa"
    fa.write_text(">syn\n" + refs + "\n")
    for name, bam in zip(TRIO, bams):
        assert torch_main(["germline", "--reference", str(fa),
                           "--align-file", bam, "--output-dir",
                           str(d / name), "--device", "cpu"]) == 0
    joint = ["germline", "--reference", str(fa), "--output-dir",
             str(d / "joint"), "--device", "cpu"]
    for bam in bams:
        joint += ["--align-file", bam]
    assert torch_main(joint) == 0
    return d, truth["som_snv"]


def _run(pkg_main, argv):
    """The exit code of a CLI call, argparse's exits included."""
    try:
        return pkg_main(argv)
    except SystemExit as e:
        return e.code


def _text(path):
    with gzip.open(path, "rt") as f:
        return f.read()


def _both(tmp_path, argv):
    """Both packages' denovo on argv (+ --output); (rc, outputs) each."""
    from strelka_tpu.__main__ import main as jax_main
    out = []
    for tag, fn in (("jax", jax_main), ("torch", torch_main)):
        path = str(tmp_path / f"{tag}.vcf.gz")
        rc = _run(fn, ["denovo", *argv, "--output", path])
        out.append((rc, _text(path) if os.path.exists(path) else None))
    return out


def _dq(text):
    recs = [l.split("\t") for l in text.splitlines()
            if not l.startswith("#")]
    return {int(r[1]): float(kv[3:]) for r in recs
            for kv in r[7].split(";") if kv.startswith("DQ=")}


@pytest.mark.parametrize("min_dq", [0.0, 20.0])
def test_per_sample_mode_equal(trio, tmp_path, min_dq):
    d, private = trio
    gv = {n: str(d / n / "genome.S1.vcf.gz") for n in TRIO}
    (jrc, jout), (trc, tout) = _both(tmp_path, [
        "--proband", gv["proband"], "--mother", gv["mother"],
        "--father", gv["father"], "--min-dq", str(min_dq)])
    assert jrc == trc == 0
    assert tout == jout
    dq = _dq(tout)
    assert max(dq.values()) >= 20
    # the proband's private SNVs are the high-DQ sites
    hits = [p + 1 for p in private if dq.get(p + 1, 0) >= 20]
    assert len(hits) >= len(private) // 2
    if min_dq:
        assert min(dq.values()) >= min_dq
    # every input record is kept, changed in INFO's DQ alone
    src = _text(gv["proband"]).splitlines()
    got = tout.splitlines()
    assert len(got) == len(src) + 1
    for a, b in zip([l for l in src if not l.startswith("#")],
                    [l for l in got if not l.startswith("#")]):
        if a != b:
            fa, fb = a.split("\t"), b.split("\t")
            assert fa[:7] == fb[:7] and fa[8:] == fb[8:]
            assert fb[7].startswith(fa[7]) or fb[7].startswith("DQ=")


@pytest.mark.parametrize("min_dq", [0.0, 15.0])
def test_multisample_mode_equal(trio, tmp_path, min_dq):
    d, _ = trio
    (jrc, jout), (trc, tout) = _both(tmp_path, [
        "--vcf", str(d / "joint" / "variants.vcf.gz"),
        "--proband-id", "proband", "--mother-id", "mother",
        "--father-id", "father", "--min-dq", str(min_dq)])
    assert jrc == trc == 0
    assert tout == jout
    assert _dq(tout)


def test_missing_sample_exits_1(trio, tmp_path, capfd):
    d, _ = trio
    (jrc, _), (trc, _) = _both(tmp_path, [
        "--vcf", str(d / "joint" / "variants.vcf.gz"),
        "--proband-id", "nobody", "--mother-id", "mother",
        "--father-id", "father"])
    assert jrc == trc == 1
    err = capfd.readouterr().err
    assert err.count("denovo: sample not in VCF") == 2


@pytest.mark.parametrize("argv", [[], ["--output", "x.vcf.gz"],
                                  ["--vcf", "x.vcf", "--output", "y"]])
def test_usage_errors_exit_like_jax(argv):
    from strelka_tpu.__main__ import main as jax_main
    assert _run(torch_main, ["denovo", *argv]) == _run(
        jax_main, ["denovo", *argv]) == 2
