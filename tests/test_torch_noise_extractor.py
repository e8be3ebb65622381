"""The port's noise-extractor subcommand
(strelka_tpu_torch/workflow/noise_extractor.py) against the JAX
package's (strelka_tpu/workflow/noise_extractor.py): the panel VCF of
two synthetic 30x normals on a 200 kb contig identical once decompressed,
with --min-noise-count 2 and with a BAM that lacks the contig (its
columns '.:.'), the same exit codes, and the port's somatic run on the
port's panel equal, record for record, to the JAX package's somatic run
on its own panel.
"""
import gzip
import os

import pytest
import torch

from strelka_tpu.__main__ import main as jax_main
from strelka_tpu_torch.__main__ import main as torch_main

L = 200_000
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
def panel_inputs(tmp_path_factory):
    """The reference (ref_seed 11) and two normals at 30x from seeds 41
    and 42 (synth's 0.15% basecall errors are the noise), plus a BAM
    whose header names another contig."""
    from strelka_tpu_torch import synth
    from strelka_tpu_torch.io.bam import BamHeader
    from strelka_tpu_torch.io.bam_writer import write_bam
    d = tmp_path_factory.mktemp("panel")
    bams = []
    for i in range(2):
        refs, batch, _ = synth.generate(L=L, depth=30, snv_every=1000,
                                        indel_every=1500, ref_seed=11,
                                        seed=41 + i)
        bam = str(d / f"normal{i + 1}.bam")
        write_bam(bam, BamHeader(text="", ref_names=["syn"],
                                 ref_lengths=[len(refs)]), batch)
        bams.append(bam)
    other = str(d / "other_contig.bam")
    write_bam(other, BamHeader(text="", ref_names=["other"],
                               ref_lengths=[len(refs)]), batch)
    fa = d / "ref.fa"
    fa.write_text(">syn\n" + refs + "\n")
    return d, str(fa), bams, other


def _run(pkg_main, argv):
    try:
        return pkg_main(argv)
    except SystemExit as e:
        return e.code


def _text(path):
    with gzip.open(path, "rt") as f:
        return f.read()


def _panels(d, fa, bams, tag, extra=()):
    """Both packages' panel from `bams`: (jax path, torch path)."""
    out = []
    for pkg, fn in (("jax", jax_main), ("torch", torch_main)):
        path = str(d / f"{tag}_{pkg}.vcf.gz")
        argv = ["noise-extractor", "--reference", fa, "--output", path,
                *extra]
        for b in bams:
            argv += ["--align-file", b]
        assert _run(fn, argv) == 0
        out.append(path)
    return out


def _records(text):
    return [l.split("\t") for l in text.splitlines() if not l.startswith("#")]


@pytest.fixture(scope="module")
def panel2(panel_inputs):
    """Both packages' default panel of the two normals."""
    d, fa, bams, _ = panel_inputs
    return _panels(d, fa, bams, "p2")


@pytest.mark.parametrize("extra", [[], ["--min-noise-count", "2"]])
def test_panel_identical_to_jax(panel_inputs, panel2, extra):
    d, fa, bams, _ = panel_inputs
    n = len(bams)
    jp, tp = _panels(d, fa, bams, "p2_min2", extra) if extra else panel2
    a, b = _text(jp), _text(tp)
    assert a == b
    recs = _records(b)
    assert len(recs) > 100
    names = b.splitlines()[6].split("\t")[9:]
    assert names == [f"normal{i + 1}" for i in range(n)]
    for r in recs:
        assert r[8] == "DP:AD" and len(r) == 9 + n
        live = [c for c in r[9:] if c != ".:."]
        assert len(live) >= (2 if extra else 1)
        for c in live:
            dp, ad = c.split(":")
            ref_c, alt_c = map(int, ad.split(","))
            assert int(dp) >= 12 and 1 <= alt_c <= 0.2 * int(dp)


def test_bam_without_the_contig_gives_empty_columns(panel_inputs):
    d, fa, bams, other = panel_inputs
    jp, tp = _panels(d, fa, [bams[0], other], "other")
    a, b = _text(jp), _text(tp)
    assert a == b
    recs = _records(b)
    assert recs and all(r[10] == ".:." for r in recs)
    assert all(r[7].endswith(("PNOISE2=0.000", "PNOISE2=0.500"))
               for r in recs)


def test_usage_errors_exit_like_jax(tmp_path):
    for argv in ([], ["--reference", "x.fa"],
                 ["--reference", "x.fa", "--output", str(tmp_path / "o")]):
        assert _run(torch_main, ["noise-extractor", *argv]) == _run(
            jax_main, ["noise-extractor", *argv]) == 2


def test_somatic_with_port_panel_equals_jax(panel_inputs, panel2,
                                            monkeypatch):
    """Somatic T/N on the panel's reference (normal 30x, tumor 60x with
    somatic SNVs), over its first 40 kb: the port's run with the port's
    panel equals the JAX package's run with its own, record for record,
    and the panel annotates some records."""
    from strelka_tpu.models import evs as jevs
    from strelka_tpu_torch import synth
    from strelka_tpu_torch.io.bam import BamHeader
    from strelka_tpu_torch.io.bam_writer import write_bam
    from strelka_tpu_torch.models import evs as tevs
    d, fa, bams, _ = panel_inputs
    for mod in (jevs, tevs):
        for name in ("DEFAULT_SOMATIC_SNV_MODEL",
                     "DEFAULT_SOMATIC_INDEL_MODEL"):
            monkeypatch.setattr(mod, name, str(d / "absent.json"))
    jp, tp = panel2
    common = dict(L=L, snv_every=1000, indel_every=1500, ref_seed=11)
    _, normal, _ = synth.generate(depth=30, seed=51, **common)
    _, tumor, _ = synth.generate(depth=60, seed=52, somatic_every=1500,
                                 somatic_vaf=0.35, **common)
    hdr = BamHeader(text="", ref_names=["syn"], ref_lengths=[L])
    nbam, tbam = str(d / "som_n.bam"), str(d / "som_t.bam")
    write_bam(nbam, hdr, normal)
    write_bam(tbam, hdr, tumor)
    args = ["--reference", fa, "--normal-align-file", nbam,
            "--tumor-align-file", tbam, "--region", "syn:1-40000"]
    outs = {}
    for pkg, fn, panel, extra in (("jax", jax_main, jp, []),
                                  ("torch", torch_main, tp,
                                   ["--device", "cpu"]),
                                  ("bare", torch_main, None,
                                   ["--device", "cpu"])):
        out = str(d / f"somatic_{pkg}")
        noise = ["--noise-vcf", panel] if panel else []
        assert fn(["somatic", *args, "--output-dir", out, *noise,
                   *extra]) in (0, None)
        outs[pkg] = out
    moved = 0
    for name in ("somatic.snvs.vcf.gz", "somatic.indels.vcf.gz"):
        j, t, bare = (
            [l for l in _text(os.path.join(outs[k], name)).splitlines()
             if not l.startswith(DROP)] for k in ("jax", "torch", "bare"))
        assert t == j, name
        moved += sum(x != y for x, y in zip(_records("\n".join(t)),
                                            _records("\n".join(bare))))
    snvs = _records(_text(os.path.join(outs["torch"], "somatic.snvs.vcf.gz")))
    assert snvs and moved > 0
    assert any("PNOISE=" in r[7] for r in snvs)
