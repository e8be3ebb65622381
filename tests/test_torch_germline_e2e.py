"""The port's germline CLI (python -m strelka_tpu_torch germline
--device cpu) against the JAX package's on the dryrun dataset
(__graft_entry__.py: 60 kb contig, 25x, SNVs every 700 bp, indels every
1000 bp, seed 11), in WGS mode and with --exome.

variants.vcf.gz and genome.S1.vcf.gz must be byte-identical after
dropping the volatile header lines (##fileDate, ##startTime, ##cmdline)
and the program-name lines (##source, ##source_version, ##content).
"""
import gzip
import os

import numpy as np
import pytest

from benchmarks import synth as jsynth
from strelka_tpu.io.bam import BamHeader
from strelka_tpu.io.bam_writer import write_bam
from strelka_tpu.workflow.germline import run_germline as jax_germline
from strelka_tpu_torch import synth as tsynth
from strelka_tpu_torch.__main__ import main as torch_main

DROP = ("##fileDate", "##startTime", "##cmdline", "##source",
        "##source_version", "##content")
OUTPUTS = ("variants.vcf.gz", "genome.S1.vcf.gz")
DRYRUN = dict(L=60_000, depth=25, snv_every=700, indel_every=1000, seed=11)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    d = tmp_path_factory.mktemp("dryrun")
    refs, batch, _ = jsynth.generate(**DRYRUN)
    fa = d / "ref.fa"
    fa.write_text(">syn\n" + refs + "\n")
    bam = d / "s.bam"
    write_bam(str(bam), BamHeader(text="", ref_names=["syn"],
                                  ref_lengths=[len(refs)]), batch)
    return d, str(fa), str(bam)


def _lines(out, name):
    with gzip.open(os.path.join(out, name), "rt") as f:
        return [l for l in f if not l.startswith(DROP)]


@pytest.mark.parametrize("mode", ["wgs", "exome"])
def test_outputs_byte_identical_to_jax(dataset, mode):
    d, fa, bam = dataset
    extra = ["--exome"] if mode == "exome" else []
    jout, tout = str(d / f"jax_{mode}"), str(d / f"torch_{mode}")
    assert jax_germline(["--reference", fa, "--align-file", bam,
                         "--output-dir", jout, *extra]) in (0, None)
    assert torch_main(["germline", "--reference", fa, "--align-file", bam,
                       "--output-dir", tout, "--device", "cpu",
                       *extra]) == 0
    n_var = 0
    for name in OUTPUTS:
        a, b = _lines(jout, name), _lines(tout, name)
        assert a == b, name
        if name == "variants.vcf.gz":
            n_var = sum(not l.startswith("#") for l in a)
    assert n_var > 20


def test_synth_copy_matches_benchmarks_synth():
    ra, ba, ta = jsynth.generate(**DRYRUN)
    rb, bb, tb = tsynth.generate(**DRYRUN)
    assert ra == rb
    assert ta == tb
    assert ba.n == bb.n and ba.names == bb.names
    for f in ("tid", "pos", "mapq", "flag", "mate_tid", "mate_pos", "tlen",
              "seq", "qual", "seq_off", "cig_ops", "cig_lens", "cig_off"):
        np.testing.assert_array_equal(getattr(ba, f), getattr(bb, f),
                                      err_msg=f)


def _exit_code(main, argv):
    try:
        return main(argv)
    except SystemExit as e:
        return e.code


@pytest.mark.parametrize("argv", [["denovo"], ["noise-extractor"],
                                  ["no-such-command"], ["tools"]],
                         ids=["denovo", "noise-extractor", "unknown",
                              "tools"])
def test_unported_subcommands_exit_2(argv, capsys):
    """Once the last two subcommands (denovo, noise-extractor) were
    ported, no subcommand is left unported: each of them with no
    arguments, and an unknown command, exits as strelka_tpu's main does
    (2, from argparse or the dispatcher); tools with no tool prints the
    list and exits 2, as the JAX package's does."""
    from strelka_tpu.__main__ import main as jax_main
    want = _exit_code(jax_main, argv)
    capsys.readouterr()
    assert _exit_code(torch_main, argv) == want == 2
    if argv == ["tools"]:
        assert "estimate-parameters" in capsys.readouterr().err
