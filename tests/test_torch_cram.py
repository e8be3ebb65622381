"""The port's CRAM reader (strelka_tpu_torch/io/cram.py) against the JAX
package's, record for record, on the fixtures of tests/data/cram/
(reference-compressed, no-ref with and without the reference, embedded
reference; whole-file, through read_alignments, and by .crai region),
and the port's germline CLI on synth.cram against the JAX package's on
the same file (byte-identical) and against the port's own run on
synth.bam (identical records). The repository has no CRAM writer: the
fixtures are the only CRAM input."""
import gzip
import os

import numpy as np
import pytest

from strelka_tpu.io import bam as jbam
from strelka_tpu.io import cram as jcram
from strelka_tpu.workflow.germline import run_germline as jax_germline
from strelka_tpu_torch.__main__ import main as torch_main
from strelka_tpu_torch.io import bam as tbam
from strelka_tpu_torch.io import cram as tcram

DATA = os.path.join(os.path.dirname(__file__), "data", "cram")
FA = os.path.join(DATA, "synth.fa")
FIELDS = ("tid", "pos", "mapq", "flag", "mate_tid", "mate_pos", "tlen",
          "seq", "qual", "seq_off", "cig_ops", "cig_lens", "cig_off")
DROP = ("##fileDate", "##startTime", "##cmdline", "##source",
        "##source_version", "##content")
OUTPUTS = ("variants.vcf.gz", "genome.S1.vcf.gz")


def _assert_same(a, b):
    (ha, ba), (hb, bb) = a, b
    assert ha.ref_names == hb.ref_names
    assert ha.ref_lengths == hb.ref_lengths
    assert ba.n == bb.n > 0
    assert ba.names == bb.names
    for f in FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(ba, f)),
                                      np.asarray(getattr(bb, f)), err_msg=f)


@pytest.mark.parametrize("cram, ref", [
    ("synth.cram", FA), ("synth.noref.cram", FA),
    ("synth.noref.cram", None), ("synth.embed.cram", FA),
    ("synth.embed.cram", None)])
def test_read_cram_matches_jax(cram, ref):
    path = os.path.join(DATA, cram)
    want = jcram.read_cram(path, ref)
    _assert_same(tcram.read_cram(path, ref), want)
    _assert_same(tbam.read_alignments(path, ref),
                 jbam.read_alignments(path, ref))
    # and the BAM of the same records
    _assert_same(tcram.read_cram(path, ref), tbam.read_bam(
        os.path.join(DATA, "synth.bam")))


@pytest.mark.parametrize("regions", [
    [("c1", 2000, 3000)],
    [("c1", 0, 100), ("c1", 7000, 8000)],
    [("c1", 0, 8000)],
    [("cX", 5, 10)],
])
def test_read_cram_regions_matches_jax(regions):
    path = os.path.join(DATA, "synth.cram")
    th, tb = tbam.read_alignments_regions(path, regions, FA)
    jh, jb = jcram.read_cram_regions(path, regions, FA)
    assert th.ref_names == jh.ref_names
    assert tb.names == jb.names
    for f in FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(tb, f)),
                                      np.asarray(getattr(jb, f)), err_msg=f)


def _lines(out, name):
    with gzip.open(os.path.join(out, name), "rt") as f:
        return [l for l in f if not l.startswith(DROP)]


def test_germline_cli_on_cram(tmp_path):
    cram = os.path.join(DATA, "synth.cram")
    jout, tout, bout = (str(tmp_path / n) for n in ("jax", "torch", "bam"))
    assert jax_germline(["--reference", FA, "--align-file", cram,
                         "--output-dir", jout]) in (0, None)
    for path, out in ((cram, tout),
                      (os.path.join(DATA, "synth.bam"), bout)):
        assert torch_main(["germline", "--reference", FA, "--align-file",
                           path, "--output-dir", out,
                           "--device", "cpu"]) == 0
    for name in OUTPUTS:
        a, b = _lines(jout, name), _lines(tout, name)
        assert a == b, name
        records = [l for l in b if not l.startswith("#")]
        assert records == [l for l in _lines(bout, name)
                           if not l.startswith("#")], name
    # the fixture's pairs are all improper (flag 0x2 unset), so no read
    # reaches tier 1 and the gVCF is one block over the contig
    assert len(records) >= 1
