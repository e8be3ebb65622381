"""The germline --estimate-sequence-error pre-pass of the port
(python -m strelka_tpu_torch germline --device cpu) against the JAX
package's on the dryrun dataset (tests/test_torch_germline_e2e.py):

- sequenceAlleleCounts.Sample000.npz: the same arrays (the counts are
  integers, so equal);
- sequenceErrorModel.Sample000.json: the same keys, motifs and flags,
  the rates within FLAT_RTOL (tests/test_torch_error_fit.py: the fit
  keeps its least-loss step, and where the loss is flat an ulp picks
  another step);
- variants.vcf.gz and genome.S1.vcf.gz byte-identical after the
  volatile header lines are dropped;
- and, given the JAX package's model JSON through
  --indel-error-models-file, the port's VCFs byte-identical to the JAX
  package's estimated run.
"""
import json
import os

import numpy as np
import pytest

from strelka_tpu.workflow.germline import run_germline as jax_germline
from strelka_tpu_torch.__main__ import main as torch_main
from tests.test_torch_error_fit import FLAT_RTOL
from tests.test_torch_germline_e2e import DROP, OUTPUTS, dataset  # noqa: F401
from tests.test_torch_rna_e2e import lines

COUNTS = "sequenceAlleleCounts.Sample000.npz"
MODEL = "sequenceErrorModel.Sample000.json"


@pytest.fixture(scope="module")
def estimated(dataset):
    d, fa, bam = dataset
    jout, tout = str(d / "jax_est"), str(d / "torch_est")
    assert jax_germline(["--reference", fa, "--align-file", bam,
                         "--output-dir", jout,
                         "--estimate-sequence-error"]) in (0, None)
    assert torch_main(["germline", "--reference", fa, "--align-file", bam,
                       "--output-dir", tout, "--device", "cpu",
                       "--estimate-sequence-error"]) == 0
    return jout, tout


def test_counts_npz_arrays_equal(estimated):
    jout, tout = estimated
    with np.load(os.path.join(jout, COUNTS)) as a, \
            np.load(os.path.join(tout, COUNTS)) as b:
        assert sorted(a.files) == sorted(b.files)
        assert len(a.files) >= 3 * 10        # ref/alt/n of each context
        for k in a.files:
            np.testing.assert_array_equal(b[k], a[k], err_msg=k)
            assert b[k].dtype == a[k].dtype, k


def test_model_json_matches(estimated):
    jout, tout = estimated
    with open(os.path.join(jout, MODEL)) as f:
        want = json.load(f)
    with open(os.path.join(tout, MODEL)) as f:
        got = json.load(f)
    (ws,), (gs,) = want["sample"], got["sample"]
    assert list(gs) == list(ws)
    assert (gs["sampleName"], gs["isStatic"]) == (ws["sampleName"],
                                                  ws["isStatic"])
    assert len(gs["motif"]) == len(ws["motif"]) == 25
    for gm, wm in zip(gs["motif"], ws["motif"]):
        assert list(gm) == list(wm)
        assert (gm["repeatPatternSize"], gm["repeatCount"]) == \
            (wm["repeatPatternSize"], wm["repeatCount"])
        for f in ("indelRate", "noisyLocusRate"):
            assert gm[f] == pytest.approx(wm[f], rel=FLAT_RTOL, abs=0), f


def test_estimated_vcfs_byte_identical(estimated):
    jout, tout = estimated
    n_var = 0
    for name in OUTPUTS:
        a, b = lines(jout, name), lines(tout, name)
        assert a == b, name
        n_var += sum(not l.startswith("#") for l in a)
    assert n_var > 20


def test_jax_model_json_gives_identical_vcfs(dataset, estimated):
    d, fa, bam = dataset
    jout, _ = estimated
    tout = str(d / "torch_jaxmodel")
    assert torch_main(["germline", "--reference", fa, "--align-file", bam,
                       "--output-dir", tout, "--device", "cpu",
                       "--indel-error-models-file",
                       os.path.join(jout, MODEL)]) == 0
    for name in OUTPUTS:
        assert lines(jout, name) == lines(tout, name), name


def test_merge_only_keeps_the_workers_models(dataset, estimated):
    """A --merge-only run with --estimate-sequence-error concatenates the
    fragments and leaves the estimated files as the run wrote them (it
    touches no device); the VCFs stay byte-identical to the JAX
    package's."""
    d, fa, bam = dataset
    jout, tout = estimated
    before = {n: os.stat(os.path.join(tout, n)).st_mtime_ns
              for n in (COUNTS, MODEL)}
    assert torch_main(["germline", "--reference", fa, "--align-file", bam,
                       "--output-dir", tout, "--device", "cpu",
                       "--estimate-sequence-error", "--merge-only"]) == 0
    assert {n: os.stat(os.path.join(tout, n)).st_mtime_ns
            for n in (COUNTS, MODEL)} == before
    for name in OUTPUTS:
        assert lines(jout, name) == lines(tout, name), name
