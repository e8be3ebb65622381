"""The port's tools subcommand (python -m strelka_tpu_torch tools ...)
against the JAX package's (python -m strelka_tpu tools ...) on the same
inputs, each tool in both packages in this process: the same exit
codes, the same stdout and stderr, byte-identical output files; the
estimate-parameters JSON within tests/test_torch_error_zoo.py's FIT_RTOL
(its fits keep their last Adam step). Then training/evs_train:
read_evsf_vcf and vcf_to_feature_csv equal, and one small
train_and_export equal to the JAX package's JSON but for its Date.

The inputs come from the dryrun dataset (tests/test_torch_germline_e2e.py):
its BAM, one germline run of the port with --report-evs-features, and
the allele counts of two stretches of it.
"""
import gzip
import json
import os
import random

import numpy as np
import pytest

from strelka_tpu.training import evs_train as jet
from strelka_tpu.workflow.tools import main as jax_tools
from strelka_tpu_torch.__main__ import main as torch_main
from strelka_tpu_torch.training import evs_train as tet
from tests.test_torch_allele_counts import dryrun  # noqa: F401
from tests.test_torch_error_zoo import FIT_RTOL
from tests.test_torch_germline_e2e import dataset  # noqa: F401

TOOLS = ("extract-indel-candidates", "sort-vcf", "update-nopassed-filter",
         "merge-chrom-depth", "get-region-depth", "dump-counts",
         "merge-counts", "estimate-parameters", "validate-model",
         "vcf-cmdline-swapper", "evs-feature-csv", "cat")


@pytest.fixture(scope="module")
def inputs(dataset, dryrun, tmp_path_factory):
    """Files both packages' tools read: the germline run's VCFs (with
    EVSF), a shuffled plain VCF, depth files, counts npz files, models."""
    from strelka_tpu_torch.pipeline import allele_counts as tac
    d, fa, bam = dataset
    w = tmp_path_factory.mktemp("tools_in")
    out = str(w / "germline")
    assert torch_main(["germline", "--reference", fa, "--align-file", bam,
                       "--output-dir", out, "--device", "cpu",
                       "--report-evs-features"]) == 0
    var = os.path.join(out, "variants.vcf.gz")
    with gzip.open(var, "rt") as f:
        lines = f.readlines()
    head = [l for l in lines if l.startswith("#")]
    recs = [l for l in lines if not l.startswith("#")]
    random.Random(0).shuffle(recs)
    shuffled = str(w / "shuffled.vcf")
    with open(shuffled, "w") as f:
        f.writelines(head + recs)
    depths = []
    for i, text in enumerate(["chr1\t31.5\n", "chr2\t29.0\nchr3\t12.25\n"]):
        depths.append(str(w / f"depth{i}.txt"))
        with open(depths[-1], "w") as f:
            f.write(text)
    npz = []
    b, ea, lvl, ref = dryrun["torch"]
    for i, (beg, end) in enumerate([(0, 8000), (30_000, 36_000)]):
        cc = tac.collect_context_counts(b, ea, lvl, ref[beg:end], beg, beg,
                                        end)
        keep = {k: cc[k] for k in ((1, 1), (1, 2)) if k in cc}
        assert len(keep) == 2
        npz.append(str(w / f"counts{i}.npz"))
        tac.save_context_counts(npz[-1], keep)
    bad_model = str(w / "bad.json")
    with open(bad_model, "w") as f:
        json.dump({"sample": [{"sampleName": "S", "motif": [{}]}]}, f)
    good_model = str(w / "good.json")
    with open(good_model, "w") as f:
        json.dump({"sample": [{"sampleName": "S", "isStatic": False,
                               "motif": [{"repeatPatternSize": 1,
                                          "repeatCount": 1,
                                          "indelRate": 1e-3,
                                          "noisyLocusRate": 0.5}]}]}, f)
    return dict(bam=bam, fa=fa, var=var, gvcf=os.path.join(
        out, "genome.S1.vcf.gz"), shuffled=shuffled, depths=depths,
        npz=npz, bad_model=bad_model, good_model=good_model, w=w)


def run_both(capfd, args_of, outputs=()):
    """args_of(tag) -> the tool's argv for the JAX ("jax") and the port
    ("torch") run; outputs(tag) names the files each writes. Asserts the
    exit codes, stdout, stderr and every output file's bytes equal, and
    returns the port's (exit code, stdout, stderr, file bytes)."""
    res = {}
    for tag, run in (("jax", jax_tools),
                     ("torch", lambda a: torch_main(["tools", *a]))):
        capfd.readouterr()
        rc = run(args_of(tag))
        o, e = capfd.readouterr()
        files = []
        for path in outputs(tag) if outputs else ():
            with open(path, "rb") as f:
                files.append(f.read())
        res[tag] = (rc, o, e, files)
    assert res["torch"] == res["jax"]
    return res["torch"]


def test_no_tool_and_unknown_tool(capfd):
    rc, _, err, _ = run_both(capfd, lambda tag: [])
    assert rc == 2 and all(t in err for t in TOOLS)
    rc, _, err, _ = run_both(capfd, lambda tag: ["no-such-tool"])
    assert rc == 2 and "unknown tool: no-such-tool" in err
    assert torch_main(["tools"]) == 2


@pytest.mark.parametrize("which", ["var", "gvcf"])
def test_extract_indel_candidates(inputs, capfd, which):
    w = inputs["w"]
    rc, _, err, (data,) = run_both(
        capfd, lambda tag: ["extract-indel-candidates", inputs[which],
                            str(w / f"{tag}_cand_{which}.vcf.gz")],
        lambda tag: [str(w / f"{tag}_cand_{which}.vcf.gz")])
    assert rc == 0 and "kept" in err and data[:2] == b"\x1f\x8b"


def test_sort_vcf(inputs, capfd):
    w = inputs["w"]
    rc, *_ = run_both(
        capfd, lambda tag: ["sort-vcf", inputs["shuffled"],
                            str(w / f"{tag}_sorted.vcf.gz")],
        lambda tag: [str(w / f"{tag}_sorted.vcf.gz")])
    assert rc == 0


def test_update_nopassed_filter(inputs, capfd):
    w = inputs["w"]
    rc, _, err, _ = run_both(
        capfd, lambda tag: ["update-nopassed-filter", inputs["var"],
                            str(w / f"{tag}_upd.vcf.gz")],
        lambda tag: [str(w / f"{tag}_upd.vcf.gz")])
    assert rc == 0 and "updated" in err


def test_merge_chrom_depth_and_cat(inputs, capfd):
    """Depth files merged; text and BGZF files concatenated as bytes."""
    w = inputs["w"]
    for tool, extra in (("merge-chrom-depth", []), ("cat", [inputs["var"]])):
        rc, *_ = run_both(
            capfd, lambda tag: [tool, *inputs["depths"], *extra,
                                str(w / f"{tag}_{tool}.out")],
            lambda tag: [str(w / f"{tag}_{tool}.out")])
        assert rc == 0


@pytest.mark.parametrize("region", ["syn", "syn:10001-30000"])
def test_get_region_depth(inputs, capfd, region):
    rc, out, _, _ = run_both(
        capfd, lambda tag: ["get-region-depth", inputs["bam"], region,
                            inputs["fa"]])
    assert rc == 0 and out.startswith(region + "\t")
    assert float(out.split("\t")[1]) > 10


def test_dump_and_merge_counts(inputs, capfd):
    w = inputs["w"]
    rc, out, _, _ = run_both(capfd, lambda tag: ["dump-counts",
                                                 inputs["npz"][0]])
    assert rc == 0 and out.count("pattern_size=") == 2
    rc, *_ = run_both(
        capfd, lambda tag: ["merge-counts", *inputs["npz"],
                            str(w / f"{tag}_merged.npz")],
        lambda tag: [str(w / f"{tag}_merged.npz")])
    assert rc == 0


def test_validate_model(inputs, capfd):
    for path, kind, want in ((inputs["good_model"], "indel-error", 0),
                             (inputs["bad_model"], "indel-error", 1)):
        rc, *_ = run_both(capfd, lambda tag: ["validate-model", path, kind])
        assert rc == want


def test_vcf_cmdline_swapper(inputs, capfd):
    w = inputs["w"]
    for src in (inputs["var"], inputs["shuffled"]):
        rc, *_ = run_both(
            capfd, lambda tag: ["vcf-cmdline-swapper", src,
                                str(w / f"{tag}_swap.vcf"), "a b --c"],
            lambda tag: [str(w / f"{tag}_swap.vcf")])
        assert rc == 0


def test_evs_feature_csv(inputs, capfd):
    w = inputs["w"]
    for vt in ("SNV", "INDEL"):
        rc, _, err, (data,) = run_both(
            capfd, lambda tag: ["evs-feature-csv", "--type", vt, "--tp",
                                inputs["var"], "--fp", inputs["var"],
                                "--out", str(w / f"{tag}_{vt}.csv")],
            lambda tag: [str(w / f"{tag}_{vt}.csv")])
        assert rc == 0 and data.count(b"\n") > 10
    for bad in (["evs-feature-csv", inputs["var"], "--out", "x.csv"],
                ["evs-feature-csv", "--tp", inputs["var"], "--out",
                 str(w / "x.vcf")]):
        rc, *_ = run_both(capfd, lambda tag: bad)
        assert rc == 2


def estimate(capfd, args, port_device=("--device", "cpu")):
    capfd.readouterr()
    assert jax_tools(["estimate-parameters", *args]) == 0
    want = json.loads(capfd.readouterr().out)
    assert torch_main(["tools", "estimate-parameters", *args,
                       *port_device]) == 0
    got = json.loads(capfd.readouterr().out)
    return got, want


@pytest.mark.parametrize("args", [[], ["indelIndyNoOverlapDelete",
                                       "--lock-theta"]])
def test_estimate_parameters(inputs, capfd, args):
    got, want = estimate(capfd, [inputs["npz"][1], *args])
    assert list(got) == list(want) == ["unit1_rep1", "unit1_rep2"]
    for ctx in want:
        assert list(got[ctx]) == list(want[ctx])
        for k, v in want[ctx].items():
            assert got[ctx][k] == pytest.approx(v, rel=FIT_RTOL, abs=0), k


def test_estimate_parameters_model1_exact(inputs, capfd):
    got, want = estimate(capfd, [inputs["npz"][0], "indelModel1Insert"],
                         port_device=())      # host scipy: no device used
    assert got == want


def test_estimate_parameters_unknown_model_and_device(inputs):
    with pytest.raises(ValueError, match="unknown model"):
        jax_tools(["estimate-parameters", inputs["npz"][0], "nope"])
    with pytest.raises(ValueError, match="unknown model"):
        torch_main(["tools", "estimate-parameters", inputs["npz"][0],
                    "nope", "--device", "cpu"])
    with pytest.raises(SystemExit):
        torch_main(["tools", "estimate-parameters", inputs["npz"][0],
                    "--device", "tpu"])


def test_read_evsf_vcf_and_feature_csv_equal(inputs, tmp_path):
    for vt in (None, "SNV", "INDEL"):
        assert list(tet.read_evsf_vcf(inputs["var"], vt)) == \
            list(jet.read_evsf_vcf(inputs["var"], vt))
    a, b = str(tmp_path / "a.csv"), str(tmp_path / "b.csv")
    names = None
    for vt in ("SNV", "INDEL"):
        n = jet.vcf_to_feature_csv([inputs["var"]], [inputs["gvcf"]], a, vt,
                                   names)
        assert tet.vcf_to_feature_csv([inputs["var"]], [inputs["gvcf"]], b,
                                      vt, names) == n
        with open(a, "rb") as f1, open(b, "rb") as f2:
            assert f1.read() == f2.read()
        fa, la, na = jet.load_feature_csv(a)
        fb, lb, nb = tet.load_feature_csv(b)
        np.testing.assert_array_equal(fa, fb)
        np.testing.assert_array_equal(la, lb)
        assert na == nb
    with pytest.raises(ValueError, match="EVSF width"):
        tet.vcf_to_feature_csv([inputs["var"]], [], b, None)


def test_train_and_export_equal(tmp_path):
    pytest.importorskip("sklearn")
    rng = np.random.default_rng(9)
    x = rng.normal(size=(600, 4))
    y = (x[:, 0] + 0.5 * x[:, 1] ** 2 > 0.5).astype(int)
    docs = []
    for mod, name in ((jet, "j.json"), (tet, "t.json")):
        path = str(tmp_path / name)
        mod.train_and_export(x, y, ["A", "B", "C", "D"], path, "SNV",
                             "Germline", 3.0, n_trees=6, max_depth=4,
                             random_state=5)
        with open(path) as f:
            doc = json.load(f)
        del doc["CalibrationModels"]["Germline"]["SNV"]["Date"]
        docs.append(doc)
    assert docs[0] == docs[1]
    assert len(docs[1]["CalibrationModels"]["Germline"]["SNV"]["Model"]) == 6
