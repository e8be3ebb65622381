"""Configurations, traffic mixes and per-layer metrics are found by
name, one added as files and manifest entries alone included."""
import json
import shutil

from portbench.core import harness, manifest


def test_every_name_in_the_manifest_is_found():
    man = manifest.load()
    for w in man["workloads"]:
        cell = harness.Cell(man, w["name"])
        assert cell.config["mode"] in ("germline", "somatic")
        assert "cli_args" in cell.traffic
        for m in manifest.metrics_for(man, w["name"], trace=True):
            assert callable(manifest.reader(m["name"]).read)
    assert {m["name"] for m in manifest.metrics_for(
        man, "germline-wgs35.n1", trace=False)} == {"reads_per_s",
                                                   "setup_s"}


def test_a_cell_mix_and_metric_added_as_files(tmp_path):
    root = tmp_path / "checkout"
    bench = root / "portbench"
    shutil.copytree(manifest.BENCH, bench,
                    ignore=shutil.ignore_patterns("__pycache__"))
    man = manifest.load()
    with open(bench / "configs" / "germline-wgs35.json") as f:
        cfg = json.load(f)
    cfg["name"] = "germline-exome"
    cfg["samples"][0]["depth"] = 100
    (bench / "configs" / "germline-exome.json").write_text(json.dumps(cfg))
    (bench / "traffic" / "jobs2.json").write_text(json.dumps(
        {"name": "jobs2", "cli_args": ["--jobs", "2"]}))
    (bench / "metrics" / "jobs.count.py").write_text(
        "def read(run):\n    return float(len(run['jobs'])) or None\n")
    man["configs"].append({"name": "germline-exome", "source": "x",
                           "file": "portbench/configs/germline-exome.json",
                           "reduced": [], "why": "x"})
    man["workloads"].append({"name": "germline-exome.jobs2",
                             "config": "germline-exome", "traffic": "jobs2",
                             "chips": 1, "why": "x"})
    man["per_layer"].append({"name": "jobs.count", "unit": "jobs",
                             "better": "higher", "source": "host_clock",
                             "layer": "fan-out and merge",
                             "moves": "reads_per_s",
                             "workloads": ["germline-exome.jobs2"]})
    (root / "BENCHMARK.json").write_text(json.dumps(man))
    new = manifest.load(str(root))
    w = manifest.workload(new, "germline-exome.jobs2")
    assert manifest.config(new, w["config"], str(root))["samples"][0][
        "depth"] == 100
    assert manifest.traffic("jobs2", str(bench))["cli_args"] == [
        "--jobs", "2"]
    ms = manifest.metrics_for(new, "germline-exome.jobs2", trace=True)
    assert [m["name"] for m in ms] == ["jobs.count"]
    assert manifest.reader("jobs.count", str(bench)).read(
        {"jobs": [1, 2]}) == 2.0
