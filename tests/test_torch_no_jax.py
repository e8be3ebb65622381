"""The port imports neither jax nor the JAX package, and asking it for
the card without one raises instead of falling back to the CPU."""
import ast
import os
import subprocess
import sys

import pytest
import torch

from strelka_tpu_torch import device as devmod

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "strelka_tpu")


def _port_sources():
    root = os.path.join(REPO, "strelka_tpu_torch")
    for d, _dirs, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)
    yield os.path.join(REPO, "chip_smoke.py")


def _imported_roots(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_source_imports_jax_or_the_jax_package():
    sources = list(_port_sources())
    bad = [(os.path.relpath(p, REPO), m) for p in sources
           for m in _imported_roots(p) if m in FORBIDDEN]
    assert not bad, bad
    scanned = {os.path.relpath(p, REPO) for p in sources}
    for path in ("models/error_fit.py", "models/error_zoo.py",
                 "pipeline/allele_counts.py", "training/evs_train.py",
                 "utils/special.py", "workflow/tools.py",
                 "workflow/denovo.py", "workflow/noise_extractor.py",
                 "sim.py", "parallel/mesh.py", "ops/fit_kernels.py"):
        assert os.path.join("strelka_tpu_torch", path) in scanned, path


def test_import_and_cli_help_load_no_jax():
    code = (
        "import sys\n"
        "import strelka_tpu_torch\n"
        "from strelka_tpu_torch.__main__ import main\n"
        "from strelka_tpu_torch.pipeline import germline_caller, gvcf\n"
        "from strelka_tpu_torch.pipeline import somatic_caller\n"
        "from strelka_tpu_torch.models import evs, somatic_indel\n"
        "from strelka_tpu_torch.parallel import hardware, runner\n"
        "from strelka_tpu_torch.io import cram\n"
        "from strelka_tpu_torch.models import error_fit, error_zoo\n"
        "from strelka_tpu_torch.pipeline import allele_counts\n"
        "from strelka_tpu_torch.training import evs_train\n"
        "from strelka_tpu_torch.utils import special\n"
        "from strelka_tpu_torch.workflow import tools\n"
        "from strelka_tpu_torch.workflow import denovo, noise_extractor\n"
        "from strelka_tpu_torch import sim\n"
        "from strelka_tpu_torch.parallel import mesh\n"
        "assert main(['tools']) == 2\n"
        "for cmd in ('germline', 'somatic', 'denovo', 'noise-extractor'):\n"
        "    try:\n"
        "        main([cmd, '--help'])\n"
        "    except SystemExit as e:\n"
        "        assert e.code == 0, e.code\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert "clean" in r.stdout
    assert r.stdout.count("--device") >= 2
    assert r.stdout.count("--jobs") >= 2
    assert r.stdout.count("--cluster-submit") >= 2
    assert "--tumor-align-file" in r.stdout
    assert "--estimate-sequence-error" in r.stdout
    assert "--error-count-target" in r.stdout
    assert r.stdout.count("--mesh") >= 2
    assert "--proband-id" in r.stdout and "--min-noise-count" in r.stdout


def test_cuda_without_gpu_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        devmod.resolve("cuda")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        devmod.resolve(None)
    from strelka_tpu_torch.__main__ import main
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        main(["germline", "--reference", "x.fa", "--align-file", "x.bam",
              "--output-dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        main(["somatic", "--reference", "x.fa", "--normal-align-file",
              "n.bam", "--tumor-align-file", "t.bam", "--output-dir",
              str(tmp_path), "--device", "cuda"])
    assert devmod.resolve("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        devmod.resolve("meta")
