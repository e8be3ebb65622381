"""Nothing the benchmark runs loads JAX or the JAX package, and nothing
in it reads the old benchmarks/ folder."""
import json
import os
import re
import subprocess
import sys

from portbench import run as bench_run

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
TINY = ["--workload", "somatic-tn60-30.n1", "--seed", "3", "--seconds", "1",
        "--trace", "0", "--device", "cpu", "--contig-bp", "60000"]


def _sources():
    for d, _dirs, files in os.walk(BENCH):
        if "tests" in d.split(os.sep):
            continue
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_source_imports_jax_or_the_jax_package():
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flax|strelka_tpu)"
                     r"(\s|\.|$)", re.M)
    for p in _sources():
        with open(p) as f:
            src = f.read()
        assert not pat.search(src), p
        assert "benchmarks/" not in src and "benchmarks." not in src, p


def test_the_reference_and_generator_import_nothing_of_the_port():
    pat = re.compile(r"(import|from)\s+strelka_tpu|import_module\(")
    for sub in ("reference", "gen"):
        for f in os.listdir(os.path.join(BENCH, sub)):
            if f.endswith(".py"):
                with open(os.path.join(BENCH, sub, f)) as fh:
                    assert not pat.search(fh.read()), f


def test_top_level_names_compared_whole():
    saved = dict(sys.modules)
    try:
        sys.modules.pop("strelka_tpu", None)
        sys.modules["strelka_tpu_torch_like"] = sys
        assert "strelka_tpu" not in bench_run.loaded_forbidden()
        sys.modules["strelka_tpu.models"] = sys
        assert "strelka_tpu" in bench_run.loaded_forbidden()
    finally:
        sys.modules.clear()
        sys.modules.update(saved)


def test_a_run_loads_neither_and_is_refused_when_it_does():
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    r = subprocess.run([sys.executable, "portbench/run.py", *TINY],
                       cwd=ROOT, capture_output=True, text=True, env=env,
                       timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    line = json.loads(r.stdout.strip().splitlines()[-1])
    assert set(line) >= {"correct", "attempted", "failed", "metrics",
                         "device"}
    assert list(line)[-1] == "checks"
    code = ("import sys, types, runpy; sys.modules['jaxlib'] = "
            "types.ModuleType('jaxlib'); sys.argv = ['run.py'] + "
            f"{TINY!r}; runpy.run_path('portbench/run.py', "
            "run_name='__main__')")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, env=env, timeout=600)
    assert r.returncode == 3 and "jaxlib" in r.stderr
    assert not r.stdout.strip()


def test_no_result_without_the_port(tmp_path):
    import shutil
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "portbench/run.py", *TINY],
                       cwd=tmp_path, capture_output=True, text=True,
                       env=env, timeout=600)
    assert r.returncode != 0 and not r.stdout.strip()
