"""What the benchmark runs imports: never JAX or the JAX package (names
compared whole: ``doa_mpc_tpu_torch`` begins with ``doa_mpc_tpu``), and the
reference nothing of the program."""

import ast
import os
import subprocess
import sys

import pytest

from common import BENCH, ROOT
from mpcbench import harness

BENCH_DIR = os.path.join(ROOT, "mpcbench")
FORBIDDEN = {"jax", "jaxlib", "flax", "doa_mpc_tpu"}


def _sources(sub=""):
    for d, _, files in os.walk(os.path.join(BENCH_DIR, sub)):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def _imported_tops(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module.split(".")[0]


def _loaded_after(code):
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\n"
                          "print(sorted({m.split('.')[0] for m in sys.modules}))"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300, check=True)
    return set(ast.literal_eval(out.stdout.strip().splitlines()[-1]))


def test_no_source_of_the_benchmark_imports_jax_or_the_jax_package():
    for path in _sources():
        assert not set(_imported_tops(path)) & FORBIDDEN, path


def test_running_the_benchmark_loads_no_jax_module():
    readers = "; ".join(f"harness.reader({m['name']!r})" for m in BENCH["per_layer"])
    loaded = _loaded_after("from mpcbench import harness, system, check, generator, trace, "
                           "yardstick, calibrate; " + readers)
    assert "doa_mpc_tpu_torch" in loaded
    assert not loaded & FORBIDDEN


def test_the_reference_imports_nothing_of_the_program():
    for path in _sources("reference"):
        assert not set(_imported_tops(path)) & (FORBIDDEN | {"doa_mpc_tpu_torch", "mpcbench"}) \
            - {"mpcbench"}, path
    loaded = _loaded_after("from mpcbench.reference import tick, ip")
    assert not loaded & (FORBIDDEN | {"doa_mpc_tpu_torch"})


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "doa_mpc_tpu_torch_extra", sys)
    assert "doa_mpc_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "doa_mpc_tpu.ops", sys)
    assert harness.forbidden_modules() == ["doa_mpc_tpu"]


def test_without_a_card_the_run_prints_no_result():
    out = subprocess.run([sys.executable, "mpcbench/run.py", "--workload",
                          "campaign_irk_qp100.pair200", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
                         timeout=300, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.cuda
def test_a_cell_runs_on_the_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    out = subprocess.run([sys.executable, "mpcbench/run.py", "--workload",
                          "campaign_irk_qp100.pair200", "--seed", "3", "--seconds", "2",
                          "--trace", "0"], cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert '"correct": true' in out.stdout.strip().splitlines()[-1]
