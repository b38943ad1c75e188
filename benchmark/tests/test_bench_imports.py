"""Nothing under benchmark/ imports JAX or the JAX package (top-level
module names compared whole: ftrl_ffm_tpu_torch is not ftrl_ffm_tpu),
and the plain reference imports nothing of the program."""

import ast
import os
import subprocess
import sys

from benchmark import spec

HERE = os.path.join(spec.ROOT, "benchmark")
FORBIDDEN = {"jax", "jaxlib", "flax", "ftrl_ffm_tpu"}


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def _sources(root):
    for d, _, files in os.walk(root):
        yield from (os.path.join(d, f) for f in files if f.endswith(".py"))


def test_no_jax_anywhere():
    found = {p: FORBIDDEN & set(_imports(p)) for p in _sources(HERE)}
    assert not {p: f for p, f in found.items() if f}


def test_reference_is_free_of_the_program():
    # the reference and the model modules it reads
    for d in ("reference", "models"):
        for p in _sources(os.path.join(HERE, d)):
            assert "ftrl_ffm_tpu_torch" not in set(_imports(p)), p


def test_loaded_harness_holds_no_jax():
    code = ("import sys, benchmark.run, benchmark.calibrate, benchmark.port; "
            "import ftrl_ffm_tpu_torch.train; "
            "from benchmark import run; "
            "[run.load_metric(m[:-3]) for m in __import__('os').listdir('benchmark/metrics')]; "
            "print(run.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
