"""The port stands alone: every module of ``theanompi_tpu_torch``, and
``chip_smoke.py``, imports with a poisoned ``jax`` on the path, and no
port source imports ``jax`` or the JAX package."""

import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "theanompi_tpu_torch")


def _port_sources():
    for root, _dirs, files in os.walk(PKG):
        for name in files:
            if name.endswith(".py"):
                yield os.path.join(root, name)
    yield os.path.join(REPO, "chip_smoke.py")


def test_port_imports_with_poisoned_jax(tmp_path):
    (tmp_path / "jax.py").write_text(
        'raise ImportError("poisoned jax - the port must not import me")')
    code = (
        "import importlib, pkgutil, sys\n"
        "import theanompi_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, "
        "'theanompi_tpu_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "import chip_smoke\n"
        "assert {'theanompi_tpu_torch.serving.server', "
        "'theanompi_tpu_torch.launcher', 'theanompi_tpu_torch.ops.lrn', "
        "'theanompi_tpu_torch.models.alex_net', "
        "'theanompi_tpu_torch.ops.attention', "
        "'theanompi_tpu_torch.models.transformer', "
        "'theanompi_tpu_torch.data.lm'} <= set(names)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith("
        "('jax.', 'theanompi_tpu.')) or m == 'theanompi_tpu']\n"
        "assert not bad, bad\n"
        "print('imported', len(names))\n")
    env = dict(os.environ,
               PYTHONPATH=os.pathsep.join([str(tmp_path), REPO]))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, cwd=str(tmp_path), timeout=120)
    assert p.returncode == 0, p.stdout + p.stderr
    assert "imported" in p.stdout


def test_no_port_source_imports_jax_or_the_jax_package():
    pat = re.compile(
        r"^\s*(import|from)\s+(jax\b|flax\b|theanompi_tpu(?!_torch)\b)",
        re.M)
    offenders = [path for path in _port_sources()
                 if pat.search(open(path).read())]
    assert offenders == []
