"""The port's static checker suite (``theanompi_tpu_torch/analysis``)
against the JAX package's checkers, on the same files.

* the framework-neutral checks (TM101, TM302, TM401–TM404) give the JAX
  checkers' findings key for key, on the shared corpus and on the whole
  port tree;
* the restated TM301 flags every seeded host sync of a PyTorch corpus
  and is silent on its good twin; TM201 is a record that reports
  nothing;
* the gate is green with the committed baseline, and
  ``theanompi_tpu_torch/tools/tmlint.py --gate`` runs with ``torch``
  (and ``jax``) unimportable.
"""

from __future__ import annotations

import os
import subprocess
import sys
import textwrap

import pytest

from theanompi_tpu.analysis import guarded_by as jax_guarded_by
from theanompi_tpu.analysis import jit_hygiene as jax_jit_hygiene
from theanompi_tpu.analysis import site_coverage as jax_site_coverage
from theanompi_tpu.analysis.common import CHECK_IDS as JAX_CHECK_IDS
from theanompi_tpu.analysis.common import SourceFile as JaxSourceFile
from theanompi_tpu.analysis.common import iter_source_files as jax_iter
from theanompi_tpu_torch.analysis import (
    donation,
    guarded_by,
    jit_hygiene,
    site_coverage,
)
from theanompi_tpu_torch.analysis.cli import main as tmlint_main
from theanompi_tpu_torch.analysis.cli import run_checks
from theanompi_tpu_torch.analysis.common import (
    CHECK_IDS,
    SourceFile,
    iter_source_files,
    load_baseline,
    split_by_baseline,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORPUS = os.path.join(REPO, "tests", "analysis_corpus")
PKG = os.path.join(REPO, "theanompi_tpu_torch")


def both(name: str):
    path = os.path.join(CORPUS, name)
    return (JaxSourceFile(path, f"corpus/{name}"),
            SourceFile(path, f"corpus/{name}"))


def keyed(findings):
    return sorted((f.check_id, f.key, f.path, f.line) for f in findings)


def seeded_lines(path: str, check_id: str) -> list[int]:
    with open(path) as f:
        return [i for i, line in enumerate(f, start=1)
                if f"SEED: {check_id}" in line]


# ---------------------------------------------------------------------------
# Against JAX's checkers
# ---------------------------------------------------------------------------


def test_check_ids_are_jaxs():
    assert set(CHECK_IDS) == set(JAX_CHECK_IDS)


@pytest.mark.parametrize("name", ["guarded_bad.py", "guarded_good.py"])
def test_guarded_by_corpus_equals_jax(name):
    jf, pf = both(name)
    jax_out = keyed(jax_guarded_by.run([jf]))
    assert keyed(guarded_by.run([pf])) == jax_out
    if name.endswith("bad.py"):
        assert jax_out  # the corpus really seeds findings


def test_guarded_by_over_the_port_tree_equals_jax():
    jax_files = list(jax_iter(PKG, REPO))
    port_files = list(iter_source_files(PKG, REPO))
    assert [f.relpath for f in jax_files] == [f.relpath for f in port_files]
    assert keyed(guarded_by.run(port_files)) == \
        keyed(jax_guarded_by.run(jax_files))
    # the port's threaded host plane declares its guards
    n_decl = sum(f.source.count("# guarded_by:") for f in port_files)
    assert n_decl >= 100


@pytest.mark.parametrize("name", ["jit_bad.py", "jit_good.py"])
def test_pickle_corpus_equals_jax(name):
    jf, pf = both(name)
    jax_out = keyed(jax_jit_hygiene.check_pickle(jf))
    assert keyed(jit_hygiene.check_pickle(pf)) == jax_out
    if name == "jit_bad.py":
        assert [f[3] for f in jax_out] == seeded_lines(
            os.path.join(CORPUS, name), "TM302")


def test_pickle_over_the_port_tree_equals_jax():
    jax_out = [f for src in jax_iter(PKG, REPO)
               for f in jax_jit_hygiene.check_pickle(src)]
    port_out = [f for src in iter_source_files(PKG, REPO)
                for f in jit_hygiene.check_pickle(src)]
    assert keyed(port_out) == keyed(jax_out)


def test_site_coverage_corpus_equals_jax():
    jf, pf = both("coverage_code.py")
    doc = os.path.join(CORPUS, "coverage_docs.md")
    jax_out = jax_site_coverage.run([jf], doc, "corpus/coverage_docs.md")
    port_out = site_coverage.run([pf], doc, "corpus/coverage_docs.md")
    assert {f.check_id for f in port_out} == {
        "TM401", "TM402", "TM403", "TM404"}
    assert keyed(port_out) == keyed(jax_out)


def test_port_inventory_matches_jax_collectors():
    port_files = list(iter_source_files(PKG, REPO))
    jax_files = list(jax_iter(PKG, REPO))
    assert site_coverage.render_inventory(port_files) == \
        jax_site_coverage.render_inventory(jax_files)


# ---------------------------------------------------------------------------
# The restated TM301 and the TM201 record
# ---------------------------------------------------------------------------

TM301_BAD = '''
import torch
from torch import nn


class Net(nn.Module):
    def forward(self, x):
        s = x.sum().item()  # SEED: TM301
        return x * s + self.scale(x)

    def scale(self, x):
        return float(x.mean())  # SEED: TM301


class Deeper(Net):
    def forward(self, x):
        return x.tolist()  # SEED: TM301


class Fn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.cpu()  # SEED: TM301

    @staticmethod
    def backward(ctx, g):
        torch.cuda.synchronize()  # SEED: TM301
        return g


def norm(t):
    return t.numpy()  # SEED: TM301


def make_bsp_train_step(loss_fn):
    def step(state, batch):
        loss = loss_fn(state, batch)
        return norm(loss)
    return step


class Session:
    def _decode_fn(self, net, toks):
        return bool(toks.any())  # SEED: TM301

    def decode(self, toks):
        return self._run("decode", self._decode_fn, toks)

    def _run(self, family, fn, *args):
        return fn(None, *args)
'''

TM301_GOOD = '''
import torch
from torch import nn


class Net(nn.Module):
    def forward(self, x):
        n = int(x.shape[0]) + len(x) + int(x.numel()) + int(x.dim())
        return x * n + float(2)


class Fn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x * 2

    @staticmethod
    def backward(ctx, g):
        return g * 2


def make_bsp_train_step(loss_fn):
    def step(state, batch):
        return loss_fn(state, batch)
    return step


class Reader:
    def report(self, t):
        return t.item()  # not reachable from a step


def flush(metrics):
    return {k: v.cpu().tolist() for k, v in metrics.items()}
'''


def _write(tmp_path, name, text):
    path = tmp_path / name
    path.write_text(textwrap.dedent(text))
    return SourceFile(str(path), name)


def test_host_sync_flags_every_seeded_bug(tmp_path):
    src = _write(tmp_path, "tm301_bad.py", TM301_BAD)
    findings = jit_hygiene.check_host_sync(src)
    assert {f.check_id for f in findings} == {"TM301"}
    assert sorted(f.line for f in findings) == seeded_lines(
        src.abspath, "TM301")
    quals = {f.key.split(":")[2] for f in findings}
    assert {"Net.forward", "Net.scale", "Deeper.forward", "Fn.forward",
            "Fn.backward", "norm", "Session._decode_fn"} <= quals


def test_host_sync_silent_on_good_twin(tmp_path):
    src = _write(tmp_path, "tm301_good.py", TM301_GOOD)
    assert jit_hygiene.check_host_sync(src) == []


def test_host_sync_inline_suppression(tmp_path):
    src = _write(tmp_path, "tm301_ok.py", TM301_BAD.replace(
        "# SEED: TM301", "# lint: ok TM301"))
    assert jit_hygiene.check_host_sync(src) == []


def test_donation_is_a_record(tmp_path, capsys):
    src = _write(tmp_path, "tm301_bad.py", TM301_BAD)
    assert donation.run([src]) == []
    assert "TM201" in CHECK_IDS
    assert tmlint_main(["--root", REPO, "--checks", "donation"]) == 0
    assert donation.WHY in capsys.readouterr().out


# ---------------------------------------------------------------------------
# The gate
# ---------------------------------------------------------------------------


def test_gate_is_green_with_the_committed_baseline(capsys):
    findings = run_checks(REPO)
    baseline = load_baseline(os.path.join(
        PKG, "analysis", "baseline.json"))
    new, stale = split_by_baseline(findings, baseline)
    assert new == [] and stale == []
    assert all(reason and not reason.startswith("baselined:")
               for reason in baseline.values())
    assert tmlint_main(["--root", REPO, "--gate"]) == 0
    assert "0 new finding(s)" in capsys.readouterr().out


def test_the_catalog_covers_every_series_and_site():
    findings = run_checks(REPO, ["site_coverage"])
    assert findings == []


def test_json_format_reports_the_baselined_findings(capsys):
    import json

    assert tmlint_main(["--root", REPO, "--format", "json"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["new"] == [] and out["findings"]
    assert {f["check_id"] for f in out["findings"]} <= {"TM301", "TM302"}


def test_gate_fails_on_a_new_finding(tmp_path, capsys):
    pkg = tmp_path / "theanompi_tpu_torch"
    (pkg / "analysis").mkdir(parents=True)
    (pkg / "analysis" / "OBSERVABILITY.md").write_text(
        "## Metric catalog\n\n## Fault sites\n")
    (pkg / "m.py").write_text(textwrap.dedent(TM301_BAD))
    assert tmlint_main(["--root", str(tmp_path), "--gate"]) == 1
    assert tmlint_main(["--root", str(tmp_path), "--write-baseline"]) == 0
    assert tmlint_main(["--root", str(tmp_path), "--gate"]) == 0
    capsys.readouterr()


def test_tmlint_script_gate_without_torch(tmp_path):
    for name in ("torch", "jax"):
        (tmp_path / f"{name}.py").write_text(
            f'raise ImportError("poisoned {name}")')
    env = dict(os.environ, PYTHONPATH=str(tmp_path))
    p = subprocess.run(
        [sys.executable, os.path.join(PKG, "tools", "tmlint.py"), "--gate"],
        capture_output=True, text=True, env=env, cwd=str(tmp_path),
        timeout=120)
    assert p.returncode == 0, p.stdout + p.stderr
    assert "0 new finding(s)" in p.stdout
