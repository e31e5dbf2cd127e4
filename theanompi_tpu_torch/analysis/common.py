"""Shared plumbing for the port's static checker suite.

Counterpart of ``theanompi_tpu/analysis/common.py``, kept as a copy so
the port imports nothing of the JAX package.  Every checker is a
pure-stdlib ``ast`` pass over the package source — no imports of the
checked code (so no ``torch``), no network, no pip.  They share three pieces of plumbing:

* :class:`SourceFile` — parsed module + raw lines (``ast`` drops
  comments, and the guarded-by/suppression conventions live in
  comments, so checkers need both views);
* :class:`Finding` — one diagnostic with a **stable key** that
  deliberately excludes the line number, so a finding keeps its
  identity across unrelated edits and the baseline file does not churn;
* the **baseline** (``theanompi_tpu_torch/analysis/baseline.json``): the committed set of
  accepted finding keys.  The gate is *zero new findings*, not zero
  findings — a judged false positive is suppressed there with a
  ``reason`` instead of contorting the code.

Inline suppression: a line ending in ``# lint: ok`` (optionally
``# lint: ok TM101``) is skipped by every checker (or just the named
check).  Prefer the baseline for anything that needs a recorded
reason.
"""

from __future__ import annotations

import ast
import dataclasses
import json
import os
import re
from typing import Iterable, Iterator

#: check IDs -> one-line summaries (the module docstrings carry the long
#: form; TM201 and TM301 are restated for PyTorch)
CHECK_IDS = {
    "TM101": "guarded_by attribute accessed outside its lock",
    "TM201": "buffer donation (no PyTorch counterpart; see donation.py)",
    "TM301": "host-sync call inside a function reachable from a step",
    "TM302": "pickle decode without an allow_pickle guard",
    "TM401": "fault site fired in code but not documented",
    "TM402": "fault site documented but never fired",
    "TM403": "metric emitted in code but not documented",
    "TM404": "metric documented but never emitted",
}

_SUPPRESS_RE = re.compile(r"#\s*lint:\s*ok(?:\s+(?P<ids>[A-Z0-9, ]+))?")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One diagnostic.  ``key`` is the stable identity used by the
    baseline; ``line`` is presentation only."""

    check_id: str
    path: str  # repo-relative, '/'-separated
    line: int
    message: str
    key: str

    def render(self) -> str:
        return f"{self.path}:{self.line}: {self.check_id} {self.message}"

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


def make_key(check_id: str, *parts: str) -> str:
    return ":".join((check_id,) + tuple(str(p) for p in parts))


class SourceFile:
    """One parsed module: ast + raw lines + suppression map."""

    def __init__(self, abspath: str, relpath: str):
        self.abspath = abspath
        self.relpath = relpath.replace(os.sep, "/")
        with open(abspath, encoding="utf-8") as f:
            self.source = f.read()
        self.lines = self.source.splitlines()
        self.tree = ast.parse(self.source, filename=relpath)

    def line(self, lineno: int) -> str:
        """1-based physical line ('' when out of range)."""
        if 1 <= lineno <= len(self.lines):
            return self.lines[lineno - 1]
        return ""

    def suppressed(self, lineno: int, check_id: str) -> bool:
        """True when ``lineno`` (or the line above it) carries an
        inline ``# lint: ok [IDs]`` matching ``check_id``."""
        for ln in (lineno, lineno - 1):
            m = _SUPPRESS_RE.search(self.line(ln))
            if m:
                ids = m.group("ids")
                if not ids:
                    return True
                if check_id in {s.strip() for s in ids.split(",")}:
                    return True
        return False


def iter_source_files(package_root: str,
                      repo_root: str | None = None,
                      exclude: Iterable[str] = ()) -> Iterator[SourceFile]:
    """Yield every ``.py`` file under ``package_root`` as a
    :class:`SourceFile` with paths relative to ``repo_root``.  Files
    that fail to parse are skipped (the interpreter will complain
    louder than a linter ever could)."""
    repo_root = repo_root or os.path.dirname(package_root)
    exclude = tuple(exclude)
    for dirpath, dirnames, filenames in os.walk(package_root):
        dirnames[:] = sorted(d for d in dirnames
                             if d != "__pycache__")
        for fn in sorted(filenames):
            if not fn.endswith(".py"):
                continue
            abspath = os.path.join(dirpath, fn)
            rel = os.path.relpath(abspath, repo_root)
            if any(part in rel.replace(os.sep, "/") for part in exclude):
                continue
            try:
                yield SourceFile(abspath, rel)
            except (SyntaxError, UnicodeDecodeError):
                continue


# ---------------------------------------------------------------------------
# AST helpers shared by the checkers
# ---------------------------------------------------------------------------


def dotted_name(node: ast.AST) -> str | None:
    """``a.b.c`` for a Name/Attribute chain rooted at a Name; None for
    anything dynamic (calls, subscripts, literals)."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def call_name(node: ast.Call) -> str | None:
    """Dotted name of a call's callee (``np.asarray``, ``self.f``)."""
    return dotted_name(node.func)


def const_str(node: ast.AST) -> str | None:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


# ---------------------------------------------------------------------------
# Baseline
# ---------------------------------------------------------------------------


def load_baseline(path: str) -> dict[str, str]:
    """``{finding_key: reason}`` from ``analysis/baseline.json``;
    empty when the file is absent."""
    if not os.path.exists(path):
        return {}
    with open(path, encoding="utf-8") as f:
        data = json.load(f)
    out: dict[str, str] = {}
    for entry in data.get("suppressions", []):
        out[str(entry["key"])] = str(entry.get("reason", ""))
    return out


def write_baseline(path: str, findings: Iterable[Finding],
                   reasons: dict[str, str] | None = None) -> None:
    """Write every finding's key as a suppression, preserving reasons
    already recorded for keys that persist."""
    reasons = reasons or {}
    entries = []
    seen: set[str] = set()
    for f in findings:
        if f.key in seen:
            continue
        seen.add(f.key)
        entries.append({
            "key": f.key,
            "reason": reasons.get(
                f.key, f"baselined: {f.path}:{f.line} {f.message}"),
        })
    entries.sort(key=lambda e: e["key"])
    with open(path, "w", encoding="utf-8") as f:
        json.dump({"version": 1, "suppressions": entries}, f, indent=2)
        f.write("\n")


def split_by_baseline(findings: list[Finding], baseline: dict[str, str]
                      ) -> tuple[list[Finding], list[str]]:
    """(new_findings, stale_baseline_keys)."""
    live_keys = {f.key for f in findings}
    new = [f for f in findings if f.key not in baseline]
    stale = sorted(k for k in baseline if k not in live_keys)
    return new, stale
