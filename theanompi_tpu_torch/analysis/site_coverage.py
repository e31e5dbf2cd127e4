"""TM401–TM404 — site-coverage lint: code and docs cannot drift.

Two inventories, both extracted from the package source by ``ast``:

* **fault sites** — every ``faults.fire("<site>", coord=...)`` call
  site (the resilience injection plane, ``resilience/faults.py``);
* **metric series** — every ``monitor.inc/set_gauge/add_gauge/
  observe("<name>", ...)`` emission (including direct
  ``registry.<kind>("<name>", ...)`` calls inside the monitor package
  itself), with the label keys used at each call site.

Both are diffed against the port's own catalog,
``theanompi_tpu_torch/analysis/OBSERVABILITY.md`` (the JAX package's is
``docs/OBSERVABILITY.md``): the metric catalog table and the fault-site
table (first-column backticked names).  Counterpart of
``theanompi_tpu/analysis/site_coverage.py``, the same checks and keys.  Four
outcomes:

* TM401 — a site fires in code but is missing from the docs table;
* TM402 — the docs name a site nothing fires (stale docs, or a typo'd
  site string that silently never matches a fault plan — the worse
  failure, since an operator's plan then tests nothing);
* TM403 — a metric is emitted but undocumented;
* TM404 — a documented metric is never emitted (a dashboard built on
  it would silently flatline).

``python theanompi_tpu_torch/tools/tmlint.py --inventory`` prints both
inventories as markdown rows; the catalog's tables are generated from
that output.
"""

from __future__ import annotations

import ast
import os
import re
from typing import Iterable

from theanompi_tpu_torch.analysis.common import (
    Finding,
    SourceFile,
    const_str,
    dotted_name,
    make_key,
)

CHECK_SITE_UNDOC = "TM401"
CHECK_SITE_UNFIRED = "TM402"
CHECK_METRIC_UNDOC = "TM403"
CHECK_METRIC_UNEMITTED = "TM404"

_EMIT_METHODS = {"inc": "counter", "set_gauge": "gauge",
                 "add_gauge": "gauge", "observe": "histogram"}

#: modules excluded from the inventories: the checkers themselves, and
#: — for FIRE sites only — faults.py, whose ``fire`` definitions and
#: internal dispatch would otherwise read as call sites
_INTERNAL = ("analysis/",)
_FIRE_INTERNAL = _INTERNAL + ("resilience/faults.py",)

_BACKTICK_RE = re.compile(r"`([^`]+)`")

#: the port's catalog, relative to the repo root
CATALOG = "theanompi_tpu_torch/analysis/OBSERVABILITY.md"


# ---------------------------------------------------------------------------
# Code inventories
# ---------------------------------------------------------------------------


class Emission:
    def __init__(self, name: str, kind: str, labels: tuple[str, ...],
                 path: str, line: int):
        self.name = name
        self.kind = kind
        self.labels = labels
        self.path = path
        self.line = line


class FireSite:
    def __init__(self, site: str, coords: tuple[str, ...],
                 path: str, line: int):
        self.site = site
        self.coords = coords
        self.path = path
        self.line = line


def collect_metrics(files: list[SourceFile]) -> list[Emission]:
    out: list[Emission] = []
    for src in files:
        if any(part in src.relpath for part in _INTERNAL):
            continue
        for node in ast.walk(src.tree):
            if not isinstance(node, ast.Call) \
                    or not isinstance(node.func, ast.Attribute):
                continue
            meth = node.func.attr
            if meth not in _EMIT_METHODS or not node.args:
                continue
            name = const_str(node.args[0])
            if name is None:
                continue
            # the receiver must look like the monitor facade or a
            # registry (self.registry / _state.registry / monitor) —
            # not, say, Counter.inc
            recv = dotted_name(node.func.value) or ""
            if not (recv == "monitor" or recv.endswith("registry")
                    or recv.endswith("_registry")):
                continue
            labels = tuple(sorted(kw.arg for kw in node.keywords
                                  if kw.arg is not None))
            out.append(Emission(name, _EMIT_METHODS[meth], labels,
                                src.relpath, node.lineno))
    return out


def collect_fires(files: list[SourceFile]) -> list[FireSite]:
    out: list[FireSite] = []
    for src in files:
        if any(part in src.relpath for part in _FIRE_INTERNAL):
            continue
        for node in ast.walk(src.tree):
            if not isinstance(node, ast.Call):
                continue
            d = dotted_name(node.func) or ""
            if d.split(".")[-1] != "fire" or not node.args:
                continue
            site = const_str(node.args[0])
            if site is None:
                continue
            coords = tuple(sorted(kw.arg for kw in node.keywords
                                  if kw.arg is not None))
            out.append(FireSite(site, coords, src.relpath, node.lineno))
    return out


# ---------------------------------------------------------------------------
# Docs inventory
# ---------------------------------------------------------------------------


def _table_names(md_text: str, section_heading: str) -> dict[str, int]:
    """Backticked names from the first column of the table under
    ``section_heading`` -> line number."""
    out: dict[str, int] = {}
    in_section = False
    for i, line in enumerate(md_text.splitlines(), start=1):
        if line.startswith("#"):
            in_section = section_heading in line
            continue
        if not in_section or not line.lstrip().startswith("|"):
            continue
        cells = line.split("|")
        if len(cells) < 3:
            continue
        first = cells[1]
        if set(first.strip()) <= {"-", ":", " "}:
            continue  # separator row
        for name in _BACKTICK_RE.findall(first):
            out[name.strip()] = i
    return out


def docs_metrics(doc_path: str) -> dict[str, int]:
    with open(doc_path, encoding="utf-8") as f:
        return _table_names(f.read(), "Metric catalog")


def docs_sites(doc_path: str) -> dict[str, int]:
    with open(doc_path, encoding="utf-8") as f:
        return _table_names(f.read(), "Fault sites")


# ---------------------------------------------------------------------------
# The check
# ---------------------------------------------------------------------------


def run(files: list[SourceFile], doc_path: str,
        doc_relpath: str = CATALOG) -> list[Finding]:
    findings: list[Finding] = []
    if not os.path.exists(doc_path):
        findings.append(Finding(
            CHECK_METRIC_UNDOC, doc_relpath, 1,
            f"{doc_relpath} is missing; the metric catalog and "
            "fault-site tables are the coverage contract",
            make_key(CHECK_METRIC_UNDOC, doc_relpath, "<missing>")))
        return findings

    emissions = collect_metrics(files)
    fires = collect_fires(files)
    doc_m = docs_metrics(doc_path)
    doc_s = docs_sites(doc_path)

    emitted: dict[str, list[Emission]] = {}
    for e in emissions:
        emitted.setdefault(e.name, []).append(e)
    fired: dict[str, list[FireSite]] = {}
    for f in fires:
        fired.setdefault(f.site, []).append(f)

    for name, es in sorted(emitted.items()):
        # an inline suppression on ANY emission of the name covers the
        # name (the suppression is about the metric, not one call
        # site — and must not depend on file-walk order)
        if name not in doc_m \
                and not any(_suppressed_line(files, e) for e in es):
            e = es[0]
            findings.append(Finding(
                CHECK_METRIC_UNDOC, e.path, e.line,
                f"metric '{name}' ({e.kind}) is emitted here but "
                f"missing from the {doc_relpath} metric catalog",
                make_key(CHECK_METRIC_UNDOC, name)))
    for name, line in sorted(doc_m.items()):
        if name not in emitted:
            findings.append(Finding(
                CHECK_METRIC_UNEMITTED, doc_relpath, line,
                f"documented metric '{name}' is never emitted by the "
                f"package (dashboards on it would flatline)",
                make_key(CHECK_METRIC_UNEMITTED, name)))
    for site, fs in sorted(fired.items()):
        if site not in doc_s \
                and not any(_suppressed_line(files, f) for f in fs):
            f = fs[0]
            findings.append(Finding(
                CHECK_SITE_UNDOC, f.path, f.line,
                f"fault site '{site}' fires here but is missing from "
                f"the {doc_relpath} fault-site table",
                make_key(CHECK_SITE_UNDOC, site)))
    for site, line in sorted(doc_s.items()):
        if site not in fired:
            findings.append(Finding(
                CHECK_SITE_UNFIRED, doc_relpath, line,
                f"documented fault site '{site}' never fires in the "
                f"package (a fault plan naming it tests nothing)",
                make_key(CHECK_SITE_UNFIRED, site)))
    return findings


def _suppressed_line(files: Iterable[SourceFile], item) -> bool:
    for src in files:
        if src.relpath == item.path:
            check = CHECK_METRIC_UNDOC if isinstance(item, Emission) \
                else CHECK_SITE_UNDOC
            return src.suppressed(item.line, check)
    return False


# ---------------------------------------------------------------------------
# Inventory rendering (the docs-regeneration seam)
# ---------------------------------------------------------------------------


def render_inventory(files: list[SourceFile]) -> str:
    """Markdown rows for both tables, grouped per series/site with the
    union of labels/coords and every source module."""
    emissions = collect_metrics(files)
    fires = collect_fires(files)
    lines = ["## metrics", "", "| Series | Kind | Labels | Source |",
             "|---|---|---|---|"]
    by_name: dict[str, list[Emission]] = {}
    for e in emissions:
        by_name.setdefault(e.name, []).append(e)
    for name in sorted(by_name):
        es = by_name[name]
        kinds = sorted({e.kind for e in es})
        labels = sorted({l for e in es for l in e.labels})
        paths = sorted({e.path for e in es})
        lines.append(f"| `{name}` | {', '.join(kinds)} | "
                     f"{', '.join(f'`{l}`' for l in labels) or '—'} | "
                     f"{', '.join(f'`{p}`' for p in paths)} |")
    lines += ["", "## fault sites", "",
              "| Site | Coords | Source |", "|---|---|---|"]
    by_site: dict[str, list[FireSite]] = {}
    for f in fires:
        by_site.setdefault(f.site, []).append(f)
    for site in sorted(by_site):
        fs = by_site[site]
        coords = sorted({c for f in fs for c in f.coords})
        paths = sorted({f.path for f in fs})
        lines.append(f"| `{site}` | "
                     f"{', '.join(f'`{c}`' for c in coords) or '—'} | "
                     f"{', '.join(f'`{p}`' for p in paths)} |")
    return "\n".join(lines) + "\n"
