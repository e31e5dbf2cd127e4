"""``tmlint`` over the port — the static checker CLI.

Counterpart of ``theanompi_tpu/analysis/cli.py``: it checks
``theanompi_tpu_torch/`` against
``theanompi_tpu_torch/analysis/baseline.json`` and the port's catalog
``theanompi_tpu_torch/analysis/OBSERVABILITY.md``.  Run it as
``python theanompi_tpu_torch/tools/tmlint.py [--gate]`` (no torch
needed) or ``python -m theanompi_tpu_torch.analysis.cli``.

Modes:

* default / ``--format json``: run every checker, print findings;
* ``--gate``: zero-NEW-findings gate against the baseline (exit 1 on
  any finding whose stable key is not baselined; stale baseline entries
  are warnings, not failures) — the first step of
  ``theanompi_tpu_torch/tools/preflight.sh``;
* ``--write-baseline``: accept the current findings as the baseline
  (reasons already recorded for surviving keys are preserved);
* ``--inventory``: print the metric/fault-site inventories as markdown
  (the catalog's tables are generated from this).

Pure stdlib + ``ast``: nothing in the checked package is imported, so
the gate runs in seconds on a CPU with no torch.  TM201 reports nothing
(``donation.py`` says why); the text modes print that reason.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from theanompi_tpu_torch.analysis import (
    donation,
    guarded_by,
    jit_hygiene,
    site_coverage,
)
from theanompi_tpu_torch.analysis.common import (
    CHECK_IDS,
    Finding,
    iter_source_files,
    load_baseline,
    split_by_baseline,
    write_baseline,
)

#: checker name -> callable(files, doc_path) -> findings
_CHECKERS = ("guarded_by", "donation", "jit_hygiene", "site_coverage")
PACKAGE = "theanompi_tpu_torch"
BASELINE = os.path.join(PACKAGE, "analysis", "baseline.json")


def find_repo_root(start: str | None = None) -> str:
    """Nearest ancestor of ``start``/cwd containing the
    ``theanompi_tpu_torch`` package; falls back to the checkout this
    module itself was imported from (so ``tmlint`` works from any cwd)."""
    d = os.path.abspath(start or os.getcwd())
    while True:
        if os.path.isdir(os.path.join(d, PACKAGE)):
            return d
        parent = os.path.dirname(d)
        if parent == d:
            break
        d = parent
    own = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    if os.path.isdir(os.path.join(own, PACKAGE)):
        return own
    raise SystemExit(
        f"tmlint: cannot find a {PACKAGE} package above "
        f"{start or os.getcwd()} (use --root)")


def run_checks(repo_root: str, checks: list[str] | None = None,
               package: str = PACKAGE,
               doc_path: str | None = None) -> list[Finding]:
    """Run the selected checkers over ``<repo_root>/<package>``."""
    checks = checks or list(_CHECKERS)
    files = list(iter_source_files(
        os.path.join(repo_root, package), repo_root))
    doc = doc_path if doc_path is not None else os.path.join(
        repo_root, site_coverage.CATALOG)
    findings: list[Finding] = []
    if "guarded_by" in checks:
        findings.extend(guarded_by.run(files))
    if "donation" in checks:
        findings.extend(donation.run(files))
    if "jit_hygiene" in checks:
        findings.extend(jit_hygiene.run(files))
    if "site_coverage" in checks:
        findings.extend(site_coverage.run(
            files, doc, os.path.relpath(doc, repo_root).replace(
                os.sep, "/")))
    findings.sort(key=lambda f: (f.path, f.line, f.check_id))
    return findings


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="tmlint",
        description="static checker suite over theanompi_tpu_torch")
    ap.add_argument("--root", default=None,
                    help="repo root (default: nearest ancestor with a "
                         "theanompi_tpu_torch package)")
    ap.add_argument("--checks", default=None,
                    help=f"comma-separated subset of "
                         f"{','.join(_CHECKERS)}")
    ap.add_argument("--format", choices=("text", "json"), default="text")
    ap.add_argument("--gate", action="store_true",
                    help="fail (exit 1) on findings not in the "
                         "baseline; stale baseline keys warn")
    ap.add_argument("--write-baseline", action="store_true",
                    help="accept current findings as the baseline")
    ap.add_argument("--baseline", default=None,
                    help=f"baseline path (default: <root>/{BASELINE})")
    ap.add_argument("--inventory", action="store_true",
                    help="print the metric/fault-site inventory as "
                         "markdown and exit")
    args = ap.parse_args(argv)

    t0 = time.monotonic()
    root = os.path.abspath(args.root) if args.root else find_repo_root()
    baseline_path = args.baseline or os.path.join(root, BASELINE)

    if args.inventory:
        files = list(iter_source_files(
            os.path.join(root, PACKAGE), root))
        sys.stdout.write(site_coverage.render_inventory(files))
        return 0

    checks = (args.checks.split(",") if args.checks else None)
    if checks:
        unknown = set(checks) - set(_CHECKERS)
        if unknown:
            ap.error(f"unknown checks: {sorted(unknown)}")
    findings = run_checks(root, checks)

    if args.write_baseline:
        old = load_baseline(baseline_path)
        write_baseline(baseline_path, findings, reasons=old)
        print(f"tmlint: wrote {len({f.key for f in findings})} "
              f"suppression(s) to "
              f"{os.path.relpath(baseline_path, root)}")
        return 0

    baseline = load_baseline(baseline_path)
    new, stale = split_by_baseline(findings, baseline)
    dt = time.monotonic() - t0

    if args.format == "json":
        print(json.dumps({
            "findings": [f.to_json() for f in findings],
            "new": [f.to_json() for f in new],
            "stale_baseline_keys": stale,
            "elapsed_s": round(dt, 3),
        }, indent=2))
    else:
        report = new if args.gate else findings
        for f in report:
            marker = "" if args.gate or f.key not in baseline \
                else " [baselined]"
            print(f.render() + marker)
        if checks is None or "donation" in checks:
            print(f"tmlint: {donation.WHY}")
        for key in stale:
            print(f"tmlint: warning: stale baseline entry '{key}' "
                  f"(no longer found; consider pruning)")
        by_id: dict[str, int] = {}
        for f in report:
            by_id[f.check_id] = by_id.get(f.check_id, 0) + 1
        summary = ", ".join(f"{cid} x{n} ({CHECK_IDS[cid]})"
                            for cid, n in sorted(by_id.items()))
        scope = "new " if args.gate else ""
        print(f"tmlint: {len(report)} {scope}finding(s)"
              + (f" [{summary}]" if summary else "")
              + f", {len(findings) - len(new)} baselined, "
                f"{dt:.1f}s")

    if args.gate and new:
        print("tmlint: GATE FAILED — fix the findings above or add a "
              f"documented suppression to {BASELINE}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
