"""TM101 — guarded-by lint for the threaded host plane.

Counterpart of ``theanompi_tpu/analysis/guarded_by.py``; the check is
framework-neutral and its findings are the JAX checker's, key for key.

Convention: a class that shares mutable state
between threads declares each shared attribute at its ``__init__``
assignment with a trailing comment::

    self._q = deque()        # guarded_by: self._cond
    self._restarts = {}      # guarded_by: self._lock

The checker then flags every ``self.<attr>`` read or write of a
declared attribute that is not lexically inside a ``with self.<lock>:``
block for the matching lock (``threading.Condition(self._lock)`` makes
``self._cond`` and ``self._lock`` aliases — either guards both).

Escapes:

* ``__init__`` / ``__post_init__`` / ``__new__`` are exempt — the
  constructor publishes the object before any other thread can see it;
* a method whose ``def`` line carries ``# requires_lock: self.<lock>``
  is analyzed as if that lock were held on entry (for helpers that are
  documented called-with-lock-held, e.g. ``MetricsRegistry._get``);
* ``# lint: ok TM101`` on the access line suppresses inline;
* anything left that is judged a false positive belongs in
  ``theanompi_tpu_torch/analysis/baseline.json`` with a reason.

The pass is purely lexical: it does not chase calls, so a helper that
*sometimes* runs under the lock must either take the lock itself or be
annotated.  That is the point — "sometimes locked" is the bug class.
"""

from __future__ import annotations

import ast
import re

from theanompi_tpu_torch.analysis.common import (
    Finding,
    SourceFile,
    dotted_name,
    make_key,
)

CHECK_ID = "TM101"

_DECL_RE = re.compile(r"#\s*guarded_by:\s*self\.(\w+)")
_REQUIRES_RE = re.compile(r"#\s*requires_lock:\s*self\.(\w+)")

_EXEMPT_METHODS = {"__init__", "__post_init__", "__new__"}

#: constructors that make one lock attribute an alias of another
#: (``self._cond = threading.Condition(self._lock)``)
_ALIAS_CALLS = ("Condition", "make_condition")


def _alias_groups(cls: ast.ClassDef) -> dict[str, str]:
    """attr name -> canonical lock name (union of Condition aliases)."""
    canon: dict[str, str] = {}
    for node in ast.walk(cls):
        if not isinstance(node, ast.Assign):
            continue
        if not (isinstance(node.value, ast.Call)):
            continue
        callee = dotted_name(node.value.func) or ""
        if callee.split(".")[-1] not in _ALIAS_CALLS:
            continue
        if not node.value.args:
            continue
        src = dotted_name(node.value.args[0])
        if src is None or not src.startswith("self."):
            continue
        src_attr = src.split(".", 1)[1]
        for tgt in node.targets:
            t = dotted_name(tgt)
            if t is not None and t.startswith("self."):
                tgt_attr = t.split(".", 1)[1]
                root = canon.get(src_attr, src_attr)
                canon[tgt_attr] = root
                canon.setdefault(src_attr, root)
    return canon


def _declared_guards(cls: ast.ClassDef, src: SourceFile,
                     canon: dict[str, str]) -> dict[str, str]:
    """Declared attr -> canonical guard name, from the trailing
    ``# guarded_by:`` comments on ``self.X = ...`` assignments."""
    guards: dict[str, str] = {}
    for node in ast.walk(cls):
        targets: list[ast.AST] = []
        if isinstance(node, ast.Assign):
            targets = list(node.targets)
        elif isinstance(node, (ast.AnnAssign, ast.AugAssign)):
            targets = [node.target]
        else:
            continue
        m = _DECL_RE.search(src.line(node.lineno)) \
            or _DECL_RE.search(src.line(getattr(node, "end_lineno",
                                                node.lineno)))
        if not m:
            continue
        lock = canon.get(m.group(1), m.group(1))
        for tgt in targets:
            d = dotted_name(tgt)
            if d is not None and d.startswith("self.") \
                    and d.count(".") == 1:
                guards[d.split(".", 1)[1]] = lock
    return guards


class _MethodChecker(ast.NodeVisitor):
    """Walk one method body tracking the lexically-held lock set."""

    def __init__(self, src: SourceFile, cls_name: str, method: str,
                 guards: dict[str, str], canon: dict[str, str],
                 held0: frozenset[str], findings: list[Finding]):
        self.src = src
        self.cls_name = cls_name
        self.method = method
        self.guards = guards
        self.canon = canon
        self.held = held0
        self.findings = findings
        self._reported: set[str] = set()

    def visit_With(self, node: ast.With) -> None:
        entered: set[str] = set()
        for item in node.items:
            d = dotted_name(item.context_expr)
            if d is not None and d.startswith("self.") \
                    and d.count(".") == 1:
                attr = d.split(".", 1)[1]
                entered.add(self.canon.get(attr, attr))
            # context exprs themselves (and optional vars) still get
            # visited for guarded-attr reads
            self.visit(item.context_expr)
        prev = self.held
        self.held = self.held | frozenset(entered)
        for stmt in node.body:
            self.visit(stmt)
        self.held = prev

    def visit_Attribute(self, node: ast.Attribute) -> None:
        if (isinstance(node.value, ast.Name) and node.value.id == "self"
                and node.attr in self.guards):
            lock = self.guards[node.attr]
            if lock not in self.held \
                    and not self.src.suppressed(node.lineno, CHECK_ID):
                kind = {ast.Store: "write", ast.Del: "delete"}.get(
                    type(node.ctx), "read")
                key = make_key(CHECK_ID, self.src.relpath,
                               f"{self.cls_name}.{self.method}",
                               node.attr)
                if key not in self._reported:
                    self._reported.add(key)
                    self.findings.append(Finding(
                        CHECK_ID, self.src.relpath, node.lineno,
                        f"{kind} of {self.cls_name}.{node.attr} "
                        f"(guarded_by self.{lock}) outside "
                        f"'with self.{lock}:'", key))
        self.generic_visit(node)


def check_file(src: SourceFile) -> list[Finding]:
    findings: list[Finding] = []
    for cls in [n for n in ast.walk(src.tree)
                if isinstance(n, ast.ClassDef)]:
        canon = _alias_groups(cls)
        guards = _declared_guards(cls, src, canon)
        if not guards:
            continue
        for meth in cls.body:
            if not isinstance(meth, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)):
                continue
            if meth.name in _EXEMPT_METHODS:
                continue
            held = set()
            m = _REQUIRES_RE.search(src.line(meth.lineno))
            if m:
                held.add(canon.get(m.group(1), m.group(1)))
            checker = _MethodChecker(src, cls.name, meth.name, guards,
                                     canon, frozenset(held), findings)
            for stmt in meth.body:
                checker.visit(stmt)
    return findings


def run(files: list[SourceFile]) -> list[Finding]:
    out: list[Finding] = []
    for src in files:
        out.extend(check_file(src))
    return out
