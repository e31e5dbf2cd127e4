"""TM301/TM302 — step hygiene and pickle-reachability lints.

Counterpart of ``theanompi_tpu/analysis/jit_hygiene.py``.  TM302 is the
JAX checker's, key for key; TM301 is restated for PyTorch.

**TM301 (host sync in a function reachable from a step), restated.**
JAX's TM301 roots its call graph at what ``jax.jit``/``shard_map``/
``pallas_call`` trace, where a host sync fails or constant-folds.  The
port runs eagerly, so a host sync there is legal but stalls the host
until the card drains its queue: the step can no longer run ahead of
the device, and a later CUDA graph of the step cannot capture it.  The
pass builds a per-module call graph and roots it at

* ``forward`` of every ``nn.Module`` subclass (a class with a base
  named ``Module``, or a subclass of such a class in the same module);
* ``forward``/``backward`` of every ``torch.autograd.Function``
  subclass (a base named ``Function``);
* the step builders (module-level ``make_*step`` functions, e.g.
  ``parallel/bsp.py`` ``make_bsp_train_step``; the steps they return
  are nested in them and scanned with them);
* the decode programs: a function handed to the program runner
  ``DecodeSession._run``, and each method that calls it
  (``DecodeSession.decode``, ``verify``, ...: the step as the scheduler
  sees it, whose read-back of the tokens is the host sync a CUDA graph
  of the step would end on).

It flags, in any reachable function, ``.item()``, ``.cpu()``,
``.tolist()``, ``.numpy()`` (no arguments), ``torch.cuda.synchronize()``
and ``float()``/``int()``/``bool()`` of an expression that is not a
constant or shape-like (``.shape``, ``.ndim``, ``.size``, ``len()``,
``.numel()``, ``.dim()``: host values in PyTorch too).

Known limits, all lexical: a base class from another module is not
followed (a subclass of an imported ``nn.Module`` subclass is a root
only if one of its own bases is named ``Module``); calls are followed
within a module only; ``float()`` of a Python number that is not
written as a constant is flagged (baseline it with a reason); an
implicit ``bool`` (``if t:`` on a tensor) and ``print(t)`` are not seen.

**TM302 (unguarded pickle decode).**  ``pickle.loads``/``pickle.load``
executes arbitrary code from the payload.  Every pickle decode in the
package must sit in a function that first checks an ``allow_pickle``
flag and raises when it is off (the wire's ``_decode_node`` pattern), or
carry a baseline suppression with a reason (e.g. trusted local dataset
files).  ``np.load(..., allow_pickle=True)`` is flagged the same way.
"""

from __future__ import annotations

import ast
import re

from theanompi_tpu_torch.analysis.common import (
    Finding,
    SourceFile,
    call_name,
    dotted_name,
    make_key,
)

CHECK_HOST_SYNC = "TM301"
CHECK_PICKLE = "TM302"

#: method names (called with no arguments) that force a host sync
_HOST_SYNC_METHODS = {"item", "cpu", "tolist", "numpy"}
#: dotted call names that force a host sync
_HOST_SYNC_CALLS = {"torch.cuda.synchronize", "cuda.synchronize"}
_SCALAR_COERCIONS = {"float", "int", "bool"}
#: step builders: module-level functions named like ``make_bsp_train_step``
_BUILDER_RE = re.compile(r"^make_\w*step$")
#: the decode program runner: its function-valued arguments are programs
_PROGRAM_RUNNER = "_run"


def _is_shape_like(node: ast.AST) -> bool:
    """Host values in eager PyTorch: anything touching ``.shape``,
    ``.ndim``, ``.size``, ``len()``, ``.numel()``, ``.dim()``, or
    constants and arithmetic on them."""
    for sub in ast.walk(node):
        if isinstance(sub, ast.Attribute) and sub.attr in (
                "shape", "ndim", "size", "itemsize", "dtype"):
            return True
        if isinstance(sub, ast.Call):
            n = (dotted_name(sub.func) or "").split(".")[-1]
            if n in ("len", "numel", "dim"):
                return True
    return all(isinstance(s, (ast.Constant, ast.BinOp, ast.UnaryOp,
                              ast.operator, ast.unaryop, ast.expr_context))
               for s in ast.walk(node)) if isinstance(
                   node, (ast.Constant, ast.BinOp, ast.UnaryOp)) else False


# ---------------------------------------------------------------------------
# Call graph per module
# ---------------------------------------------------------------------------


class _Scope:
    """One function in the module graph."""

    def __init__(self, qual: str, node: ast.FunctionDef,
                 cls: str | None):
        self.qual = qual
        self.node = node
        self.cls = cls
        self.calls: set[str] = set()       # plain names called
        self.self_calls: set[str] = set()  # self.<m>() method calls


def _collect_scopes(src: SourceFile) -> dict[str, list[_Scope]]:
    """name -> scopes with that (unqualified) name in this module."""
    scopes: dict[str, list[_Scope]] = {}

    def visit(node: ast.AST, prefix: str, cls: str | None):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.ClassDef):
                visit(child, f"{prefix}{child.name}.", child.name)
            elif isinstance(child, (ast.FunctionDef,
                                    ast.AsyncFunctionDef)):
                sc = _Scope(f"{prefix}{child.name}", child, cls)
                scopes.setdefault(child.name, []).append(sc)
                for sub in ast.walk(child):
                    if isinstance(sub, ast.Call):
                        d = dotted_name(sub.func)
                        if d is None:
                            continue
                        if "." not in d:
                            sc.calls.add(d)
                        elif d.startswith("self.") and d.count(".") == 1:
                            sc.self_calls.add(d.split(".", 1)[1])
                visit(child, f"{prefix}{child.name}.", cls)
            else:
                visit(child, prefix, cls)

    visit(src.tree, "", None)
    return scopes


def _class_kinds(tree: ast.Module) -> dict[str, str]:
    """Class name -> ``"module"`` or ``"function"`` for the classes
    whose ``forward`` (and a Function's ``backward``) root the graph."""
    classes = [n for n in ast.walk(tree) if isinstance(n, ast.ClassDef)]
    kinds: dict[str, str] = {}
    changed = True
    while changed:
        changed = False
        for cls in classes:
            if cls.name in kinds:
                continue
            for base in cls.bases:
                last = (dotted_name(base) or "").split(".")[-1]
                kind = {"Module": "module", "Function": "function"}.get(
                    last) or kinds.get(last)
                if kind:
                    kinds[cls.name] = kind
                    changed = True
                    break
    return kinds


def _roots(src: SourceFile, scopes: dict[str, list[_Scope]]
           ) -> list[_Scope]:
    kinds = _class_kinds(src.tree)
    roots: list[_Scope] = []
    for name, scs in scopes.items():
        for sc in scs:
            kind = kinds.get(sc.cls) if sc.qual == f"{sc.cls}.{name}" \
                else None
            if name == "forward" and kind \
                    or name == "backward" and kind == "function" \
                    or sc.cls is None and sc.qual == name \
                    and _BUILDER_RE.match(name):
                roots.append(sc)
    for node in ast.walk(src.tree):
        if isinstance(node, ast.Call) and (call_name(node) or "").split(
                ".")[-1] == _PROGRAM_RUNNER:
            for arg in node.args:
                ref = dotted_name(arg)
                if ref is not None:
                    roots.extend(scopes.get(ref.split(".")[-1], []))
    roots.extend(sc for scs in scopes.values() for sc in scs
                 if _PROGRAM_RUNNER in sc.self_calls)
    return roots


def _reachable(scopes: dict[str, list[_Scope]],
               roots: list[_Scope]) -> list[_Scope]:
    seen: set[str] = set()
    work = list(roots)
    out: list[_Scope] = []
    while work:
        sc = work.pop()
        if sc.qual in seen:
            continue
        seen.add(sc.qual)
        out.append(sc)
        for callee in sc.calls | sc.self_calls:
            for nxt in scopes.get(callee, []):
                # self.m() resolves within the same class only
                if callee in sc.self_calls and nxt.cls != sc.cls \
                        and callee not in sc.calls:
                    continue
                work.append(nxt)
    return out


# ---------------------------------------------------------------------------
# TM301
# ---------------------------------------------------------------------------


def _sync_label(node: ast.Call) -> str | None:
    d = dotted_name(node.func)
    if d in _HOST_SYNC_CALLS:
        return f"{d}()"
    if isinstance(node.func, ast.Attribute) \
            and node.func.attr in _HOST_SYNC_METHODS \
            and not node.args and not node.keywords:
        return f".{node.func.attr}()"
    if d in _SCALAR_COERCIONS and node.args \
            and not isinstance(node.args[0], ast.Constant) \
            and not _is_shape_like(node.args[0]):
        return f"{d}()"
    return None


def check_host_sync(src: SourceFile) -> list[Finding]:
    scopes = _collect_scopes(src)
    roots = _roots(src, scopes)
    if not roots:
        return []
    findings: list[Finding] = []
    reported: set[str] = set()
    for sc in _reachable(scopes, roots):
        for node in ast.walk(sc.node):
            if not isinstance(node, ast.Call):
                continue
            label = _sync_label(node)
            if label is None \
                    or src.suppressed(node.lineno, CHECK_HOST_SYNC):
                continue
            key = make_key(CHECK_HOST_SYNC, src.relpath, sc.qual, label)
            if key in reported:
                continue
            reported.add(key)
            findings.append(Finding(
                CHECK_HOST_SYNC, src.relpath, node.lineno,
                f"host-sync {label} inside '{sc.qual}', which is "
                f"reachable from a step (a module's forward, an "
                f"autograd function, a step builder or a decode "
                f"program)", key))
    return findings


# ---------------------------------------------------------------------------
# TM302
# ---------------------------------------------------------------------------


def _has_allow_pickle_guard(fn: ast.AST) -> bool:
    for node in ast.walk(fn):
        if isinstance(node, ast.If):
            test_names = {dotted_name(s) or getattr(s, "attr", "")
                          for s in ast.walk(node.test)
                          if isinstance(s, (ast.Name, ast.Attribute))}
            if any("allow_pickle" in (n or "") for n in test_names):
                if any(isinstance(s, ast.Raise)
                       for s in ast.walk(node)):
                    return True
    return False


def check_pickle(src: SourceFile) -> list[Finding]:
    findings: list[Finding] = []
    # map each pickle decode to its innermost enclosing function
    def visit(node: ast.AST, fn_stack: list[ast.AST], qual: str):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                visit(child, fn_stack + [child], f"{qual}{child.name}.")
                continue
            if isinstance(child, ast.ClassDef):
                visit(child, fn_stack, f"{qual}{child.name}.")
                continue
            if isinstance(child, ast.Call):
                d = dotted_name(child.func) or ""
                flagged = None
                if d in ("pickle.loads", "pickle.load",
                         "cPickle.loads", "cPickle.load"):
                    flagged = d
                elif d.endswith(("np.load", "numpy.load")) or d == "np.load":
                    for kw in child.keywords:
                        if kw.arg == "allow_pickle" \
                                and isinstance(kw.value, ast.Constant) \
                                and kw.value.value is True:
                            flagged = f"{d}(allow_pickle=True)"
                if flagged and not src.suppressed(child.lineno,
                                                 CHECK_PICKLE):
                    guarded = any(_has_allow_pickle_guard(fn)
                                  for fn in fn_stack)
                    if not guarded:
                        scope = qual.rstrip(".") or "<module>"
                        key = make_key(CHECK_PICKLE, src.relpath, scope)
                        if not any(f.key == key for f in findings):
                            findings.append(Finding(
                                CHECK_PICKLE, src.relpath, child.lineno,
                                f"{flagged} in '{scope}' without an "
                                f"allow_pickle guard (wire-v2 servers "
                                f"decode with allow_pickle=False; "
                                f"arbitrary-code-execution surface)",
                                key))
            visit(child, fn_stack, qual)

    visit(src.tree, [], "")
    return findings


def run(files: list[SourceFile]) -> list[Finding]:
    out: list[Finding] = []
    for src in files:
        out.extend(check_host_sync(src))
        out.extend(check_pickle(src))
    return out
