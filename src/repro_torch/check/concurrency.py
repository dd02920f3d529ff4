"""Pass 4 — AST concurrency lint over the serving stack.

Two checks, both purely static:

**Lock discipline.** A class opts in by declaring a ``_GUARDED_BY``
dict-literal class attribute mapping field names to the lock attribute
that guards them::

    class MicroBatchScheduler:
        _GUARDED_BY = {"_stopping": "_cond", "_shutdown": "_cond"}

The lint then walks every method (except ``__init__``, which runs
before the object is shared) and flags any ``self.<field>`` load or
store that is not lexically inside a ``with self.<lock>:`` block for
the declared lock. Lexical nesting is a conservative approximation —
it cannot see a lock held by a caller — so helpers that *require* the
lock already held can be exempted by listing them in a
``_LOCKED_METHODS`` tuple class attribute (the lint then also checks
they are never called from an unlocked context within the class).

Fields that are *intentionally* unguarded (single-writer counters,
append-before-serving callback lists, racy-but-monotonic timestamps)
are declared in a ``_LOCK_FREE`` tuple — that records the decision in
code instead of leaving the field looking forgotten, and the lint
rejects a field listed in both ``_GUARDED_BY`` and ``_LOCK_FREE`` as a
conflicting annotation. Both annotations cover ``repro_torch.serve`` and the
shared-mutable classes of ``repro_torch.obs`` (windowed metrics, burn-rate
monitor, online profiler — all fed from scheduler/executor/client
threads concurrently).

**Reject-reason coverage.** Every constant on ``RejectReason`` must
have (a) a real code path in ``repro_torch.serve`` that raises/records it and
(b) at least one of the port's tests (``tests/test_torch_*.py``)
referencing it — a reason nothing can raise, or one no test pins down,
is dead policy.
"""
from __future__ import annotations

import ast
import pathlib
from typing import Dict, Iterable, List, Optional, Set, Tuple

from .report import CheckReport

PASS = "concurrency"

_REPO_ROOT = pathlib.Path(__file__).resolve().parents[3]
SERVE_DIR = _REPO_ROOT / "src" / "repro_torch" / "serve"
OBS_DIR = _REPO_ROOT / "src" / "repro_torch" / "obs"
TEST_DIR = _REPO_ROOT / "tests"
# the port's tests: tests/ also holds the reference package's, which
# name every reason of the reference's own scheduler
TEST_GLOB = "test_torch_*.py"
SERVE_FILES = ("sched.py", "replica.py", "aggregate.py")
OBS_FILES = ("window.py", "slo.py", "online.py")


# ---------------------------------------------------------------------------
# lock discipline
# ---------------------------------------------------------------------------

def _dict_literal(node: ast.AST) -> Optional[Dict[str, str]]:
    if not isinstance(node, ast.Dict):
        return None
    out = {}
    for k, v in zip(node.keys, node.values):
        if not (isinstance(k, ast.Constant) and isinstance(k.value, str)
                and isinstance(v, ast.Constant)
                and isinstance(v.value, str)):
            return None
        out[k.value] = v.value
    return out


def _str_tuple(node: ast.AST) -> Tuple[str, ...]:
    if isinstance(node, (ast.Tuple, ast.List)):
        return tuple(e.value for e in node.elts
                     if isinstance(e, ast.Constant)
                     and isinstance(e.value, str))
    return ()


def _self_attr(node: ast.AST) -> Optional[str]:
    """``self.<name>`` -> name, else None."""
    if (isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "self"):
        return node.attr
    return None


class _MethodLockWalker(ast.NodeVisitor):
    """Collect guarded-field accesses with the set of self-locks held
    lexically at each access point."""

    def __init__(self, guarded: Dict[str, str]):
        self.guarded = guarded
        self.held: Set[str] = set()
        # (field, lock_required, lineno, held_snapshot)
        self.accesses: List[Tuple[str, str, int, Set[str]]] = []
        self.calls: List[Tuple[str, int, Set[str]]] = []  # self-method calls

    def visit_With(self, node: ast.With) -> None:
        locks = []
        for item in node.items:
            a = _self_attr(item.context_expr)
            if a is not None:
                locks.append(a)
        added = [a for a in locks if a not in self.held]
        self.held.update(added)
        for item in node.items:
            self.visit(item.context_expr)
        for stmt in node.body:
            self.visit(stmt)
        self.held.difference_update(added)

    def visit_Attribute(self, node: ast.Attribute) -> None:
        a = _self_attr(node)
        if a is not None and a in self.guarded:
            self.accesses.append((a, self.guarded[a], node.lineno,
                                  set(self.held)))
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call) -> None:
        a = _self_attr(node.func)
        if a is not None:
            self.calls.append((a, node.lineno, set(self.held)))
        self.generic_visit(node)

    # a nested function/lambda runs later, possibly without the lock —
    # treat its body as lock-free
    def _nested(self, node: ast.AST) -> None:
        saved, self.held = self.held, set()
        self.generic_visit(node)
        self.held = saved

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        self._nested(node)

    def visit_AsyncFunctionDef(self, node: ast.AsyncFunctionDef) -> None:
        self._nested(node)

    def visit_Lambda(self, node: ast.Lambda) -> None:
        self._nested(node)


def lint_class_locks(cls: ast.ClassDef, rep: CheckReport,
                     filename: str) -> None:
    guarded: Dict[str, str] = {}
    locked_methods: Tuple[str, ...] = ()
    lock_free: Tuple[str, ...] = ()
    for stmt in cls.body:
        if (isinstance(stmt, ast.Assign) and len(stmt.targets) == 1
                and isinstance(stmt.targets[0], ast.Name)):
            if stmt.targets[0].id == "_GUARDED_BY":
                d = _dict_literal(stmt.value)
                if d is None:
                    rep.error(PASS, "bad-annotation",
                              f"{cls.name}._GUARDED_BY must be a dict "
                              f"literal of 'field': 'lockattr' strings",
                              where=f"{filename}:{stmt.lineno}")
                    return
                guarded = d
            elif stmt.targets[0].id == "_LOCKED_METHODS":
                locked_methods = _str_tuple(stmt.value)
            elif stmt.targets[0].id == "_LOCK_FREE":
                lock_free = _str_tuple(stmt.value)
    for field in lock_free:
        rep.checked += 1
        if field in guarded:
            rep.error(PASS, "conflicting-annotation",
                      f"{cls.name}.{field} is listed in both _GUARDED_BY "
                      f"(lock {guarded[field]!r}) and _LOCK_FREE — pick "
                      f"one", where=f"{filename}:{cls.lineno}")
    if not guarded:
        return
    rep.info.setdefault("guarded_classes", []).append(cls.name)
    for meth in cls.body:
        if not isinstance(meth, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        if meth.name == "__init__":
            continue
        walker = _MethodLockWalker(guarded)
        # visit statements directly so the method def itself is not
        # treated as a nested (lock-clearing) function
        for stmt in meth.body:
            walker.visit(stmt)
        assume = meth.name in locked_methods
        for field, lock, line, held in walker.accesses:
            rep.checked += 1
            if assume or lock in held:
                continue
            rep.error(PASS, "unlocked-access",
                      f"{cls.name}.{meth.name} touches self.{field} "
                      f"outside 'with self.{lock}:' "
                      f"(declared guarded by _GUARDED_BY)",
                      where=f"{filename}:{line}")
        for callee, line, held in walker.calls:
            if callee in locked_methods and not assume:
                rep.checked += 1
                # every lock any guarded field of this class needs
                locks_needed = set(guarded.values())
                if not locks_needed & held:
                    rep.error(PASS, "unlocked-call",
                              f"{cls.name}.{meth.name} calls "
                              f"self.{callee}() (listed in "
                              f"_LOCKED_METHODS) without holding the "
                              f"lock", where=f"{filename}:{line}")


def lint_file_locks(path: pathlib.Path, rep: CheckReport) -> None:
    try:
        tree = ast.parse(path.read_text(), filename=str(path))
    except SyntaxError as e:
        rep.error(PASS, "syntax", f"cannot parse {path.name}: {e}",
                  where=path.name)
        return
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef):
            lint_class_locks(node, rep, path.name)


# ---------------------------------------------------------------------------
# RejectReason coverage
# ---------------------------------------------------------------------------

def _reject_reasons(sched_path: pathlib.Path) -> Dict[str, str]:
    """name -> string value of every constant on ``RejectReason``."""
    tree = ast.parse(sched_path.read_text(), filename=str(sched_path))
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef) and node.name == "RejectReason":
            out = {}
            for stmt in node.body:
                if (isinstance(stmt, ast.Assign)
                        and len(stmt.targets) == 1
                        and isinstance(stmt.targets[0], ast.Name)
                        and isinstance(stmt.value, ast.Constant)
                        and isinstance(stmt.value.value, str)):
                    out[stmt.targets[0].id] = stmt.value.value
            return out
    return {}


def _reason_refs(path: pathlib.Path, skip_class_def: bool) -> Set[str]:
    """Names referenced as ``RejectReason.<NAME>`` in a file."""
    try:
        tree = ast.parse(path.read_text(), filename=str(path))
    except SyntaxError:
        return set()
    refs: Set[str] = set()
    for node in ast.walk(tree):
        if (isinstance(node, ast.Attribute)
                and isinstance(node.value, ast.Name)
                and node.value.id == "RejectReason"):
            refs.add(node.attr)
    return refs


def check_reject_coverage(serve_dir: pathlib.Path, test_dir: pathlib.Path,
                          rep: CheckReport) -> None:
    sched = serve_dir / "sched.py"
    if not sched.exists():
        rep.error(PASS, "missing-file", f"{sched} not found")
        return
    reasons = _reject_reasons(sched)
    if not reasons:
        rep.error(PASS, "missing-class",
                  "no RejectReason constants found in sched.py")
        return
    rep.info["reject_reasons"] = sorted(reasons)
    code_refs: Set[str] = set()
    for p in sorted(serve_dir.glob("*.py")):
        code_refs |= _reason_refs(p, skip_class_def=True)
    test_refs: Set[str] = set()
    test_text = ""
    for p in sorted(test_dir.glob(TEST_GLOB)):
        test_refs |= _reason_refs(p, skip_class_def=False)
        test_text += p.read_text()
    for name, value in sorted(reasons.items()):
        rep.checked += 2
        if name not in code_refs:
            rep.error(PASS, "unraisable-reason",
                      f"RejectReason.{name} is declared but no serve/ "
                      f"code path references it", where=name)
        if name not in test_refs and value not in test_text:
            rep.error(PASS, "untested-reason",
                      f"RejectReason.{name} has no test referencing it "
                      f"(neither the attribute nor the string "
                      f"'{value}' appears under {test_dir.name}/)",
                      where=name)


# ---------------------------------------------------------------------------
# entry point
# ---------------------------------------------------------------------------

def check_concurrency(serve_dir: Optional[pathlib.Path] = None,
                      test_dir: Optional[pathlib.Path] = None,
                      files: Optional[Iterable[pathlib.Path]] = None,
                      name: str = "concurrency") -> CheckReport:
    """Run both concurrency checks over the serving stack (or, for
    tests, over an explicit ``files`` list with reason coverage skipped
    unless a serve_dir is given)."""
    rep = CheckReport(name)
    if files is not None:
        for p in files:
            lint_file_locks(pathlib.Path(p), rep)
        if serve_dir is None:
            return rep
    serve = pathlib.Path(serve_dir) if serve_dir else SERVE_DIR
    tests = pathlib.Path(test_dir) if test_dir else TEST_DIR
    if files is None:
        for fname in SERVE_FILES:
            p = serve / fname
            if p.exists():
                lint_file_locks(p, rep)
            else:
                rep.error(PASS, "missing-file", f"{p} not found")
        for fname in OBS_FILES:
            p = OBS_DIR / fname
            if p.exists():
                lint_file_locks(p, rep)
            else:
                rep.error(PASS, "missing-file", f"{p} not found")
    check_reject_coverage(serve, tests, rep)
    return rep
