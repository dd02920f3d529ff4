"""Source-level duplicate-definition lint.

``core/lutmap.py`` and ``synth/lutmap.py`` historically each carried
their own copy of the LUT cost model (k, per-level delay, the
tree-decomposition LUT count) — and the two drifted. The cost model now
lives once in ``core/lutcost.py``; this lint keeps it that way by
scanning every module under ``src/repro_torch`` and flagging any *watchlist*
symbol that is **defined** (def/class/assignment — imports don't count)
in more than one module.

The watchlist is deliberately small: these are the symbols whose
duplication has already bitten once. Growing it is the cheap way to
pin future de-duplications.
"""
from __future__ import annotations

import ast
import pathlib
from typing import Dict, Iterable, List, Optional, Tuple

from .report import CheckReport

PASS = "srclint"

_REPO_ROOT = pathlib.Path(__file__).resolve().parents[3]
SRC_DIR = _REPO_ROOT / "src" / "repro_torch"

# symbols that must have exactly one defining module
WATCHLIST = (
    "MapReport",
    "logicnets_lut_cost",
    "tree_lut_cost",
    "LUT_K",
    "T_LEVEL_NS",
    "T_FF_NS",
)


def _definitions(tree: ast.Module) -> List[Tuple[str, int]]:
    """(name, lineno) for every top-level def/class/constant assignment."""
    out = []
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            out.append((node.name, node.lineno))
        elif isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    out.append((t.id, node.lineno))
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            if isinstance(node.target, ast.Name):
                out.append((node.target.id, node.lineno))
    return out


def check_duplicate_definitions(src_dir: Optional[pathlib.Path] = None,
                                watchlist: Iterable[str] = WATCHLIST,
                                name: str = "srclint") -> CheckReport:
    rep = CheckReport(name)
    root = pathlib.Path(src_dir) if src_dir else SRC_DIR
    watch = set(watchlist)
    sites: Dict[str, List[str]] = {w: [] for w in watch}
    for path in sorted(root.rglob("*.py")):
        try:
            tree = ast.parse(path.read_text(), filename=str(path))
        except SyntaxError as e:
            rep.error(PASS, "syntax", f"cannot parse {path.name}: {e}",
                      where=path.name)
            continue
        rel = path.relative_to(root.parent).as_posix()
        for dname, line in _definitions(tree):
            if dname in watch:
                sites[dname].append(f"{rel}:{line}")
    for sym in sorted(watch):
        rep.checked += 1
        if len(sites[sym]) > 1:
            rep.error(PASS, "duplicate-definition",
                      f"'{sym}' is defined in {len(sites[sym])} modules "
                      f"({', '.join(sites[sym])}) — keep one definition "
                      f"and import it", where=sym)
    rep.info["watchlist"] = sorted(watch)
    return rep
