"""Typed findings shared by every ``repro_torch.check`` pass.

A pass returns a ``CheckReport``: a list of ``Issue``s (error or
warning severity) plus a count of invariants/vectors it actually
examined, so "clean" is distinguishable from "didn't look". Equivalence
failures carry a ``Counterexample`` — the concrete PI bit pattern on
which the two stages disagree — because "not equivalent" without the
witness input is not actionable.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

ERROR = "error"
WARNING = "warning"


@dataclasses.dataclass(frozen=True)
class Counterexample:
    """A witness input on which two pipeline stages disagree."""

    inputs: Tuple[int, ...]      # one {0,1} bit per primary input wire
    output: int                  # index of the first mismatching output
    got: int                     # value produced by the stage under test
    want: int                    # value produced by the reference stage
    exhaustive: bool = False     # found during exhaustive enumeration
    formal: bool = False         # decoded from a SAT model (and replayed)

    def __str__(self) -> str:
        bits = "".join(str(b) for b in self.inputs)
        kind = ("SAT" if self.formal
                else "exhaustive" if self.exhaustive else "sampled")
        return (f"output[{self.output}]: got {self.got}, want {self.want} "
                f"on PI pattern [pi0..pi{len(self.inputs) - 1}]={bits} "
                f"({kind})")


@dataclasses.dataclass
class Issue:
    pass_name: str               # "lint" | "equiv" | "plan" | "concurrency"
    code: str                    # machine-readable, e.g. "init-width"
    message: str
    severity: str = ERROR
    where: str = ""              # LUT index, wire, file:line, ...
    counterexample: Optional[Counterexample] = None

    def __str__(self) -> str:
        loc = f" [{self.where}]" if self.where else ""
        cex = f"\n      counterexample: {self.counterexample}" \
            if self.counterexample else ""
        return (f"{self.severity.upper()} {self.pass_name}/{self.code}"
                f"{loc}: {self.message}{cex}")


@dataclasses.dataclass
class CheckReport:
    name: str
    issues: List[Issue] = dataclasses.field(default_factory=list)
    checked: int = 0             # invariants / vectors examined
    info: Dict[str, object] = dataclasses.field(default_factory=dict)

    def error(self, pass_name: str, code: str, message: str,
              where: str = "",
              counterexample: Optional[Counterexample] = None) -> None:
        self.issues.append(Issue(pass_name, code, message, ERROR, where,
                                 counterexample))

    def warn(self, pass_name: str, code: str, message: str,
             where: str = "") -> None:
        self.issues.append(Issue(pass_name, code, message, WARNING, where))

    @property
    def errors(self) -> List[Issue]:
        return [i for i in self.issues if i.severity == ERROR]

    @property
    def warnings(self) -> List[Issue]:
        return [i for i in self.issues if i.severity == WARNING]

    @property
    def ok(self) -> bool:
        """No error-severity findings (warnings do not fail a check)."""
        return not self.errors

    def merge(self, other: "CheckReport") -> "CheckReport":
        self.issues.extend(other.issues)
        self.checked += other.checked
        for k, v in other.info.items():
            self.info.setdefault(k, v)
        return self

    def format(self, verbose: bool = False) -> str:
        head = (f"[check] {self.name}: "
                f"{'OK' if self.ok else 'FAIL'} "
                f"({self.checked} checks, {len(self.errors)} error(s), "
                f"{len(self.warnings)} warning(s))")
        shown = self.issues if verbose else self.errors
        return "\n".join([head] + [f"  {i}" for i in shown])


class CheckFailure(RuntimeError):
    """Raised by ``verify=True`` entry points when a pass finds errors."""

    def __init__(self, report: CheckReport):
        super().__init__(report.format())
        self.report = report


def require_ok(report: CheckReport) -> CheckReport:
    if not report.ok:
        raise CheckFailure(report)
    return report
