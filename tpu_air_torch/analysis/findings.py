"""Finding and severity types for airlint.

Pure stdlib — the analyzer must be importable (and fast) without torch, so it
can gate CI on machines with no accelerator stack at all.
"""

from __future__ import annotations

from dataclasses import dataclass, field


class Severity:
    ERROR = "error"
    WARNING = "warning"

    ORDER = {ERROR: 0, WARNING: 1}


@dataclass
class Finding:
    """One rule violation at a source location."""

    rule: str
    severity: str
    path: str
    line: int
    col: int
    message: str
    suppressed: bool = False
    suppress_reason: str = ""
    # schema v2: dataflow rules attach their evidence (lockset held at the
    # access, the call-path witness) so CI annotations can show the trace
    dataflow: dict = None

    def location(self) -> str:
        return f"{self.path}:{self.line}:{self.col}"

    def to_dict(self) -> dict:
        d = {
            "rule": self.rule,
            "severity": self.severity,
            "path": self.path,
            "line": self.line,
            "col": self.col,
            "message": self.message,
        }
        if self.dataflow:
            d["dataflow"] = self.dataflow
        if self.suppressed:
            d["suppressed"] = True
            d["suppress_reason"] = self.suppress_reason
        return d

    def sort_key(self):
        return (self.path, self.line, self.col, self.rule)


@dataclass
class FileReport:
    """All findings for one analyzed file (suppressed ones included)."""

    path: str
    findings: list = field(default_factory=list)

    @property
    def active(self):
        return [f for f in self.findings if not f.suppressed]

    @property
    def suppressed(self):
        return [f for f in self.findings if f.suppressed]
