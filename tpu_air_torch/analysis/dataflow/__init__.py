"""Interprocedural dataflow core for airlint.

A :class:`ProgramContext` spans every module of one analysis run: the
call graph (``callgraph``), the RacerD-style lockset analysis
(``lockset``) and the crash-consistency analysis (``crashflow``) are all
built lazily, once, and shared by the per-file rule invocations — rules
CC001–CC003, CS001–CS003 and FI001 just filter the program-wide result
down to the file being reported on.  (The JAX analyzer's jit-boundary
and shape analyses have no counterpart here: eager PyTorch has no trace.)

``analyze_paths`` attaches one shared ProgramContext to every
ModuleContext; ``analyze_source`` (single-string entry point, used by the
fixture tests) builds a single-module program on the fly, so every rule
works identically in both modes.  Pure stdlib throughout.
"""

from __future__ import annotations

import os
from typing import Dict, Iterable, List, Optional, Set

from ..context import ModuleContext
from ..findings import Finding
from ..registry import get_rule
from .callgraph import CallGraph, module_name  # noqa: F401 — re-export
from .crashflow import CrashFlowAnalysis
from .lockset import LocksetAnalysis, RawFinding

# which program analysis produces each dataflow-backed rule's findings
_ANALYSIS_FOR_RULE = {
    "CS001": "crashflow", "CS002": "crashflow", "CS003": "crashflow",
    "FI001": "crashflow",
}


class ProgramContext:
    """All modules of one analysis run + lazily-built program analyses."""

    def __init__(self, contexts: Iterable[ModuleContext]):
        self.contexts: List[ModuleContext] = sorted(
            contexts, key=lambda c: c.path)
        self._by_path: Dict[str, ModuleContext] = {
            os.path.normpath(c.path): c for c in self.contexts}
        self._callgraph: Optional[CallGraph] = None
        self._lockset: Optional[LocksetAnalysis] = None
        self._crashflow: Optional[CrashFlowAnalysis] = None

    @property
    def callgraph(self) -> CallGraph:
        if self._callgraph is None:
            self._callgraph = CallGraph(self.contexts)
        return self._callgraph

    @property
    def lockset(self) -> LocksetAnalysis:
        if self._lockset is None:
            self._lockset = LocksetAnalysis(self.callgraph)
            self._lockset.run()
        return self._lockset

    @property
    def crashflow(self) -> CrashFlowAnalysis:
        if self._crashflow is None:
            self._crashflow = CrashFlowAnalysis(self.callgraph)
            self._crashflow.run()
        return self._crashflow

    def module(self, path: str) -> Optional[ModuleContext]:
        return self._by_path.get(os.path.normpath(path))

    # -- findings ------------------------------------------------------------
    def findings_for(self, path: str, rule_id: str) -> List[Finding]:
        """Program-analysis findings of one rule, restricted to ``path``."""
        analysis = _ANALYSIS_FOR_RULE.get(rule_id, "lockset")
        raw = getattr(self, analysis).findings
        norm = os.path.normpath(path)
        return [_to_finding(r) for r in raw
                if r.rule == rule_id and os.path.normpath(r.path) == norm]

    # -- incremental-mode support --------------------------------------------
    def dependent_closure(self, changed: Iterable[str]) -> Set[str]:
        """``changed`` plus every file sharing a (resolved) call edge with
        a changed file, in either direction — the files whose findings can
        shift when the changed files change.  Paths are normalized."""
        changed_n = {os.path.normpath(p) for p in changed}
        out = set(changed_n)
        cg = self.callgraph
        for fn in cg.functions:
            src = os.path.normpath(fn.ctx.path)
            for site in cg.call_sites(fn):
                if site.callee is None:
                    continue
                dst = os.path.normpath(site.callee.ctx.path)
                if src == dst:
                    continue
                if dst in changed_n:
                    out.add(src)
                if src in changed_n:
                    out.add(dst)
        return out


def _to_finding(raw: RawFinding) -> Finding:
    r = get_rule(raw.rule)
    f = Finding(rule=raw.rule, severity=r.severity, path=raw.path,
                line=getattr(raw.node, "lineno", 1),
                col=getattr(raw.node, "col_offset", 0),
                message=raw.message)
    f.dataflow = raw.dataflow
    return f


def ensure_program(ctx: ModuleContext) -> ProgramContext:
    """The program a rule should consult for ``ctx``: the attached one
    when analyze_paths built it, else a fresh single-module program."""
    prog = getattr(ctx, "program", None)
    if prog is None:
        prog = ProgramContext([ctx])
        ctx.program = prog
    return prog
