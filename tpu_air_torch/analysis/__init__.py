"""airlint for the PyTorch port — an AST-based hazard analyzer.

The port's classic failure modes are invisible until production: data
races between the engine's threads and its callers, blocking calls under
a lock, torn publishes, unperturbed cross-process boundaries, and
host-device syncs inside step and decode loops.  All of them are
*statically checkable* shapes in the AST, so airlint checks them — over
``tpu_air_torch/`` itself in tier-1 CI (tests/test_torch_analysis.py) and
over any tree via::

    python -m tpu_air_torch.analysis                    # human output
    python -m tpu_air_torch.analysis --json tpu_air_torch/   # rc=1 on findings

The families shared with the JAX package's analyzer (CC, RT, CS, FI and
the AL meta rules) keep their ids, severities and messages, so a
``# airlint: disable=...`` comment means the same under both; PT004 is the
PyTorch rule.  Rule catalog and suppression syntax: docs/ANALYSIS.md.
Pure stdlib: nothing here imports torch, and nothing touches a device.
"""

from __future__ import annotations

import os
from typing import Iterable, List, Optional

from .findings import FileReport, Finding, Severity  # noqa: F401 — re-export
from .registry import (  # noqa: F401 — re-export
    JAX_ONLY_RULES,
    META_RULES,
    Rule,
    all_rules,
    known_rule_ids,
    rule,
    select_rules,
)

# importing the rule modules populates the registry
from . import rules_runtime as _rules_runtime  # noqa: E402,F401
from . import rules_torch as _rules_torch  # noqa: E402,F401
from .context import ModuleContext
from .dataflow import ProgramContext
from .dataflow import rules_concurrency as _rules_cc  # noqa: E402,F401
from .dataflow import rules_crash as _rules_cs  # noqa: E402,F401
from .suppressions import apply_suppressions, parse_suppressions


def _parse_error_report(path: str, e: SyntaxError) -> FileReport:
    report = FileReport(path=path)
    report.findings.append(Finding(
        "AL000", Severity.ERROR, path, e.lineno or 1, e.offset or 0,
        f"file does not parse: {e.msg}"))
    return report


def _analyze_ctx(ctx: ModuleContext,
                 only: Optional[Iterable[str]] = None) -> FileReport:
    """Run the (selected) rule set over one already-parsed module."""
    report = FileReport(path=ctx.path)
    findings: List[Finding] = []
    for r in select_rules(only):
        findings.extend(r.check(ctx))
    # the JAX analyzer's ids are no typos: it reads the same comments
    idx = parse_suppressions(ctx, known_rule_ids() | set(JAX_ONLY_RULES))
    apply_suppressions(idx, findings)
    findings.extend(idx.meta_findings)
    report.findings = sorted(findings, key=Finding.sort_key)
    return report


def analyze_source(source: str, path: str = "<string>",
                   only: Optional[Iterable[str]] = None) -> FileReport:
    """Run the (selected) rule set over one source string.  The dataflow
    rules see a single-module program — cross-module resolution needs
    :func:`analyze_paths`."""
    try:
        ctx = ModuleContext(path, source)
    except SyntaxError as e:
        return _parse_error_report(path, e)
    ctx.program = ProgramContext([ctx])
    return _analyze_ctx(ctx, only)


def iter_python_files(paths: Iterable[str]) -> List[str]:
    out = []
    for path in paths:
        if os.path.isfile(path):
            out.append(path)
            continue
        for root, dirs, files in os.walk(path):
            dirs[:] = sorted(d for d in dirs
                             if not d.startswith(".") and d != "__pycache__")
            out.extend(os.path.join(root, f) for f in sorted(files)
                       if f.endswith(".py"))
    return out


def analyze_paths(paths: Iterable[str],
                  only: Optional[Iterable[str]] = None,
                  changed: Optional[Iterable[str]] = None
                  ) -> List[FileReport]:
    """Analyze every python file under ``paths`` with one shared
    :class:`ProgramContext` (so the dataflow rules resolve calls across
    modules).  With ``changed`` (an iterable of file paths), the whole
    tree still feeds the program context, but only changed files plus
    their call-graph dependents are rule-checked and reported — the
    ``--changed`` incremental mode."""
    files = iter_python_files(paths)
    parse_errors = {}
    contexts: List[ModuleContext] = []
    for fpath in files:
        with open(fpath, "r", encoding="utf-8") as f:
            source = f.read()
        try:
            contexts.append(ModuleContext(fpath, source))
        except SyntaxError as e:
            parse_errors[fpath] = _parse_error_report(fpath, e)
    program = ProgramContext(contexts)
    scope = None
    if changed is not None:
        scope = program.dependent_closure(changed)
    reports = []
    for fpath in files:
        in_scope = scope is None or os.path.normpath(fpath) in scope
        if fpath in parse_errors:
            if in_scope:
                reports.append(parse_errors[fpath])
            continue
        if not in_scope:
            continue
        ctx = program.module(fpath)
        ctx.program = program
        reports.append(_analyze_ctx(ctx, only=only))
    return reports
