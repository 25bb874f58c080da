"""Inline suppression comments.

Syntax (the reason is REQUIRED — a reason-less suppression is inert and is
itself reported as AL001)::

    x = f(x)  # airlint: disable=PT004 — the step's one host sync
    # airlint: disable=RT003,RT001 - standalone form covers the next line
    # airlint: disable-file=RT001 — whole-file scope (put near the top)

The separator before the reason may be an em-dash, hyphen(s), or colon.
A trailing suppression applies to its own physical line; a standalone
comment line applies to itself and the next code line; ``disable-file``
applies to every line of the file.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, List, Set, Tuple

from .findings import Finding
from .registry import META_RULES

_PATTERN = re.compile(
    r"airlint:\s*disable(?P<scope>-file)?\s*=\s*"
    r"(?P<rules>[A-Za-z0-9_]+(?:\s*,\s*[A-Za-z0-9_]+)*)"
    r"(?:\s*(?:[-—–:]+)\s*(?P<reason>\S.*))?"
)


@dataclass
class Suppression:
    line: int
    rules: Tuple[str, ...]
    reason: str
    file_level: bool
    applies_to: Set[int] = field(default_factory=set)
    used: bool = False


@dataclass
class SuppressionIndex:
    """Parsed suppressions for one file + the meta findings they generated."""

    suppressions: List[Suppression] = field(default_factory=list)
    meta_findings: List[Finding] = field(default_factory=list)
    _file_level: Set[str] = field(default_factory=set)
    _by_line: Dict[Tuple[str, int], Suppression] = field(default_factory=dict)

    def match(self, rule: str, line: int):
        """The suppression covering (rule, line), or None."""
        sup = self._by_line.get((rule, line))
        if sup is not None:
            return sup
        for s in self.suppressions:
            if s.file_level and s.reason and rule in s.rules:
                return s
        return None


def _next_code_line(ctx, line: int) -> int:
    lines = ctx.source.splitlines()
    nxt = line + 1
    while nxt <= len(lines) and (
        not lines[nxt - 1].strip() or ctx.comment_is_standalone(nxt)
    ):
        nxt += 1
    return nxt


def parse_suppressions(ctx, known_ids: Set[str]) -> SuppressionIndex:
    idx = SuppressionIndex()
    meta = idx.meta_findings
    for line, (col, text) in sorted(ctx.comments.items()):
        m = _PATTERN.search(text)
        if m is None:
            continue
        rules = tuple(r.strip() for r in m.group("rules").split(","))
        reason = (m.group("reason") or "").strip()
        file_level = m.group("scope") is not None
        sup = Suppression(line=line, rules=rules, reason=reason,
                          file_level=file_level)
        idx.suppressions.append(sup)
        for r in rules:
            if r not in known_ids:
                sev = META_RULES["AL002"].severity
                meta.append(Finding("AL002", sev, ctx.path, line, col,
                                    f"suppression names unknown rule {r!r}"))
        if not reason:
            sev = META_RULES["AL001"].severity
            meta.append(Finding(
                "AL001", sev, ctx.path, line, col,
                "suppression has no reason — write "
                f"'# airlint: disable={','.join(rules)} — <why>' "
                "(reason-less suppressions do not suppress)"))
            continue  # inert: it must not silence anything
        if file_level:
            idx._file_level.update(rules)
            continue
        covered = {line}
        if ctx.comment_is_standalone(line):
            covered.add(_next_code_line(ctx, line))
        # a decorated def/class is one statement: a suppression touching
        # any line of its decorator+header span covers the whole span
        # (findings land on the decorator line OR the def line)
        for start, end in ctx.decorated_spans():
            if any(start <= ln <= end for ln in covered):
                covered.update(range(start, end + 1))
        sup.applies_to = covered
        for r in rules:
            for ln in covered:
                idx._by_line[(r, ln)] = sup
    return idx


def apply_suppressions(idx: SuppressionIndex, findings: List[Finding]) -> None:
    """Mark findings covered by a (reasoned) suppression as suppressed."""
    for f in findings:
        if f.rule.startswith("AL"):
            continue  # meta findings about suppressions are never suppressed
        sup = idx.match(f.rule, f.line)
        if sup is not None:
            f.suppressed = True
            f.suppress_reason = sup.reason
            sup.used = True
