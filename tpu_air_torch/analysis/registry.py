"""Pluggable rule registry.

A rule is a function ``check(ctx: ModuleContext) -> Iterable[Finding]``
registered with :func:`rule`.  Registration order is the report order for
ties; rule ids must be unique.  External plugins can call :func:`rule`
directly — the CLI discovers everything through :func:`all_rules`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Iterable, List, Optional

from .findings import Finding, Severity


@dataclass(frozen=True)
class Rule:
    id: str
    name: str
    severity: str
    rationale: str
    check: Callable
    example: Optional[str] = None  # minimal fires example (--explain)


_REGISTRY: Dict[str, Rule] = {}

# Meta rule ids emitted by the suppression parser itself (no check function):
# AL001 — suppression without a reason; AL002 — suppression of an unknown rule.
META_RULES = {
    "AL000": Rule("AL000", "parse-error", Severity.ERROR,
                  "a file that does not parse cannot be analyzed", None),
    "AL001": Rule("AL001", "suppression-without-reason", Severity.ERROR,
                  "every suppression must explain itself or it rots", None),
    "AL002": Rule("AL002", "suppression-of-unknown-rule", Severity.ERROR,
                  "a typoed rule id silently disables nothing", None),
}


# The JAX package's analyzer's rules that this one does not run, each with
# its counterpart or why it has none.  A suppression naming one is no typo
# — the JAX analyzer reads the same comments — so it is not AL002; here it
# silences nothing.
JAX_ONLY_RULES = {
    "JX001": "tracer-leak — eager PyTorch has no trace to leak from",
    "JX002": "use-after-donate — PyTorch has no buffer donation",
    "JX003": "recompile-hazard — the port compiles nothing per call: no jit",
    "JX004": "host-sync-in-hot-path — PT004 is its counterpart, over "
             "PyTorch's syncs",
    "JX005": "collective-outside-mapped-context — a torch.distributed "
             "collective names its process group; there is no mapped "
             "context (shard_map, pmap) to be outside of",
    "JX006": "jit-boundary-escape — eager PyTorch has no trace boundary",
    "JX007": "shape-polymorphic-jit — no jit, so a new shape costs no "
             "compile",
    "JX008": "sharding-axis-mismatch — queued in ROADMAP: the counterpart "
             "checks the axis names that parallel/sharding.py places "
             "against those parallel/mesh.py declares",
    "JX009": "donation-dropped — PyTorch has no buffer donation",
    "RT004": "non-static-static-arg — no jit, so no static arguments",
    "PL001": "vmem-overflow — the counterpart is a .cu launcher's "
             "shared-memory request, which a Python AST cannot read; the "
             "kernel build reports registers, shared memory and spills",
}


def rule(id: str, name: str, severity: str, rationale: str,
         example: Optional[str] = None):
    """Decorator: register ``check(ctx) -> Iterable[Finding]`` under ``id``."""

    def deco(fn):
        if id in _REGISTRY or id in META_RULES:
            raise ValueError(f"duplicate airlint rule id {id!r}")
        _REGISTRY[id] = Rule(id, name, severity, rationale, fn, example)
        return fn

    return deco


def all_rules() -> List[Rule]:
    return list(_REGISTRY.values())


def known_rule_ids() -> set:
    return set(_REGISTRY) | set(META_RULES)


def get_rule(rule_id: str) -> Rule:
    return _REGISTRY.get(rule_id) or META_RULES[rule_id]


def select_rules(only: Iterable[str] = None) -> List[Rule]:
    rules = all_rules()
    if only is None:
        return rules
    only = set(only)
    unknown = only - {r.id for r in rules}
    if unknown:
        raise KeyError(f"unknown rule id(s): {sorted(unknown)}")
    return [r for r in rules if r.id in only]


def make_finding(ctx, rule_id: str, node, message: str) -> Finding:
    """Finding at an AST node's location, severity from the registry."""
    r = get_rule(rule_id)
    return Finding(rule=rule_id, severity=r.severity, path=ctx.path,
                   line=getattr(node, "lineno", 1),
                   col=getattr(node, "col_offset", 0), message=message)
