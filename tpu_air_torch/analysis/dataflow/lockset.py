"""RacerD-style lockset analysis over the module call graph.

For every class with concurrency evidence — it spawns a thread at one of
its own methods (``threading.Thread(target=self.X)``), is registered as an
actor, or coordinates through lock fields — compute, interprocedurally,
the set of locks held at every ``self.field`` read/write, then report:

- **CC001**: a field accessed from more than one thread context under
  inconsistent (empty or disjoint) locksets, with at least one write.
- **CC002**: two locks acquired in both orders anywhere in the call graph
  (static deadlock), each direction witnessed.
- **CC003**: a blocking call (``time.sleep``, ``Event.wait``, ``socket``,
  ``subprocess``, queue/object-store gets, ``Thread.join``) reached while a
  lock is held, anchored at the frame that acquired the lock, with the
  call path as witness.

The lock abstraction is the *syntactic access path*, class-qualified:
``self._lock`` inside ``Scheduler`` is the key ``Scheduler._lock`` at every
use site, so two methods of one class (or a caller that resolves through a
typed field, e.g. ``self.scheduler.pop_admissible``) compare consistently.
Known unsoundness holes (documented in docs/ANALYSIS.md): distinct
instances of one class share a key, locks passed as call arguments are
unknown, dynamic dispatch is unresolved, and nested defs are skipped.
"""

from __future__ import annotations

import ast
import os
from collections import deque
from dataclasses import dataclass, field as dc_field
from typing import Dict, FrozenSet, List, Optional, Set, Tuple

from ..context import ModuleContext, dotted
from ..rules_runtime import _actor_classes
from .callgraph import (
    CallGraph,
    CallSite,
    ClassInfo,
    FunctionInfo,
    walk_scope,
)

_LOCK_CTORS = {"threading.Lock", "threading.RLock", "threading.Condition",
               "Lock", "RLock", "Condition"}
_EVENT_CTORS = {"threading.Event", "Event"}
_THREAD_CTORS = {"threading.Thread", "Thread"}
_QUEUE_CTORS = {"queue.Queue", "queue.SimpleQueue", "queue.LifoQueue",
                "queue.PriorityQueue", "Queue", "SimpleQueue"}
_SEMAPHORE_CTORS = {"threading.Semaphore", "threading.BoundedSemaphore",
                    "Semaphore", "BoundedSemaphore"}
# internally-synchronized primitives: never race candidates themselves
_SYNC_CTORS = (_LOCK_CTORS | _EVENT_CTORS | _THREAD_CTORS | _QUEUE_CTORS
               | _SEMAPHORE_CTORS)

_BLOCKING_EXACT = {"time.sleep", "os.system", "input", "core_api.get"}
_BLOCKING_PREFIX = ("subprocess.", "socket.", "requests.",
                    "urllib.request.")
_BLOCKING_QNAME_SUFFIX = (".api.get", ".object_store.get")

# method calls that mutate the receiver in place
_MUTATORS = {"append", "appendleft", "extend", "extendleft", "add", "update",
             "insert", "remove", "discard", "pop", "popleft", "popitem",
             "clear", "setdefault", "sort", "reverse", "rotate"}

_STATE_CAP = 30000      # total propagation states (runaway guard)
_PER_FN_CAP = 12        # distinct entry locksets propagated per function


@dataclass
class Access:
    field: str
    kind: str               # "read" | "write"
    node: ast.AST
    held: FrozenSet[str]    # locks held locally at the access


@dataclass
class FnSummary:
    fn: FunctionInfo
    accesses: List[Access] = dc_field(default_factory=list)
    calls: List[Tuple[CallSite, FrozenSet[str]]] = dc_field(default_factory=list)
    acquisitions: List[Tuple[str, ast.AST, Tuple[str, ...]]] = \
        dc_field(default_factory=list)
    acquired: Set[str] = dc_field(default_factory=set)


@dataclass
class ClassModel:
    ci: ClassInfo
    mode: Optional[str]           # "threads" | "locks" | None
    lock_fields: Set[str]
    sync_fields: Set[str]
    thread_targets: Set[str]
    init_only: Set[str] = dc_field(default_factory=set)
    # private helpers used by same-class code: analyzed only as reached
    # from real entries, never as independent external entry points
    internal: Set[str] = dc_field(default_factory=set)


@dataclass
class Record:
    kind: str
    node: ast.AST
    locks: FrozenSet[str]
    tag: str                      # "thread" | "ext"
    path: Tuple[str, ...]
    fn: FunctionInfo


@dataclass
class RawFinding:
    rule: str
    path: str
    node: ast.AST
    message: str
    dataflow: dict


def _display(fn: FunctionInfo) -> str:
    if fn.cls is not None:
        return f"{fn.cls.name}.{fn.name}"
    return f"{fn.modname.rsplit('.', 1)[-1]}.{fn.name}"


def _loc(fn: FunctionInfo, node: ast.AST) -> str:
    return f"{os.path.basename(fn.ctx.path)}:{node.lineno}"


def _fmt_locks(locks) -> str:
    return "{" + ", ".join(sorted(locks)) + "}" if locks else "{}"


class LocksetAnalysis:
    """One pass over a call graph; produces CC001/CC002/CC003 findings."""

    def __init__(self, cg: CallGraph):
        self.cg = cg
        self._summaries: Dict[str, FnSummary] = {}
        self._models: Dict[str, ClassModel] = {}
        self._module_locks: Dict[Tuple[str, str], str] = {}
        self._module_events: Set[Tuple[str, str]] = set()
        self._actor_names: Dict[str, Set[str]] = {}
        self._blocking_memo: Dict[str, Optional[List[str]]] = {}
        self._acquires_memo: Dict[str, Dict[str, ast.AST]] = {}
        self.findings: List[RawFinding] = []
        self._ran = False

    # -- public --------------------------------------------------------------
    def run(self) -> List[RawFinding]:
        if self._ran:
            return self.findings
        self._ran = True
        self._build_tables()
        self._propagate()
        return self.findings

    # -- tables --------------------------------------------------------------
    def _build_tables(self) -> None:
        for (modname, gname), ctor in self.cg.global_ctors.items():
            if ctor in _LOCK_CTORS:
                self._module_locks[(modname, gname)] = f"{modname}:{gname}"
            elif ctor in _EVENT_CTORS:
                self._module_events.add((modname, gname))
        for modname, ctx in self.cg.modules.items():
            self._actor_names[modname] = {
                c.name for c in _actor_classes(ctx)}
        for ci in self.cg.classes.values():
            self._models[ci.qname] = self._build_model(ci)
        for model in self._models.values():
            model.init_only = self._init_only(model)
            model.internal = self._internal_privates(model)

    def _build_model(self, ci: ClassInfo) -> ClassModel:
        lock_fields = {f for f, c in ci.field_ctors.items()
                       if c in _LOCK_CTORS}
        sync_fields = {f for f, c in ci.field_ctors.items()
                       if c in _SYNC_CTORS}
        targets: Set[str] = set()
        for m in ci.methods.values():
            for node in walk_scope(m.node):
                if not (isinstance(node, ast.Call)
                        and dotted(node.func) in _THREAD_CTORS):
                    continue
                cands = [kw.value for kw in node.keywords
                         if kw.arg == "target"]
                if not cands and node.args:
                    cands = [node.args[0]]
                for cand in cands:
                    d = dotted(cand)
                    if d and d.startswith("self.") and d.count(".") == 1:
                        name = d.split(".", 1)[1]
                        if name in ci.methods:
                            targets.add(name)
        is_actor = ci.name in self._actor_names.get(ci.modname, set())
        if targets:
            mode = "threads"
        elif lock_fields or is_actor:
            mode = "locks"
        else:
            mode = None
        return ClassModel(ci, mode, lock_fields, sync_fields, targets)

    def _init_only(self, model: ClassModel) -> Set[str]:
        """Methods reachable only from ``__init__`` (construction-time
        happens-before: their accesses are not race candidates)."""
        ci = model.ci
        callers: Dict[str, Set[str]] = {m: set() for m in ci.methods}
        for m in ci.methods.values():
            for site in self.cg.call_sites(m):
                if (site.callee is not None and site.callee.cls is ci
                        and site.callee.name in callers):
                    callers[site.callee.name].add(m.name)
        init_only: Set[str] = set()
        changed = True
        while changed:
            changed = False
            for name, froms in callers.items():
                if (name != "__init__" and name not in init_only
                        and name not in model.thread_targets and froms
                        and all(f == "__init__" or f in init_only
                                for f in froms)):
                    init_only.add(name)
                    changed = True
        return init_only

    def _internal_privates(self, model: ClassModel) -> Set[str]:
        """Private (``_x``) methods referenced by same-class code: internal
        implementation whose concurrency discipline is owned by their
        callers, so they are not independent external entry points."""
        ci = model.ci
        referenced: Set[str] = set()
        for m in ci.methods.values():
            for node in walk_scope(m.node):
                if (isinstance(node, ast.Attribute)
                        and isinstance(node.value, ast.Name)
                        and node.value.id == "self"
                        and node.attr in ci.methods):
                    referenced.add(node.attr)
        return {name for name in referenced
                if name.startswith("_") and not name.startswith("__")}

    # -- per-function summaries ---------------------------------------------
    def _summary(self, fn: FunctionInfo) -> FnSummary:
        s = self._summaries.get(fn.qname)
        if s is None:
            s = FnSummary(fn)
            self._walk_block(fn, fn.node.body, (), s)
            self._summaries[fn.qname] = s
        return s

    def _lock_key(self, fn: FunctionInfo, expr: ast.AST) -> Optional[str]:
        d = dotted(expr)
        if d is None:
            return None
        parts = d.split(".")
        if parts[0] == "self" and fn.cls is not None and len(parts) == 2:
            model = self._models.get(fn.cls.qname)
            if model and parts[1] in model.lock_fields:
                return f"{fn.cls.name}.{parts[1]}"
            return None
        if len(parts) == 1:
            return self._module_locks.get((fn.modname, d))
        ent = self.cg._resolve_in_module(fn.modname, parts[0])
        if ent and ent[0] == "instance" and len(parts) == 2:
            model = self._models.get(ent[1].qname)
            if model and parts[1] in model.lock_fields:
                return f"{ent[1].name}.{parts[1]}"
        # fallback: lock-named access path on a local (rt.lock, handle._lock)
        if "lock" in parts[-1].lower() or "mutex" in parts[-1].lower():
            return f"{fn.modname}:{d}"
        return None

    def _walk_block(self, fn: FunctionInfo, stmts, held: Tuple[str, ...],
                    s: FnSummary) -> None:
        cur: List[str] = list(held)
        for stmt in stmts:
            if isinstance(stmt, (ast.With, ast.AsyncWith)):
                inner = list(cur)
                for item in stmt.items:
                    self._record(fn, item.context_expr, tuple(cur), s)
                    key = self._lock_key(fn, item.context_expr)
                    if key is not None and key not in inner:
                        s.acquisitions.append((key, stmt, tuple(inner)))
                        s.acquired.add(key)
                        inner.append(key)
                self._walk_block(fn, stmt.body, tuple(inner), s)
            elif isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                                   ast.ClassDef)):
                continue  # nested scope runs in another dynamic context
            elif isinstance(stmt, ast.Try):
                for blk in (stmt.body, stmt.orelse, stmt.finalbody):
                    self._walk_block(fn, blk, tuple(cur), s)
                for h in stmt.handlers:
                    self._walk_block(fn, h.body, tuple(cur), s)
            elif isinstance(stmt, (ast.If, ast.While)):
                self._record(fn, stmt.test, tuple(cur), s)
                self._walk_block(fn, stmt.body, tuple(cur), s)
                self._walk_block(fn, stmt.orelse, tuple(cur), s)
            elif isinstance(stmt, (ast.For, ast.AsyncFor)):
                self._record(fn, stmt.iter, tuple(cur), s)
                self._record(fn, stmt.target, tuple(cur), s)
                self._walk_block(fn, stmt.body, tuple(cur), s)
                self._walk_block(fn, stmt.orelse, tuple(cur), s)
            else:
                key = self._acquire_release(fn, stmt)
                if key is not None:
                    op, k = key
                    if op == "acquire" and k not in cur:
                        self._record(fn, stmt, tuple(cur), s)
                        s.acquisitions.append((k, stmt, tuple(cur)))
                        s.acquired.add(k)
                        cur.append(k)
                        continue
                    if op == "release" and k in cur:
                        cur.remove(k)
                self._record(fn, stmt, tuple(cur), s)

    def _acquire_release(self, fn, stmt) -> Optional[Tuple[str, str]]:
        if not (isinstance(stmt, ast.Expr)
                and isinstance(stmt.value, ast.Call)):
            return None
        func = stmt.value.func
        if (not isinstance(func, ast.Attribute)
                or func.attr not in ("acquire", "release")):
            return None
        key = self._lock_key(fn, func.value)
        return (func.attr, key) if key is not None else None

    def _record(self, fn: FunctionInfo, node: ast.AST,
                held: Tuple[str, ...], s: FnSummary) -> None:
        """Collect self-field accesses and calls under ``node``."""
        fheld = frozenset(held)
        model = self._models.get(fn.cls.qname) if fn.cls else None
        for sub in [node] + list(walk_scope(node)):
            if (model is not None and isinstance(sub, ast.Attribute)
                    and isinstance(sub.value, ast.Name)
                    and sub.value.id == "self"):
                fname = sub.attr
                if (fname in model.sync_fields or fname in model.lock_fields
                        or fname in model.ci.methods):
                    continue
                kind = self._access_kind(fn.ctx, sub)
                if kind is not None:
                    s.accesses.append(Access(fname, kind, sub, fheld))
            elif isinstance(sub, ast.Call):
                s.calls.append((self.cg.resolve_call(fn, sub), fheld))

    @staticmethod
    def _access_kind(ctx: ModuleContext, node: ast.Attribute) -> Optional[str]:
        if isinstance(node.ctx, (ast.Store, ast.Del)):
            return "write"
        cur, parent = node, ctx.parent(node)
        while isinstance(parent, ast.Subscript) and parent.value is cur:
            if isinstance(parent.ctx, (ast.Store, ast.Del)):
                return "write"
            cur, parent = parent, ctx.parent(parent)
        if isinstance(parent, ast.Attribute) and parent.value is cur:
            if isinstance(parent.ctx, (ast.Store, ast.Del)):
                return "write"
            gp = ctx.parent(parent)
            if (isinstance(gp, ast.Call) and gp.func is parent
                    and parent.attr in _MUTATORS):
                return "write"
            return None  # self.a.b read — attribute of field, not the field
        return "read"

    # -- transitive summaries ------------------------------------------------
    def _blocking_name(self, fn: FunctionInfo,
                       site: CallSite) -> Optional[str]:
        name = site.name
        if name in _BLOCKING_EXACT or name.startswith(_BLOCKING_PREFIX):
            return name
        if site.callee is not None and any(
                site.callee.qname.endswith(sfx)
                for sfx in _BLOCKING_QNAME_SUFFIX):
            return name
        base, _, attr = name.rpartition(".")
        if not base:
            return None
        if attr in ("wait", "join", "get"):
            ctor = self._base_ctor(fn, base)
            if attr == "wait" and ctor in _EVENT_CTORS:
                return name
            if attr == "join" and ctor in _THREAD_CTORS:
                return name
            if attr == "get" and ctor in _QUEUE_CTORS:
                return name
        return None

    def _base_ctor(self, fn: FunctionInfo, base: str) -> Optional[str]:
        parts = base.split(".")
        if parts[0] == "self" and fn.cls is not None and len(parts) == 2:
            return fn.cls.field_ctors.get(parts[1])
        if len(parts) == 1:
            if (fn.modname, base) in self._module_events:
                return "threading.Event"
            return self.cg.global_ctors.get((fn.modname, base))
        return None

    def _blocking_path(self, fn: FunctionInfo,
                       _stack: Tuple[str, ...] = ()) -> Optional[List[str]]:
        """First chain of callee names from ``fn`` to a blocking call, or
        None when nothing reachable from ``fn`` blocks."""
        if fn.qname in self._blocking_memo:
            return self._blocking_memo[fn.qname]
        if fn.qname in _stack or len(_stack) > 8:
            return None
        stack = _stack + (fn.qname,)
        result: Optional[List[str]] = None
        for site, _held in self._summary(fn).calls:
            direct = self._blocking_name(fn, site)
            if direct is not None:
                result = [f"{direct} @ {_loc(fn, site.node)}"]
                break
            if site.callee is not None:
                sub = self._blocking_path(site.callee, stack)
                if sub is not None:
                    result = [_display(site.callee)] + sub
                    break
        self._blocking_memo[fn.qname] = result
        return result

    def _acquires(self, fn: FunctionInfo,
                  _stack: Tuple[str, ...] = ()) -> Dict[str, ast.AST]:
        """Locks acquired by ``fn`` or anything it (resolvably) calls."""
        if fn.qname in self._acquires_memo:
            return self._acquires_memo[fn.qname]
        if fn.qname in _stack or len(_stack) > 8:
            return {}
        stack = _stack + (fn.qname,)
        out: Dict[str, ast.AST] = {}
        s = self._summary(fn)
        for key, node, _held in s.acquisitions:
            out.setdefault(key, node)
        for site, _held in s.calls:
            if site.callee is not None:
                for key, node in self._acquires(site.callee, stack).items():
                    out.setdefault(key, node)
        self._acquires_memo[fn.qname] = out
        return out

    # -- propagation ---------------------------------------------------------
    def _roots(self) -> List[Tuple[FunctionInfo, FrozenSet[str], str]]:
        roots = []
        for model in self._models.values():
            if model.mode is None:
                continue
            for name, m in sorted(model.ci.methods.items()):
                if name == "__init__":
                    roots.append((m, frozenset(), "init"))
                elif name in model.thread_targets:
                    roots.append((m, frozenset(), "thread"))
                elif name in model.init_only or name in model.internal:
                    continue
                else:
                    roots.append((m, frozenset(), "ext"))
        for fn in self.cg.functions:
            if fn.cls is None:
                roots.append((fn, frozenset(), "ext"))
        return roots

    def _propagate(self) -> None:
        records: Dict[str, Dict[str, List[Record]]] = {}
        rec_seen: Set[Tuple] = set()
        edges: Dict[Tuple[str, str], Tuple[ast.AST, FunctionInfo,
                                           Tuple[str, ...]]] = {}
        cc3_seen: Set[Tuple] = set()
        state_seen: Set[Tuple] = set()
        per_fn: Dict[str, int] = {}
        queue = deque()
        for fn, locks, tag in self._roots():
            state = (fn.qname, locks, tag)
            if state not in state_seen:
                state_seen.add(state)
                queue.append((fn, locks, tag, (_display(fn),)))
        indexed = {f.qname for f in self.cg.functions}
        while queue and len(state_seen) < _STATE_CAP:
            fn, locks, tag, path = queue.popleft()
            s = self._summary(fn)
            model = self._models.get(fn.cls.qname) if fn.cls else None
            recording = (
                tag != "init" and model is not None and model.mode is not None
                and fn.name != "__init__" and fn.name not in model.init_only)
            if recording:
                for acc in s.accesses:
                    eff = acc.held | locks
                    key = (fn.qname, acc.node.lineno, acc.node.col_offset,
                           eff, tag, acc.kind)
                    if key in rec_seen:
                        continue
                    rec_seen.add(key)
                    records.setdefault(fn.cls.qname, {}).setdefault(
                        acc.field, []).append(
                            Record(acc.kind, acc.node, eff, tag, path, fn))
            for lock, node, held_at in s.acquisitions:
                # order edges come from locks held on entry (caller frames)
                # AND locks this frame already took itself
                for h in locks | frozenset(held_at):
                    if h != lock:
                        edges.setdefault((h, lock), (node, fn, path))
            for site, held in s.calls:
                eff = locks | held
                if held:  # this frame holds a lock it acquired itself
                    self._check_blocking(fn, site, held, path, cc3_seen)
                    if site.callee is not None:
                        for lock2 in self._acquires(site.callee):
                            for h in held:
                                if h != lock2:
                                    edges.setdefault(
                                        (h, lock2), (site.node, fn, path))
                if site.callee is not None and site.callee.qname in indexed:
                    state = (site.callee.qname, eff, tag)
                    if (state not in state_seen
                            and per_fn.get(site.callee.qname, 0) < _PER_FN_CAP):
                        state_seen.add(state)
                        per_fn[site.callee.qname] = \
                            per_fn.get(site.callee.qname, 0) + 1
                        queue.append((site.callee, eff, tag,
                                      path + (_display(site.callee),)))
        self._report_cc001(records)
        self._report_cc002(edges)

    def _check_blocking(self, fn: FunctionInfo, site: CallSite,
                        held: FrozenSet[str], path: Tuple[str, ...],
                        seen: Set[Tuple]) -> None:
        key = (fn.qname, site.node.lineno, site.node.col_offset)
        if key in seen:
            return
        direct = self._blocking_name(fn, site)
        chain: Optional[List[str]] = None
        if direct is not None:
            chain = [direct]
        elif site.callee is not None:
            sub = self._blocking_path(site.callee)
            if sub is not None:
                chain = [_display(site.callee)] + sub
        if chain is None:
            return
        seen.add(key)
        what = chain[-1].split(" @ ")[0]
        via = "" if len(chain) == 1 else \
            f" (via {' -> '.join(chain[:-1])})"
        self.findings.append(RawFinding(
            "CC003", fn.ctx.path, site.node,
            f"blocking `{what}` reached while holding "
            f"{_fmt_locks(held)}{via} — every thread contending for the "
            "lock stalls behind the wait; move the blocking call outside "
            "the critical section",
            {"lockset": sorted(held),
             "call_path": list(path) + chain}))

    # -- reporting -----------------------------------------------------------
    def _report_cc001(self, records) -> None:
        for cls_qname in sorted(records):
            model = self._models.get(cls_qname)
            if model is None or model.mode is None:
                continue
            for fname in sorted(records[cls_qname]):
                recs = records[cls_qname][fname]
                pair = self._race_pair(model, recs)
                if pair is None:
                    continue
                r1, r2 = pair
                primary = r1 if len(r1.locks) <= len(r2.locks) else r2
                other = r2 if primary is r1 else r1
                self.findings.append(RawFinding(
                    "CC001", primary.fn.ctx.path, primary.node,
                    f"field `{model.ci.name}.{fname}` is shared across "
                    f"threads but accessed under inconsistent locksets: "
                    f"{primary.kind} at {_loc(primary.fn, primary.node)} "
                    f"holds {_fmt_locks(primary.locks)} (via "
                    f"{' -> '.join(primary.path)}), {other.kind} at "
                    f"{_loc(other.fn, other.node)} holds "
                    f"{_fmt_locks(other.locks)} (via "
                    f"{' -> '.join(other.path)}) — guard both sides with "
                    "the same lock",
                    {"class": model.ci.name, "field": fname,
                     "accesses": [
                         {"kind": r.kind,
                          "location": f"{r.fn.ctx.path}:{r.node.lineno}",
                          "lockset": sorted(r.locks),
                          "call_path": list(r.path)}
                         for r in (primary, other)]}))

    @staticmethod
    def _race_pair(model: ClassModel,
                   recs: List[Record]) -> Optional[Tuple[Record, Record]]:
        if not any(r.kind == "write" for r in recs):
            return None
        common = None
        for r in recs:
            common = r.locks if common is None else (common & r.locks)
        if common:
            return None  # one lock consistently guards every access
        ordered = sorted(recs, key=lambda r: (len(r.locks), r.node.lineno,
                                              r.node.col_offset))
        for i, r1 in enumerate(ordered):
            for r2 in ordered[i + 1:]:
                if r1.node is r2.node:
                    continue
                if r1.locks & r2.locks:
                    continue
                if r1.kind != "write" and r2.kind != "write":
                    continue
                # thread evidence: thread-side vs external-surface pair
                if (model.mode == "threads"
                        and {r1.tag, r2.tag} == {"thread", "ext"}):
                    return (r1, r2)
                # either mode: guarded-here-but-not-there inconsistency
                if r1.locks or r2.locks:
                    return (r1, r2)
        return None

    def _report_cc002(self, edges) -> None:
        reported: Set[Tuple[str, str]] = set()
        for (a, b) in sorted(edges):
            if a >= b or (a, b) in reported:
                continue
            if (b, a) not in edges:
                continue
            reported.add((a, b))
            n1, f1, p1 = edges[(a, b)]
            n2, f2, p2 = edges[(b, a)]
            self.findings.append(RawFinding(
                "CC002", f1.ctx.path, n1,
                f"lock-order inversion: `{a}` then `{b}` here (via "
                f"{' -> '.join(p1)}), but `{b}` then `{a}` at "
                f"{_loc(f2, n2)} (via {' -> '.join(p2)}) — two threads "
                "taking the pair in opposite orders can deadlock; pick one "
                "global order",
                {"locks": [a, b],
                 "order_a_then_b": f"{f1.ctx.path}:{n1.lineno}",
                 "order_b_then_a": f"{f2.ctx.path}:{n2.lineno}",
                 "call_path": list(p1)}))
