"""Actor-runtime hazard rules: RT001–RT003, RT005.

(The JAX analyzer's RT004 checks jit static arguments; eager PyTorch has
none, so the port has no RT004.)
"""

from __future__ import annotations

import ast
import re
from typing import List, Optional, Set

from .context import ModuleContext, dotted
from .findings import Finding, Severity
from .registry import make_finding, rule

# ---------------------------------------------------------------------------
# RT001 — blocking call inside an actor method
# ---------------------------------------------------------------------------

_REMOTE_DECOR = re.compile(r"(^|\.)remote$")
_BLOCKING_EXACT = {"time.sleep", "os.system", "input"}
_BLOCKING_PREFIX = ("subprocess.", "requests.", "urllib.request.")
_BLOCKING_OPEN = {"open", "io.open"}


def _is_remote_decorated(node: ast.ClassDef) -> bool:
    for deco in node.decorator_list:
        target = deco.func if isinstance(deco, ast.Call) else deco
        name = dotted(target)
        if name is not None and _REMOTE_DECOR.search(name):
            return True
    return False


def _actor_classes(ctx: ModuleContext) -> List[ast.ClassDef]:
    """Classes made into actors: ``@remote``/``@tpu_air_torch.remote`` decoration,
    or the explicit ``remote(**opts)(Cls)`` wrapping form."""
    classes = {n.name: n for n in ctx.nodes
               if isinstance(n, ast.ClassDef)}
    actors = {n.name for n in classes.values() if _is_remote_decorated(n)}
    for node in ctx.nodes:
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Call)):
            inner = dotted(node.func.func)
            if (inner is not None and _REMOTE_DECOR.search(inner)
                    and len(node.args) == 1
                    and isinstance(node.args[0], ast.Name)
                    and node.args[0].id in classes):
                actors.add(node.args[0].id)
    return [classes[name] for name in sorted(actors)]


@rule("RT001", "blocking-call-in-actor", Severity.WARNING,
      "an actor executes one method at a time; a blocking call stalls its "
      "whole message queue and every caller awaiting a result")
def rt001_blocking_in_actor(ctx: ModuleContext) -> List[Finding]:
    out = []
    for cls in _actor_classes(ctx):
        for method in cls.body:
            if not isinstance(method, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            for node in ast.walk(method):
                if not isinstance(node, ast.Call):
                    continue
                name = dotted(node.func)
                if name is None:
                    continue
                blocking = (name in _BLOCKING_EXACT
                            or name in _BLOCKING_OPEN
                            or name.startswith(_BLOCKING_PREFIX))
                if blocking:
                    out.append(make_finding(
                        ctx, "RT001", node,
                        f"blocking `{name}` inside actor method "
                        f"`{cls.name}.{method.name}` — it stalls the "
                        "actor's message loop; move the wait to the caller "
                        "or a worker thread"))
    return out


# ---------------------------------------------------------------------------
# RT002 — mutation after object_store.put (pickle-store aliasing)
# ---------------------------------------------------------------------------

_MUTATORS = {"append", "extend", "insert", "update", "pop", "popitem",
             "clear", "remove", "sort", "reverse", "setdefault", "add",
             "discard", "fill", "itemset", "resize", "sort_values"}


def _put_arg(node: ast.Call) -> Optional[ast.Name]:
    """If this is a ``*.put(x, ...)``/``put(x, ...)`` call with a Name first
    arg, return that Name."""
    fname = dotted(node.func)
    if fname is None or not (fname == "put" or fname.endswith(".put")):
        return None
    if node.args and isinstance(node.args[0], ast.Name):
        return node.args[0]
    return None


def _mutation_of(node: ast.AST, name: str) -> Optional[ast.AST]:
    """If ``node`` mutates ``name`` in place, return the offending node."""
    if isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
        targets = node.targets if isinstance(node, ast.Assign) else [node.target]
        for tgt in targets:
            # x[...] = / x.attr = / x += mutate the stored object; a plain
            # `x = ...` rebinding does NOT (it stops tracking instead)
            if isinstance(tgt, (ast.Subscript, ast.Attribute)):
                base = tgt.value
                if isinstance(base, ast.Name) and base.id == name:
                    return tgt
            if (isinstance(node, ast.AugAssign) and isinstance(tgt, ast.Name)
                    and tgt.id == name):
                return tgt
    if isinstance(node, ast.Delete):
        for tgt in node.targets:
            if (isinstance(tgt, (ast.Subscript, ast.Attribute))
                    and isinstance(tgt.value, ast.Name)
                    and tgt.value.id == name):
                return tgt
    if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
            and node.func.attr in _MUTATORS
            and isinstance(node.func.value, ast.Name)
            and node.func.value.id == name):
        return node
    return None


def _rebinds(node: ast.AST, name: str) -> bool:
    # only a direct Store on the bare name (x = .., (x, y) = ..) rebinds;
    # the base Name of `x[0] = ..` has Load ctx and is a mutation instead
    if isinstance(node, ast.Assign):
        for tgt in node.targets:
            for leaf in ast.walk(tgt):
                if (isinstance(leaf, ast.Name) and leaf.id == name
                        and isinstance(leaf.ctx, ast.Store)):
                    return True
    return False


def _walk_scope(scope: ast.AST):
    """Walk a function/module body without descending into nested defs."""
    stack = list(ast.iter_child_nodes(scope))
    while stack:
        node = stack.pop(0)
        yield node
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda, ast.ClassDef)):
            stack[:0] = list(ast.iter_child_nodes(node))


@rule("RT002", "mutate-after-put", Severity.ERROR,
      "put() snapshots by pickling, but small objects may be served from "
      "the in-process cache — mutating the original afterwards makes local "
      "and remote readers observe different values")
def rt002_mutate_after_put(ctx: ModuleContext) -> List[Finding]:
    out = []
    scopes = [ctx.tree] + [n for n in ctx.nodes
                           if isinstance(n, (ast.FunctionDef,
                                             ast.AsyncFunctionDef))]
    for scope in scopes:
        # source-order event scan per scope (the same linear approximation
        # the JAX analyzer's JX002 uses): put → track; rebind → untrack; mutation → report
        events = []
        for node in _walk_scope(scope):
            if isinstance(node, ast.Call):
                arg = _put_arg(node)
                if arg is not None:
                    events.append(((node.lineno, node.col_offset),
                                   "put", arg.id, node))
            for name in _names_in(node):
                if _rebinds(node, name):
                    events.append(((node.lineno, node.col_offset),
                                   "rebind", name, node))
                bad = _mutation_of(node, name)
                if bad is not None:
                    events.append(((bad.lineno, bad.col_offset),
                                   "mut", name, bad))
        events.sort(key=lambda e: e[0])
        tracked = {}
        for _pos, kind, name, node in events:
            if kind == "put":
                tracked[name] = node
            elif kind == "rebind":
                tracked.pop(name, None)
            elif kind == "mut" and name in tracked:
                out.append(make_finding(
                    ctx, "RT002", node,
                    f"`{name}` is mutated after being put() into the "
                    f"object store on line {tracked[name].lineno} — "
                    "readers may alias the stored snapshot; copy before "
                    "mutating, or put() the final value"))
                del tracked[name]
    return out


def _names_in(node: ast.AST) -> Set[str]:
    """Candidate variable names a single AST node could rebind or mutate."""
    names: Set[str] = set()
    if isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
        targets = node.targets if isinstance(node, ast.Assign) else [node.target]
        for tgt in targets:
            for leaf in ast.walk(tgt):
                if isinstance(leaf, ast.Name):
                    names.add(leaf.id)
    elif isinstance(node, ast.Delete):
        for tgt in node.targets:
            for leaf in ast.walk(tgt):
                if isinstance(leaf, ast.Name):
                    names.add(leaf.id)
    elif (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
          and isinstance(node.func.value, ast.Name)):
        names.add(node.func.value.id)
    return names


# ---------------------------------------------------------------------------
# RT003 — broad except without justification
# ---------------------------------------------------------------------------

_BROAD = {"Exception", "BaseException", "builtins.Exception",
          "builtins.BaseException"}
_NOQA = re.compile(r"noqa(?:\s*:\s*[A-Z0-9, ]+)?", re.IGNORECASE)
_AIRLINT = re.compile(r"airlint:.*")


def _is_broad(handler: ast.ExceptHandler) -> bool:
    if handler.type is None:
        return True
    types = (handler.type.elts if isinstance(handler.type, ast.Tuple)
             else [handler.type])
    return any(dotted(t) in _BROAD for t in types)


def _justified(ctx: ModuleContext, line: int) -> bool:
    """A broad catch is justified by a comment (same line or the line
    above) that still says something once noqa/airlint directives are
    stripped — at least one word of actual prose."""
    for ln in (line, line - 1):
        text = ctx.comment_on(ln)
        if ln == line - 1 and (text is None or not ctx.comment_is_standalone(ln)):
            continue
        if text is None:
            continue
        prose = _AIRLINT.sub("", _NOQA.sub("", text))
        if re.search(r"[A-Za-z]{2,}", prose):
            return True
    return False


@rule("RT003", "unjustified-broad-except", Severity.WARNING,
      "a bare `except Exception` in a runtime path swallows real faults "
      "(lost leases, dead actors) unless the breadth is deliberate and "
      "documented")
def rt003_broad_except(ctx: ModuleContext) -> List[Finding]:
    out = []
    for node in ctx.nodes:
        if not isinstance(node, ast.ExceptHandler):
            continue
        if not _is_broad(node):
            continue
        if _justified(ctx, node.lineno):
            continue
        what = "bare `except:`" if node.type is None else "`except Exception`"
        out.append(make_finding(
            ctx, "RT003", node,
            f"{what} without a justifying comment — narrow the exception "
            "type, or state why catching everything is correct in a "
            "trailing comment"))
    return out


# ---------------------------------------------------------------------------
# RT005 — unbounded retry loop
# ---------------------------------------------------------------------------

# pacing: a call whose dotted name ends in sleep/wait, or mentions a
# backoff object (`backoff.next_delay`, `self._backoff(...)`)
_RT005_PACING = re.compile(r"(^|[._])(sleep|wait)$|backoff|next_delay")
# attempt bound: a comparison touching an attempts/retries counter or a
# max_* limit (`while attempts < max_attempts`, `if tries > MAX_TRIES`)
_RT005_BOUND = re.compile(r"attempt|retries|tries|max_", re.IGNORECASE)
# deadline awareness: any name that consults a deadline/budget
_RT005_DEADLINE = re.compile(r"deadline|expired|remaining", re.IGNORECASE)
# work consumption: a loop that blocks on a receive or pops a queue handles
# a NEW item each iteration (message/worker loop) — that's not a retry of
# one failing operation, and the blocking receive paces it besides
_RT005_CONSUME = re.compile(r"(^|[._])(pop|popleft|recv|accept)$")


def _rt005_swallows(handler: ast.ExceptHandler) -> bool:
    """A handler that never leaves the loop (no raise/return/break anywhere
    in its body) swallows the failure and lets the loop spin again."""
    for stmt in handler.body:
        for node in ast.walk(stmt):
            if isinstance(node, (ast.Raise, ast.Return, ast.Break)):
                return False
    return True


def _rt005_identifiers(loop: ast.While):
    """Every identifier the loop touches — bare names and attribute tails
    (`self._deadline` contributes both "self" and "_deadline")."""
    for node in ast.walk(loop):
        if isinstance(node, ast.Name):
            yield node.id
        elif isinstance(node, ast.Attribute):
            yield node.attr


@rule("RT005", "unbounded-retry", Severity.WARNING,
      "a while-loop that catches failures and spins again with no attempt "
      "bound, no backoff and no deadline is a retry storm: it hammers the "
      "failing target at full speed forever and can hold locks/slots while "
      "doing it")
def rt005_unbounded_retry(ctx: ModuleContext) -> List[Finding]:
    out = []
    for loop in ctx.nodes:
        if not isinstance(loop, ast.While):
            continue
        # the failure-swallowing retry shape: a try inside the loop whose
        # handler neither re-raises nor exits the loop.  (for-loops are
        # bounded by construction and never fire.)
        swallowed = None
        for node in ast.walk(loop):
            if isinstance(node, ast.Try):
                for handler in node.handlers:
                    if _rt005_swallows(handler):
                        swallowed = handler
                        break
            if swallowed is not None:
                break
        if swallowed is None:
            continue
        idents = list(_rt005_identifiers(loop))
        bounded = any(
            any(_RT005_BOUND.search(i)
                for n in ast.walk(cmp_node) for i in _cmp_idents(n))
            for cmp_node in ast.walk(loop)
            if isinstance(cmp_node, ast.Compare))
        call_names = [name for node in ast.walk(loop)
                      if isinstance(node, ast.Call)
                      for name in [dotted(node.func)] if name is not None]
        paced = any(_RT005_PACING.search(n) for n in call_names)
        consumes = any(_RT005_CONSUME.search(n) for n in call_names)
        deadline_aware = any(_RT005_DEADLINE.search(i) for i in idents)
        if bounded or paced or consumes or deadline_aware:
            continue
        out.append(make_finding(
            ctx, "RT005", swallowed,
            "retry loop swallows failures with no attempt bound, backoff "
            "or deadline — bound the attempts, pace them "
            "(tpu_air.faults.retry.Backoff), and stop at the request's "
            "deadline"))
    return out


def _cmp_idents(node: ast.AST):
    if isinstance(node, ast.Name):
        yield node.id
    elif isinstance(node, ast.Attribute):
        yield node.attr
