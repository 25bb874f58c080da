"""aircrash — interprocedural crash-consistency & fault-coverage analysis.

Every function is summarized as an **ordered sequence of durability
effects** — ``write(path)`` (an ``open()`` in a write mode, or a
``shutil.copyfile`` destination), ``flush``, ``fsync``,
``rename(src, dst)`` (``os.rename``/``os.replace`` only — string
``.replace()`` must never look like a seal), object-store ``put``/
``delete``, and **declared commit points** — and the sequences are
expanded transitively through resolved calls, with the callee's path
expressions rewritten in the caller's terms (parameters substituted by
the rendered argument expression; remaining callee locals scoped so two
inlined helpers' ``tmp`` variables never alias).  The expanded sequences
power three ordering rules, and a separate reachability pass powers the
fault-coverage rule:

* **CS001 non-atomic-publish** — inside a flow that demonstrably follows
  the durability discipline (it seals at least one other write with a
  rename, or fsyncs), a write opened directly on a non-temp final path
  that is never the source of a rename.  A flow with no seal anywhere is
  out of scope: we cannot tell a published artifact from a scratch file,
  and unknown degrades to silence.
* **CS002 rename-without-fsync** — a rename whose source's visible write
  sequence lacks the flush+fsync that makes the rename durable: the
  rename itself is atomic, but on power loss it can survive while the
  data does not, leaving a torn file *at the final path*.
* **CS003 commit-order-inversion** — ``# aircrash: commits <tag>`` /
  ``# aircrash: data <tag>`` annotation pairs declare that a commit
  point (manifest rename, cursor checkpoint) covers the tagged data
  writes.  A commit effect ordered before a same-tag data effect in any
  transitive sequence is an inversion: a crash between them publishes a
  commit naming data that never became durable.  A clean run over
  annotated code is a machine-checked *proof* the shipped order is
  right — tests/test_aircrash.py pins the weights-manifest and
  batch-chunk pairs.
* **FI001 unperturbed-boundary** — a cross-process side-effect primitive
  (``os._exit``, ``subprocess.*``, ``socket.*``, object-store ops, actor
  ``.remote()`` calls) reachable from a serve/train/batch entry point
  (or a ``# aircrash: entry`` annotated function) along a call path with
  no ``faults.perturb()`` site — a boundary the chaos lane cannot
  exercise.  Dynamic-dispatch primitives are credited when their
  dispatch funnel module carries the hook (``core.remote`` for actor
  calls, ``core.object_store`` for store ops, under the package root —
  ``tpu_air`` or ``tpu_air_torch`` — of the module being read): the hook
  lives below the dynamic edge the call graph cannot see.

Known unsoundness holes, same philosophy as airshape (silence over
guessing): branches and loop bodies are concatenated in source order
(an inversion that only exists across exclusive ``if`` arms can be a
false fire; a loop-carried reordering is missed); ``pathlib`` renames,
``os.write``, and mmap flushes are invisible; a path expression the
renderer cannot print (f-strings, comprehensions) never participates in
a match; FI001 ignores intra-function ordering (a perturb anywhere in a
frame covers the whole frame).  All pure stdlib.
"""

from __future__ import annotations

import ast
import re
from dataclasses import dataclass, field as dc_field
from typing import Dict, List, Optional, Set, Tuple

from ..context import dotted
from .callgraph import (
    PACKAGE_ROOTS,
    CallGraph,
    CallSite,
    FunctionInfo,
    package_root,
)
from .lockset import RawFinding

_FUNC_DEFS = (ast.FunctionDef, ast.AsyncFunctionDef)
_SCOPE_DEFS = _FUNC_DEFS + (ast.ClassDef, ast.Lambda)

_DEPTH_CAP = 8          # transitive inlining depth
_SEQ_CAP = 600          # effects per expanded sequence (runaway guard)
_STATE_CAP = 20000      # FI001 reachability states

# `# aircrash: commits <tag>` / `# aircrash: data <tag>` / `# aircrash: entry`
_ANNOT = re.compile(r"aircrash:\s*(commits|data|entry)\b[ \t]*([\w.\-/]*)")

_STORE_OPS = {"put", "get", "delete", "put_serialized"}
_SUBPROCESS_OPS = {"run", "Popen", "call", "check_call", "check_output"}
_TEMP_MARKERS = ("tmp", "temp", ".part", ".bak", "tempfile", "mkstemp")

# dynamic-dispatch primitives and the funnel module, under the package
# root, whose perturb hook covers them (the hook sits below the edge the
# call graph cannot see)
_FUNNELS = {
    "actor-call": "core.remote",
    "object-store": "core.object_store",
}
# entry-point packages, under the package root
_ENTRY_PACKAGES = ("serve", "train", "batch")


@dataclass
class Effect:
    """One durability effect, positioned in a function's effect sequence."""

    kind: str                    # write|flush|fsync|rename|put|delete|commit|data
    node: ast.AST
    fn: FunctionInfo             # function whose body contains the effect
    target: str = ""             # write path / put object id / commit-data tag
    src: str = ""                # rename source path expression
    dst: str = ""                # rename destination path expression
    buffered: bool = True        # write via buffered open() (needs flush too)
    chain: Tuple[str, ...] = ()  # call path from the expansion root


@dataclass
class CrashSummary:
    """Per-function local effect list, before transitive expansion.

    ``items`` interleaves ("eff", Effect) with ("call", CallSite) markers
    in source order so callee sequences inline at the right position.
    """

    fn: FunctionInfo
    items: List[tuple] = dc_field(default_factory=list)
    has_perturb: bool = False
    has_effects: bool = False


def _display(fn: FunctionInfo) -> str:
    if fn.cls is not None:
        return f"{fn.cls.name}.{fn.name}"
    return f"{fn.modname.rsplit('.', 1)[-1]}.{fn.name}"


def _loc(fn: FunctionInfo, node: ast.AST) -> str:
    import os

    return f"{os.path.basename(fn.ctx.path)}:{getattr(node, 'lineno', 1)}"


def _render(node: ast.AST) -> str:
    """Print a path expression, or ``?`` when it cannot be printed.  An
    unknown render never participates in a match — silence over guessing."""
    if isinstance(node, ast.Constant):
        return repr(node.value) if isinstance(node.value, str) else "?"
    d = dotted(node)
    if d is not None:
        return d
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Add):
        left, right = _render(node.left), _render(node.right)
        if "?" in (left, right):
            return "?"
        return f"{left} + {right}"
    if isinstance(node, ast.Call):
        fname = dotted(node.func)
        if fname is None:
            return "?"
        args = [_render(a) for a in node.args]
        if any(a == "?" for a in args):
            return "?"
        return f"{fname}({', '.join(args)})"
    if isinstance(node, ast.Subscript):
        base = _render(node.value)
        return "?" if base == "?" else f"{base}[…]"
    return "?"


def _is_unknown(expr: str) -> bool:
    return not expr or "?" in expr


def _is_temp_like(expr: str) -> bool:
    low = expr.lower()
    return any(m in low for m in _TEMP_MARKERS)


def _clean(expr: str) -> str:
    """Strip the inlining scope prefixes (``qname@line::``) for display."""
    return re.sub(r"[\w.@<>]+::", "", expr)


def _open_write_mode(call: ast.Call) -> Optional[bool]:
    """For an ``open()`` call, True when the mode can write, False when it
    cannot, None when the mode is not statically known."""
    mode = None
    if len(call.args) >= 2:
        mode = call.args[1]
    for kw in call.keywords:
        if kw.arg == "mode":
            mode = kw.value
    if mode is None:
        return False  # default "r"
    if isinstance(mode, ast.Constant) and isinstance(mode.value, str):
        return any(c in mode.value for c in "wax+")
    return None


class CrashFlowAnalysis:
    """Durability-effect sequences + commit-order and fault-coverage rules."""

    def __init__(self, cg: CallGraph):
        self.cg = cg
        self._summaries: Dict[str, CrashSummary] = {}
        self._touches_memo: Dict[str, bool] = {}
        self._perturbs_memo: Dict[str, bool] = {}
        self._seq_memo: Dict[str, List[Effect]] = {}
        self.findings: List[RawFinding] = []
        self._best: Dict[tuple, tuple] = {}  # dedupe key -> (chain_len, finding)
        self._ran = False

    # -- public --------------------------------------------------------------
    def run(self) -> List[RawFinding]:
        if self._ran:
            return self.findings
        self._ran = True
        for fn in self.cg.functions:
            if self._touches(fn.qname):
                seq = self.sequence(fn.qname)
                self._check_cs001(seq)
                self._check_cs002(seq)
                self._check_cs003(seq)
        self._check_fi001()
        self.findings.extend(
            f for _, f in sorted(
                self._best.values(),
                key=lambda e: (e[1].path, e[1].node.lineno)))
        return self.findings

    def sequence(self, qname: str) -> List[Effect]:
        """The fully expanded effect sequence of one function — the unit
        the crashflow tests (and the CS003 order proofs) assert on."""
        cached = self._seq_memo.get(qname)
        if cached is None:
            cached = []
            fn = self._fn_by_qname(qname)
            if fn is not None:
                self._expand(fn, 0, frozenset(), {}, (_display(fn),), cached)
            self._seq_memo[qname] = cached
        return cached

    # -- summaries -----------------------------------------------------------
    def _fn_by_qname(self, qname: str) -> Optional[FunctionInfo]:
        for fn in self.cg.functions:
            if fn.qname == qname:
                return fn
        return None

    def _summary(self, fn: FunctionInfo) -> CrashSummary:
        s = self._summaries.get(fn.qname)
        if s is None:
            s = CrashSummary(fn)
            sites = {id(site.node): site for site in self.cg.call_sites(fn)}
            self._walk_body(fn, fn.node.body, s, sites)
            s.has_effects = any(k == "eff" for k, _ in s.items)
            self._summaries[fn.qname] = s
        return s

    def _annotation(self, fn: FunctionInfo, line: int) -> Optional[tuple]:
        """(verb, tag) declared on ``line`` (trailing) or on a standalone
        comment line directly above it."""
        for ln in (line, line - 1):
            text = fn.ctx.comment_on(ln)
            if text is None:
                continue
            if ln != line and not fn.ctx.comment_is_standalone(ln):
                continue
            m = _ANNOT.search(text)
            if m:
                return m.group(1), m.group(2)
        return None

    def _walk_body(self, fn: FunctionInfo, body, s: CrashSummary,
                   sites: Dict[int, CallSite]) -> None:
        for stmt in body:
            if isinstance(stmt, _SCOPE_DEFS):
                continue  # nested scopes run in a different dynamic context
            ann = self._annotation(fn, stmt.lineno)
            if ann is not None and ann[0] in ("commits", "data"):
                kind = "commit" if ann[0] == "commits" else "data"
                s.items.append(("eff", Effect(kind, stmt, fn, target=ann[1])))
            if isinstance(stmt, (ast.With, ast.AsyncWith)):
                for item in stmt.items:
                    self._scan_expr(fn, item.context_expr, s, sites)
                self._walk_body(fn, stmt.body, s, sites)
            elif isinstance(stmt, ast.If):
                self._scan_expr(fn, stmt.test, s, sites)
                self._walk_body(fn, stmt.body, s, sites)
                self._walk_body(fn, stmt.orelse, s, sites)
            elif isinstance(stmt, (ast.For, ast.AsyncFor)):
                self._scan_expr(fn, stmt.iter, s, sites)
                self._walk_body(fn, stmt.body, s, sites)
                self._walk_body(fn, stmt.orelse, s, sites)
            elif isinstance(stmt, ast.While):
                self._scan_expr(fn, stmt.test, s, sites)
                self._walk_body(fn, stmt.body, s, sites)
                self._walk_body(fn, stmt.orelse, s, sites)
            elif isinstance(stmt, ast.Try):
                self._walk_body(fn, stmt.body, s, sites)
                for handler in stmt.handlers:
                    self._walk_body(fn, handler.body, s, sites)
                self._walk_body(fn, stmt.orelse, s, sites)
                self._walk_body(fn, stmt.finalbody, s, sites)
            else:
                self._scan_expr(fn, stmt, s, sites)

    def _scan_expr(self, fn: FunctionInfo, node: ast.AST, s: CrashSummary,
                   sites: Dict[int, CallSite]) -> None:
        calls = []
        stack = [node]
        while stack:
            cur = stack.pop()
            if isinstance(cur, _SCOPE_DEFS):
                continue
            if isinstance(cur, ast.Call):
                calls.append(cur)
            stack.extend(ast.iter_child_nodes(cur))
        calls.sort(key=lambda n: (n.lineno, n.col_offset))
        for call in calls:
            self._classify_call(fn, call, s, sites)

    def _classify_call(self, fn: FunctionInfo, call: ast.Call,
                       s: CrashSummary, sites: Dict[int, CallSite]) -> None:
        name = dotted(call.func) or "<dynamic>"
        parts = name.split(".")
        if parts[-1] == "perturb":
            s.has_perturb = True
            return
        if name in ("open", "io.open") and call.args:
            writes = _open_write_mode(call)
            if writes:
                s.items.append(("eff", Effect(
                    "write", call, fn, target=_render(call.args[0]))))
            return
        if name in ("shutil.copyfile", "shutil.copy", "shutil.copy2",
                    "copyfile") and len(call.args) >= 2:
            s.items.append(("eff", Effect(
                "write", call, fn, target=_render(call.args[1]),
                buffered=False)))
            return
        if len(parts) >= 2 and parts[-1] == "flush":
            s.items.append(("eff", Effect("flush", call, fn)))
            return
        if name in ("os.fsync", "fsync"):
            s.items.append(("eff", Effect("fsync", call, fn)))
            return
        if name in ("os.rename", "os.replace") and len(call.args) >= 2:
            s.items.append(("eff", Effect(
                "rename", call, fn, src=_render(call.args[0]),
                dst=_render(call.args[1]))))
            return
        if (len(parts) >= 2 and parts[-1] in _STORE_OPS
                and "store" in ".".join(parts[:-1]).lower()):
            oid = "?"
            if call.args:
                oid = _render(call.args[-1] if parts[-1] != "put"
                              or len(call.args) < 2 else call.args[1])
            for kw in call.keywords:
                if kw.arg == "object_id":
                    oid = _render(kw.value)
            kind = "delete" if parts[-1] == "delete" else "put"
            s.items.append(("eff", Effect(kind, call, fn, target=oid)))
            # fall through: a resolved store call still inlines its body
        site = sites.get(id(call))
        if site is not None and site.callee is not None:
            s.items.append(("call", site))

    # -- transitive expansion ------------------------------------------------
    def _touches(self, qname: str, _stack: frozenset = frozenset()) -> bool:
        """Does this function (transitively) produce any durability effect?
        Barren subtrees are skipped during expansion."""
        memo = self._touches_memo.get(qname)
        if memo is not None:
            return memo
        if qname in _stack:
            return False
        fn = self._fn_by_qname(qname)
        if fn is None:
            return False
        s = self._summary(fn)
        result = s.has_effects
        if not result:
            for kind, payload in s.items:
                if kind == "call" and payload.callee is not None:
                    if self._touches(payload.callee.qname,
                                     _stack | {qname}):
                        result = True
                        break
        self._touches_memo[qname] = result
        return result

    def _expand(self, fn: FunctionInfo, depth: int, stack: frozenset,
                subst: Dict[str, str], chain: Tuple[str, ...],
                out: List[Effect]) -> None:
        if depth > _DEPTH_CAP or fn.qname in stack or len(out) >= _SEQ_CAP:
            return
        s = self._summary(fn)
        fn_locals = self.cg._locals(fn) if depth > 0 else set()
        frame = f"{fn.qname}@{depth}"
        for kind, payload in s.items:
            if len(out) >= _SEQ_CAP:
                return
            if kind == "eff":
                out.append(self._materialize(
                    payload, subst, fn_locals, frame, chain))
            else:
                callee = payload.callee
                if callee is None or not self._touches(callee.qname):
                    continue
                sub2 = self._arg_map(fn, payload, callee, subst,
                                     fn_locals, frame)
                self._expand(callee, depth + 1, stack | {fn.qname}, sub2,
                             chain + (_display(callee),), out)

    def _materialize(self, eff: Effect, subst, fn_locals, frame,
                     chain) -> Effect:
        def rw(expr: str) -> str:
            return self._rewrite(expr, subst, fn_locals, frame)

        return Effect(eff.kind, eff.node, eff.fn,
                      target=eff.target if eff.kind in ("commit", "data")
                      else rw(eff.target),
                      src=rw(eff.src), dst=rw(eff.dst),
                      buffered=eff.buffered, chain=chain)

    @staticmethod
    def _rewrite(expr: str, subst: Dict[str, str], fn_locals: Set[str],
                 frame: str) -> str:
        """Rewrite a callee path expression in the caller's terms:
        parameters become the rendered argument; remaining callee locals
        get a frame scope so two inlined helpers' ``tmp`` never alias."""
        if _is_unknown(expr) or (not subst and not fn_locals):
            return expr

        def repl(m):
            tok = m.group(0)
            if tok in subst:
                return subst[tok]
            if tok in fn_locals:
                return f"{frame}::{tok}"
            return tok

        return re.sub(r"[A-Za-z_]\w*", repl, expr)

    def _arg_map(self, fn: FunctionInfo, site: CallSite,
                 callee: FunctionInfo, subst, fn_locals,
                 frame) -> Dict[str, str]:
        """Callee parameter -> caller-namespace rendered argument."""
        args = callee.node.args
        params = [a.arg for a in args.posonlyargs + args.args]
        out: Dict[str, str] = {}
        pos = list(site.node.args)
        if params and params[0] == "self" and callee.cls is not None:
            recv = (site.name or "").rsplit(".", 1)[0]
            if recv.startswith("self"):
                out["self"] = "self"
            params = params[1:]
        for p, a in zip(params, pos):
            rendered = self._rewrite(_render(a), subst, fn_locals, frame)
            out[p] = rendered
        for kw in site.node.keywords:
            if kw.arg and kw.arg in params:
                out[kw.arg] = self._rewrite(
                    _render(kw.value), subst, fn_locals, frame)
        return out

    # -- ordering rules ------------------------------------------------------
    def _report(self, key: tuple, finding: RawFinding,
                chain_len: int) -> None:
        prev = self._best.get(key)
        if prev is None or chain_len < prev[0]:
            self._best[key] = (chain_len, finding)

    def _check_cs001(self, seq: List[Effect]) -> None:
        renames = [e for e in seq if e.kind == "rename"]
        if not renames and not any(e.kind == "fsync" for e in seq):
            return  # no seal anywhere in this flow — out of scope
        sealed_srcs = {e.src for e in renames if not _is_unknown(e.src)}
        for e in seq:
            if e.kind != "write" or _is_unknown(e.target):
                continue
            if _is_temp_like(e.target) or e.target in sealed_srcs:
                continue
            disp = _clean(e.target)
            via = "" if len(e.chain) <= 1 else \
                f" (via {' -> '.join(e.chain)})"
            self._report(
                ("CS001", e.fn.ctx.path, e.node.lineno),
                RawFinding(
                    "CS001", e.fn.ctx.path, e.node,
                    f"`{disp}` is opened for writing directly at its final "
                    f"path while this flow seals other writes with "
                    f"tmp+rename{via} — a reader (or a crash) can observe "
                    "the file half-written; write a same-directory tmp file "
                    "and os.replace() it into place",
                    {"path_expr": disp, "write": _loc(e.fn, e.node),
                     "call_path": list(e.chain)}),
                len(e.chain))

    def _check_cs002(self, seq: List[Effect]) -> None:
        for i, e in enumerate(seq):
            if e.kind != "rename" or _is_unknown(e.src):
                continue
            write = None
            start = 0
            for j in range(i - 1, -1, -1):
                prev = seq[j]
                if prev.kind == "write" and prev.target == e.src:
                    write, start = prev, j + 1
                    break
                if prev.kind == "rename" and prev.dst == e.src:
                    break  # src was produced by an earlier (checked) seal
            if write is None:
                continue  # provenance unknown — silence
            between = seq[start:i]
            has_fsync = any(b.kind == "fsync" for b in between)
            has_flush = any(b.kind == "flush" for b in between)
            if has_fsync and (has_flush or not write.buffered):
                continue
            missing = []
            if write.buffered and not has_flush:
                missing.append("flush")
            if not has_fsync:
                missing.append("fsync")
            disp = _clean(e.src)
            via = "" if len(e.chain) <= 1 else \
                f" (via {' -> '.join(e.chain)})"
            self._report(
                ("CS002", e.fn.ctx.path, e.node.lineno),
                RawFinding(
                    "CS002", e.fn.ctx.path, e.node,
                    f"`{disp}` (written at {_loc(write.fn, write.node)}) is "
                    f"renamed into place without {'+'.join(missing)}{via} — "
                    "the rename is atomic but the data is not yet durable: "
                    "a power loss can keep the rename and lose the bytes, "
                    "tearing the file at its final path; flush+fsync before "
                    "sealing",
                    {"rename": _loc(e.fn, e.node), "src": disp,
                     "write": _loc(write.fn, write.node),
                     "missing": missing, "call_path": list(e.chain)}),
                len(e.chain))

    def _check_cs003(self, seq: List[Effect]) -> None:
        for i, c in enumerate(seq):
            if c.kind != "commit":
                continue
            for d in seq[i + 1:]:
                if d.kind == "data" and d.target == c.target:
                    self._report(
                        ("CS003", c.target, c.node.lineno, d.node.lineno),
                        RawFinding(
                            "CS003", c.fn.ctx.path, c.node,
                            f"commit point `{c.target}` executes before a "
                            f"data write it covers: commit at "
                            f"{_loc(c.fn, c.node)}, data at "
                            f"{_loc(d.fn, d.node)} (via "
                            f"{' -> '.join(c.chain)}) — a crash between "
                            "them publishes a commit naming data that never "
                            "became durable; order every covered data write "
                            "before the commit",
                            {"tag": c.target, "commit": _loc(c.fn, c.node),
                             "data": _loc(d.fn, d.node),
                             "call_path": list(c.chain)}),
                        len(c.chain))
                    break

    # -- FI001: perturb-site coverage ----------------------------------------
    def _is_entry(self, fn: FunctionInfo) -> bool:
        node = fn.node
        if self._annotation(fn, node.lineno) == ("entry", ""):
            return True
        for deco in getattr(node, "decorator_list", []):
            if self._annotation(fn, deco.lineno) == ("entry", ""):
                return True
        root = package_root(fn.modname)
        if root is None or not fn.modname.startswith(
                tuple(f"{root}.{pkg}" for pkg in _ENTRY_PACKAGES)):
            return False
        if fn.name.startswith("_"):
            return False
        if fn.cls is not None and fn.cls.name.startswith("_"):
            return False
        return True

    @staticmethod
    def _primitive(site: CallSite) -> Optional[Tuple[str, str]]:
        """(kind, display) when the call site is a cross-process primitive."""
        name = site.name
        if name == "os._exit":
            return ("process-exit", name)
        parts = name.split(".")
        if parts[0] == "subprocess" and parts[-1] in _SUBPROCESS_OPS:
            return ("subprocess", name)
        if name in ("socket.socket", "socket.create_connection"):
            return ("socket", name)
        if len(parts) >= 2 and parts[-1] in _STORE_OPS \
                and "store" in ".".join(parts[:-1]).lower():
            return ("object-store", name)
        if len(parts) >= 2 and parts[-1] in ("remote", "crash_actor"):
            return ("actor-call", name)
        return None

    def _perturbs(self, qname: str, _stack: frozenset = frozenset()) -> bool:
        """Does this function (or a resolved callee) call faults.perturb?"""
        memo = self._perturbs_memo.get(qname)
        if memo is not None:
            return memo
        if qname in _stack:
            return False
        fn = self._fn_by_qname(qname)
        if fn is None:
            return False
        s = self._summary(fn)
        result = s.has_perturb
        if not result:
            for site in self.cg.call_sites(fn):
                if site.callee is not None and self._perturbs(
                        site.callee.qname, _stack | {qname}):
                    result = True
                    break
        self._perturbs_memo[qname] = result
        return result

    def _funnel_hooked(self, kind: str, modname: str) -> bool:
        """Is the funnel of ``kind`` hooked in the package ``modname``
        belongs to?  A module outside both packages (an example, a tool)
        is credited by either package's funnel."""
        sub = _FUNNELS.get(kind)
        if sub is None:
            return False
        root = package_root(modname)
        funnels = {f"{r}.{sub}" for r in ((root,) if root else PACKAGE_ROOTS)}
        return any(self._summary(fn).has_perturb
                   for fn in self.cg.functions if fn.modname in funnels)

    def _check_fi001(self) -> None:
        from collections import deque

        entries = [fn for fn in self.cg.functions if self._is_entry(fn)]
        if not entries:
            return
        parents: Dict[tuple, Optional[tuple]] = {}
        queue = deque()
        for fn in entries:
            state = (fn.qname, self._summary(fn).has_perturb)
            if state not in parents:
                parents[state] = None
                queue.append((fn, state))
        visited = 0
        while queue and visited < _STATE_CAP:
            fn, state = queue.popleft()
            visited += 1
            covered = state[1]
            for site in self.cg.call_sites(fn):
                prim = self._primitive(site)
                if prim is not None and not covered:
                    kind, name = prim
                    hooked = (
                        (site.callee is not None
                         and self._perturbs(site.callee.qname))
                        or self._funnel_hooked(kind, fn.modname))
                    if not hooked:
                        self._report_fi001(fn, site, name, state, parents)
                if site.callee is None:
                    continue
                nxt_cov = covered or self._summary(site.callee).has_perturb
                nxt = (site.callee.qname, nxt_cov)
                if nxt not in parents:
                    parents[nxt] = state
                    queue.append((site.callee, nxt))

    def _report_fi001(self, fn: FunctionInfo, site: CallSite, name: str,
                      state: tuple, parents: Dict[tuple, Optional[tuple]]
                      ) -> None:
        chain = []
        cur: Optional[tuple] = state
        while cur is not None:
            hop = self._fn_by_qname(cur[0])
            chain.append(_display(hop) if hop is not None else cur[0])
            cur = parents.get(cur)
        chain.reverse()
        self._report(
            ("FI001", fn.ctx.path, site.node.lineno),
            RawFinding(
                "FI001", fn.ctx.path, site.node,
                f"cross-process boundary `{name}` is reachable from entry "
                f"`{chain[0]}` with no faults.perturb() site on the path "
                f"({' -> '.join(chain)}) — the chaos lane cannot exercise "
                "this boundary; add a perturb hook here or route the call "
                "through a hooked funnel",
                {"primitive": name, "entry": chain[0],
                 "call_path": chain}),
            len(chain))
