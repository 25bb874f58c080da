"""Module-level call graph over a set of parsed modules.

Resolution is deliberately conservative and purely syntactic (no imports
executed, nothing imported but the standard library):

- ``f()``            → module-level def in the same module, else an
                       import-resolved def in another analyzed module.
- ``self.m()``       → method of the enclosing class (base classes chased
                       by name, bounded depth).
- ``self.fld.m()``   → one level of field-type inference: when some method
                       assigns ``self.fld = ClassName(...)`` and ClassName
                       resolves to an analyzed class, ``m`` resolves there.
- ``mod.f()``        → through the per-module import table, including
                       ``from pkg import mod as alias`` and one-hop
                       re-exports out of package ``__init__`` files.
- everything else    → an *unknown callee*: the site is still recorded
                       (with the dotted name as written, or ``<dynamic>``)
                       so downstream analyses degrade instead of crashing.

Names shadowed by a local binding (parameter, assignment, nested def) are
unknown callees on purpose — ``f = something(); f()`` must not resolve to
the module-level ``f``.
"""

from __future__ import annotations

import ast
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

from ..context import ModuleContext, dotted

_FUNC_DEFS = (ast.FunctionDef, ast.AsyncFunctionDef)
_SCOPE_DEFS = _FUNC_DEFS + (ast.ClassDef, ast.Lambda)
_MAX_CHASE = 3  # re-export / base-class chase depth

# the packages whose modules are named from their root: the JAX package and
# its port.  A path through either is named from that component on.
PACKAGE_ROOTS = ("tpu_air", "tpu_air_torch")


def module_name(path: str) -> str:
    """Dotted module name for ``path``: the name rooted at the first path
    component that is a package root (``tpu_air`` or ``tpu_air_torch``),
    else the bare stem (so fixture files in temp dirs still get usable
    names)."""
    parts = [p for p in os.path.normpath(path).split(os.sep)
             if p not in ("", ".", "..")]
    if parts and parts[-1].endswith(".py"):
        parts[-1] = parts[-1][:-3]
    if parts and parts[-1] == "__init__":
        parts = parts[:-1]
    roots = [i for i, p in enumerate(parts) if p in PACKAGE_ROOTS]
    if roots:
        parts = parts[roots[0]:]
    elif parts:
        parts = parts[-1:]
    return ".".join(parts) or "<module>"


def package_root(modname: str) -> Optional[str]:
    """The package root a module name starts with, or None for a module
    outside both packages (an example, a tool, a fixture)."""
    head = modname.split(".", 1)[0]
    return head if head in PACKAGE_ROOTS else None


@dataclass
class ClassInfo:
    """One top-level class: methods, syntactic bases, and the constructor
    names its ``self.X = Ctor(...)`` fields were assigned from."""

    name: str
    qname: str
    node: ast.ClassDef
    ctx: ModuleContext
    modname: str
    methods: Dict[str, "FunctionInfo"] = field(default_factory=dict)
    base_names: List[str] = field(default_factory=list)
    field_ctors: Dict[str, str] = field(default_factory=dict)


@dataclass
class FunctionInfo:
    """One analyzable function: a module-level def or a class method."""

    qname: str
    name: str
    node: ast.AST
    ctx: ModuleContext
    modname: str
    cls: Optional[ClassInfo] = None

    def __hash__(self):
        return hash(self.qname)

    def __eq__(self, other):
        return isinstance(other, FunctionInfo) and other.qname == self.qname


@dataclass
class CallSite:
    """A call inside a function: the name as written plus the resolved
    callee when resolution succeeded (None = unknown callee)."""

    node: ast.Call
    name: str
    callee: Optional[FunctionInfo]


def walk_scope(node: ast.AST):
    """Preorder walk that does NOT descend into nested function/class/
    lambda bodies — their code runs in a different dynamic context."""
    stack = list(ast.iter_child_nodes(node))
    while stack:
        cur = stack.pop()
        yield cur
        if not isinstance(cur, _SCOPE_DEFS):
            stack.extend(ast.iter_child_nodes(cur))


def in_loop_header(node: ast.AST, loop: ast.AST) -> bool:
    """True when ``node`` sits in a For's iter/target — evaluated once at
    loop entry, not per iteration (While tests DO run per iteration)."""
    if not isinstance(loop, (ast.For, ast.AsyncFor)):
        return False
    for header in (loop.iter, loop.target):
        for sub in ast.walk(header):
            if sub is node:
                return True
    return False


class CallGraph:
    """Function/class index + call resolution across analyzed modules."""

    def __init__(self, contexts: List[ModuleContext]):
        self.modules: Dict[str, ModuleContext] = {}
        self.module_funcs: Dict[Tuple[str, str], FunctionInfo] = {}
        self.classes: Dict[Tuple[str, str], ClassInfo] = {}
        self.imports: Dict[str, Dict[str, Tuple[str, Optional[str]]]] = {}
        # module-level ``x = Ctor(...)`` bindings: (mod, name) -> ctor name
        self.global_ctors: Dict[Tuple[str, str], str] = {}
        self.functions: List[FunctionInfo] = []
        self._locals_cache: Dict[str, Set[str]] = {}
        self._sites_cache: Dict[str, List[CallSite]] = {}
        self._loop_reached: Optional[Set[str]] = None
        for ctx in sorted(contexts, key=lambda c: c.path):
            self._index_module(ctx)

    # -- indexing ------------------------------------------------------------
    def _index_module(self, ctx: ModuleContext) -> None:
        modname = module_name(ctx.path)
        if modname in self.modules:  # collision: first (sorted) path wins
            return
        self.modules[modname] = ctx
        is_pkg = os.path.basename(ctx.path) == "__init__.py"
        imp = self.imports.setdefault(modname, {})
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Import):
                for alias in node.names:
                    bound = alias.asname or alias.name.split(".")[0]
                    target = alias.name if alias.asname else alias.name.split(".")[0]
                    imp[bound] = (target, None)
            elif isinstance(node, ast.ImportFrom):
                base = self._import_base(modname, is_pkg, node)
                for alias in node.names:
                    if alias.name == "*":
                        continue
                    imp[alias.asname or alias.name] = (base, alias.name)
        for stmt in ctx.tree.body:
            if isinstance(stmt, _FUNC_DEFS):
                fi = FunctionInfo(f"{modname}.{stmt.name}", stmt.name,
                                  stmt, ctx, modname)
                self.module_funcs[(modname, stmt.name)] = fi
                self.functions.append(fi)
            elif isinstance(stmt, ast.ClassDef):
                self._index_class(ctx, modname, stmt)
            elif isinstance(stmt, ast.Assign) and len(stmt.targets) == 1:
                tgt = stmt.targets[0]
                if (isinstance(tgt, ast.Name)
                        and isinstance(stmt.value, ast.Call)):
                    ctor = dotted(stmt.value.func)
                    if ctor:
                        self.global_ctors[(modname, tgt.id)] = ctor

    @staticmethod
    def _import_base(modname: str, is_pkg: bool, node: ast.ImportFrom) -> str:
        if not node.level:
            return node.module or ""
        parts = modname.split(".")
        drop = node.level - 1 if is_pkg else node.level
        base = parts[: len(parts) - drop] if drop else parts
        if node.module:
            base = base + node.module.split(".")
        return ".".join(base)

    def _index_class(self, ctx: ModuleContext, modname: str,
                     node: ast.ClassDef) -> None:
        ci = ClassInfo(node.name, f"{modname}.{node.name}", node, ctx, modname)
        ci.base_names = [d for d in (dotted(b) for b in node.bases) if d]
        for stmt in node.body:
            if isinstance(stmt, _FUNC_DEFS):
                fi = FunctionInfo(f"{ci.qname}.{stmt.name}", stmt.name,
                                  stmt, ctx, modname, cls=ci)
                ci.methods[stmt.name] = fi
                self.functions.append(fi)
        # self.X = Ctor(...) anywhere in the class body (first wins: the
        # __init__-time type is the one that matters for resolution)
        for sub in ast.walk(node):
            if (isinstance(sub, ast.Assign) and len(sub.targets) == 1
                    and isinstance(sub.targets[0], ast.Attribute)
                    and isinstance(sub.targets[0].value, ast.Name)
                    and sub.targets[0].value.id == "self"
                    and isinstance(sub.value, ast.Call)):
                ctor = dotted(sub.value.func)
                if ctor:
                    ci.field_ctors.setdefault(sub.targets[0].attr, ctor)
        self.classes[(modname, node.name)] = ci

    # -- entity resolution ---------------------------------------------------
    def _resolve_in_module(self, modname: str, name: str, depth: int = 0):
        """Resolve a bare name in a module to ('module', m) /
        ('func', fi) / ('class', ci) / ('instance', ci) / None."""
        if depth > _MAX_CHASE:
            return None
        if (modname, name) in self.module_funcs:
            return ("func", self.module_funcs[(modname, name)])
        if (modname, name) in self.classes:
            return ("class", self.classes[(modname, name)])
        if (modname, name) in self.global_ctors:
            ci = self.resolve_class(self.global_ctors[(modname, name)], modname)
            if ci is not None:
                return ("instance", ci)
        bound = self.imports.get(modname, {}).get(name)
        if bound is not None:
            target_mod, attr = bound
            if attr is None:
                return ("module", target_mod) if target_mod in self.modules \
                    else None
            sub = f"{target_mod}.{attr}"
            if sub in self.modules:
                return ("module", sub)
            if target_mod in self.modules:
                return self._resolve_in_module(target_mod, attr, depth + 1)
        return None

    def resolve_class(self, name: str, modname: str,
                      depth: int = 0) -> Optional[ClassInfo]:
        """Resolve a (possibly dotted) class name seen in ``modname``."""
        if depth > _MAX_CHASE:
            return None
        parts = name.split(".")
        ent = self._resolve_in_module(modname, parts[0])
        for part in parts[1:]:
            if ent is None:
                return None
            kind, val = ent
            if kind != "module":
                return None
            ent = self._resolve_in_module(val, part)
        if ent and ent[0] == "class":
            return ent[1]
        return None

    def lookup_method(self, ci: ClassInfo, name: str,
                      depth: int = 0) -> Optional[FunctionInfo]:
        if name in ci.methods:
            return ci.methods[name]
        if depth >= _MAX_CHASE:
            return None
        for base in ci.base_names:
            bci = self.resolve_class(base, ci.modname)
            if bci is not None and bci is not ci:
                m = self.lookup_method(bci, name, depth + 1)
                if m is not None:
                    return m
        return None

    def field_class(self, ci: ClassInfo, fname: str) -> Optional[ClassInfo]:
        ctor = ci.field_ctors.get(fname)
        if ctor is None:
            return None
        return self.resolve_class(ctor, ci.modname)

    # -- call resolution -----------------------------------------------------
    def _locals(self, fn: FunctionInfo) -> Set[str]:
        cached = self._locals_cache.get(fn.qname)
        if cached is not None:
            return cached
        names: Set[str] = set()
        args = fn.node.args
        for a in (args.posonlyargs + args.args + args.kwonlyargs):
            names.add(a.arg)
        if args.vararg:
            names.add(args.vararg.arg)
        if args.kwarg:
            names.add(args.kwarg.arg)
        for node in walk_scope(fn.node):
            if isinstance(node, ast.Name) and isinstance(node.ctx, ast.Store):
                names.add(node.id)
            elif isinstance(node, _FUNC_DEFS + (ast.ClassDef,)):
                names.add(node.name)
        self._locals_cache[fn.qname] = names
        return names

    def resolve_call(self, fn: FunctionInfo, call: ast.Call) -> CallSite:
        name = dotted(call.func)
        if name is None:
            return CallSite(call, "<dynamic>", None)
        parts = name.split(".")
        if len(parts) == 1:
            if parts[0] in self._locals(fn):
                return CallSite(call, name, None)  # shadowed → unknown
            ent = self._resolve_in_module(fn.modname, parts[0])
            callee = ent[1] if ent and ent[0] == "func" else None
            return CallSite(call, name, callee)
        if parts[0] == "self" and fn.cls is not None:
            if len(parts) == 2:
                return CallSite(call, name,
                                self.lookup_method(fn.cls, parts[1]))
            if len(parts) == 3:
                fci = self.field_class(fn.cls, parts[1])
                if fci is not None:
                    return CallSite(call, name,
                                    self.lookup_method(fci, parts[2]))
            return CallSite(call, name, None)
        if parts[0] in self._locals(fn):
            return CallSite(call, name, None)
        ent = self._resolve_in_module(fn.modname, parts[0])
        for i, part in enumerate(parts[1:], start=1):
            if ent is None:
                return CallSite(call, name, None)
            kind, val = ent
            last = i == len(parts) - 1
            if kind == "module":
                ent = self._resolve_in_module(val, part)
            elif kind in ("class", "instance") and last:
                return CallSite(call, name, self.lookup_method(val, part))
            elif kind == "instance":
                fci = self.field_class(val, part)
                ent = ("instance", fci) if fci is not None else None
            else:
                return CallSite(call, name, None)
        if ent and ent[0] == "func":
            return CallSite(call, name, ent[1])
        return CallSite(call, name, None)

    def call_sites(self, fn: FunctionInfo) -> List[CallSite]:
        """Every call in ``fn``'s own body (nested defs excluded),
        resolved where possible, in source order."""
        cached = self._sites_cache.get(fn.qname)
        if cached is not None:
            return cached
        sites = [self.resolve_call(fn, node) for node in walk_scope(fn.node)
                 if isinstance(node, ast.Call)]
        sites.sort(key=lambda s: (s.node.lineno, s.node.col_offset))
        self._sites_cache[fn.qname] = sites
        return sites

    def loop_reached(self) -> Set[str]:
        """Qualified names of the functions that run once per iteration of
        some loop: called from a loop body (a ``for`` header runs once and
        does not count), or called, through resolved calls, by such a
        function."""
        if self._loop_reached is not None:
            return self._loop_reached
        seen: Set[str] = set()
        stack: List[FunctionInfo] = []
        for fn in self.functions:
            for site in self.call_sites(fn):
                if site.callee is None or site.callee.qname in seen:
                    continue
                loop = fn.ctx.enclosing_loop(site.node)
                if loop is not None and not in_loop_header(site.node, loop):
                    seen.add(site.callee.qname)
                    stack.append(site.callee)
        while stack:
            fn = stack.pop()
            for site in self.call_sites(fn):
                if site.callee is not None and site.callee.qname not in seen:
                    seen.add(site.callee.qname)
                    stack.append(site.callee)
        self._loop_reached = seen
        return seen
