"""PyTorch/CUDA hazard rules: PT004.

PT004 is the counterpart of the JAX analyzer's JX004: the same hot-path
test (a step/decode/train/generate function, inside a loop, a ``for``
header exempt), over the calls that make the host wait for a CUDA stream.
It also reads the whole body of a hot function that the call graph shows
running once per iteration of a loop elsewhere (the engine's decode step,
called by ``step()`` from the serving loop), which JX004 does not.
The JAX analyzer's other JX rules (and RT004, PL001) have no counterpart
here; README.md's port section gives each one's reason.  Intentional hits
are documented with ``# airlint: disable=PT004 — reason``.
"""

from __future__ import annotations

import ast
import re
from typing import List, Optional, Set

from .context import ModuleContext, dotted
from .dataflow import ensure_program
from .dataflow.callgraph import in_loop_header
from .findings import Finding, Severity
from .registry import make_finding, rule

HOT_NAME = re.compile(r"(^|_)(step|decode|train|generate)")
# no-argument tensor methods that copy to (or read on) the host
_SYNC_ATTRS = {"item", "tolist", "cpu", "numpy"}
_SYNC_CALLS = {"np.asarray", "np.array", "numpy.asarray", "numpy.array"}
_STREAM_SYNCS = {"torch.cuda.synchronize", "cuda.synchronize"}
_SCALARS = {"bool", "float", "int"}


def _hot_function(ctx: ModuleContext, node: ast.AST):
    # direct enclosing function only — a helper nested inside a hot loop fn
    # (e.g. a batch-staging closure over host data) is not itself hot
    fn = ctx.enclosing_function(node)
    if fn is not None and HOT_NAME.search(fn.name):
        return fn
    return None


def _module_aliases(ctx: ModuleContext) -> Set[str]:
    """Every name an import binds in the module (``np``, ``torch``, ``F``)."""
    names: Set[str] = set()
    for node in ctx.nodes:
        if isinstance(node, ast.Import):
            names.update(a.asname or a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            names.update(a.asname or a.name for a in node.names)
    return names


def _is_cpu(node: ast.AST) -> bool:
    return isinstance(node, ast.Constant) and node.value == "cpu"


def _sync_desc(node: ast.Call, aliases: Set[str]) -> Optional[str]:
    """How ``node`` makes the host wait for the device, or None."""
    func = node.func
    if isinstance(func, ast.Attribute):
        if func.attr in _SYNC_ATTRS and not node.args and not node.keywords:
            return f".{func.attr}()"
        if func.attr == "to" and (
                (node.args and _is_cpu(node.args[0]))
                or any(kw.arg == "device" and _is_cpu(kw.value)
                       for kw in node.keywords)):
            return '.to("cpu")'
    fname = dotted(func)
    if fname in _STREAM_SYNCS:
        return f"{fname}()"
    if fname in _SYNC_CALLS and node.args:
        return f"{fname}(...)"
    if fname in _SCALARS and len(node.args) == 1:
        arg = node.args[0]
        # bool(done.all()), float(loss), int(tok[0]) read a tensor;
        # int(np.prod(s)) and int(args.epochs) are host values
        if isinstance(arg, (ast.Name, ast.Subscript)) or (
                isinstance(arg, ast.Call)
                and isinstance(arg.func, ast.Attribute)
                and isinstance(arg.func.value, ast.Name)
                and arg.func.value.id not in aliases):
            return f"{fname}(...)"
    return None


def _inner_sync(node: ast.Call, aliases: Set[str]) -> bool:
    """Does the call's receiver or sole argument already sync?  Then the
    chain (``x.cpu().numpy()``, ``int(x.item())``) reports once, inside."""
    inner = node.func.value if isinstance(node.func, ast.Attribute) \
        else (node.args[0] if len(node.args) == 1 else None)
    return isinstance(inner, ast.Call) and _sync_desc(inner, aliases) is not None


def _looped_defs(ctx: ModuleContext) -> Set[int]:
    """ids of this module's defs that the call graph shows running once per
    iteration of some loop (``step()`` called from a serving loop runs its
    ``_decode_all()``, and that one's body, every iteration)."""
    cg = ensure_program(ctx).callgraph
    reached = cg.loop_reached()
    return {id(fi.node) for fi in cg.functions
            if fi.ctx is ctx and fi.qname in reached}


@rule("PT004", "host-sync-in-hot-path", Severity.WARNING,
      "pulling a CUDA tensor to the host inside a step/decode loop makes "
      "the host wait for the stream to drain, so the next launch queues "
      "behind the last one every iteration",
      example="""
      import torch

      def generate(model, tok, steps):
          for _ in range(steps):
              tok = model(tok)
              done = tok == 1
              if bool(done.all()):   # PT004: waits on the stream
                  break
          return tok
      """)
def pt004_host_sync(ctx: ModuleContext) -> List[Finding]:
    """Fires on ``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``,
    ``.to("cpu")``, ``torch.cuda.synchronize()``, ``np.asarray``/
    ``np.array``, and ``bool``/``float``/``int`` of a name, a subscript or
    a method call on a non-module name, inside a loop of a function whose
    name says step, decode, train or generate — or anywhere in such a
    function when resolved calls run it once per iteration of a loop."""
    out = []
    aliases = looped = None
    for node in ctx.nodes:
        if not isinstance(node, ast.Call):
            continue
        fn = _hot_function(ctx, node)
        if fn is None:
            continue
        loop = ctx.enclosing_loop(node)
        if loop is None:
            if looped is None:
                looped = _looped_defs(ctx)
            if id(fn) not in looped:
                continue
            where = f"in `{fn.name}`, which a loop calls every iteration,"
        elif in_loop_header(node, loop):
            continue
        else:
            where = f"inside the `{fn.name}` loop"
        if aliases is None:
            aliases = _module_aliases(ctx)
        desc = _sync_desc(node, aliases)
        if desc is None or _inner_sync(node, aliases):
            continue
        out.append(make_finding(
            ctx, "PT004", node,
            f"{desc} {where} forces a host-device "
            "sync every iteration — batch the transfer outside the "
            "loop or keep the value on device"))
    return out
