"""Shared per-module AST infrastructure for airlint rules.

One :class:`ModuleContext` is built per file: parse tree, parent links and
comment map (the JAX analyzer's jit and donation tables have no reader
here).  Everything here is pure ``ast``/``tokenize``.
"""

from __future__ import annotations

import ast
import io
import tokenize
from typing import Dict, Iterator, List, Optional, Tuple


def dotted(node: ast.AST) -> Optional[str]:
    """``a.b.c`` for a Name/Attribute chain, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


class ModuleContext:
    """Parse tree + derived tables for one source file."""

    def __init__(self, path: str, source: str):
        self.path = path
        self.source = source
        self.tree = ast.parse(source, filename=path)
        self._parents: Dict[ast.AST, ast.AST] = {}
        self.nodes: List[ast.AST] = [self.tree]
        for parent in self.nodes:  # grows while iterating: preorder walk
            for child in ast.iter_child_nodes(parent):
                self._parents[child] = parent
                self.nodes.append(child)
        self.comments = self._comment_map(source)
        self._decorated_spans = None
        # the ProgramContext of the analysis run (set by analyze_paths /
        # analyze_source); dataflow rules consult it for cross-module state
        self.program = None

    # -- structure -----------------------------------------------------------
    def parent(self, node: ast.AST) -> Optional[ast.AST]:
        return self._parents.get(node)

    def ancestors(self, node: ast.AST) -> Iterator[ast.AST]:
        cur = self._parents.get(node)
        while cur is not None:
            yield cur
            cur = self._parents.get(cur)

    def enclosing_function(self, node: ast.AST):
        for anc in self.ancestors(node):
            if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef)):
                return anc
        return None

    def enclosing_loop(self, node: ast.AST):
        """Nearest For/While ancestor *within* the same function scope."""
        for anc in self.ancestors(node):
            if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
                return None
            if isinstance(anc, (ast.For, ast.AsyncFor, ast.While)):
                return anc
        return None

    # -- statement spans -----------------------------------------------------
    def decorated_spans(self) -> List[Tuple[int, int]]:
        """Inclusive line spans (first decorator line → last header line)
        of every decorated def/class.  A suppression anywhere in the span
        covers findings reported anywhere in it — rules report on the
        decorator OR the ``def`` line, and a comment above the statement
        must attach to both."""
        if self._decorated_spans is None:
            spans = []
            for node in self.nodes:
                if (isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                      ast.ClassDef))
                        and node.decorator_list):
                    start = min(d.lineno for d in node.decorator_list)
                    body_start = node.body[0].lineno if node.body \
                        else node.lineno
                    spans.append((start, max(node.lineno, body_start - 1)))
            self._decorated_spans = spans
        return self._decorated_spans

    # -- comments ------------------------------------------------------------
    @staticmethod
    def _comment_map(source: str) -> Dict[int, Tuple[int, str]]:
        """{line -> (col, comment_text_without_hash)} via tokenize (immune
        to '#' inside string literals)."""
        out: Dict[int, Tuple[int, str]] = {}
        try:
            for tok in tokenize.generate_tokens(io.StringIO(source).readline):
                if tok.type == tokenize.COMMENT:
                    out[tok.start[0]] = (tok.start[1], tok.string.lstrip("#").strip())
        except (tokenize.TokenError, IndentationError):  # pragma: no cover
            pass  # comment-dependent rules degrade gracefully
        return out

    def comment_on(self, line: int) -> Optional[str]:
        entry = self.comments.get(line)
        return entry[1] if entry else None

    def comment_is_standalone(self, line: int) -> bool:
        """True when line ``line`` holds only a comment (no code)."""
        entry = self.comments.get(line)
        if entry is None:
            return False
        lines = self.source.splitlines()
        if not (1 <= line <= len(lines)):
            return False
        return lines[line - 1][: entry[0]].strip() == ""
