"""Crash-consistency & fault-coverage rules CS001–CS003 / FI001.

Thin rule surface over :class:`..crashflow.CrashFlowAnalysis` — the
program analysis runs once per ProgramContext and each rule filters the
shared result down to the file being reported (same pattern as the
lockset rules).  Semantics, the effect lattice, and the annotation
syntax are documented in docs/ANALYSIS.md.
"""

from __future__ import annotations

from ..findings import Severity
from ..registry import rule
from . import ensure_program


@rule("CS001", "non-atomic-publish", Severity.ERROR,
      "a write opened directly on a reader-visible final path, in a flow "
      "that seals its other writes with tmp+rename, publishes torn bytes "
      "to anyone who reads (or crashes) mid-write",
      example="""
      import json, os

      def publish(state, path):
          tmp = path + ".tmp"
          with open(tmp, "w") as f:       # sealed write: fine
              json.dump(state, f)
              f.flush()
              os.fsync(f.fileno())
          os.replace(tmp, path)
          with open("manifest.json", "w") as f:   # CS001: final path,
              json.dump({"ok": True}, f)          # no tmp+rename seal
      """)
def check_non_atomic_publish(ctx):
    """Fires on a ``write(P)`` effect where the expanded flow contains
    durability discipline (a rename or fsync somewhere), P is not
    temp-like, and P is never the source of a rename in the same flow."""
    return ensure_program(ctx).findings_for(ctx.path, "CS001")


@rule("CS002", "rename-without-fsync", Severity.ERROR,
      "os.rename/os.replace is atomic but does not make the source's "
      "bytes durable — after power loss the rename can survive while the "
      "data does not, leaving a torn file at the final path",
      example="""
      import json, os

      def seal(state, path):
          tmp = path + ".tmp"
          with open(tmp, "w") as f:
              json.dump(state, f)
          os.replace(tmp, path)   # CS002: no flush+fsync before the seal
      """)
def check_rename_without_fsync(ctx):
    """Fires on a ``rename(src, dst)`` whose nearest preceding
    ``write(src)`` in the expanded sequence is not followed by flush+fsync
    before the rename.  No visible write of src means unknown provenance,
    and unknown degrades to silence."""
    return ensure_program(ctx).findings_for(ctx.path, "CS002")


@rule("CS003", "commit-order-inversion", Severity.ERROR,
      "a declared commit point ordered before a data write it covers "
      "publishes, on crash, a commit that names data which never became "
      "durable — the exact torn-publish hole the manifest-written-LAST "
      "and chunk-before-checkpoint disciplines exist to close",
      example="""
      # aircrash annotations declare the coverage pair; the analysis
      # proves the order interprocedurally.
      def checkpoint(store, cursors):
          store.put(cursors, object_id="ckpt")   # aircrash: commits epoch

      def run(store, chunk):
          checkpoint(store, [0])                 # CS003: commit first...
          store.put(chunk, object_id="c0")       # aircrash: data epoch
      """)
def check_commit_order_inversion(ctx):
    """Fires when a ``# aircrash: commits <tag>`` effect precedes a
    ``# aircrash: data <tag>`` effect of the same tag anywhere in a
    transitively expanded sequence.  Zero findings over annotated code is
    a machine-checked proof the shipped commit order is correct."""
    return ensure_program(ctx).findings_for(ctx.path, "CS003")


@rule("FI001", "unperturbed-boundary", Severity.WARNING,
      "a cross-process side-effect primitive reachable from a "
      "serve/train/batch entry point with no faults.perturb() site on the "
      "path is a boundary the seeded chaos lane can never exercise — "
      "fault-injection coverage rots silently as subsystems land",
      example="""
      import subprocess
      from tpu_air_torch.faults import plan as _faults

      def fetch(cmd):          # covered: perturb site on the path
          _faults.perturb("fetch.exec", key=cmd)
          subprocess.run([cmd])

      def publish(cmd):        # aircrash: entry
          subprocess.run([cmd])   # FI001: no perturb site on this path
      """)
def check_unperturbed_boundary(ctx):
    """Fires on a socket/subprocess/object-store/actor-call/os._exit call
    site reachable from an entry point (public serve/train/batch function
    or ``# aircrash: entry``) along a call path with no perturb site.
    Dynamic-dispatch primitives are credited when their funnel module
    (core.remote, core.object_store) carries the hook."""
    return ensure_program(ctx).findings_for(ctx.path, "FI001")
