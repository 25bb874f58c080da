"""CC-family rules: concurrency hazards from the lockset analysis.

The heavy lifting happens once per program in
:class:`~tpu_air_torch.analysis.dataflow.lockset.LocksetAnalysis`; each rule
here just surfaces that run's findings for the file under report.
Suppression policy for CC rules is documented in docs/ANALYSIS.md — a CC
suppression reason must say which thread discipline makes the access
safe, not merely that it "works".
"""

from __future__ import annotations

from typing import List

from ..findings import Finding, Severity
from ..registry import rule
from . import ensure_program


@rule("CC001", "unguarded-shared-field", Severity.ERROR,
      "a field accessed by more than one thread under empty or disjoint "
      "locksets is a data race: torn reads, lost updates, and gauges that "
      "lie under load")
def cc001_unguarded_shared_field(ctx) -> List[Finding]:
    return ensure_program(ctx).findings_for(ctx.path, "CC001")


@rule("CC002", "lock-order-inversion", Severity.ERROR,
      "two locks taken in both orders anywhere in the call graph deadlock "
      "the first time the schedulers interleave the two paths")
def cc002_lock_order_inversion(ctx) -> List[Finding]:
    return ensure_program(ctx).findings_for(ctx.path, "CC002")


@rule("CC003", "blocking-call-while-holding-lock", Severity.WARNING,
      "a sleep/wait/IO call under a held lock convoys every thread that "
      "contends for it — latency spikes that look like load but are lock "
      "shadow")
def cc003_blocking_under_lock(ctx) -> List[Finding]:
    return ensure_program(ctx).findings_for(ctx.path, "CC003")
