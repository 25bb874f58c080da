"""Trial schedulers — ASHA (async successive halving) and FIFO, copied from
``tpu_air/tune/schedulers.py``: the same report streams give the same
decisions.

Parity surface: ``ray.tune.schedulers.async_hyperband.ASHAScheduler(max_t=…)``
(Model_finetuning…ipynb:cc-51,57).  The reference uses it to early-stop
underperforming HPO trials on ``eval_loss`` per epoch (§3.2: "per-epoch metric
report → scheduler decision (continue/stop)").

Decision protocol: the Tuner calls ``on_result(trial_id, metrics)`` for every
streamed report and gets back CONTINUE or STOP.  ASHA is *asynchronous*: rung
decisions use whatever results have arrived so far — no barrier across trials
(the property that lets a trial's card lease recycle immediately).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

CONTINUE = "CONTINUE"
STOP = "STOP"


class TrialScheduler:
    def set_metric(self, metric: str, mode: str) -> None:
        """Inherit metric/mode from TuneConfig when not set explicitly."""
        if getattr(self, "metric", None) is None:
            self.metric = metric
        if getattr(self, "mode", None) is None:
            self.mode = mode

    def on_result(self, trial_id: str, metrics: Dict[str, Any]) -> str:
        return CONTINUE

    def on_trial_complete(self, trial_id: str) -> None:
        pass

    def reset(self) -> None:
        """Clear per-sweep state.  Called at the start of every ``fit()`` so a
        scheduler instance may be reused across sweeps; stateful built-ins
        override this."""


class FIFOScheduler(TrialScheduler):
    """No early stopping — every trial runs to completion."""


class ASHAScheduler(TrialScheduler):
    """Async Successive Halving.

    Rungs at ``grace_period * reduction_factor**k`` (in units of
    ``time_attr``, default ``training_iteration`` = epochs here) up to
    ``max_t``.  When a trial reaches a rung, its metric joins the rung's
    record; the trial continues only if it is in the top ``1/reduction_factor``
    fraction of results seen at that rung so far.  Reaching ``max_t`` stops
    the trial (budget exhausted).
    """

    def __init__(
        self,
        time_attr: str = "training_iteration",
        metric: Optional[str] = None,
        mode: Optional[str] = None,
        max_t: int = 100,
        grace_period: int = 1,
        reduction_factor: float = 4,
        brackets: int = 1,  # accepted for parity; single bracket implemented
    ):
        if max_t < grace_period:
            raise ValueError("max_t must be >= grace_period")
        self.time_attr = time_attr
        self.metric = metric
        self.mode = mode
        self.max_t = max_t
        self.grace_period = grace_period
        self.rf = reduction_factor
        # rung milestones ascending: g, g*rf, g*rf^2, ... < max_t
        self.milestones: List[int] = []
        t = grace_period
        while t < max_t:
            self.milestones.append(int(t))
            t *= reduction_factor
        # per-rung records keyed by trial: a trial joins each rung at most
        # once, at its first report with t >= milestone (reports may skip
        # milestone values when the loop's time_attr strides)
        self._rungs: Dict[int, Dict[str, float]] = {m: {} for m in self.milestones}
        self._stopped: set = set()

    def _key(self, metrics: Dict[str, Any]) -> Optional[float]:
        v = metrics.get(self.metric)
        if v is None:
            return None
        v = float(v)
        return -v if self.mode == "max" else v  # normalize: lower is better

    def on_result(self, trial_id: str, metrics: Dict[str, Any]) -> str:
        if trial_id in self._stopped:
            return STOP
        t = int(metrics.get(self.time_attr, 0))
        if t >= self.max_t:
            self._stopped.add(trial_id)
            return STOP
        val = self._key(metrics)
        if val is None:
            return CONTINUE
        decision = CONTINUE
        for m in self.milestones:
            if t >= m and trial_id not in self._rungs[m]:
                rung = self._rungs[m]
                rung[trial_id] = val
                vals = sorted(rung.values())
                k = max(1, int(len(vals) / self.rf))
                cutoff = vals[k - 1]
                if val > cutoff:
                    decision = STOP
                    break  # pruned here; don't join higher rungs
        if decision == STOP:
            self._stopped.add(trial_id)
        return decision

    def on_trial_complete(self, trial_id: str) -> None:
        self._stopped.discard(trial_id)

    def reset(self) -> None:
        self._rungs = {m: {} for m in self.milestones}
        self._stopped = set()
