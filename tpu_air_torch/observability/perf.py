"""airscope — the perf pillar of observability, copied from
``tpu_air/observability/perf.py`` (the port imports nothing of ``tpu_air``;
only :func:`detect_peak` differs: it reads the CUDA card, not a TPU).

Three pieces, each usable alone:

* :class:`Histogram` — a thread-safe log-bucketed streaming histogram.
  Buckets grow by ``2**(1/4)`` (≤ ~9% relative error per bucket), counts
  are a sparse ``{bucket_index: count}`` dict so two histograms — or two
  serialized snapshots from different replicas — merge by adding counts.
  Each bucket optionally carries an OpenMetrics-style *exemplar*: the
  airtrace ``trace_id`` of the bucket's worst recent sample, so a p99 on
  the dashboard is one ``/api/traces?trace_id=`` click from its span tree.
  This replaces the seed's 256-sample deques + sorted-index quantiles:
  quantiles here are unwindowed and unbiased to bucket resolution.

* :class:`LMCostModel` — an analytic flops/bytes model for the engine's
  compiled programs (paged decode step, prefill chunk, train step),
  derived from model geometry the way the pjit/TPUv4 scaling work does it
  (PAPERS.md, arXiv:2204.06514): costs come from the shapes the machine
  actually executes (fixed S×slot_len decode, ``[1, page_len]`` chunks),
  not from per-request token counts.

* :class:`PerfLedger` — accumulates ``(cost, seconds)`` per program kind
  into achieved flops/s and bytes/s, a roofline fraction against a
  detected-or-configured peak (:func:`detect_peak` — CPU fallback
  constants keep tier-1 meaningful everywhere), and a goodput split of
  emitted tokens into useful vs. wasted work (shed-after-prefill,
  re-prefilled-on-cache-miss, dead-stream; spec-decode rejections plug in
  as just another category).
"""

from __future__ import annotations

import math
import os
import threading
import time
from dataclasses import dataclass
from typing import Any, Dict, Iterable, List, Optional

# -- histogram ---------------------------------------------------------------

# bucket upper bounds are _BASE**i for integer i (i may be negative);
# bucket i covers (_BASE**(i-1), _BASE**i].  2**(1/4) keeps relative
# quantile error under ~9% while a seconds-scale latency range
# (1e-6 .. 1e3) still spans only ~120 live buckets.
_BASE = 2.0 ** 0.25
_LN_BASE = math.log(_BASE)
# values at or below this clamp into the bottom bucket (latencies are
# positive; 1ns is far below anything a host-side timer can resolve)
_MIN_VALUE = 1e-9
# an exemplar older than this loses its slot to ANY newer sample, even a
# smaller one — "worst recent", not "worst ever"
_EXEMPLAR_TTL_S = 300.0


def bucket_index(value: float) -> int:
    """The histogram bucket a value lands in: smallest integer ``i`` with
    ``value <= _BASE**i`` (epsilon keeps exact bounds in their own bucket)."""
    v = max(float(value), _MIN_VALUE)
    return math.ceil(math.log(v) / _LN_BASE - 1e-9)


def bucket_upper(index: int) -> float:
    """Inclusive upper bound of bucket ``index``."""
    return math.exp(index * _LN_BASE)


class Histogram:
    """Streaming log-bucketed histogram with mergeable buckets and
    per-bucket trace exemplars.  All methods are thread-safe."""

    def __init__(self):
        self._lock = threading.Lock()
        self._buckets: Dict[int, int] = {}
        self._exemplars: Dict[int, Dict[str, Any]] = {}
        self._count = 0
        self._sum = 0.0
        self._min = math.inf
        self._max = -math.inf

    # -- recording -----------------------------------------------------------
    def observe(self, value: float, trace_id: Optional[str] = None) -> None:
        v = float(value)
        idx = bucket_index(v)
        now = time.time()
        with self._lock:
            self._buckets[idx] = self._buckets.get(idx, 0) + 1
            self._count += 1
            self._sum += v
            if v < self._min:
                self._min = v
            if v > self._max:
                self._max = v
            if trace_id:
                ex = self._exemplars.get(idx)
                if (ex is None or v >= ex["value"]
                        or now - ex["ts"] > _EXEMPLAR_TTL_S):
                    self._exemplars[idx] = {
                        "value": v, "trace_id": trace_id, "ts": now}

    def merge_state(self, state: Dict[str, Any]) -> None:
        """Fold a serialized snapshot (:meth:`to_dict` of another instance,
        possibly from another process) into this histogram."""
        if not state or not state.get("count"):
            return
        with self._lock:
            for key, n in (state.get("buckets") or {}).items():
                idx = int(key)
                self._buckets[idx] = self._buckets.get(idx, 0) + int(n)
            for key, ex in (state.get("exemplars") or {}).items():
                idx = int(key)
                mine = self._exemplars.get(idx)
                if mine is None or ex["value"] >= mine["value"]:
                    self._exemplars[idx] = dict(ex)
            self._count += int(state["count"])
            self._sum += float(state.get("sum", 0.0))
            if "min" in state:
                self._min = min(self._min, float(state["min"]))
            if "max" in state:
                self._max = max(self._max, float(state["max"]))

    def merge(self, other: "Histogram") -> None:
        # sequential lock holds (other's, then ours) — never nested
        self.merge_state(other.to_dict())

    def reset(self) -> None:
        with self._lock:
            self._buckets.clear()
            self._exemplars.clear()
            self._count = 0
            self._sum = 0.0
            self._min = math.inf
            self._max = -math.inf

    # -- reading -------------------------------------------------------------
    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    def quantile(self, q: float) -> float:
        with self._lock:
            return self._quantile_locked(q)

    def _quantile_locked(self, q: float) -> float:
        if self._count == 0:
            return 0.0
        rank = q * self._count
        if rank <= 0:
            return self._min
        cum = 0
        for idx in sorted(self._buckets):
            c = self._buckets[idx]
            cum += c
            if cum >= rank:
                hi = bucket_upper(idx)
                lo = bucket_upper(idx - 1)
                frac = (rank - (cum - c)) / c
                v = lo + frac * (hi - lo)
                # observed extremes are exact — clamp the interpolation
                return min(max(v, self._min), self._max)
        return self._max

    def to_dict(self) -> Dict[str, Any]:
        """Serializable state: str bucket keys (JSON round-trips), plus the
        summary scalars.  ``from_dict``/``merge_state`` accept it back."""
        with self._lock:
            out: Dict[str, Any] = {
                "count": self._count,
                "sum": self._sum,
                "buckets": {str(i): c for i, c in sorted(self._buckets.items())},
            }
            if self._count:
                out["min"] = self._min
                out["max"] = self._max
            if self._exemplars:
                out["exemplars"] = {
                    str(i): dict(ex)
                    for i, ex in sorted(self._exemplars.items())
                }
            return out

    @classmethod
    def from_dict(cls, state: Dict[str, Any]) -> "Histogram":
        h = cls()
        h.merge_state(state or {})
        return h

    def summary(self) -> Dict[str, Any]:
        """The engine-snapshot distribution dict.  Superset of the seed's
        ``_dist`` keys (count/mean/p50/p95/p99/max) so every existing
        consumer keeps working; ``buckets``/``sum``/``exemplars`` make it
        mergeable and exemplar-linked downstream."""
        with self._lock:
            if self._count == 0:
                return {"count": 0}
            out = {
                "count": self._count,
                "mean": self._sum / self._count,
                "p50": self._quantile_locked(0.50),
                "p95": self._quantile_locked(0.95),
                "p99": self._quantile_locked(0.99),
                "min": self._min,
                "max": self._max,
                "sum": self._sum,
                "buckets": {str(i): c for i, c in sorted(self._buckets.items())},
            }
            if self._exemplars:
                out["exemplars"] = {
                    str(i): dict(ex)
                    for i, ex in sorted(self._exemplars.items())
                }
            return out

    def cumulative_buckets(self) -> List[Any]:
        """``[(upper_bound, cumulative_count, exemplar_or_None), ...]`` over
        the non-empty buckets, ascending — the prometheus ``_bucket`` series
        (caller appends the ``+Inf`` bound = count)."""
        with self._lock:
            out = []
            cum = 0
            for idx in sorted(self._buckets):
                cum += self._buckets[idx]
                out.append((bucket_upper(idx), cum, self._exemplars.get(idx)))
            return out


def cumulative_from_summary(summary: Dict[str, Any]) -> List[Any]:
    """``[(upper_bound, cumulative_count, exemplar_or_None), ...]`` from a
    SERIALIZED distribution dict — the prometheus ``_bucket`` series for
    snapshots that already crossed a process boundary."""
    buckets = (summary or {}).get("buckets") or {}
    exemplars = (summary or {}).get("exemplars") or {}
    out = []
    cum = 0
    for idx in sorted(int(k) for k in buckets):
        cum += int(buckets[str(idx)])
        out.append((bucket_upper(idx), cum, exemplars.get(str(idx))))
    return out


def merge_summaries(summaries: Iterable[Dict[str, Any]]) -> Dict[str, Any]:
    """Merge distribution dicts (``Histogram.summary()`` outputs, possibly
    JSON-round-tripped from other replicas) into one summary.  Entries
    without ``buckets`` (a pre-airscope snapshot, or a synthetic test dict)
    degrade gracefully: their counts still add and the merged max/p99 are
    at least as large as theirs."""
    h = Histogram()
    legacy_count = 0
    legacy_floor: Dict[str, float] = {}
    for s in summaries:
        if not s or not s.get("count"):
            continue
        if s.get("buckets"):
            h.merge_state(s)
        else:
            legacy_count += int(s["count"])
            for k in ("p50", "p95", "p99", "max", "mean"):
                if k in s:
                    legacy_floor[k] = max(legacy_floor.get(k, 0.0),
                                          float(s[k]))
    out = h.summary()
    if legacy_count:
        out["count"] = out.get("count", 0) + legacy_count
        for k, v in legacy_floor.items():
            out[k] = max(out.get(k, 0.0), v)
    return out


def exemplar_trace_id(summary: Dict[str, Any],
                      q: float = 0.99) -> Optional[str]:
    """The trace id joined to the tail of a distribution: the exemplar of
    the highest bucket at or below the q-quantile's bucket (falling back to
    the worst exemplar present).  None when the summary carries none."""
    exemplars = (summary or {}).get("exemplars") or {}
    if not exemplars:
        return None
    best_idx = max(int(i) for i in exemplars)
    return exemplars[str(best_idx)]["trace_id"]


# -- peak detection ----------------------------------------------------------

# dense bf16 peak FLOPs/s and HBM bytes/s per card, by the prefix of
# ``torch.cuda.get_device_name`` (the H100 SXM data sheet's peaks, which
# PERF.md's kernel bounds use too)
_PEAK_FLOPS: Dict[str, float] = {
    "NVIDIA H100": 989e12,
}
_PEAK_HBM_BYTES: Dict[str, float] = {
    "NVIDIA H100": 3.35e12,
}
# CPU fallback: a nominal desktop-class core complex (placeholder so the
# roofline fraction is nonzero and stable in CPU test runs; the absolute
# value is NOT a hardware claim — the `source` field says so)
_CPU_PEAK_FLOPS = 5e11
_CPU_PEAK_BYTES = 5e10


@dataclass(frozen=True)
class PeakSpec:
    """The roofline ceiling the ledger divides by."""

    flops_per_s: float
    bytes_per_s: float
    source: str  # "env" | device name prefix | "cpu-fallback"


def detect_peak() -> PeakSpec:
    """Resolve the peak spec: env overrides (``TPU_AIR_PEAK_FLOPS``,
    ``TPU_AIR_PEAK_BYTES``) win; otherwise the CUDA card's name in the
    table; otherwise (no CUDA, or a card not in the table) the CPU
    fallback constants."""
    env_f = os.environ.get("TPU_AIR_PEAK_FLOPS")
    env_b = os.environ.get("TPU_AIR_PEAK_BYTES")
    if env_f or env_b:
        return PeakSpec(
            flops_per_s=float(env_f) if env_f else _CPU_PEAK_FLOPS,
            bytes_per_s=float(env_b) if env_b else _CPU_PEAK_BYTES,
            source="env",
        )
    import torch

    kind = torch.cuda.get_device_name() if torch.cuda.is_available() else ""
    for k in sorted(_PEAK_FLOPS, key=len, reverse=True):
        if kind.startswith(k):
            return PeakSpec(flops_per_s=_PEAK_FLOPS[k],
                            bytes_per_s=_PEAK_HBM_BYTES[k], source=k)
    return PeakSpec(_CPU_PEAK_FLOPS, _CPU_PEAK_BYTES, source="cpu-fallback")


# -- analytic cost model -----------------------------------------------------

_DTYPE_BYTES = {
    "float32": 4, "f32": 4, "float64": 8,
    "bfloat16": 2, "bf16": 2, "float16": 2, "f16": 2,
    "int8": 1, "uint8": 1,
}


@dataclass(frozen=True)
class ProgramCost:
    """What one execution of a compiled program costs the machine."""

    flops: float
    hbm_bytes: float
    tokens: int = 0

    def scaled(self, n: float) -> "ProgramCost":
        return ProgramCost(self.flops * n, self.hbm_bytes * n,
                           int(self.tokens * n))


class LMCostModel:
    """Flops/bytes for the decoder-only LM's compiled programs.

    Geometry (``D`` d_model, ``H`` heads, ``Dh`` head_dim, ``F`` d_ff,
    ``L`` layers, ``V`` vocab, ``b`` dtype bytes) gives the exact formulas
    the unit tests hand-compute:

    * matmul params/layer: ``4*D*H*Dh`` (q,k,v,o) + ``3*D*F`` (SwiGLU
      gate/up/down); lm head compute ``D*V`` per token (params stored only
      when untied; embedding lookup adds no matmul flops).
    * linear flops/token: ``2 * (L*(4*D*H*Dh + 3*D*F) + D*V)``.
    * attention flops: ``4*H*Dh*P`` per layer for a token attending ``P``
      positions (QK^T and AV, 2 flops/MAC each).
    * KV bytes/position: ``L * 2*H*Dh * b`` (K and V, all layers).

    Norms, rotary embeddings and softmax are omitted (≪1% of the matmul
    budget at any real geometry); the model is deliberately closed-form so
    identical claims can be recomputed anywhere (arXiv:2204.06514 §4).
    """

    def __init__(self, config):
        self.d_model = int(config.d_model)
        self.n_layers = int(config.n_layers)
        self.n_heads = int(config.n_heads)
        self.head_dim = int(config.head_dim)
        self.d_ff = int(config.d_ff)
        self.vocab_size = int(config.vocab_size)
        self.tie_embeddings = bool(getattr(config, "tie_embeddings", True))
        self.dtype_bytes = _DTYPE_BYTES.get(
            str(getattr(config, "dtype", "float32")), 4)

    # -- derived geometry ----------------------------------------------------
    @property
    def matmul_params(self) -> int:
        hd = self.n_heads * self.head_dim
        return self.n_layers * (
            4 * self.d_model * hd + 3 * self.d_model * self.d_ff)

    @property
    def param_count(self) -> int:
        n = self.vocab_size * self.d_model + self.matmul_params
        if not self.tie_embeddings:
            n += self.d_model * self.vocab_size
        return n

    @property
    def param_bytes(self) -> int:
        return self.param_count * self.dtype_bytes

    @property
    def linear_flops_per_token(self) -> float:
        return 2.0 * (self.matmul_params
                      + self.d_model * self.vocab_size)

    @property
    def kv_bytes_per_position(self) -> float:
        return self.n_layers * 2 * self.n_heads * self.head_dim \
            * self.dtype_bytes

    def attention_flops(self, attended_positions: float) -> float:
        """Per ONE token attending over ``attended_positions``."""
        return self.n_layers * 4.0 * self.n_heads * self.head_dim \
            * attended_positions

    # -- program costs -------------------------------------------------------
    def decode_step_cost(self, rows: int, attended: int) -> ProgramCost:
        """One fixed-shape pool decode step: ``rows`` slots each computing
        one token and attending the COMPILED context length (the paged
        gather reads ``attended = slot_len`` positions per row regardless
        of occupancy — that is what the machine executes)."""
        flops = rows * (self.linear_flops_per_token
                        + self.attention_flops(attended))
        hbm = (self.param_bytes
               + rows * attended * self.kv_bytes_per_position   # KV read
               + rows * self.kv_bytes_per_position)             # KV write
        return ProgramCost(flops=flops, hbm_bytes=hbm, tokens=rows)

    def prefill_chunk_cost(self, chunk_len: int,
                           start_pos: int) -> ProgramCost:
        """One ``[1, chunk_len]`` prefill chunk starting at ``start_pos``:
        token ``t`` of the chunk attends ``start_pos + t + 1`` positions, so
        the chunk's attended-position total is
        ``chunk_len*start_pos + chunk_len*(chunk_len+1)/2``."""
        c = int(chunk_len)
        attended_sum = c * start_pos + c * (c + 1) / 2.0
        flops = (c * self.linear_flops_per_token
                 + self.attention_flops(attended_sum))
        hbm = (self.param_bytes
               + (start_pos + c) * self.kv_bytes_per_position   # prefix read
               + c * self.kv_bytes_per_position)                # KV write
        return ProgramCost(flops=flops, hbm_bytes=hbm, tokens=c)

    def train_step_cost(self, batch: int, seq_len: int) -> ProgramCost:
        """One train step over ``[batch, seq_len]``: backward ≈ 2× forward
        (the standard 3× multiplier), bytes ≈ 3 weight-sized streams
        (params + grads + optimizer update) plus activation KV traffic."""
        tokens = batch * seq_len
        attended_sum = batch * seq_len * (seq_len + 1) / 2.0
        fwd = (tokens * self.linear_flops_per_token
               + self.attention_flops(attended_sum))
        hbm = 3.0 * self.param_bytes \
            + 2.0 * tokens * self.kv_bytes_per_position
        return ProgramCost(flops=3.0 * fwd, hbm_bytes=hbm, tokens=tokens)


# -- the ledger --------------------------------------------------------------

# wasted-token categories the engine reports today; the set is open —
# ledger.record_tokens accepts any string (spec-decode rejections land as
# "spec_rejected" without a ledger change)
WASTED_CATEGORIES = ("shed_after_prefill", "reprefill_cache_miss",
                     "dead_stream")


class PerfLedger:
    """Per-engine accumulator: program costs → achieved rates + roofline
    fraction; token categories → goodput ratio.  Thread-safe."""

    def __init__(self, peak: Optional[PeakSpec] = None):
        self._lock = threading.Lock()
        self._peak = peak or detect_peak()
        self._programs: Dict[str, Dict[str, float]] = {}
        self._tokens: Dict[str, int] = {}

    def record_program(self, kind: str, cost: ProgramCost,
                       seconds: float, calls: int = 1) -> None:
        with self._lock:
            p = self._programs.setdefault(
                kind, {"calls": 0, "flops": 0.0, "bytes": 0.0,
                       "seconds": 0.0, "tokens": 0})
            p["calls"] += int(calls)
            p["flops"] += cost.flops
            p["bytes"] += cost.hbm_bytes
            p["seconds"] += max(float(seconds), 0.0)
            p["tokens"] += cost.tokens

    def record_tokens(self, category: str, n: int) -> None:
        """Goodput accounting: ``category`` is ``"useful"`` or a wasted
        class (``WASTED_CATEGORIES`` or any future string)."""
        if n <= 0:
            return
        with self._lock:
            self._tokens[category] = self._tokens.get(category, 0) + int(n)

    def reset(self) -> None:
        """Clear accumulators (bench steady-state windows)."""
        with self._lock:
            self._programs.clear()
            self._tokens.clear()

    def _ideal_seconds(self, flops: float, nbytes: float) -> float:
        return max(flops / self._peak.flops_per_s,
                   nbytes / self._peak.bytes_per_s)

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            programs: Dict[str, Any] = {}
            tot_flops = tot_bytes = tot_seconds = 0.0
            tot_ideal = 0.0
            for kind, p in sorted(self._programs.items()):
                secs = p["seconds"]
                ideal = self._ideal_seconds(p["flops"], p["bytes"])
                programs[kind] = {
                    "calls": int(p["calls"]),
                    "flops": p["flops"],
                    "bytes": p["bytes"],
                    "seconds": secs,
                    "tokens": int(p["tokens"]),
                    "flops_per_s": p["flops"] / secs if secs else 0.0,
                    "bytes_per_s": p["bytes"] / secs if secs else 0.0,
                    "roofline_fraction": ideal / secs if secs else 0.0,
                }
                tot_flops += p["flops"]
                tot_bytes += p["bytes"]
                tot_seconds += secs
                tot_ideal += ideal
            useful = self._tokens.get("useful", 0)
            wasted = sum(n for cat, n in self._tokens.items()
                         if cat != "useful")
            total = useful + wasted
            return {
                "peak": {
                    "flops_per_s": self._peak.flops_per_s,
                    "bytes_per_s": self._peak.bytes_per_s,
                    "source": self._peak.source,
                },
                "programs": programs,
                "totals": {
                    "flops": tot_flops,
                    "bytes": tot_bytes,
                    "seconds": tot_seconds,
                    "flops_per_s": tot_flops / tot_seconds
                    if tot_seconds else 0.0,
                    "bytes_per_s": tot_bytes / tot_seconds
                    if tot_seconds else 0.0,
                    "roofline_fraction": tot_ideal / tot_seconds
                    if tot_seconds else 0.0,
                },
                "goodput": {
                    **{cat: int(n) for cat, n in sorted(self._tokens.items())},
                    "total": total,
                    "wasted": wasted,
                    "goodput_ratio": useful / total if total else 1.0,
                },
            }


def merge_ledger_snapshots(snaps: Iterable[Dict[str, Any]]
                           ) -> Dict[str, Any]:
    """Fleet view: sum program accumulators and token categories across
    ledger snapshots (rates/fractions recomputed from the sums; the peak
    of the FIRST snapshot wins — replicas share hardware)."""
    snaps = [s for s in snaps if s]
    if not snaps:
        return {}
    peak = snaps[0].get("peak") or {
        "flops_per_s": _CPU_PEAK_FLOPS, "bytes_per_s": _CPU_PEAK_BYTES,
        "source": "cpu-fallback"}
    ledger = PerfLedger(PeakSpec(peak["flops_per_s"], peak["bytes_per_s"],
                                 peak.get("source", "merged")))
    for s in snaps:
        for kind, p in (s.get("programs") or {}).items():
            ledger.record_program(
                kind,
                ProgramCost(p.get("flops", 0.0), p.get("bytes", 0.0),
                            int(p.get("tokens", 0))),
                p.get("seconds", 0.0), calls=int(p.get("calls", 1)))
        for cat, n in (s.get("goodput") or {}).items():
            if cat in ("total", "wasted", "goodput_ratio"):
                continue
            ledger.record_tokens(cat, int(n))
    return ledger.snapshot()
