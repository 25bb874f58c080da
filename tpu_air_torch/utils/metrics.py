"""Prometheus text-exposition helpers, copied from ``tpu_air/utils/metrics.py``
(the part the engine's metrics render with; the port imports nothing of
``tpu_air``)."""

from __future__ import annotations

import re
from typing import Any, Dict, List, Optional

_INVALID_METRIC_CHARS = re.compile(r"[^a-zA-Z0-9_:]")


def sanitize_metric_name(name: str) -> str:
    """Map an arbitrary metric key to a valid prometheus identifier:
    ``[a-zA-Z_:][a-zA-Z0-9_:]*``.  Dots, dashes, slashes and anything else
    outside the charset become ``_``; a leading digit gets a ``_`` prefix."""
    out = _INVALID_METRIC_CHARS.sub("_", name)
    if not out or out[0].isdigit():
        out = "_" + out
    return out


def escape_label_value(value: Any) -> str:
    """Prometheus label-value escaping (backslash, quote, newline)."""
    return (str(value).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


class ExpositionBuilder:
    """Prometheus/OpenMetrics text builder: sample lines grouped by metric
    FAMILY, each family emitted once with its ``# HELP`` / ``# TYPE``
    header — the scrape-format contract the seed's ad-hoc line lists never
    honored.  Families render in declaration order; families that gathered
    no samples are dropped.  Histogram families get ``_bucket``/``_sum``/
    ``_count`` series via :meth:`histogram`, with OpenMetrics exemplars
    (``# {trace_id="..."} value ts``) appended to bucket lines that carry
    one."""

    def __init__(self):
        self._order: List[str] = []
        self._fams: Dict[str, Dict[str, Any]] = {}

    def declare(self, name: str, mtype: str, help_text: str) -> str:
        if name not in self._fams:
            self._fams[name] = {"type": mtype, "help": help_text,
                                "lines": []}
            self._order.append(name)
        return name

    def _labelstr(self, labels: Optional[Dict[str, Any]]) -> str:
        if not labels:
            return ""
        inner = ",".join(f'{k}="{escape_label_value(v)}"'
                         for k, v in labels.items())
        return "{" + inner + "}"

    def sample(self, family: str, labels: Optional[Dict[str, Any]],
               value: Any, *, suffix: str = "") -> None:
        """One sample line under ``family`` (declare first).  ``suffix``
        appends to the metric name (``_bucket``, ``_count``...)."""
        if isinstance(value, float):
            sval = f"{value:.6f}" if 1e-6 <= abs(value) < 1e9 or value == 0 \
                else f"{value:.6g}"
        else:
            sval = str(value)
        self._fams[family]["lines"].append(
            f"{family}{suffix}{self._labelstr(labels)} {sval}")

    def raw(self, family: str, line: str) -> None:
        self._fams[family]["lines"].append(line)

    def histogram(self, family: str, labels: Optional[Dict[str, Any]],
                  cumulative, count: int, total_sum: float) -> None:
        """Emit a full histogram series: ``cumulative`` is
        ``[(upper_bound, cum_count, exemplar_or_None), ...]`` ascending
        (perf.Histogram.cumulative_buckets / perf.cumulative_from_summary);
        the ``+Inf`` bucket, ``_sum`` and ``_count`` are appended here."""
        base = dict(labels or {})
        for upper, cum, ex in cumulative:
            lab = self._labelstr({**base, "le": f"{upper:.9g}"})
            line = f"{family}_bucket{lab} {cum}"
            if ex and ex.get("trace_id"):
                line += (f' # {{trace_id="{escape_label_value(ex["trace_id"])}"}}'
                         f' {ex["value"]:.6g} {ex.get("ts", 0):.3f}')
            self._fams[family]["lines"].append(line)
        lab = self._labelstr({**base, "le": "+Inf"})
        self._fams[family]["lines"].append(f"{family}_bucket{lab} {count}")
        slab = self._labelstr(base)
        self._fams[family]["lines"].append(
            f"{family}_sum{slab} {total_sum:.6f}")
        self._fams[family]["lines"].append(f"{family}_count{slab} {count}")

    def lines(self) -> List[str]:
        out: List[str] = []
        for name in self._order:
            fam = self._fams[name]
            if not fam["lines"]:
                continue
            out.append(f"# HELP {name} {fam['help']}")
            out.append(f"# TYPE {name} {fam['type']}")
            out.extend(fam["lines"])
        return out
