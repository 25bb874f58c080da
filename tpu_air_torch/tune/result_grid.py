"""ResultGrid — the return value of Tuner.fit(), copied from
``tpu_air/tune/result_grid.py``.

Parity surface: ``.errors``, ``.get_best_result()``,
``best_result.checkpoint/.metrics`` (Introduction_to_Ray_AI_Runtime.ipynb:
cc-49,52), per-trial failure isolation (§5: "a failed trial must not kill the
sweep — ResultGrid.errors semantics").
"""

from __future__ import annotations

from typing import List, Optional

import pandas as pd

from tpu_air_torch.train.result import Result


class ResultGrid:
    def __init__(self, results: List[Result], metric: Optional[str] = None,
                 mode: Optional[str] = None):
        self._results = results
        self._metric = metric
        self._mode = mode

    def __len__(self) -> int:
        return len(self._results)

    def __getitem__(self, i: int) -> Result:
        return self._results[i]

    def __iter__(self):
        return iter(self._results)

    @property
    def errors(self) -> List[Exception]:
        return [r.error for r in self._results if r.error is not None]

    @property
    def num_errors(self) -> int:
        return len(self.errors)

    @property
    def num_terminated(self) -> int:
        return len(self._results) - self.num_errors

    def get_best_result(self, metric: Optional[str] = None,
                        mode: Optional[str] = None) -> Result:
        metric = metric or self._metric
        mode = mode or self._mode or "min"
        if metric is None:
            raise ValueError("no metric configured; pass metric= explicitly")
        candidates = [
            r for r in self._results
            if r.error is None and r.metrics.get(metric) is not None
        ]
        if not candidates:
            raise RuntimeError(
                f"no completed trial reported metric {metric!r} "
                f"({self.num_errors} errored)"
            )
        sign = -1.0 if mode == "max" else 1.0
        return min(candidates, key=lambda r: sign * float(r.metrics[metric]))

    def get_dataframe(self) -> pd.DataFrame:
        rows = []
        for r in self._results:
            row = dict(r.metrics)
            for k, v in (r.config or {}).items():
                if isinstance(v, (int, float, str, bool)) or v is None:
                    row[f"config/{k}"] = v
            row["error"] = repr(r.error) if r.error else None
            row["path"] = r.path
            rows.append(row)
        return pd.DataFrame(rows)

    def __repr__(self):
        return (f"ResultGrid({len(self._results)} trials, "
                f"{self.num_errors} errored)")
