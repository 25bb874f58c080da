"""Checkpointable sharded readers over :class:`tpu_air_torch.data.Dataset`,
copied from ``tpu_air/batch/reader.py`` (the port imports nothing of
``tpu_air``).

The batch lane's input layer follows the t5x/seqio determinism design
(arXiv:2203.17189): the input iterator is a pure function of
``(dataset blocks, seed, cursor)``, so a preempted job that journaled its
cursors resumes mid-epoch with the *byte-identical* remaining row stream
— no re-shuffle drift, no dropped or duplicated rows.

Three pieces:

* :func:`shard_plan` — deterministic assignment of dataset blocks to
  shards: a seeded permutation of the block list, greedily placed on the
  least-loaded shard (ties break to the lowest shard index).  Same
  ``(row counts, num_shards, seed)`` ⇒ same plan, on any process.
* :class:`ShardCursor` — one shard's resume point: how many rows of its
  stream have been consumed.  JSON-trivial, journaled by the batch job.
* :class:`ShardedReader` — iterates one shard's row stream from a
  cursor, yielding ``(global_row_index, row_dict)``.  The global index
  is the row's position in the WHOLE dataset (block offset + local
  index), so outputs keyed by it union losslessly across shards — the
  exactly-once invariant the chaos tests assert.

Blocks wholly behind the cursor are skipped without fetching them from
the object store, so resuming deep into an epoch costs reads only for
the first live block.
"""

from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

from tpu_air_torch.data import block as B


def shard_plan(block_rows: Sequence[int], num_shards: int,
               seed: int) -> List[List[int]]:
    """Assign block indices to ``num_shards`` shards, deterministically.

    A seeded permutation decorrelates block order from ingest order (the
    seqio shuffle-then-shard idea at block granularity); greedy
    least-loaded placement keeps shard row totals balanced even when
    block sizes are skewed.  Pure: no global RNG state is touched."""
    if num_shards < 1:
        raise ValueError(f"num_shards must be >= 1, got {num_shards}")
    order = list(range(len(block_rows)))
    random.Random(int(seed)).shuffle(order)
    plans: List[List[int]] = [[] for _ in range(num_shards)]
    loads = [0] * num_shards
    for b in order:
        s = min(range(num_shards), key=lambda i: (loads[i], i))
        plans[s].append(b)
        loads[s] += int(block_rows[b])
    return plans


@dataclass
class ShardCursor:
    """One shard's resume point: ``rows_done`` rows of its deterministic
    stream are already consumed (and their outputs committed)."""

    shard: int
    rows_done: int = 0

    def to_dict(self) -> Dict[str, int]:
        return {"shard": int(self.shard), "rows_done": int(self.rows_done)}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ShardCursor":
        return cls(shard=int(d["shard"]), rows_done=int(d["rows_done"]))


class ShardedReader:
    """Deterministic row stream for one shard of a dataset.

    Construction needs the per-block row counts; pass ``counts`` when the
    caller already paid for them (BatchJob computes them once for every
    shard) or let the reader ask the dataset.  The reader never mutates
    the dataset and holds no open state between :meth:`rows` calls — it
    is safe to rebuild from scratch on resume, which is the point."""

    def __init__(self, dataset, shard: int, num_shards: int, seed: int, *,
                 counts: Optional[Sequence[int]] = None):
        if not 0 <= shard < num_shards:
            raise ValueError(
                f"shard {shard} out of range for num_shards={num_shards}")
        self._refs = dataset.get_internal_block_refs()
        self._counts = ([int(c) for c in counts] if counts is not None
                        else [int(c) for c in dataset._row_counts()])
        if len(self._counts) != len(self._refs):
            raise ValueError(
                f"{len(self._counts)} row counts for {len(self._refs)} blocks")
        self.shard = int(shard)
        self.num_shards = int(num_shards)
        self.seed = int(seed)
        self.plan = shard_plan(self._counts, num_shards, seed)[self.shard]
        # global row index base per block: block b's row i is row
        # offsets[b] + i of the whole dataset — unique across shards
        self._offsets = [0] * len(self._counts)
        acc = 0
        for i, c in enumerate(self._counts):
            self._offsets[i] = acc
            acc += c

    def total_rows(self) -> int:
        return sum(self._counts[b] for b in self.plan)

    def rows(self, start: int = 0) -> Iterator[Tuple[int, Dict[str, Any]]]:
        """Yield ``(global_row_index, row_dict)`` from position ``start``
        of this shard's stream (``start`` = a journaled cursor's
        ``rows_done``).  Blocks wholly behind the cursor are skipped
        without an object-store fetch."""
        from tpu_air_torch.core.api import get

        if start < 0:
            raise ValueError(f"start must be >= 0, got {start}")
        seen = 0
        for b in self.plan:
            n = self._counts[b]
            if start >= seen + n:
                seen += n
                continue  # fully consumed: skip without fetching
            df = B.block_to_pandas(get(self._refs[b]))
            local = max(0, start - seen)
            for i in range(local, n):
                yield self._offsets[b] + i, df.iloc[i].to_dict()
            seen += n

    def describe(self) -> Dict[str, Any]:
        return {
            "shard": self.shard,
            "num_shards": self.num_shards,
            "seed": self.seed,
            "blocks": list(self.plan),
            "total_rows": self.total_rows(),
        }
