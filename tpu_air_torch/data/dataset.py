"""Distributed Dataset of the port: lists of blocks in its object store,
copied from ``tpu_air/data/dataset.py``.

Parity surface (SURVEY.md §1-L2, exercised at the cited cells):
``map_batches`` (Scaling_model_training.ipynb:cc-33), ``limit``
(Model_finetuning…ipynb:cc-21), ``train_test_split`` (Introduction…ipynb:cc-10),
``repartition`` (cc-11), ``schema/count/show/take/to_pandas`` (cc-15-17),
``groupby(...).mean(...)`` (cc-18), ``drop_columns`` (cc-58), plus ``split``
(per-worker shards feeding the Trainer, Model_finetuning…ipynb:cc-29 figure).

Blocks live in the shared-memory object store (core layer) and are processed
in parallel by tasks or an actor pool — preprocessing stays on host CPUs;
device work enters only at the trainer/predictor boundary (SURVEY.md §7
architecture stance).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple, Union

import numpy as np
import pandas as pd

from tpu_air_torch.core import ObjectRef, get, put, remote
from tpu_air_torch.core.actor_pool import ActorPool

from . import block as B


class ActorPoolStrategy:
    """compute= strategy for map_batches: a fixed/autoscaling pool of actors
    (the architecture behind BatchPredictor, Scaling_batch_inference.ipynb:cc-4
    "autoscaling the actor pool")."""

    def __init__(self, size: Optional[int] = None, min_size: int = 1,
                 max_size: Optional[int] = None, num_chips: float = 0):
        self.size = size
        self.min_size = size or min_size
        self.max_size = size or max_size or max(2, self.min_size)
        self.num_chips = num_chips
        self.scaled_to: Optional[int] = None  # set by map_batches after a run


def _apply_fn_to_block(fn, blk, batch_size, batch_format, fn_args, fn_kwargs):
    n = B.block_num_rows(blk)
    if n == 0:
        return blk
    step = batch_size or n
    outs = []
    for start in range(0, n, step):
        batch = B.to_batch_format(B.block_slice(blk, start, min(start + step, n)), batch_format)
        out = fn(batch, *fn_args, **fn_kwargs)
        outs.append(B.from_batch(out))
    return B.concat_blocks(outs)


@remote
def _map_block(fn, blk, batch_size, batch_format, fn_args, fn_kwargs):
    return _apply_fn_to_block(fn, blk, batch_size, batch_format, fn_args, fn_kwargs)


# -- block-wise shape-op tasks (no driver materialization) -------------------
# The reference's data plane does "batching, pipelining … and memory
# management" off-driver (Scaling_batch_inference.ipynb:cc-4); these tasks
# keep every all-rows operation in workers reading blocks zero-copy from the
# shared-memory store, so the driver never holds the dataset.


@remote
def _num_rows_task(blk) -> int:
    return B.block_num_rows(blk)


@remote
def _gather_slices(spans, *blks):
    """Concat [blks[i][start:stop] for (i, start, stop) in spans] → one block."""
    parts = [B.block_slice(blks[i], start, stop) for i, start, stop in spans]
    return B.concat_blocks(parts) if parts else B.block_from_rows([])


@remote
def _shuffle_map(blk, nb: int, seed) -> list:
    """Scatter rows of one block uniformly into nb buckets (phase 1 of the
    distributed two-phase shuffle)."""
    n = B.block_num_rows(blk)
    rng = np.random.default_rng(seed)
    assignment = rng.integers(0, nb, size=n)
    df = B.block_to_pandas(blk)
    return [B.block_from_pandas(df.iloc[assignment == j]) for j in range(nb)]


@remote
def _shuffle_reduce(j: int, seed, *bucket_lists):
    """Concat bucket j from every map output and locally permute (phase 2)."""
    parts = [bl[j] for bl in bucket_lists]
    blk = B.concat_blocks(parts)
    df = B.block_to_pandas(blk)
    rng = np.random.default_rng(None if seed is None else seed + 40_013 * (j + 1))
    return B.block_from_pandas(
        df.iloc[rng.permutation(len(df))].reset_index(drop=True)
    )


@remote
def _sample_keys(blk, key: str, k: int):
    df = B.block_to_pandas(blk)
    vals = df[key].to_numpy()
    if len(vals) <= k:
        return vals
    idx = np.random.default_rng(0).choice(len(vals), size=k, replace=False)
    return vals[idx]


@remote
def _range_partition(blk, key: str, cuts) -> list:
    """Split one block into len(cuts)+1 key ranges (phase 1 of sample sort).
    Works for any orderable dtype — strings fall back to bisect."""
    import bisect

    df = B.block_to_pandas(blk)
    vals = df[key].to_numpy()
    try:
        bucket = np.searchsorted(np.asarray(cuts), vals, side="right")
    except (TypeError, ValueError):
        bucket = np.fromiter(
            (bisect.bisect_right(cuts, v) for v in vals), dtype=np.int64, count=len(vals)
        )
    return [B.block_from_pandas(df.iloc[bucket == j]) for j in range(len(cuts) + 1)]


@remote
def _range_merge(j: int, key: str, descending: bool, *part_lists):
    parts = [pl[j] for pl in part_lists]
    df = B.block_to_pandas(B.concat_blocks(parts))
    df = df.sort_values(key, ascending=not descending, kind="mergesort")
    return B.block_from_pandas(df.reset_index(drop=True))


@remote
def _zip_blocks(left, right):
    l, r = B.block_to_pandas(left), B.block_to_pandas(right).reset_index(drop=True)
    r = r.rename(columns={c: f"{c}_1" for c in r.columns if c in l.columns})
    return B.block_from_pandas(pd.concat([l.reset_index(drop=True), r], axis=1))


_GROUP_AGGS = ("count", "sum", "min", "max", "sumsq")


@remote
def _group_partial(blk, key: str):
    """Per-block partial aggregates; partials are tiny (one row per group) so
    the driver-side merge never sees the data itself.  sum/sumsq cover
    numeric columns; min/max cover any orderable dtype (string min/max is
    valid pandas groupby behavior)."""
    df = B.block_to_pandas(blk)
    g = df.groupby(key, dropna=False)
    out = pd.DataFrame({"__count": g.size()})
    for c in df.columns:
        if c == key:
            continue
        if pd.api.types.is_numeric_dtype(df[c]):
            out[f"__sum_{c}"] = g[c].sum()
            out[f"__sumsq_{c}"] = g[c].apply(
                lambda s: float((s.astype(float) ** 2).sum())
            )
        try:
            out[f"__min_{c}"] = g[c].min()
            out[f"__max_{c}"] = g[c].max()
        except (TypeError, ValueError):
            pass  # unorderable dtype (e.g. dicts) — no min/max partial
    return out.reset_index()


@remote
class _MapWorker:
    """Actor for callable-class map_batches (holds expensive state, e.g. a
    model on a leased chip)."""

    def __init__(self, fn_or_cls, constructor_args, constructor_kwargs):
        if isinstance(fn_or_cls, type):
            self.fn = fn_or_cls(*constructor_args, **constructor_kwargs)
        else:
            self.fn = fn_or_cls

    def apply(self, blk, batch_size, batch_format, fn_args, fn_kwargs):
        return _apply_fn_to_block(self.fn, blk, batch_size, batch_format, fn_args, fn_kwargs)


class Dataset:
    """A distributed dataset = ordered list of block refs."""

    def __init__(self, block_refs: List[ObjectRef]):
        self._block_refs = list(block_refs)
        self._cached_num_rows: Optional[int] = None

    # -- introspection -----------------------------------------------------
    def num_blocks(self) -> int:
        return len(self._block_refs)

    def get_internal_block_refs(self) -> List[ObjectRef]:
        return list(self._block_refs)

    def _blocks(self) -> Iterator[B.Block]:
        for ref in self._block_refs:
            yield get(ref)

    def count(self) -> int:
        if self._cached_num_rows is None:
            self._row_counts()  # worker-side counting; caches the total
        return self._cached_num_rows

    def __len__(self) -> int:  # convenience; Ray deprecates this but HF uses len()
        return self.count()

    def schema(self):
        for b in self._blocks():
            if B.block_num_rows(b) > 0:
                return B.block_schema(b)
        return None

    def columns(self) -> List[str]:
        for b in self._blocks():
            return B.block_columns(b)
        return []

    def stats(self) -> str:
        return (
            f"Dataset(num_blocks={self.num_blocks()}, num_rows={self.count()}, "
            f"columns={self.columns()})"
        )

    def __repr__(self) -> str:
        return self.stats()

    # -- materialization ---------------------------------------------------
    def to_pandas(self, limit: Optional[int] = None) -> pd.DataFrame:
        dfs = []
        seen = 0
        for b in self._blocks():
            df = B.block_to_pandas(b)
            dfs.append(df)
            seen += len(df)
            if limit is not None and seen >= limit:
                break
        if not dfs:
            return pd.DataFrame()
        out = pd.concat(dfs, ignore_index=True)
        return out.iloc[:limit] if limit is not None else out

    def take(self, n: int = 20) -> List[Dict[str, Any]]:
        rows: List[Dict[str, Any]] = []
        for b in self._blocks():
            df = B.block_to_pandas(b)
            for _, row in df.iterrows():
                rows.append(row.to_dict())
                if len(rows) >= n:
                    return rows
        return rows

    def take_all(self) -> List[Dict[str, Any]]:
        return self.take(self.count())

    def show(self, n: int = 20) -> None:
        for row in self.take(n):
            print(row)

    def iter_rows(self) -> Iterator[Dict[str, Any]]:
        for b in self._blocks():
            df = B.block_to_pandas(b)
            for _, row in df.iterrows():
                yield row.to_dict()

    def iter_batches(
        self,
        batch_size: Optional[int] = 256,
        batch_format: str = "pandas",
        drop_last: bool = False,
    ):
        """Sequential batch iterator (feeds host→device transfer in the
        trainer; batches are exact-size across block boundaries)."""
        carry: Optional[B.Block] = None
        for b in self._blocks():
            cur = b if carry is None else B.concat_blocks([carry, b])
            carry = None
            n = B.block_num_rows(cur)
            if batch_size is None:
                yield B.to_batch_format(cur, batch_format)
                continue
            start = 0
            while n - start >= batch_size:
                yield B.to_batch_format(
                    B.block_slice(cur, start, start + batch_size), batch_format
                )
                start += batch_size
            if start < n:
                carry = B.block_slice(cur, start, n)
        if carry is not None and not drop_last:
            yield B.to_batch_format(carry, batch_format)

    # -- transforms --------------------------------------------------------
    def map_batches(
        self,
        fn: Union[Callable, type],
        *,
        batch_size: Optional[int] = 4096,
        batch_format: str = "pandas",
        compute: Optional[Union[str, ActorPoolStrategy]] = None,
        fn_args: Tuple = (),
        fn_kwargs: Optional[Dict[str, Any]] = None,
        fn_constructor_args: Tuple = (),
        fn_constructor_kwargs: Optional[Dict[str, Any]] = None,
        num_chips: float = 0,
        **ray_remote_args,
    ) -> "Dataset":
        """Apply ``fn`` to batches of each block, in parallel.

        * default compute: one task per block;
        * ``compute=ActorPoolStrategy(size=k)`` (or a callable class ``fn``):
          a pool of k actors, each constructing ``fn`` once — the predictor
          path (§3.3).
        """
        fn_kwargs = fn_kwargs or {}
        fn_constructor_kwargs = fn_constructor_kwargs or {}
        use_actors = isinstance(compute, ActorPoolStrategy) or isinstance(fn, type)
        if not use_actors:
            task = _map_block
            if num_chips or ray_remote_args:
                task = task.options(num_chips=num_chips or None, **ray_remote_args)
            refs = [
                task.remote(fn, ref, batch_size, batch_format, fn_args, fn_kwargs)
                for ref in self._block_refs
            ]
            return Dataset(refs)

        strategy = compute if isinstance(compute, ActorPoolStrategy) else ActorPoolStrategy()
        min_size = strategy.size or max(strategy.min_size, 1)
        max_size = strategy.size or max(strategy.max_size, min_size)
        min_size = min(min_size, max(len(self._block_refs), 1))
        chips = num_chips or strategy.num_chips
        worker_cls = _MapWorker.options(num_chips=chips or None, **ray_remote_args)

        def make_actor():
            return worker_cls.remote(fn, fn_constructor_args, fn_constructor_kwargs)

        submit = lambda a, v: a.apply.remote(  # noqa: E731
            v, batch_size, batch_format, fn_args, fn_kwargs
        )
        actors = [make_actor() for _ in range(min_size)]
        pool = ActorPool(actors)
        out_refs: List[ObjectRef] = []
        pending: List[ObjectRef] = list(self._block_refs)
        try:
            idx = 0
            while idx < len(pending) and pool.has_free():
                pool.submit(submit, pending[idx])
                idx += 1
            scale_blocked = False

            def can_scale() -> bool:
                if scale_blocked or pool.size() >= max_size:
                    return False
                # grow only while there's enough queued work to keep the
                # bigger pool busy (>= 2 blocks per actor) — spinning up an
                # actor per near-empty block costs more than it saves
                if len(pending) - idx < 2 * (pool.size() + 1):
                    return False
                if not chips:
                    return True
                # A chip-leased scale-up actor queues for a lease the pool's
                # own actors may hold until THIS map_batches ends.  The free-
                # lease check below is advisory (a concurrent consumer can
                # take the chip between check and placement), so placement is
                # CONFIRMED via the ready() probe before any block is
                # submitted to the new actor.
                from tpu_air_torch.core.runtime import get_runtime

                return get_runtime().avail.get("chip", 0.0) >= float(chips)

            def try_scale_up():
                """Create an actor and submit to it only once its placement
                is confirmed; an actor stuck queued behind the pool's own
                leases is killed and scaling stops (fall back to the
                existing pool) — never feed the ordered, timeout-less
                get_next() an actor that may never be placed."""
                nonlocal scale_blocked
                import time as _time

                from tpu_air_torch.core import get, kill
                from tpu_air_torch.core.runtime import get_runtime

                a = make_actor()
                # Phase 1: bounded wait for the LEASE.  The free-lease check
                # in can_scale is advisory (TOCTOU) — a concurrent consumer
                # may have taken the chip, leaving this creation queued
                # behind leases our own pool holds until map_batches ends.
                rt = get_runtime()
                deadline = _time.monotonic() + 5.0
                while rt.actor_pending_placement(a._actor_id):
                    if _time.monotonic() > deadline:
                        kill(a)
                        scale_blocked = True
                        return False
                    _time.sleep(0.02)
                # Phase 2: lease claimed — construction may legitimately be
                # slow (heavy model load is what _MapWorker exists for), so
                # no timeout here.  A crashed constructor resolves the ready
                # ref with an error sentinel, so this cannot hang.
                try:
                    if a._ready_ref is not None:
                        get(a._ready_ref)
                except Exception:  # noqa: BLE001 — ctor failure arrives as an arbitrary unpickled error
                    kill(a)
                    scale_blocked = True
                    return False
                actors.append(a)
                pool.push(a)
                return True

            for _ in range(len(pending)):
                # Autoscale under backlog: all actors busy and blocks still
                # queued → grow toward max_size before blocking on a result
                # (Scaling_batch_inference.ipynb:cc-4 "autoscaling the actor
                # pool").
                while idx < len(pending) and not pool.has_free() and can_scale():
                    if not try_scale_up():
                        break
                    pool.submit(submit, pending[idx])
                    idx += 1
                out_refs.append(put(pool.get_next()))
                if idx < len(pending):
                    pool.submit(submit, pending[idx])
                    idx += 1
            strategy.scaled_to = pool.size()  # observable for tests/stats
        finally:
            from tpu_air_torch.core import kill

            for a in actors:
                kill(a)
        return Dataset(out_refs)

    def map(self, fn: Callable[[Dict[str, Any]], Dict[str, Any]]) -> "Dataset":
        def batch_fn(df: pd.DataFrame) -> pd.DataFrame:
            return pd.DataFrame([fn(r.to_dict()) for _, r in df.iterrows()])

        return self.map_batches(batch_fn, batch_size=None, batch_format="pandas")

    def filter(self, fn: Callable[[Dict[str, Any]], bool]) -> "Dataset":
        def batch_fn(df: pd.DataFrame) -> pd.DataFrame:
            mask = [bool(fn(r.to_dict())) for _, r in df.iterrows()]
            return df[np.asarray(mask, dtype=bool)]

        return self.map_batches(batch_fn, batch_size=None, batch_format="pandas")

    def drop_columns(self, cols: List[str]) -> "Dataset":
        return self.map_batches(
            lambda df: df.drop(columns=cols), batch_size=None, batch_format="pandas"
        )

    def select_columns(self, cols: List[str]) -> "Dataset":
        return self.map_batches(
            lambda df: df[list(cols)], batch_size=None, batch_format="pandas"
        )

    def add_column(self, name: str, fn: Callable[[pd.DataFrame], Any]) -> "Dataset":
        def batch_fn(df: pd.DataFrame) -> pd.DataFrame:
            df = df.copy()
            df[name] = fn(df)
            return df

        return self.map_batches(batch_fn, batch_size=None, batch_format="pandas")

    # -- shape ops (block-wise via tasks; the driver only ever sees row
    # counts and tiny metadata, never the rows themselves) -------------------
    def _row_counts(self) -> List[int]:
        refs = [_num_rows_task.remote(r) for r in self._block_refs]
        counts = get(refs)
        self._cached_num_rows = int(sum(counts))
        return counts

    def _row_range_refs(
        self, start: int, stop: int, counts: List[int]
    ) -> List[ObjectRef]:
        """Refs covering global rows [start, stop).  Whole blocks pass
        through by reference (zero copy); partial blocks become slice tasks."""
        refs: List[ObjectRef] = []
        off = 0
        for ref, n in zip(self._block_refs, counts):
            lo, hi = max(start - off, 0), min(stop - off, n)
            if lo < hi:
                if lo == 0 and hi == n:
                    refs.append(ref)
                else:
                    refs.append(_gather_slices.remote([(0, lo, hi)], ref))
            off += n
            if off >= stop:
                break
        return refs

    def limit(self, n: int) -> "Dataset":
        """First n rows (SMALL_DATA dial, Model_finetuning…ipynb:cc-21)."""
        return Dataset(self._row_range_refs(0, n, self._row_counts()))

    def repartition(self, num_blocks: int) -> "Dataset":
        """Rebalance into exactly ``num_blocks`` blocks
        (Introduction…ipynb:cc-11).  Each output block is assembled by one
        task from the input slices that overlap its row range."""
        counts = self._row_counts()
        total = sum(counts)
        offsets = np.cumsum([0] + counts)
        sizes = [(total + i) // num_blocks for i in range(num_blocks)]
        refs, start = [], 0
        for s in sizes:
            stop = start + s
            spans, blks = [], []
            for bi, n in enumerate(counts):
                lo = max(start - offsets[bi], 0)
                hi = min(stop - offsets[bi], n)
                if lo < hi:
                    spans.append((len(blks), int(lo), int(hi)))
                    blks.append(self._block_refs[bi])
            refs.append(_gather_slices.remote(spans, *blks))
            start = stop
        return Dataset(refs)

    def random_shuffle(self, seed: Optional[int] = None) -> "Dataset":
        """Distributed two-phase shuffle: per-block uniform scatter into
        num_blocks buckets, then per-bucket concat + local permutation —
        rows never pass through the driver."""
        nb = max(1, self.num_blocks())
        map_refs = [
            _shuffle_map.remote(ref, nb, None if seed is None else seed + i)
            for i, ref in enumerate(self._block_refs)
        ]
        return Dataset(
            [_shuffle_reduce.remote(j, seed, *map_refs) for j in range(nb)]
        )

    def train_test_split(
        self, test_size: Union[float, int], *, shuffle: bool = False,
        seed: Optional[int] = None,
    ) -> Tuple["Dataset", "Dataset"]:
        """80/20-style split (Introduction…ipynb:cc-10; the HF-side
        ``train_test_split(seed=57)`` at Model_finetuning…ipynb:cc-13)."""
        ds = self.random_shuffle(seed=seed) if shuffle else self
        counts = ds._row_counts()
        n = sum(counts)
        ntest = int(n * test_size) if isinstance(test_size, float) else int(test_size)
        ntrain = n - ntest
        train = Dataset(ds._row_range_refs(0, ntrain, counts))
        test = Dataset(ds._row_range_refs(ntrain, n, counts))
        return train, test

    def split(self, n: int, *, equal: bool = True, locality_hints=None) -> List["Dataset"]:
        """Split into n shards — one per DP worker (SURVEY.md §1-L3:
        "partitioned Dataset shards" per worker)."""
        counts = self._row_counts()
        total = sum(counts)
        if equal:
            per = total // n
            bounds = [(i * per, (i + 1) * per) for i in range(n)]
        else:
            sizes = [(total + i) // n for i in range(n)]
            offs = np.cumsum([0] + sizes)
            bounds = [(int(offs[i]), int(offs[i + 1])) for i in range(n)]
        return [Dataset(self._row_range_refs(lo, hi, counts)) for lo, hi in bounds]

    def union(self, *others: "Dataset") -> "Dataset":
        refs = list(self._block_refs)
        for o in others:
            refs.extend(o._block_refs)
        return Dataset(refs)

    def zip(self, other: "Dataset") -> "Dataset":
        """Column-wise zip: the right side is realigned to the left's block
        boundaries, then blocks are zipped pairwise by tasks."""
        counts = self._row_counts()
        offsets = np.cumsum([0] + counts)
        rcounts = other._row_counts()
        refs = []
        for bi, n in enumerate(counts):
            lo, hi = int(offsets[bi]), int(offsets[bi] + n)
            right_refs = other._row_range_refs(lo, hi, rcounts)
            if len(right_refs) == 1:
                right = right_refs[0]
            else:
                rns = get([_num_rows_task.remote(r) for r in right_refs])
                right = _gather_slices.remote(
                    [(i, 0, int(rn)) for i, rn in enumerate(rns)], *right_refs
                )
            refs.append(_zip_blocks.remote(self._block_refs[bi], right))
        return Dataset(refs)

    def sort(self, key: str, descending: bool = False) -> "Dataset":
        """Distributed sample sort: sample cut points, range-partition each
        block, merge+sort each range in its own task."""
        nb = max(1, self.num_blocks())
        if nb == 1:
            return Dataset(
                [_range_merge.remote(0, key, descending, _range_partition.remote(self._block_refs[0], key, []))]
            )
        samples = sorted(
            v
            for s in get([_sample_keys.remote(r, key, 64) for r in self._block_refs])
            for v in np.asarray(s).tolist()
        )
        if not samples:  # all blocks empty — nothing to order
            return Dataset(list(self._block_refs))
        # positional quantiles: dtype-agnostic (numeric or string keys)
        picks = [samples[(len(samples) * (i + 1)) // nb] for i in range(nb - 1)]
        cuts = sorted(set(picks))
        part_refs = [_range_partition.remote(r, key, cuts) for r in self._block_refs]
        refs = [
            _range_merge.remote(j, key, descending, *part_refs)
            for j in range(len(cuts) + 1)
        ]
        if descending:
            refs = refs[::-1]
        return Dataset(refs)

    def groupby(self, key: str) -> "GroupedData":
        """(Introduction…ipynb:cc-18: ``groupby("…").mean("…")``)."""
        return GroupedData(self, key)

    # -- writes -------------------------------------------------------------
    def write_parquet(self, path: str) -> None:
        import os

        import pyarrow as pa
        import pyarrow.parquet as pq

        os.makedirs(path, exist_ok=True)
        for i, blk in enumerate(self._blocks()):
            table = (
                blk
                if isinstance(blk, pa.Table)
                else pa.Table.from_pandas(B.block_to_pandas(blk), preserve_index=False)
            )
            pq.write_table(table, os.path.join(path, f"part-{i:05d}.parquet"))

    def write_csv(self, path: str) -> None:
        import os

        os.makedirs(path, exist_ok=True)
        for i, blk in enumerate(self._blocks()):
            B.block_to_pandas(blk).to_csv(
                os.path.join(path, f"part-{i:05d}.csv"), index=False
            )

    def materialize(self) -> "Dataset":
        return self


class GroupedData:
    """Distributed groupby: each block computes one-row-per-group partial
    aggregates (count/sum/min/max/sumsq) in a task; the driver only merges
    those tiny partials and finalizes the requested statistic."""

    def __init__(self, ds: Dataset, key: str):
        self._ds = ds
        self._key = key

    def _merged_partials(self) -> pd.DataFrame:
        parts = get([_group_partial.remote(r, self._key) for r in self._ds._block_refs])
        parts = [p for p in parts if len(p)]
        if not parts:
            return pd.DataFrame({self._key: [], "__count": []})
        allp = pd.concat(parts, ignore_index=True)
        g = allp.groupby(self._key, dropna=False)
        merged = pd.DataFrame({"__count": g["__count"].sum()})
        for c in allp.columns:
            if c.startswith("__sum_") or c.startswith("__sumsq_"):
                merged[c] = g[c].sum()
            elif c.startswith("__min_"):
                merged[c] = g[c].min()
            elif c.startswith("__max_"):
                merged[c] = g[c].max()
        return merged.reset_index()

    def _finalize(self, how: str, on: Optional[str]) -> Dataset:
        m = self._merged_partials()
        prefix = "__min_" if how in ("min", "max") else "__sum_"
        cols = sorted(
            {c[len(prefix):] for c in m.columns if c.startswith(prefix)}
        )
        targets = [on] if on else cols
        out = pd.DataFrame({self._key: m[self._key]})
        for c in targets:
            if f"{prefix}{c}" not in m.columns:
                raise ValueError(
                    f"groupby.{how}() unsupported for column {c!r} "
                    f"({'non-orderable' if how in ('min', 'max') else 'non-numeric'})"
                )
            if how == "mean":
                out[f"mean({c})"] = m[f"__sum_{c}"] / m["__count"]
            elif how == "sum":
                out[f"sum({c})"] = m[f"__sum_{c}"]
            elif how == "min":
                out[f"min({c})"] = m[f"__min_{c}"]
            elif how == "max":
                out[f"max({c})"] = m[f"__max_{c}"]
            elif how == "std":
                n, s, ss = m["__count"], m[f"__sum_{c}"], m[f"__sumsq_{c}"]
                var = (ss - s * s / n) / (n - 1).clip(lower=1)
                out[f"std({c})"] = np.sqrt(var.clip(lower=0.0))
        out = out.sort_values(self._key).reset_index(drop=True)
        return Dataset([put(B.block_from_pandas(out))])

    def mean(self, on: Optional[str] = None) -> Dataset:
        return self._finalize("mean", on)

    def sum(self, on: Optional[str] = None) -> Dataset:
        return self._finalize("sum", on)

    def min(self, on: Optional[str] = None) -> Dataset:
        return self._finalize("min", on)

    def max(self, on: Optional[str] = None) -> Dataset:
        return self._finalize("max", on)

    def std(self, on: Optional[str] = None) -> Dataset:
        return self._finalize("std", on)

    def count(self) -> Dataset:
        m = self._merged_partials()
        out = pd.DataFrame({self._key: m[self._key], "count()": m["__count"]})
        out = out.sort_values(self._key).reset_index(drop=True)
        return Dataset([put(B.block_from_pandas(out))])
