"""MeshEngine — the paged engine over a ``(dp, tp)`` device mesh, the
counterpart of ``tpu_air/engine/dist/mesh_engine.py``.

Same host loop, scheduler, slot table and token streams as
:class:`~tpu_air_torch.engine.InferenceEngine`; what changes is where state
lives and which functions the step runs:

* **lease** — in the driver of a running port runtime, the engine takes a
  chip lease of dp x tp devices (``Runtime.lease_chips``) and builds its
  mesh over ``cuda:<id>``, the ids wrapping onto the cards there are (one
  card holds the whole mesh), and releases the lease on ``close()``; in an
  actor (a serve replica placed on its lease) or without a runtime it
  meshes over the visible devices, and over ``devices=`` (a list, repeats
  allowed: the tests mesh CPU devices) when given.
* **weights** — sharded at construction, and again after a weight swap
  (``sharded.py``: q/k/v and gate/up split by output dim, o/down by input
  dim, embeddings and norms replicated).
* **KV pages** — each (replica, attention shard) holds its own page pools;
  the :class:`~tpu_air_torch.engine.dist.pool.ShardedPagedPool` keeps every
  slot's pages, null page included, in that slot's replica.
* **admission** — capacity is gated PER dp REPLICA (a full replica cannot
  borrow pages from another): the predicate simulates the slot each
  candidate will land in (lowest free row first, the SlotManager's acquire
  order) and reserves against that replica.

On a CUDA mesh every 1-token step runs the decode kernel once a layer and
attention shard in every replica.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from tpu_air_torch.parallel.mesh import make_mesh, platform_devices, visible_devices

from ..engine import InferenceEngine
from ..types import EngineConfig
from .pool import ShardedPagedPool
from .sharded import (
    ShardedLM,
    ShardedPagedCache,
    make_sharded_page_copy_fn,
    make_sharded_paged_decode_step_fn,
    make_sharded_prefill_chunk_fn,
)


class MeshEngine(InferenceEngine):
    """Tensor-parallel, data-parallel paged decode over a leased mesh."""

    def __init__(self, model, config: Optional[EngineConfig] = None,
                 *, dp: int = 1, tp: int = 1, devices=None,
                 lease_timeout: Optional[float] = 60.0,
                 auto_start: bool = True, name: str = "mesh-engine"):
        cfg = config or EngineConfig()
        if cfg.kv_mode != "paged":
            raise ValueError("MeshEngine requires kv_mode='paged'")
        if cfg.adapter_slots > 0:
            raise ValueError(
                "adapter_slots is single-chip-only for now: the sharded "
                "decode step has no bank shardings (see docs/SERVING.md)")
        if cfg.num_slots % dp != 0:
            raise ValueError(
                f"num_slots {cfg.num_slots} not divisible by dp {dp}")
        self._dp = int(dp)
        self._tp = int(tp)
        self._lease: Optional[List[int]] = None
        self._runtime = None
        devs = self._acquire_devices(devices, lease_timeout)
        self.mesh = make_mesh(("data", "model"), (self._dp, self._tp), devices=devs)
        try:
            super().__init__(model, cfg, auto_start=auto_start, name=name)
        except BaseException:  # re-raised: a failed build hands its lease back first
            self._release_lease()
            raise
        self.metrics.set_topology(
            lease=self.lease_id, mesh=f"{self._dp}x{self._tp}",
            role="decode", decode_replicas=self._dp,
            mesh_devices=self._dp * self._tp,
        )

    # -- lease / device acquisition ------------------------------------------
    def _acquire_devices(self, devices, lease_timeout):
        n = self._dp * self._tp
        if devices is not None:
            devs = list(devices)
            if len(devs) < n:
                raise ValueError(
                    f"mesh {self._dp}x{self._tp} needs {n} devices, "
                    f"got {len(devs)}")
            return devs[:n]
        from tpu_air_torch.core import runtime as _rt

        # the driver leases; an actor was placed on its lease already and
        # sees it as its visible devices
        if _rt.is_initialized() and _rt.current_worker() is None:
            all_devs = platform_devices()
            rt = _rt.get_runtime()
            chips = rt.lease_chips(n, timeout=lease_timeout)
            self._lease = chips
            self._runtime = rt
            # lease ids index the device list; wrap for a runtime whose
            # chip slots outnumber the cards
            return [all_devs[i % len(all_devs)] for i in chips]
        devs = visible_devices()
        if len(devs) < n:
            raise ValueError(
                f"mesh {self._dp}x{self._tp} needs {n} devices, "
                f"only {len(devs)} visible")
        return devs[:n]

    @property
    def lease_id(self) -> str:
        if self._lease is None:
            return "local"
        return "chips:" + "-".join(str(c) for c in self._lease)

    # -- sharded device state -------------------------------------------------
    def _pages_per_replica(self) -> int:
        cfg = self.config
        if cfg.num_pages is None:
            # slab-equivalent capacity per replica, each with its own null
            # page (dp * this stays dp-divisible, unlike S*ppslot + 1)
            return (cfg.num_slots // self._dp) * cfg.pages_per_slot() + 1
        if cfg.num_pages % self._dp != 0:
            raise ValueError(
                f"num_pages {cfg.num_pages} not divisible by dp {self._dp}")
        per = cfg.num_pages // self._dp
        if per < 2:
            raise ValueError(
                f"num_pages {cfg.num_pages} leaves <2 pages per replica")
        return per

    def _build_paged_state(self) -> None:
        cfg = self.config
        ppr = self._pages_per_replica()
        # the engine's own tensors (step arguments, tokens) live on the
        # first replica's first device
        self.device = self.mesh.devices[0, 0]
        self.pool = ShardedPagedPool(
            self._dp, ppr, cfg.page_len, cfg.num_slots,
            cfg.pages_per_slot(), prefix_cache=cfg.prefix_cache,
        )
        self.cache = ShardedPagedCache(self.model.config, self.mesh, ppr, cfg.page_len)
        self._build_step_fns()

    def _build_slab_state(self) -> None:  # pragma: no cover — ctor rejects
        raise ValueError("MeshEngine requires kv_mode='paged'")

    def _build_step_fns(self) -> None:
        """Shard the model's weights as they are now over the mesh and make
        the sharded phases over them (a weight swap calls this again)."""
        cfg = self.config
        self.sharded = ShardedLM(self.model, self.mesh)
        self._decode_step = make_sharded_paged_decode_step_fn(self.sharded, cfg.slot_len)
        self._chunk_fn = make_sharded_prefill_chunk_fn(self.sharded, cfg.page_len,
                                                       cfg.slot_len)
        self._copy_fn = make_sharded_page_copy_fn()

    def _sync(self) -> None:
        for dev in {d for d in self.mesh.devices.flat if d.type == "cuda"}:
            torch.cuda.synchronize(dev)

    # -- per-replica admission ------------------------------------------------
    def _begin_admission_round(self) -> None:
        self._round_reserved_r = [0] * self._dp
        # acquire order: lowest free row first — the predicate must know
        # which replica each admit lands in before any acquire happens
        self._round_free = self.slots.free_indices()

    def _can_admit(self, req) -> bool:
        if not self._round_free:
            return False
        idx = self._round_free[0]
        r = self.pool.replica_of(idx)
        need = self.pool.worst_case_pages(len(req.prompt), req.max_new_tokens)
        if self._round_reserved_r[r] + need > self.pool.replica_capacity(r):
            return False
        self._round_reserved_r[r] += need
        self._round_free.pop(0)
        return True

    # -- sharded-layout hooks -------------------------------------------------
    def _null_entry(self, slot_index: int) -> int:
        return self.pool.null_page_of(slot_index)

    def _kv_geometry(self):
        return self.cache.geometry

    def _extract_shipped_pages(self, page_ids):
        return self.cache.extract(page_ids)

    def _insert_shipped_pages(self, page_ids, payload) -> None:
        self.cache.insert(page_ids, payload)

    # -- lifecycle ------------------------------------------------------------
    def _release_lease(self) -> None:
        if self._lease is not None and self._runtime is not None:
            try:
                self._runtime.release_chips(self._lease)
            finally:
                self._lease = None
                self._runtime = None

    def close(self) -> None:
        super().close()
        self._release_lease()
