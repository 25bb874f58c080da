"""The paged engine's phases over a ``(data, model)`` mesh, the counterpart
of ``tpu_air/engine/dist/sharded.py``.

The JAX package runs the single-card step bodies under pjit and lets XLA's
SPMD partitioner insert the tensor-parallel all-reduces.  The port runs one
controller that places every shard itself, Megatron-style:

* q/k/v and gate/up are split by their output dim (whole heads, whole ff
  columns), o and down by their input dim, as ``lm_param_spec`` says;
  embeddings, norms and the tied head are replicated.  A part whose heads
  (or ff columns) tp does not divide is not split: its replicated copy runs
  once, on the replica's first device.
* The residual stream of replica ``r`` lives on its first device.  Each
  layer hands its normed input to every shard; each shard's partial o (and
  down) product is taken in f32 from the model-type operands (exact
  products, f32 sums, no rounding of the partial), comes back there, and
  the partials are summed in f32, in shard order, every step the same way,
  then rounded once to the model's type, as the single-card layer rounds
  its one product.  With tp = 1 the layer is the single-card layer
  exactly.
* Each (replica, attention shard) holds its own contiguous K/V pools
  ``[pages_per_replica, page_len, (h/tp)*d]`` a layer (the decode kernel's
  bulk copies read contiguous rows of h*d), so page ``p`` of the global
  view is replica ``p // pages_per_replica``'s local page, split by heads
  over its shards.  The :class:`~tpu_air_torch.engine.dist.pool.
  ShardedPagedPool` keeps every slot's pages, null page included, in its
  own replica.

A 1-token step runs every replica over its ``S/dp`` rows, and on each
attention shard writes the new K/V and attends through
:func:`decode_attention`: the kernel on a CUDA device, its plain version on
the CPU, as in the single-card engine.  A prefill chunk runs on its slot's
replica only, dense over the gathered pages as the single-card chunk is.
The engine's migration and handoff payloads stay the flat ``h*d`` pages of
``kv_transfer.py``: :class:`ShardedPagedCache` splits them over the shards
and joins them back.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, NamedTuple, Sequence

import torch
import torch.nn.functional as F

from tpu_air_torch.faults import plan as _faults
from tpu_air_torch.models.lm.modeling import AttnCache, _dense_causal_attention, rope, torch_dtype
from tpu_air_torch.ops.decode_attention import decode_attention, gather_pages
from tpu_air_torch.parallel.mesh import Mesh
from tpu_air_torch.parallel.sharding import lm_attention_shards as attention_shards
from tpu_air_torch.parallel.sharding import lm_mlp_shards as mlp_shards
from tpu_air_torch.parallel.sharding import lm_unit_spec as engine_param_spec
from tpu_air_torch.parallel.sharding import shard_params
from tpu_air_torch.parallel.tensor_parallel import column_linear, reduce_partials, row_partial

from .kv_transfer import _as_tensor, validate_kv_payload


def _axis(mesh: Mesh, name: str) -> int:
    return mesh.shape.get(name, 1)


class PoolShard(NamedTuple):
    """Where one (dp replica, attention shard) keeps its K/V pools: the
    device and the heads ``[head0, head1)`` it holds."""
    device: torch.device
    head0: int
    head1: int


def paged_cache_shardings(config, mesh: Mesh) -> List[List[PoolShard]]:
    """The layout of the paged caches over ``mesh``: per dp replica, per
    attention shard, its device and heads."""
    n = attention_shards(config, _axis(mesh, "model"))
    hs = config.n_heads // n
    return [[PoolShard(mesh.devices[r, a], a * hs, (a + 1) * hs) for a in range(n)]
            for r in range(_axis(mesh, "data"))]


class ShardedPagedCache:
    """The K/V page pools of every (replica, attention shard), and the flat
    ``h*d`` view the engine's payloads use.  ``k[r][a][i]`` is replica
    ``r``'s pool of layer ``i`` for attention shard ``a``; global page
    ``p`` is local page ``p % pages_per_replica`` of replica ``p //
    pages_per_replica``."""

    def __init__(self, config, mesh: Mesh, pages_per_replica: int, page_len: int):
        self.layout = paged_cache_shardings(config, mesh)
        self.pages_per_replica = pages_per_replica
        self.page_len = page_len
        self.n_layers = config.n_layers
        self.head_dim = config.head_dim
        self.dtype = torch_dtype(config.dtype)

        def pools(sh: PoolShard):
            shape = (pages_per_replica, page_len, (sh.head1 - sh.head0) * config.head_dim)
            return [torch.zeros(shape, dtype=self.dtype, device=sh.device)
                    for _ in range(config.n_layers)]

        self.k = [[pools(sh) for sh in rep] for rep in self.layout]
        self.v = [[pools(sh) for sh in rep] for rep in self.layout]
        width = config.n_heads * config.head_dim
        shape = (len(self.layout) * pages_per_replica, page_len, width)
        # shapes and type only: what a shipped payload is checked against
        self.geometry = [AttnCache(torch.empty(shape, dtype=self.dtype, device="meta"),
                                   torch.empty(shape, dtype=self.dtype, device="meta"), 0)
                         for _ in range(config.n_layers)]

    def _local(self, page_ids: Sequence[int]):
        """The one replica ``page_ids`` lie in, and their local ids."""
        ppr = self.pages_per_replica
        reps = {int(p) // ppr for p in page_ids}
        if len(reps) > 1:
            raise ValueError(f"page ids {list(page_ids)} span dp replicas {sorted(reps)}")
        r = reps.pop() if reps else 0
        return r, [int(p) - r * ppr for p in page_ids]

    def extract(self, page_ids: Sequence[int]) -> Dict[str, Dict[str, torch.Tensor]]:
        """Pages ``page_ids`` of every layer as flat ``[n, page_len, h*d]``
        CPU tensors, the payload ``extract_kv_pages`` makes (and through
        its ``kv.transfer`` fault site)."""
        if _faults.enabled():
            _faults.perturb("kv.transfer", key=str(len(page_ids)))
        r, local = self._local(page_ids)
        out = {}
        with torch.no_grad():
            for i in range(self.n_layers):
                parts = {}
                for name, pools in (("k", self.k[r]), ("v", self.v[r])):
                    ids = [torch.as_tensor(local, dtype=torch.long, device=p[i].device)
                           for p in pools]
                    parts[name] = torch.cat([p[i][x].cpu() for p, x in zip(pools, ids)], -1)
                out[f"layer_{i}/attn"] = parts
        return out

    def insert(self, page_ids: Sequence[int], payload: Dict[str, Dict[str, Any]]) -> None:
        """Write a flat payload's pages into ``page_ids``, each shard its
        heads; checked against :attr:`geometry` before anything is written
        (``KVTransferError``)."""
        validate_kv_payload(self.geometry, page_ids, payload)
        r, local = self._local(page_ids)
        d = self.head_dim
        with torch.inference_mode():
            for i in range(self.n_layers):
                for name, pools in (("k", self.k[r]), ("v", self.v[r])):
                    flat = _as_tensor(payload[f"layer_{i}/attn"][name])
                    for sh, pool in zip(self.layout[r], pools):
                        ids = torch.as_tensor(local, dtype=torch.long, device=sh.device)
                        part = flat[..., sh.head0 * d:sh.head1 * d]
                        pool[i][ids] = part.to(sh.device, self.dtype)

    def copy_page(self, dst: int, src: int) -> None:
        """Copy-on-write: global page ``src`` onto ``dst`` (one replica's)
        in every layer and shard."""
        r, (ld, ls) = self._local([dst, src])
        with torch.inference_mode():
            for pools in (self.k[r], self.v[r]):
                for p in pools:
                    for layer in p:
                        layer[ld].copy_(layer[ls])


class ShardedLM:
    """The causal LM's weights over a ``(data, model)`` mesh and the
    sharded forward passes the paged engine runs.  ``shards[r, s]`` is the
    state dict of mesh device ``(r, s)`` (``shard_params`` with
    :func:`engine_param_spec`); each replica keeps the f32 head on its first
    device."""

    def __init__(self, model, mesh: Mesh):
        cfg = model.config
        self.config = cfg
        self.mesh = mesh
        self.dp, self.tp = _axis(mesh, "data"), _axis(mesh, "model")
        self.dt = torch_dtype(cfg.dtype)
        self.n_attn = attention_shards(cfg, self.tp)
        self.n_mlp = mlp_shards(cfg, self.tp)
        state = {k: v.detach() for k, v in model.state_dict().items()}
        self.shards = shard_params(state, mesh, engine_param_spec(cfg, self.tp))
        head = "embedding" if cfg.tie_embeddings else "lm_head.weight"
        # the f32 (d_model, vocab) head, as the single-card step functions
        # make it once (a view of an f32 embedding, a copy of a half one)
        self.heads = [self.shards[r, 0][head].t().float() for r in range(self.dp)]
        self.scale = 1.0 / (cfg.head_dim ** 0.5)
        self.q_scale = float(torch.tensor(self.scale, dtype=self.dt, device="cpu"))

    def home(self, r: int) -> torch.device:
        return self.mesh.devices[r, 0]

    def _rms(self, x, w):
        xf = x.float()
        var = xf.square().mean(-1, keepdim=True)
        return (w * xf * torch.rsqrt(var + self.config.rmsnorm_eps)).to(self.dt)

    def forward(self, r: int, ids: torch.Tensor, positions: torch.Tensor,
                attend: Callable) -> torch.Tensor:
        """Replica ``r``'s final-norm hidden states ``(b, l, d_model)`` for
        ``ids`` at ``positions`` (both on its first device).  ``attend(a, i,
        q, kflat, vflat)`` writes layer ``i``'s new K/V of attention shard
        ``a`` and returns its attention output ``(b, l, heads*d)``."""
        cfg, w0, dt = self.config, self.shards[r, 0], self.dt
        b, l = ids.shape
        d = cfg.head_dim
        home = self.home(r)
        x = w0["embedding"][ids].to(self.dt)
        pos = [positions.to(self.mesh.devices[r, a]) for a in range(self.n_attn)]
        for i in range(cfg.n_layers):
            pre = f"layers.{i}."
            h = self._rms(x, w0[pre + "attn_norm.weight"])
            parts = []
            for a in range(self.n_attn):
                ws, dev = self.shards[r, a], self.mesh.devices[r, a]
                ha = h.to(dev)
                q = column_linear(ha, ws[pre + "attn.q.weight"], dt)
                hs = q.shape[-1] // d
                q = rope(q.view(b, l, hs, d).transpose(1, 2), pos[a], cfg.rope_theta)
                k = rope(column_linear(ha, ws[pre + "attn.k.weight"], dt).view(b, l, hs, d)
                         .transpose(1, 2), pos[a], cfg.rope_theta)
                kflat = k.transpose(1, 2).reshape(b, l, hs * d)
                o = attend(a, i, q, kflat, column_linear(ha, ws[pre + "attn.v.weight"], dt))
                parts.append(row_partial(o, ws[pre + "attn.o.weight"], dt, self.n_attn))
            x = x + reduce_partials(parts, home, dt)
            h = self._rms(x, w0[pre + "mlp_norm.weight"])
            parts = []
            for s in range(self.n_mlp):
                ws = self.shards[r, s]
                hm = h.to(self.mesh.devices[r, s])
                g = F.silu(column_linear(hm, ws[pre + "mlp.gate.weight"], dt))
                u = column_linear(hm, ws[pre + "mlp.up.weight"], dt)
                parts.append(row_partial(g * u, ws[pre + "mlp.down.weight"], dt, self.n_mlp))
            x = x + reduce_partials(parts, home, dt)
        return self._rms(x, w0["final_norm.weight"])


def _replica_logits(lm: ShardedLM, cache: ShardedPagedCache, r: int, tok: torch.Tensor,
                    pos: torch.Tensor, block_table: torch.Tensor) -> torch.Tensor:
    """One 1-token step of replica ``r`` over its rows of the global
    ``tok``/``pos``/``block_table``: the new K/V written, the f32 logits
    ``[S/dp, vocab]`` returned on the replica's first device."""
    spr, ppr, C = tok.shape[0] // lm.dp, cache.pages_per_replica, cache.page_len
    home = lm.home(r)
    rows = slice(r * spr, (r + 1) * spr)
    t, p = tok[rows].to(home), pos[rows].to(home)
    table = block_table[rows] - r * ppr
    shard = []
    for sh in cache.layout[r]:
        tb, ps = table.to(sh.device), p.to(sh.device)
        keys = torch.arange(tb.shape[1] * C, device=sh.device)
        mask = (keys[None, :] <= ps[:, None]).float()
        page = tb[torch.arange(spr, device=sh.device), ps // C]
        shard.append((tb, mask, page, ps % C))

    def attend(a, i, q, kflat, vflat):
        tb, mask, page, off = shard[a]
        ck, cv = cache.k[r][a][i], cache.v[r][a][i]
        # free and mid-prefill rows point at the replica's null page at
        # position 0, which no live row reads unmasked
        ck[page, off] = kflat[:, 0].to(ck.dtype)
        cv[page, off] = vflat[:, 0].to(cv.dtype)
        b, hs, _, d = q.shape
        o = decode_attention(q.transpose(1, 2) * lm.q_scale, gather_pages(ck, tb),
                             gather_pages(cv, tb), kv_mask=mask)
        return o.reshape(b, 1, hs * d)

    hidden = lm.forward(r, t[:, None], p[:, None], attend)
    return hidden[:, -1].float() @ lm.heads[r]


def paged_decode_logits(lm: ShardedLM, cache: ShardedPagedCache, tok: torch.Tensor,
                        pos: torch.Tensor, block_table: torch.Tensor) -> torch.Tensor:
    """The f32 logits ``[S, vocab]`` of one 1-token step over all ``S``
    slots (the step's K/V written), on ``tok``'s device: what the decode
    step takes its argmax of."""
    with torch.inference_mode():
        return torch.cat([_replica_logits(lm, cache, r, tok, pos, block_table).to(tok.device)
                          for r in range(lm.dp)])


def make_sharded_paged_decode_step_fn(lm: ShardedLM, slot_len: int) -> Callable:
    """The MeshEngine decode step, the contract of
    ``make_lm_paged_decode_step_fn``: ``fn(cache, tok, pos, block_table) ->
    (cache, next_tok)`` over all ``S`` slots (global page ids in the table,
    each row's in its replica's range).  Every replica steps its ``S/dp``
    rows; the next tokens come back on ``tok``'s device."""
    def step(cache: ShardedPagedCache, tok: torch.Tensor, pos: torch.Tensor,
             block_table: torch.Tensor):
        with torch.inference_mode():
            nxt = [torch.argmax(_replica_logits(lm, cache, r, tok, pos, block_table), dim=-1)
                   .to(tok.device) for r in range(lm.dp)]
            return cache, torch.cat(nxt)

    return step


def make_sharded_prefill_chunk_fn(lm: ShardedLM, page_len: int, slot_len: int) -> Callable:
    """The MeshEngine chunked-prefill unit, the contract of
    ``make_lm_prefill_chunk_fn``: ``fn(cache, ids, p0, last_local,
    table_row) -> (cache, tok)`` for ONE page-sized chunk of one slot,
    run on that slot's replica (the row's global page ids say which; one
    host read of the row's first id)."""
    def chunk(cache: ShardedPagedCache, ids: torch.Tensor, p0: int, last_local: int,
              table_row: torch.Tensor):
        ppr, C = cache.pages_per_replica, cache.page_len
        with torch.inference_mode():
            r = int(table_row[0]) // ppr
            home = lm.home(r)
            rows = []
            for sh in cache.layout[r]:
                tb = (table_row - r * ppr).to(sh.device)
                rows.append((tb, tb[p0 // C].reshape(1)))

            def attend(a, i, q, kflat, vflat):
                tb, page = rows[a]
                ck, cv = cache.k[r][a][i], cache.v[r][a][i]
                ck.index_copy_(0, page, kflat.to(ck.dtype))
                cv.index_copy_(0, page, vflat.to(cv.dtype))
                _, hs, l, d = q.shape
                k4 = gather_pages(ck, tb[None]).view(1, -1, hs, d).transpose(1, 2)
                v4 = gather_pages(cv, tb[None]).view(1, -1, hs, d).transpose(1, 2)
                o = _dense_causal_attention(q, k4, v4, lm.scale, p0)
                return o.transpose(1, 2).reshape(1, l, hs * d)

            positions = (p0 + torch.arange(page_len, device=home))[None]
            hidden = lm.forward(r, ids.to(home), positions, attend)
            tok = torch.argmax(hidden[0, last_local].float() @ lm.heads[r])
            return cache, tok

    return chunk


def make_sharded_page_copy_fn() -> Callable:
    """Copy-on-write over the sharded pools: ``fn(cache, dst, src) ->
    cache``.  The ShardedPagedPool resolves CoW within one replica's page
    range, so the copy never crosses replicas."""
    def copy(cache: ShardedPagedCache, dst: int, src: int) -> ShardedPagedCache:
        cache.copy_page(dst, src)
        return cache

    return copy
