"""Ring attention: attention over a sequence split into P contiguous shards,
the counterpart of ``tpu_air/ops/ring_attention.py``.

Rank r of a ring holds tokens ``[r*L/P, (r+1)*L/P)`` of q, k and v.  K/V
rotate around the ring, rank r sending to r+1 and receiving from r-1, so at
hop t rank r holds the K/V of rank ``(r - t) mod P``, the hop's *owner*.
Each hop runs the flash forward with its logsumexp (the kernel on a CUDA
tensor, the plain version on a CPU tensor) and folds the result into a
running ``(out, lse)`` through :func:`_merge`, flash's streaming rule
applied across ranks.  After P hops every rank holds its exact output.

Causality is decided by the hop type, never by a bias: the diagonal hop
(owner == r) runs causal flash, an earlier owner's hop runs non-causal
flash, and a later owner's hop is masked: it launches nothing, and only
passes its K/V on.  Without ``causal`` every hop is visible.

The gradient is one ``torch.autograd.Function`` around the whole ring.  The
JAX package differentiates its scan through ``ppermute``, whose transpose
JAX derives; a torch function per send and receive would deadlock, since a
rank whose loss uses no received K/V (rank 0 under ``causal``) would never
post the receives of the backward.  So the forward runs its P hops without
autograd and saves the merged output and the final lse; the backward is a
second pass around the ring in which K/V travel with f32 dK/dV
accumulators.  Each live hop calls :func:`flash_attention_backward` with the
merged output and the global lse: ``P = exp(s - lse)`` and ``delta =
rowsum(dO * out)`` are then the whole row's, hop by hop, so the per-hop dq,
dk and dv sum to the gradient of the whole attention.  dq accumulates where
it is; after P rotations each dK/dV accumulator is back at its owner.

The hops run over the ranks this process holds, rotated one of two ways:

* :func:`ring_attention`: one rank of a ``torch.distributed`` group,
  rotated by point-to-point sends (``batch_isend_irecv``; NCCL between
  cards, gloo between CPU processes).  The next hop's exchange is posted
  before this hop's kernels run, as XLA overlaps them in the JAX package.
* :func:`ring_attention_in_memory`: all P ranks of a sequence in this
  process, rotated by passing references.  The caller asks for it by name;
  nothing falls back to it.

The ring keeps no launch counter of its own: a live hop adds one to the
flash forward's counter, and one each to dq's and dk/dv's in the
backward; a masked hop adds none.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from tpu_air_torch._exports import make_callable

from .flash_attention import flash_attention_backward, flash_attention_with_lse

NEG_INF = -1e30
DIAGONAL, VISIBLE, MASKED = "diagonal", "visible", "masked"
_KV_TAG, _DKV_TAG = 0, 1


def _merge(out_a, lse_a, out_b, lse_b):
    """Combine two partial-softmax results in f32; ``lse = -1e30`` is the
    empty state, which takes weight 0 against any live one."""
    m = torch.maximum(lse_a, lse_b)
    wa = torch.exp(lse_a - m)[..., None]
    wb = torch.exp(lse_b - m)[..., None]
    out = (out_a.float() * wa + out_b.float() * wb) / (wa + wb)
    lse = m + torch.log(torch.exp(lse_a - m) + torch.exp(lse_b - m))
    return out, lse


def hop_kind(rank: int, owner: int, causal: bool) -> str:
    """The hop type of rank ``rank`` holding the K/V of rank ``owner``."""
    if not causal:
        return VISIBLE
    if owner == rank:
        return DIAGONAL
    return VISIBLE if owner < rank else MASKED


def live_hops(p: int, causal: bool) -> int:
    """Hops over all ranks of a ring of ``p`` that launch a kernel."""
    return p * (p + 1) // 2 if causal else p * p


class _InMemory:
    """All ``size`` ranks in this process: rank j's next tensors are rank
    j-1's (references, no copy)."""

    def __init__(self, size: int):
        self.size = size
        self.ranks = list(range(size))

    def start(self, held: List[Tuple[torch.Tensor, ...]], tag: int):
        rotated = [held[(j - 1) % self.size] for j in range(self.size)]
        return lambda: rotated


class _PointToPoint:
    """This process's one rank of ``group``: send to the next rank, receive
    from the previous one, one packed buffer each way."""

    def __init__(self, group):
        import torch.distributed as dist

        self.dist = dist
        self.group = group
        self.size = dist.get_world_size(group)
        rank = dist.get_rank(group)
        self.ranks = [rank]
        self.next = dist.get_global_rank(group, (rank + 1) % self.size)
        self.prev = dist.get_global_rank(group, (rank - 1) % self.size)
        self.backend = str(dist.get_backend(group))

    def start(self, held: List[Tuple[torch.Tensor, ...]], tag: int):
        dist = self.dist
        (tensors,) = held
        send = torch.cat([t.reshape(-1) for t in tensors])
        if send.is_cuda != (self.backend == "nccl"):
            raise ValueError(f"ring_attention: {send.device} tensors over a "
                             f"{self.backend} group (CUDA needs nccl, the CPU gloo)")
        recv = torch.empty_like(send)
        reqs = dist.batch_isend_irecv([
            dist.P2POp(dist.isend, send, self.next, self.group, tag),
            dist.P2POp(dist.irecv, recv, self.prev, self.group, tag)])

        def wait():
            for r in reqs:
                r.wait()
            out, offset = [], 0
            for t in tensors:
                out.append(recv[offset:offset + t.numel()].view(t.shape))
                offset += t.numel()
            return [tuple(out)]

        return wait


def _ring_forward(rot, qs, ks, vs, scale, causal):
    """P hops over the held ranks: merged outputs (q's type) and f32 lse."""
    p = rot.size
    outs = [torch.zeros(q.shape, dtype=torch.float32, device=q.device) for q in qs]
    lses = [torch.full(q.shape[:-1], NEG_INF, dtype=torch.float32, device=q.device)
            for q in qs]
    kv = list(zip(ks, vs))
    for hop in range(p):
        pending = rot.start(kv, _KV_TAG) if hop + 1 < p else None
        for j, r in enumerate(rot.ranks):
            kind = hop_kind(r, (r - hop) % p, causal)
            if kind == MASKED:
                continue
            o, lse = flash_attention_with_lse(qs[j], *kv[j], scale=scale,
                                              causal=kind == DIAGONAL)
            outs[j], lses[j] = _merge(outs[j], lses[j], o, lse)
        if pending is not None:
            kv = pending()
    return [o.to(q.dtype) for o, q in zip(outs, qs)], lses


def _ring_backward(rot, qs, ks, vs, outs, lses, dos, scale, causal):
    """The second pass: dq, dk, dv of every held rank, in the input types."""
    p = rot.size

    def zeros(t):
        return torch.zeros(t.shape, dtype=torch.float32, device=t.device)

    dqs = [zeros(q) for q in qs]
    kv = list(zip(ks, vs))
    dkv = [(zeros(k), zeros(v)) for k, v in kv]
    for hop in range(p):
        pending = rot.start(kv, _KV_TAG) if hop + 1 < p else None
        for j, r in enumerate(rot.ranks):
            kind = hop_kind(r, (r - hop) % p, causal)
            if kind == MASKED:
                continue
            dq, dk, dv = flash_attention_backward(qs[j], *kv[j], None, outs[j], lses[j],
                                                  dos[j], None, scale, kind == DIAGONAL)
            dqs[j].add_(dq.float())
            dkv[j][0].add_(dk.float())
            dkv[j][1].add_(dv.float())
        if pending is not None:
            kv = pending()
        # every hop, the last included: after P rotations each is at its owner
        dkv = rot.start(dkv, _DKV_TAG)()
    return ([g.to(q.dtype) for g, q in zip(dqs, qs)],
            [g.to(k.dtype) for (g, _), k in zip(dkv, ks)],
            [g.to(v.dtype) for (_, g), v in zip(dkv, vs)])


class _Ring(torch.autograd.Function):
    """The ring over the held ranks' ``q..., k..., v...``; one output a rank."""

    @staticmethod
    def forward(ctx, rot, scale, causal, *qkv):
        n = len(qkv) // 3
        qs, ks, vs = qkv[:n], qkv[n:2 * n], qkv[2 * n:]
        outs, lses = _ring_forward(rot, qs, ks, vs, scale, causal)
        ctx.save_for_backward(*qkv, *outs, *lses)
        ctx.rot, ctx.scale, ctx.causal, ctx.n = rot, scale, causal, n
        return tuple(outs)

    @staticmethod
    def backward(ctx, *dos):
        n = ctx.n
        saved = ctx.saved_tensors
        qs, ks, vs = saved[:n], saved[n:2 * n], saved[2 * n:3 * n]
        outs, lses = saved[3 * n:4 * n], saved[4 * n:]
        dqs, dks, dvs = _ring_backward(ctx.rot, qs, ks, vs, outs, lses, dos, ctx.scale,
                                       ctx.causal)
        return (None, None, None, *dqs, *dks, *dvs)


def _check(qs: Sequence[torch.Tensor], ks, vs, name: str) -> None:
    if not (len(qs) == len(ks) == len(vs)) or not qs:
        raise ValueError(f"{name}: {len(qs)} q, {len(ks)} k and {len(vs)} v shards")
    for q, k, v in zip(qs, ks, vs):
        if q.dim() not in (3, 4) or k.shape != q.shape or v.shape != q.shape \
                or q.shape != qs[0].shape:
            raise ValueError(f"{name}: shards must be one (B*H, L/P, D) or (B, H, L/P, D) "
                             f"shape; got q {tuple(q.shape)}, k {tuple(k.shape)}, "
                             f"v {tuple(v.shape)}")


def ring_attention(q, k, v, group, *, scale: Optional[float] = None,
                   causal: bool = False) -> torch.Tensor:
    """Attention of this rank's shard of a sequence split over ``group``.

    ``q/k/v``: the local shard, (B*H, L/P, D) or (B, H, L/P, D), rank r of
    the group holding tokens ``[r*L/P, (r+1)*L/P)``.  ``group``: a
    ``torch.distributed`` process group of P >= 2 ranks (nccl for CUDA
    tensors, gloo for CPU ones); every rank of it calls this together.
    ``scale`` defaults to 1/sqrt(D).  Returns the local output shard in q's
    type, differentiable in q, k and v."""
    import torch.distributed as dist

    _check([q], [k], [v], "ring_attention")
    if group is None or not dist.is_initialized():
        raise ValueError("ring_attention needs a process group; for all ranks of a "
                         "sequence in one process call ring_attention_in_memory")
    if dist.get_world_size(group) < 2:
        raise ValueError(f"ring_attention needs a group of 2 or more ranks, got "
                         f"{dist.get_world_size(group)}")
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    return _Ring.apply(_PointToPoint(group), scale, causal, q, k, v)[0]


def ring_attention_in_memory(qs: Sequence[torch.Tensor], ks: Sequence[torch.Tensor],
                             vs: Sequence[torch.Tensor], *, scale: Optional[float] = None,
                             causal: bool = False) -> List[torch.Tensor]:
    """The ring over all P ranks of a sequence held in this process: shard r
    of ``qs``, ``ks`` and ``vs`` is rank r's.  The same hops, merges and
    kernels as :func:`ring_attention`, rotated by reference.  Returns the P
    output shards, differentiable in every input."""
    _check(qs, ks, vs, "ring_attention_in_memory")
    if scale is None:
        scale = 1.0 / (qs[0].shape[-1] ** 0.5)
    return list(_Ring.apply(_InMemory(len(qs)), scale, causal, *qs, *ks, *vs))


make_callable(__name__)   # the JAX package exports the function under this name
