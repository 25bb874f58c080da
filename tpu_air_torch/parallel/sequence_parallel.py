"""Sequence- and data-parallel LM training over worker processes, the
counterpart of ``tpu_air/parallel/sequence_parallel.py``.

The JAX package runs one ``shard_map`` step over a ``(data, sequence)``
mesh.  Here each device is a rank of one ``torch.distributed`` group
(``parallel/distributed.py::run_workers``: gloo on the CPU, nccl with rank
r on ``cuda:r``), laid out as the JAX mesh lays its devices, row-major:
rank r is data row ``r // sp`` and sequence column ``r % sp``.  Each data
row's sp ranks form a sequence group, in which attention is ring attention
(``ops/ring_attention.py``: K/V rotate between the ranks, causality by hop
type).  Rank ``(d, s)`` holds batch rows ``[d*b, (d+1)*b)`` and tokens
``[s*L/sp, (s+1)*L/sp)``; RoPE takes the global positions of its tokens,
and the next-token targets are shifted globally before the split, so no
rank needs its neighbour's first token.

The step differentiates the local unnormalized loss sum, divided by the
token count all-reduced over every rank (data x sequence), then sums the
gradients over every rank (``all_reduce_grads``): the JAX step's
``psum(grad) / c_total``, the gradient of the global mean.  The
parameters are replicated, so one optimizer step on each rank keeps them
equal.  Per-rank attention memory stays O((L/sp)^2) in the scores the
plain version builds and O(L/sp) in the kernels.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import torch

from tpu_air_torch.models.lm import head_weight, lm_chunked_loss_with_targets

from .distributed import all_reduce_grads, all_reduce_sum, world


@dataclass
class SPMesh:
    """This rank's place in the ``(data, sequence)`` grid: the degrees, its
    data row and sequence column, and its row's sequence group (None when
    ``sp == 1``)."""

    dp: int
    sp: int
    data_index: int = 0
    seq_index: int = 0
    group: Any = None


def make_sp_mesh(dp: Optional[int] = None, sp: Optional[int] = None) -> SPMesh:
    """The grid over this process group's ranks (one rank, no group, outside
    one).  Default sp: the largest divisor of the world size that is <= 4;
    default dp: the world size over sp.  Every rank calls this together:
    each creates every data row's group, in the same order, as
    ``torch.distributed.new_group`` requires."""
    rank, n = world()
    if sp is None:
        sp = max(d for d in range(1, min(4, n) + 1) if n % d == 0)
    if dp is None:
        if n % sp != 0:
            raise ValueError(f"sp={sp} does not divide {n} devices")
        dp = n // sp
    if dp * sp != n:
        raise ValueError(f"dp={dp} x sp={sp} does not cover the {n} ranks")
    group = None
    if sp > 1:
        import torch.distributed as dist

        for d in range(dp):
            g = dist.new_group(list(range(d * sp, (d + 1) * sp)))
            if d == rank // sp:
                group = g
    return SPMesh(dp, sp, rank // sp, rank % sp, group)


def shift_targets(input_ids: torch.Tensor, pad_token_id: int) -> torch.Tensor:
    """Global next-token shift, done before sharding: position i's target is
    token i+1; the final position gets pad and is masked."""
    pad = torch.full((input_ids.shape[0], 1), pad_token_id, dtype=input_ids.dtype,
                     device=input_ids.device)
    return torch.cat([input_ids[:, 1:], pad], dim=1)


def shard_batch(mesh: SPMesh, input_ids, targets):
    """This rank's block of a global batch (rows over ``data``, tokens over
    ``sequence``, as ``P(data, sequence)`` shards it)."""
    n, length = input_ids.shape
    if n % mesh.dp or length % mesh.sp:
        raise ValueError(f"a ({n}, {length}) batch does not split over dp={mesh.dp} x "
                         f"sp={mesh.sp}")
    b, li = n // mesh.dp, length // mesh.sp
    rows = slice(mesh.data_index * b, (mesh.data_index + 1) * b)
    cols = slice(mesh.seq_index * li, (mesh.seq_index + 1) * li)
    return input_ids[rows, cols], targets[rows, cols]


def sp_local_loss(model, input_ids, targets, mesh: Optional[SPMesh] = None):
    """Unnormalized (sum, count) of the chunked lm-head CE over this rank's
    shard: RoPE positions from the shard's global offset, attention over the
    mesh's sequence group.  The recipe the train step differentiates and
    eval reports."""
    li = input_ids.shape[1]
    offset = mesh.seq_index * li if mesh is not None else 0
    positions = (offset + torch.arange(li, device=input_ids.device)).expand(
        input_ids.shape[0], li)
    hidden = model(input_ids, positions, return_hidden=True,
                   sequence_group=mesh.group if mesh is not None else None)
    return lm_chunked_loss_with_targets(hidden, head_weight(model), targets,
                                        model.config.pad_token_id)


def make_sp_train_step(model, optimizer, mesh: Optional[SPMesh] = None):
    """``step(input_ids, targets) -> loss`` on this rank's shards (a
    detached device scalar, the global batch's mean CE over non-pad
    targets, equal on every rank): the local sum over the global count, its
    gradient summed over every rank, one ``optimizer.step()``.
    ``optimizer`` is the object ``_make_optimizer`` returns."""
    params = optimizer.params

    def step(input_ids, targets):
        s, c = sp_local_loss(model, input_ids, targets, mesh)
        # the count is independent of the parameters: grad(S / C) = grad(S) / C
        n = torch.clamp(all_reduce_sum(c.detach().clone()), min=1.0)
        loss = s / n
        loss.backward()
        all_reduce_grads(params)
        optimizer.step()
        return all_reduce_sum(loss.detach())

    return step
