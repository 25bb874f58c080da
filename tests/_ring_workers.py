"""Per-rank functions that the ring and sequence-parallel tests run in gloo
worker processes (``tpu_air_torch.parallel.distributed.run_workers``).
They import torch and the port only, so a spawned worker does not import
JAX; the tests hold what they return against the JAX package."""

import numpy as np
import torch


def ring_rank(rank, world_size, device, q, k, v, do, cases):
    """Each (P, causal) of ``cases`` through ``ring_attention`` over a
    group of P ranks: all 4 ranks for P = 4, ranks {0, 1} and {2, 3} (two
    rings over the same sequence) for P = 2, where a rank's next and
    previous peer are one rank.  Returns, per case, this rank's place in
    its group, the length of its local shard, and its output and
    gradients for the cotangent ``do``."""
    import torch.distributed as dist

    from tpu_air_torch.ops.ring_attention import ring_attention

    groups = {4: dist.new_group([0, 1, 2, 3])}
    pairs = [dist.new_group([0, 1]), dist.new_group([2, 3])]
    groups[2] = pairs[rank // 2]
    out = {}
    for p, causal in cases:
        group = groups[p]
        r = dist.get_rank(group)
        n = q.shape[1] // p
        mine = slice(r * n, (r + 1) * n)
        qs, ks, vs = (torch.from_numpy(np.ascontiguousarray(x[:, mine])).requires_grad_()
                      for x in (q, k, v))
        o = ring_attention(qs, ks, vs, group, causal=causal)
        o.backward(torch.from_numpy(np.ascontiguousarray(do[:, mine])))
        out[(p, causal)] = {"rank": r, "local_len": qs.shape[1],
                            "out": o.detach().numpy(), "dq": qs.grad.numpy(),
                            "dk": ks.grad.numpy(), "dv": vs.grad.numpy()}
    return {"error": None, "cases": out}


class SGD:
    """``optax.sgd(lr)``: p -= lr * grad, for ``make_sp_train_step``."""

    def __init__(self, params, lr: float = 1.0):
        self.params = list(params)
        self.lr = lr

    @torch.no_grad()
    def step(self):
        for p in self.params:
            if p.grad is not None:
                p.sub_(self.lr * p.grad)
                p.grad = None


def sp_step_rank(rank, world_size, device, config, state_dict, ids, grids):
    """One ``make_sp_train_step`` of SGD(1.0) per (dp, sp) of ``grids``
    from ``state_dict`` on the global batch ``ids``: this rank's loss and
    parameter deltas (-gradient)."""
    from tpu_air_torch.models.lm import CausalLM
    from tpu_air_torch.parallel.sequence_parallel import (make_sp_mesh, make_sp_train_step,
                                                          shard_batch, shift_targets)

    out = {}
    for dp, sp in grids:
        mesh = make_sp_mesh(dp=dp, sp=sp)
        model = CausalLM(config, device="cpu")
        model.load_state_dict(state_dict)
        before = {n: p.detach().clone() for n, p in model.named_parameters()}
        ids_t = torch.from_numpy(ids).long()
        local = shard_batch(mesh, ids_t, shift_targets(ids_t, config.pad_token_id))
        loss = make_sp_train_step(model, SGD(model.parameters()), mesh)(
            *(t.contiguous() for t in local))
        out[(dp, sp)] = {"loss": float(loss), "mesh": (mesh.data_index, mesh.seq_index),
                         "local_shape": tuple(local[0].shape),
                         "delta": {n: (p.detach() - before[n]).numpy()
                                   for n, p in model.named_parameters()}}
    return {"error": None, "grids": out}
