"""Long-context LM training with sequence parallelism on the PyTorch/CUDA
port: the twin of ``examples/long_context_lm.py`` on ``tpu_air_torch``.

Context length scales with the ``sequence`` axis: ``--dp x --sp`` ranks
each hold L/sp tokens of their batch rows, and attention is ring attention
(``tpu_air_torch/ops/ring_attention.py``: K/V rotate between the ranks of
a sequence group by point-to-point sends) built on the flash forward and
backward, so each rank's attention works on O(L/sp) tokens.  Rank r runs
on ``cuda:r`` (nccl), so sp > 1 on CUDA needs dp x sp cards; with
``--device cpu`` the ranks are CPU processes joined over gloo.

Offline: the corpus is synthetic periodic token rows (period 17, a seeded
phase per row), so next-token loss falls within a few steps.

    python examples/torch_long_context_lm.py --device cpu --seq-len 256 --sp 2
    python examples/torch_long_context_lm.py --sp 1          # one card
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def corpus(batch: int, seq_len: int, seed: int = 0) -> np.ndarray:
    """Periodic rows with a per-row phase, tokens 2..18."""
    period = 17
    phase = np.random.default_rng(seed).integers(0, period, (batch, 1))
    return (2 + (np.arange(seq_len)[None] + phase) % period).astype(np.int64)


def train_rank(rank: int, world_size: int, device, args) -> dict:
    """One rank: its block of the batch, the sequence- and data-parallel
    step, one loss per step (the global batch's, equal on every rank)."""
    import torch

    from tpu_air_torch.models.lm import CausalLM, LMConfig
    from tpu_air_torch.parallel.sequence_parallel import (make_sp_mesh, make_sp_train_step,
                                                          shard_batch, shift_targets)
    from tpu_air_torch.train.t5_trainer import TrainingArguments, _make_optimizer

    config = LMConfig(vocab_size=512, d_model=args.d_model, n_layers=args.n_layers,
                      n_heads=4, max_seq_len=args.seq_len)
    mesh = make_sp_mesh(dp=args.dp, sp=args.sp)
    model = CausalLM(config, device=device).init_weights(0)
    # the JAX example's optax.chain(clip_by_global_norm(1.0), adamw(1e-3))
    opt = _make_optimizer(TrainingArguments(learning_rate=1e-3, max_grad_norm=1.0,
                                            weight_decay=1e-4, lr_scheduler_type="constant"),
                          args.steps, model.parameters())
    step = make_sp_train_step(model, opt, mesh)
    ids = torch.from_numpy(corpus(args.batch, args.seq_len))
    ids, tgt = shard_batch(mesh, ids, shift_targets(ids, config.pad_token_id))
    ids, tgt = ids.contiguous().to(device), tgt.contiguous().to(device)
    losses, seconds = [], []
    for _ in range(args.steps):
        t0 = time.time()
        losses.append(float(step(ids, tgt)))
        seconds.append(time.time() - t0)
    return {"error": None, "losses": losses, "seconds": seconds, "dp": mesh.dp,
            "sp": mesh.sp, "local_tokens": int(ids.shape[1])}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seq-len", type=int, default=512,
                    help="GLOBAL context length (split over the sp ranks)")
    ap.add_argument("--sp", type=int, default=None,
                    help="sequence-parallel degree (default: 2 on the CPU, every "
                         "visible card on CUDA)")
    ap.add_argument("--dp", type=int, default=1, help="data-parallel degree")
    ap.add_argument("--batch", type=int, default=4, help="global batch size")
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--d-model", type=int, default=128)
    ap.add_argument("--n-layers", type=int, default=2)
    ap.add_argument("--device", default=None,
                    help="'cpu' for gloo ranks on the CPU; CUDA by default")
    args = ap.parse_args(argv)

    import torch

    from tpu_air_torch.device import resolve_device
    from tpu_air_torch.parallel.distributed import run_workers

    device = resolve_device(args.device)
    if args.sp is None:
        args.sp = 2 if device.type == "cpu" else torch.cuda.device_count()
    ranks = args.dp * args.sp
    print(f"mesh: dp={args.dp} x sp={args.sp} over {ranks} ranks on {device.type}; "
          f"global seq {args.seq_len} -> {args.seq_len // args.sp} tokens/rank", flush=True)
    if ranks == 1:
        outs = [train_rank(0, 1, device, args)]
    else:
        outs = run_workers(train_rank, (args,), ranks, device)
    errors = [o["error"] for o in outs if o.get("error")]
    if errors:
        print("\n".join(errors), file=sys.stderr)
        return 2
    losses = outs[0]["losses"]
    for i, (loss, s) in enumerate(zip(losses, outs[0]["seconds"])):
        tag = " (first)" if i == 0 else ""
        print(f"step {i}: loss={loss:.4f}  [{s:.2f}s]{tag}")
    first, best = losses[0], min(losses)
    if not best < first:
        print(f"loss did not improve: {first:.4f} -> best {best:.4f}")
        return 1
    toks = args.batch * args.seq_len
    print(f"sequence-parallel training OK: {toks} tokens/step over {ranks} ranks, "
          f"loss {first:.4f} -> {losses[-1]:.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
