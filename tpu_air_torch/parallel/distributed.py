"""Data parallelism over worker processes, the port's counterpart of the
JAX package's ``data`` mesh axis (``ScalingConfig(num_workers=N)``).

The JAX package jits one SPMD step over N devices: the batch is sharded
over ``data`` (device r holds rows ``[r*b, (r+1)*b)`` of each global batch)
and XLA sums the gradients of the replicated parameters.  Here N worker
processes each hold the whole model; :func:`run_workers` starts them with
``torch.multiprocessing.start_processes`` and ``spawn`` (forking a process
that has touched CUDA breaks the children) and joins a
``torch.distributed`` group through a file store in a fresh temporary
directory (no port to pick, so no race for one): ``gloo`` on the CPU,
``nccl`` on CUDA, where rank r runs on ``cuda:r``.  A train step
all-reduces its token count and then the gradients of
``local_sum / global_count`` with a SUM (:func:`all_reduce_grads`), which
is the JAX step's gradient of the global mean; averaging per-rank means, as
plain DDP does, differs whenever the ranks hold different token counts.
"""

from __future__ import annotations

import os
import pickle
import shutil
import tempfile
from typing import Any, Callable, Dict, List, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as tmp


def world() -> tuple:
    """(rank, world size) of this process; (0, 1) outside a worker group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the workers, in place (``t`` itself with one)."""
    if world()[1] > 1:
        dist.all_reduce(t, op=dist.ReduceOp.SUM)
    return t


def all_reduce_grads(params: Sequence[torch.nn.Parameter]) -> None:
    """Sum every parameter's ``.grad`` over the workers, in one flat
    all-reduce per type."""
    if world()[1] == 1:
        return
    by_type: Dict[torch.dtype, List[torch.Tensor]] = {}
    for p in params:
        if p.grad is not None:
            by_type.setdefault(p.grad.dtype, []).append(p.grad)
    for grads in by_type.values():
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM)
        offset = 0
        for g in grads:
            g.copy_(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()


def check_devices(num_workers: int, device: torch.device) -> None:
    """N workers on CUDA need N cards: rank r runs on ``cuda:r``."""
    if device.type == "cuda" and torch.cuda.device_count() < num_workers:
        raise ValueError(
            f"num_workers={num_workers} on CUDA needs {num_workers} cards (rank r runs on "
            f"cuda:r); {torch.cuda.device_count()} are visible")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"no worker group for device {device}")


def _worker(rank: int, world_size: int, store: str, device_type: str, threads: int,
            payload: bytes, out_dir: str) -> None:
    """One worker: join the group, run ``fn(rank, world_size, device,
    *args)`` from the payload and write its result to ``out_dir/<rank>``.
    A result that holds an error raises after it is written, so that
    ``start_processes`` stops the workers still running (one may wait in a
    collective for the failed rank)."""
    if device_type == "cuda":
        check_devices(world_size, torch.device("cuda"))
        device = torch.device("cuda", rank)
        torch.cuda.set_device(device)
    else:
        device = torch.device("cpu")
        torch.set_num_threads(threads)
    dist.init_process_group("nccl" if device_type == "cuda" else "gloo",
                            init_method=f"file://{store}", world_size=world_size, rank=rank)
    try:
        fn, args = pickle.loads(payload)
        out = fn(rank, world_size, device, *args)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, str(rank)), "wb") as f:
        pickle.dump(out, f)
    if out.get("error"):
        raise RuntimeError(f"worker {rank}: {out['error']}")


def run_workers(fn: Callable[..., Dict[str, Any]], args: tuple, num_workers: int,
                device: torch.device, cloudpickled: bool = False) -> List[Dict[str, Any]]:
    """Run ``fn(rank, num_workers, device_of_rank, *args)`` in
    ``num_workers`` spawned processes joined in one ``torch.distributed``
    group; return each rank's result (a dict; ``{"error": ...}`` for a
    rank that raised, or that was stopped when another failed).  ``fn`` and
    ``args`` are pickled (``cloudpickled`` for objects plain pickle
    refuses, such as a preprocessor wrapping a lambda).  A daemonic
    process (an actor of the port's runtime, a Tune trial's among them) may
    not start processes, so there it raises."""
    import multiprocessing

    if multiprocessing.current_process().daemon:
        raise NotImplementedError(
            f"{num_workers} worker processes from an actor of the runtime (a Tune trial): "
            "a daemonic process may not start processes (ROADMAP Queue 1 item 12)")
    check_devices(num_workers, device)
    if cloudpickled:
        import cloudpickle

        payload = cloudpickle.dumps((fn, args))
    else:
        payload = pickle.dumps((fn, args))
    work = tempfile.mkdtemp(prefix="tpu_air_torch-workers-")
    threads = max(1, torch.get_num_threads() // num_workers)
    failure = ""
    try:
        try:
            group = tmp.start_processes(
                _worker, nprocs=num_workers, start_method="spawn", join=False,
                args=(num_workers, os.path.join(work, "store"), device.type, threads,
                      payload, work))
            # when one worker fails, the others get 30 s to fail in their
            # collectives and write their own results (rank 0's names the
            # latest checkpoint a retry resumes from) before they are stopped
            while not group.join(grace_period=30.0):
                pass
        except (tmp.ProcessRaisedException, tmp.ProcessExitedException) as e:
            failure = str(e)
        outs = []
        for r in range(num_workers):
            path = os.path.join(work, str(r))
            if not os.path.exists(path):
                outs.append({"error": f"worker {r} left no result:{failure}"})
                continue
            with open(path, "rb") as f:
                outs.append(pickle.load(f))
        return outs
    finally:
        shutil.rmtree(work, ignore_errors=True)
