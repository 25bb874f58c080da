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
Statistics of the global batch inside the model (SegFormer's batch norm)
sum over the workers with :func:`cross_replica_sum`, which is
differentiable: its backward sums the cotangents over the workers too.
"""

from __future__ import annotations

import os
import pickle
import shutil
import tempfile
import threading
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


def cross_replica_sum(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the workers, and over the in-process data replicas
    of :func:`run_local_replicas`, as a differentiable op (``t`` itself
    with one of each): the backward sums the cotangents over them too, so a
    statistic of the global batch (a batch norm's moments) gets the
    gradient of every replica's loss.  ``torch.nn.SyncBatchNorm`` refuses
    CPU tensors, so a gloo group cannot use it."""
    group = getattr(_replica, "group", None)
    if group is not None:
        return group.sum(t, _replica.index)
    return _world_sum(t)


def _world_sum(t: torch.Tensor) -> torch.Tensor:
    if world()[1] == 1:
        return t
    return _CrossReplicaSum.apply(t)


_replica = threading.local()


def local_replica() -> int:
    """The in-process data replica this thread runs (0 outside
    :func:`run_local_replicas`)."""
    return getattr(_replica, "index", 0)


class _LocalReplicas:
    """The in-process data replicas of one worker, each running its forward
    pass in a thread of its own: :meth:`sum` waits for every replica's
    tensor, adds them in replica order on the first one's device (and over
    the workers), and hands each replica the sum on its device.  Plain
    autograd ops, so one backward over the replicas' summed loss carries
    every cotangent back."""

    def __init__(self, n: int):
        self.barrier = threading.Barrier(n)
        self.slots: List[Any] = [None] * n
        self.result = None

    def sum(self, t: torch.Tensor, index: int) -> torch.Tensor:
        self.slots[index] = t
        if self.barrier.wait() == 0:
            acc = self.slots[0]
            for x in self.slots[1:]:
                acc = acc + x.to(acc.device)
            self.result = _world_sum(acc)
        self.barrier.wait()
        out = self.result.to(t.device)
        self.barrier.wait()        # every replica has its sum before a next one starts
        return out


def run_local_replicas(fns: Sequence[Callable[[], Any]]) -> List[Any]:
    """Run ``fns[r]()`` for each in-process data replica ``r``, together
    (one thread each, under this thread's grad mode), so that their
    :func:`cross_replica_sum` calls meet; their results in replica order.
    One replica runs in this thread."""
    if len(fns) == 1:
        return [fns[0]()]
    group = _LocalReplicas(len(fns))
    grad = torch.is_grad_enabled()
    results: List[Any] = [None] * len(fns)
    errors: List[BaseException] = []

    def run(r: int) -> None:
        _replica.group, _replica.index = group, r
        try:
            with torch.set_grad_enabled(grad):
                results[r] = fns[r]()
        except BaseException as e:  # noqa: BLE001 - re-raised in the caller below
            errors.append(e)
            group.barrier.abort()   # the other replicas stop waiting for this one
        finally:
            _replica.group = None
            _replica.index = 0

    threads = [threading.Thread(target=run, args=(r,), name=f"replica-{r}")
               for r in range(len(fns))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    real = [e for e in errors if not isinstance(e, threading.BrokenBarrierError)]
    if errors:
        raise (real or errors)[0]
    return results


class _CrossReplicaSum(torch.autograd.Function):
    """A SUM all-reduce whose backward is a SUM all-reduce of the cotangent
    (what ``torch.distributed.nn.functional.all_reduce`` does, without its
    deprecation)."""

    @staticmethod
    def forward(ctx, t):
        out = t.clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, op=dist.ReduceOp.SUM)
        return g


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
    """N ranks on CUDA need N cards: rank r runs on ``cuda:r``."""
    if device.type == "cuda" and torch.cuda.device_count() < num_workers:
        raise ValueError(
            f"a run of {num_workers} ranks on CUDA needs {num_workers} cards (rank r runs "
            f"on cuda:r); {torch.cuda.device_count()} are visible")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"no worker group for device {device}")


def _worker(rank: int, world_size: int, store: str, device_type: str, threads: int,
            payload: str, out_dir: str, chips_per_worker: int = 1) -> None:
    """One worker: join the group, run ``fn(rank, world_size, device,
    *args)`` from the payload file and write its result to ``out_dir/<rank>``.
    On CUDA ``device`` is the first of the worker's ``chips_per_worker``
    devices (``mesh.worker_devices``: ``cuda:rank`` for one a worker), which
    its training function meshes again from its rank.  A result that holds
    an error raises after it is written, so that ``start_processes`` stops
    the workers still running (one may wait in a collective for the failed
    rank)."""
    if device_type == "cuda":
        from .mesh import worker_devices

        check_devices(world_size, torch.device("cuda"))
        devices = worker_devices(rank, chips_per_worker, torch.device("cuda"))
        if not devices:
            raise ValueError(f"worker {rank} of {chips_per_worker} devices each has none of "
                             f"the {torch.cuda.device_count()} visible cards")
        device = devices[0]
        torch.cuda.set_device(device)
    else:
        device = torch.device("cpu")
        torch.set_num_threads(threads)
    dist.init_process_group("nccl" if device_type == "cuda" else "gloo",
                            init_method=f"file://{store}", world_size=world_size, rank=rank)
    try:
        with open(payload, "rb") as f:
            fn, args = pickle.load(f)
        out = fn(rank, world_size, device, *args)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, str(rank)), "wb") as f:
        pickle.dump(out, f)
    if out.get("error"):
        raise RuntimeError(f"worker {rank}: {out['error']}")


def run_workers(fn: Callable[..., Dict[str, Any]], args: tuple, num_workers: int,
                device: torch.device, cloudpickled: bool = False,
                chips_per_worker: int = 1) -> List[Dict[str, Any]]:
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
        # through a file, not the process arguments: spawn writes those to
        # each child's pipe, and a write larger than the pipe blocks until
        # that child has imported its main module, so the children would
        # start one after another
        with open(os.path.join(work, "payload"), "wb") as f:
            f.write(payload)
        try:
            group = tmp.start_processes(
                _worker, nprocs=num_workers, start_method="spawn", join=False,
                args=(num_workers, os.path.join(work, "store"), device.type, threads,
                      os.path.join(work, "payload"), work, chips_per_worker))
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
