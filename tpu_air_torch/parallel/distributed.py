"""Data parallelism over worker processes, the port's counterpart of the
JAX package's ``data`` mesh axis (``ScalingConfig(num_workers=N)``).

The JAX package jits one SPMD step over N devices: the batch is sharded
over ``data`` (device r holds rows ``[r*b, (r+1)*b)`` of each global batch)
and XLA sums the gradients of the replicated parameters.  Here N worker
processes each hold the whole model, joined in a ``torch.distributed``
group through a file store in a fresh temporary directory (no port to
pick, so no race for one).  :func:`run_workers` makes each rank an actor
of the port's runtime placed on its share of one lease
(:func:`run_actor_workers`): inside an actor (a ``fit()``'s or a Tune
trial's runner) that actor's own lease, elsewhere a carrier actor's.  The
group's backend is ``nccl`` where every rank has a card of its own,
``gloo`` on the CPU and where ranks share a card (:func:`group_backend`).
:func:`any_rank` is a decision
every rank of a group takes together (a Tune trial's stop).  A train step
all-reduces its token count and then the gradients of
``local_sum / global_count`` with a SUM (:func:`all_reduce_grads`), which
is the JAX step's gradient of the global mean; averaging per-rank means, as
plain DDP does, differs whenever the ranks hold different token counts.
Statistics of the global batch inside the model (SegFormer's batch norm)
sum over the workers with :func:`cross_replica_sum`, which is
differentiable: its backward sums the cotangents over the workers too.

Multi-host (the JAX package's ``tpu_air/parallel/distributed.py``, with its
env contract): ``ensure_initialized()`` joins a gloo group of one rank a
host at the coordinator's ``TCPStore``; ``HostAgentServer`` (host 0) and
``agent_loop`` (the other hosts) broadcast cloudpickled thunks that every
host runs in lockstep; ``ObjectPlane`` fetches objects across hosts through
the GCS object directory; ``spawn_local_cluster`` emulates N hosts on one
machine.  A multi-host fit runs one controller a host, its data replicas
joined over the hosts its lease spans by a :class:`HostGroup`, which
:func:`host_scope` makes the group of :func:`world` and of the all-reduces
above for the length of the fit, and of nothing else: a worker group of
:func:`run_workers` and a single-host attempt never see it.

Env contract (set by the pod launcher or ``spawn_local_cluster``):
    TPU_AIR_COORDINATOR   host:port of process 0's rendezvous store
    TPU_AIR_NUM_PROCESSES world size (one process a host)
    TPU_AIR_PROCESS_ID    this host's rank
    TPU_AIR_CONTROL       host:port of the agent control plane (host 0)
    TPU_AIR_NUM_CHIPS     the cluster's chip slots (hosts x chips a host)
    TPU_AIR_CHIPS_PER_HOST chip slots a host: global slot g is slot
                          g % chips_per_host of host g // chips_per_host
    TPU_AIR_AUTHKEY       the control plane's key
    TPU_AIR_RENDEZVOUS_TIMEOUT_S how long the rendezvous waits (300)
"""

from __future__ import annotations

import datetime
import multiprocessing.connection as mpc
import os
import pickle
import secrets
import shutil
import socket
import subprocess
import sys
import tempfile
import threading
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist


def world() -> tuple:
    """(rank, world size) of this process: its host's within a multi-host
    fit (:func:`host_scope`), its worker's in a worker group, else (0, 1)."""
    if _SCOPE is not None:
        return _SCOPE.rank, _SCOPE.size
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _all_reduce(t: torch.Tensor) -> None:
    """A SUM all-reduce of ``t`` in place over the scoped hosts, else over
    the worker group."""
    if _SCOPE is not None:
        _SCOPE.all_reduce(t)
    else:
        dist.all_reduce(t, op=dist.ReduceOp.SUM)


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the workers, in place (``t`` itself with one)."""
    if world()[1] > 1:
        _all_reduce(t)
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
        _all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        _all_reduce(g)
        return g


def all_reduce_grads(params: Sequence[torch.nn.Parameter]) -> None:
    """Sum every parameter's ``.grad`` over the workers, in one flat
    all-reduce per device and type.  Within a multi-host fit each call's
    wall time, from the gradients' readiness to the summed values', is
    added to :data:`HOST_ALLREDUCE`."""
    if world()[1] == 1:
        return
    by_type: Dict[tuple, List[torch.Tensor]] = {}
    for p in params:
        if p.grad is not None:
            by_type.setdefault((p.grad.device, p.grad.dtype), []).append(p.grad)
    timed = _SCOPE is not None
    if timed:
        _sync(by_type)
        t0 = time.perf_counter()
    for grads in by_type.values():
        flat = torch.cat([g.reshape(-1) for g in grads])
        _all_reduce(flat)
        offset = 0
        for g in grads:
            g.copy_(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()
    if timed:
        _sync(by_type)
        HOST_ALLREDUCE["backend"] = _SCOPE.backend
        HOST_ALLREDUCE["calls"] += 1
        HOST_ALLREDUCE["ms"].append((time.perf_counter() - t0) * 1e3)
        HOST_ALLREDUCE["bytes"] = sum(g.numel() * g.element_size()
                                      for grads in by_type.values() for g in grads)


def _sync(by_type: Dict[tuple, List[torch.Tensor]]) -> None:
    for device, _ in by_type:
        if device.type == "cuda":
            torch.cuda.synchronize(device)


def check_slots(ranks: int, devices_per_rank: int, slots: int) -> None:
    """A group of ``ranks`` ranks over ``devices_per_rank`` cards each
    leases that many chip slots of the runtime (wrapped onto its cards):
    refused before any rank starts where the runtime has fewer."""
    need = ranks * devices_per_rank
    if need > slots:
        raise ValueError(
            f"a run of {ranks} ranks of {devices_per_rank} devices each needs {need} cards "
            f"(chip slots of the runtime, wrapped onto its cards); the runtime has {slots}")


def run_workers(fn: Callable[..., Dict[str, Any]], args: tuple, num_workers: int,
                device: torch.device, chips_per_worker: int = 1) -> List[Dict[str, Any]]:
    """Run ``fn(rank, num_workers, device_of_rank, *args)`` on
    ``num_workers`` ranks joined in one ``torch.distributed`` group; return
    each rank's result (a dict; ``{"error": ...}`` for a rank that raised,
    or that was stopped when another failed).  When one rank fails, the
    others get 30 s to fail in their collectives and write their own
    results (rank 0's names the latest checkpoint a retry resumes from)
    before they are stopped.  ``fn`` and ``args`` travel cloudpickled.

    Each rank is an actor of the port's runtime placed on its share of one
    lease (:func:`run_actor_workers`).  Called from an actor (a Tune
    trial's, or the one ``fit()`` runs its attempt in), that lease is the
    actor's own.  Elsewhere a carrier actor leases the group's cards (none
    on the CPU) and runs the group from inside: in the runtime that runs,
    or in one started for the call and stopped after it."""
    import cloudpickle

    from tpu_air_torch.core import api
    from tpu_air_torch.core import runtime as _rt
    from tpu_air_torch.core.remote import kill, remote

    if _rt.current_worker() is not None:
        return run_actor_workers(fn, args, num_workers, device, chips_per_worker)
    device = torch.device(device)
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"no worker group for device {device}")
    on_cards = device.type == "cuda"
    started = not _rt.is_initialized()
    if on_cards:    # a runtime started here has a slot a card
        check_slots(num_workers, chips_per_worker,
                    torch.cuda.device_count() if started else _rt.get_runtime().num_chips)
    if started:
        _rt.init(num_chips=None if on_cards else 0)
    try:
        carrier = remote(_Carrier).options(
            num_cpus=0, num_chips=num_workers * chips_per_worker if on_cards else None).remote()
        try:
            return api.get(carrier.run.remote(cloudpickle.dumps((fn, args)), num_workers,
                                              device, chips_per_worker,
                                              torch.get_num_threads()))
        finally:
            kill(carrier)
    finally:
        if started:
            _rt.shutdown()


class _Carrier:
    """The actor that holds a group's lease for :func:`run_workers` called
    outside the runtime's actors, and runs the group on it."""

    def run(self, payload: bytes, num_workers: int, device: torch.device,
            chips_per_worker: int, threads: int) -> List[Dict[str, Any]]:
        torch.set_num_threads(threads)
        return _run_rank_actors(payload, num_workers, device, chips_per_worker)


# how long the other ranks of a failed group get to fail in their
# collectives and write their results before they are stopped
_GRACE_S = 30.0

# a worker group's control group (gloo, CPU tensors) where its data backend
# is nccl; None where the default group is gloo
_CONTROL: Optional[Any] = None


def any_rank(flag: bool) -> bool:
    """Whether ``flag`` holds on any rank of this worker group: a decision
    every rank takes at the same point of its program (a MAX all-reduce of
    a CPU tensor over gloo).  ``flag`` itself outside a group."""
    if not (dist.is_available() and dist.is_initialized()) or dist.get_world_size() == 1:
        return flag
    t = torch.tensor([1.0 if flag else 0.0])
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=_CONTROL)
    return bool(t.item())


def group_backend(cards: Sequence[Optional[int]]) -> str:
    """The data backend of a worker group whose rank r runs on card
    ``cards[r]`` (None on the CPU): ``nccl`` where every rank has a card
    of its own, ``gloo`` on the CPU and where ranks share a card (NCCL
    refuses two ranks on one device; gloo carries CUDA tensors through host
    memory), as :func:`host_backend` rules for hosts."""
    if any(c is None for c in cards) or len(set(cards)) < len(cards):
        return "gloo"
    return "nccl"


class _Rank:
    """One rank of an actor worker group (an actor placed on its share of
    the group's lease)."""

    def run(self, rank: int, world_size: int, store: str, backend: str, device_type: str,
            threads: int, lease: Optional[List[int]], chips_per_worker: int,
            payload: bytes) -> Dict[str, Any]:
        global _CONTROL
        if lease is not None:
            # the group's whole lease: the rank's devices are its
            # chips_per_worker consecutive ones (mesh.worker_devices)
            os.environ["TPU_AIR_CHIP_IDS"] = ",".join(str(c) for c in lease)
        if device_type == "cuda":
            from .mesh import worker_devices

            device = worker_devices(rank, chips_per_worker, torch.device("cuda"))[0]
            torch.cuda.set_device(device)
        else:
            device = torch.device("cpu")
            torch.set_num_threads(threads)
        dist.init_process_group(backend, init_method=f"file://{store}",
                                world_size=world_size, rank=rank)
        _CONTROL = dist.new_group(backend="gloo") if backend == "nccl" else None
        try:
            fn, args = pickle.loads(payload)
            return fn(rank, world_size, device, *args)
        except Exception:  # noqa: BLE001 - a rank's failure is its result
            return {"error": f"worker {rank}: {traceback.format_exc()}"}
        finally:
            _CONTROL = None
            dist.destroy_process_group()


def run_actor_workers(fn: Callable[..., Dict[str, Any]], args: tuple, num_workers: int,
                      device: torch.device, chips_per_worker: int = 1
                      ) -> List[Dict[str, Any]]:
    """:func:`run_workers` from inside an actor of the port's runtime: each
    rank is an actor placed on its ``chips_per_worker`` ids of this actor's
    lease (none when the lease is empty, on the CPU), never claimed from the
    pool again, so a trial's workers cannot wait for cards their own trial
    holds.  They die with this actor, whose lease returns to the pool only
    once their processes have exited.  The ranks join a group through a
    file store in a fresh directory; its backend is
    :func:`group_backend`'s.  The payload is cloudpickled once into the
    object store."""
    import cloudpickle

    return _run_rank_actors(cloudpickle.dumps((fn, args)), num_workers, device,
                            chips_per_worker)


def _run_rank_actors(payload: bytes, num_workers: int, device: torch.device,
                     chips_per_worker: int) -> List[Dict[str, Any]]:
    from tpu_air_torch.core import api
    from tpu_air_torch.core.remote import kill, remote
    from tpu_air_torch.core.runtime import RemoteError, current_worker

    device = torch.device(device)
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"no worker group for device {device}")
    ctx = current_worker()
    lease = list(ctx.chip_ids)
    need = num_workers * chips_per_worker
    if device.type == "cuda" and len(lease) < need:
        raise ValueError(
            f"a group of {num_workers} ranks of {chips_per_worker} devices each on CUDA "
            f"needs a lease of {need} chips; this actor holds {lease}")
    shares = ([lease[r * chips_per_worker:(r + 1) * chips_per_worker]
               for r in range(num_workers)] if len(lease) >= need
              else [[] for _ in range(num_workers)])
    cards = ([share[0] % torch.cuda.device_count() for share in shares]
             if device.type == "cuda" else [None] * num_workers)
    backend = group_backend(cards)
    group_lease = lease[:need] if device.type == "cuda" else None
    threads = max(1, torch.get_num_threads() // num_workers)
    payload = api.put(payload)
    work = tempfile.mkdtemp(prefix="tpu_air_torch-workers-")
    rank_cls = remote(_Rank)
    ranks = [rank_cls.options(num_cpus=0, chip_ids=shares[r]).remote()
             for r in range(num_workers)]
    futures = [a.run.remote(r, num_workers, os.path.join(work, "store"), backend,
                            device.type, threads, group_lease, chips_per_worker, payload)
               for r, a in enumerate(ranks)]
    outs: List[Optional[Dict[str, Any]]] = [None] * num_workers
    failed_at: Optional[float] = None
    try:
        pending = list(futures)
        while pending:
            slot = 0.5 if failed_at is None else failed_at + _GRACE_S - time.monotonic()
            if slot <= 0:
                break
            ready, pending = api.wait(pending, num_returns=1, timeout=slot)
            for ref in ready:
                r = futures.index(ref)
                try:
                    outs[r] = api.get(ref)
                except RemoteError as e:    # the rank's process died outright
                    outs[r] = {"error": f"worker {r}: {e}"}
                ctx.store.delete(ref.id)
                if outs[r].get("error") and failed_at is None:
                    failed_at = time.monotonic()
    finally:
        for a in ranks:
            kill(a)
        ctx.store.delete(payload.id)
        shutil.rmtree(work, ignore_errors=True)
    return [o if o is not None else
            {"error": f"worker {r} was stopped {_GRACE_S:.0f} s after another failed"}
            for r, o in enumerate(outs)]


# --------------------------------------------------------------------------
# multi-host: rendezvous
# --------------------------------------------------------------------------


def _authkey() -> bytes:
    """Per-cluster control-plane authkey (copied from the JAX package).  The
    launcher generates a random key and distributes it via the env contract
    (``TPU_AIR_AUTHKEY``); a compiled-in constant would be remote code
    execution for anyone who can reach a non-loopback ``HostAgentServer``.
    The static fallback only covers single-host loopback emulation with no
    launcher."""
    key = os.environ.get("TPU_AIR_AUTHKEY")
    return key.encode() if key else b"tpu_air-local-loopback"


def _routable_host(toward: Optional[str]) -> str:
    """The local address other hosts can reach us at: the source address of
    a route toward the coordinator or GCS (copied from the JAX package).
    Stays 127.0.0.1 in single-host emulation, where that is loopback."""
    target = (toward or "").split(":")[0] or "127.0.0.1"
    try:
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        try:
            s.connect((target, 1))  # no packets sent; just picks a route
            return s.getsockname()[0]
        finally:
            s.close()
    except OSError:
        return "127.0.0.1"


class _Rendezvous:
    """What :func:`ensure_initialized` joined: the coordinator's store and a
    gloo group of every host, this host at its process id."""

    def __init__(self, coordinator: str, store, rank: int, size: int,
                 timeout: datetime.timedelta):
        self.coordinator = coordinator
        self.store = store
        self.timeout = timeout
        self.group = dist.ProcessGroupGloo(dist.PrefixStore("hosts", store), rank, size, timeout)


_RENDEZVOUS: Optional[_Rendezvous] = None
_ACTIVE_CLUSTER: Optional["LocalCluster"] = None


def set_active_cluster(cluster) -> None:
    """Register the cluster handle trainers use for multi-host fits (a
    lease that spans hosts runs through its agent plane).
    ``spawn_local_cluster`` registers automatically."""
    global _ACTIVE_CLUSTER
    _ACTIVE_CLUSTER = cluster


def active_cluster():
    return _ACTIVE_CLUSTER


def _env_int(name: str) -> Optional[int]:
    raw = os.environ.get(name)
    return int(raw) if raw else None


def _rendezvous_timeout() -> datetime.timedelta:
    return datetime.timedelta(seconds=float(os.environ.get("TPU_AIR_RENDEZVOUS_TIMEOUT_S", "300")))


def _bind_store(host: str, port: int, num_processes: int, timeout: datetime.timedelta):
    """The coordinator's store, listening on ``host:port`` (host 0)."""
    return dist.TCPStore(host, port, num_processes, True, timeout, wait_for_workers=False)


def ensure_initialized(
    coordinator: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> bool:
    """Join the multi-host cluster if configured; returns True when this
    process is part of a multi-process run.  Idempotent.  Reads the env
    contract when args are omitted (``tpu_air_torch.init()`` calls this
    first, so an env block is all a multi-host launch needs).  Host 0
    serves the coordinator's ``TCPStore`` (what a ``tcp://`` init does);
    every host joins a gloo group of one rank a host there.  Raises when
    the rendezvous fails or times out (``TPU_AIR_RENDEZVOUS_TIMEOUT_S``)."""
    return _rendezvous(coordinator, num_processes, process_id) is not None


def _rendezvous(coordinator=None, num_processes=None, process_id=None, store=None,
                timeout: Optional[datetime.timedelta] = None) -> Optional[_Rendezvous]:
    global _RENDEZVOUS
    if _RENDEZVOUS is not None:
        return _RENDEZVOUS
    coordinator = coordinator or os.environ.get("TPU_AIR_COORDINATOR")
    num_processes = num_processes or _env_int("TPU_AIR_NUM_PROCESSES")
    process_id = process_id if process_id is not None else _env_int("TPU_AIR_PROCESS_ID")
    if not coordinator or not num_processes or num_processes <= 1:
        return None
    pid = process_id or 0
    timeout = timeout or _rendezvous_timeout()
    host, port = coordinator.rsplit(":", 1)
    if store is None:
        store = (_bind_store(host, int(port), num_processes, timeout) if pid == 0 else
                 dist.TCPStore(host, int(port), num_processes, False, timeout))
    _RENDEZVOUS = _Rendezvous(coordinator, store, pid, num_processes, timeout)
    return _RENDEZVOUS


def _leave() -> None:
    """Forget the rendezvous (its group and store close with the last
    reference), so a later cluster in this process starts anew."""
    global _RENDEZVOUS
    _RENDEZVOUS = None
    _RETIRED.clear()


def process_index() -> int:
    return _RENDEZVOUS.group.rank() if _RENDEZVOUS is not None else 0


def process_count() -> int:
    return _RENDEZVOUS.group.size() if _RENDEZVOUS is not None else 1


def is_coordinator() -> bool:
    return process_index() == 0


def hosts_share_cards() -> bool:
    """Whether the hosts of this cluster are processes of one machine: the
    coordinator is a loopback address.  Each host then maps its local chip
    slots onto the same cards (slot s of every host on ``cuda:s`` wrapped,
    ``mesh.visible_devices``), so they share them."""
    if _RENDEZVOUS is None:
        return True
    host = _RENDEZVOUS.coordinator.rsplit(":", 1)[0]
    return host in ("localhost", "::1") or host.startswith("127.")


def host_backend(device: torch.device) -> str:
    """The backend of a multi-host fit's data group: ``gloo`` on the CPU
    and where the hosts share cards (NCCL refuses two ranks on one device;
    gloo carries CUDA tensors through host memory, for ``all_reduce``,
    ``broadcast`` and ``barrier``, which are all a fit sends across
    hosts); ``nccl`` where each host has cards of its own."""
    if torch.device(device).type != "cuda" or hosts_share_cards():
        return "gloo"
    return "nccl"


class HostGroup:
    """The hosts a multi-host fit's lease spans (global process ids
    ``hosts``, in order), as one group: this host is rank
    ``hosts.index(process_index())``.  Made by every host of the fit
    together, under ``token``, a name the fit's thunk carries, so that
    each attempt gets groups of its own.  The data group's backend is
    :func:`host_backend`'s; the control group (:meth:`any`) is gloo on
    CPU tensors."""

    def __init__(self, hosts: Sequence[int], token: str, device: torch.device):
        rdv = _RENDEZVOUS
        if rdv is None:
            raise RuntimeError("a host group needs the multi-host rendezvous "
                               "(ensure_initialized)")
        self.hosts = list(hosts)
        self.rank = self.hosts.index(rdv.group.rank())
        self.size = len(self.hosts)
        self.backend = host_backend(device)
        prefix = f"fit/{token}/" + ",".join(str(h) for h in self.hosts)
        self._ctl = dist.ProcessGroupGloo(dist.PrefixStore(prefix + "/ctl", rdv.store),
                                          self.rank, self.size, rdv.timeout)
        if self.backend == "gloo":
            self._data = self._ctl
        else:
            torch.cuda.set_device(torch.device(device))
            self._data = dist.ProcessGroupNCCL(dist.PrefixStore(prefix + "/data", rdv.store),
                                               self.rank, self.size)

    def all_reduce(self, t: torch.Tensor) -> None:
        opts = dist.AllreduceOptions()
        opts.reduceOp = dist.ReduceOp.SUM
        self._data.allreduce([t], opts).wait()

    def any(self, flag: bool) -> bool:
        """Whether ``flag`` holds on any host: one decision every host
        takes at the same point of its program."""
        t = torch.tensor([1.0 if flag else 0.0])
        opts = dist.AllreduceOptions()
        opts.reduceOp = dist.ReduceOp.MAX
        self._ctl.allreduce([t], opts).wait()
        return bool(t.item())

    def close(self) -> None:
        """Drop the groups: the other hosts' pending collectives then fail
        at once instead of waiting for the timeout.  For a host whose fit
        failed; a fit that ends well leaves its groups to :class:`host_scope`."""
        self._ctl = self._data = None


_SCOPE: Optional[HostGroup] = None
# the last fit's group, kept open: dropping it at once could reset a
# connection whose last message the other host is still reading.  The next
# fit's end replaces it (by then every host has finished the one before)
_RETIRED: List[HostGroup] = []

# the cross-host gradient all-reduce of this process's multi-host fits:
# calls, each call's wall ms, the bytes and the group's backend of the last
HOST_ALLREDUCE: Dict[str, Any] = {"calls": 0, "ms": [], "bytes": 0, "backend": None}


class host_scope:
    """``with host_scope(group):`` makes ``group`` the one :func:`world`,
    :func:`all_reduce_sum`, :func:`all_reduce_grads` and
    :func:`cross_replica_sum` use; after the block no call sees it."""

    def __init__(self, group: HostGroup):
        self.group = group

    def __enter__(self) -> HostGroup:
        global _SCOPE
        if _SCOPE is not None:
            raise RuntimeError("a multi-host fit is already running in this process")
        _SCOPE = self.group
        return self.group

    def __exit__(self, *exc) -> None:
        global _SCOPE
        _SCOPE = None
        _RETIRED[:] = [self.group]


def current_host_group() -> Optional[HostGroup]:
    return _SCOPE


# --------------------------------------------------------------------------
# control plane: program broadcast from host 0
# --------------------------------------------------------------------------


class HostAgentServer:
    """Driver-side (host 0) control plane.

    Accepts one connection per non-zero host, then ``run(fn)`` broadcasts a
    cloudpickled zero-arg thunk, executes it locally too (every host enters
    the same program), and gathers per-host results.  Exceptions on any
    host propagate with their remote traceback."""

    def __init__(self, num_processes: int, address: Optional[tuple] = None):
        self.num_processes = num_processes
        addr = address or ("127.0.0.1", 0)
        self._listener = mpc.Listener(addr, authkey=_authkey())
        self.address = self._listener.address
        self._conns: Dict[int, Any] = {}

    def wait_for_agents(self, timeout: float = 60.0) -> None:
        deadline = time.monotonic() + timeout
        while len(self._conns) < self.num_processes - 1:
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"only {len(self._conns)}/{self.num_processes - 1} host agents connected")
            conn = self._listener.accept()  # blocks; the launcher enforces the timeout
            pid = conn.recv()  # handshake: the agent sends its process id
            self._conns[int(pid)] = conn

    def run(self, fn: Callable[[], Any]) -> List[Any]:
        """Execute ``fn`` on every host (this one included); returns results
        ordered by process id."""
        import cloudpickle

        payload = cloudpickle.dumps(fn)
        for conn in self._conns.values():
            conn.send(("run", payload))
        local = _call_guarded(fn)
        results: Dict[int, Any] = {0: local}
        for pid, conn in self._conns.items():
            results[pid] = conn.recv()
        out = []
        for pid in range(self.num_processes):
            status, value = results[pid]
            if status == "err":
                raise RuntimeError(f"host {pid} failed:\n{value}")
            out.append(value)
        return out

    def barrier(self) -> None:
        self.run(lambda: None)

    def shutdown(self) -> None:
        for conn in self._conns.values():
            try:
                conn.send(("exit", None))
                conn.close()
            except OSError:
                pass
        self._listener.close()


def _call_guarded(fn):
    try:
        return ("ok", fn())
    except Exception:  # noqa: BLE001 - control-plane boundary: host 0 raises it
        return ("err", traceback.format_exc())


def agent_loop(control_address, process_id: int) -> None:
    """Non-zero hosts: connect to host 0 and execute broadcast programs in
    lockstep until told to exit."""
    import cloudpickle

    conn = mpc.Client(tuple(control_address) if isinstance(control_address, list)
                      else control_address, authkey=_authkey())
    conn.send(process_id)
    while True:
        kind, payload = conn.recv()
        if kind == "exit":
            return
        fn = cloudpickle.loads(payload)
        result = _call_guarded(fn)
        try:
            conn.send(result)
        except (TypeError, AttributeError, pickle.PicklingError):
            # a result that does not pickle fails the run, not the agent
            conn.send(("err", traceback.format_exc()))


# --------------------------------------------------------------------------
# cross-host object plane
# --------------------------------------------------------------------------


class ObjectPlane:
    """Cross-host object fetch (the JAX package's): each host serves its
    local ObjectStore on a socket and advertises the endpoint in the GCS KV
    (``objplane/<node_id>``); ``fetch`` resolves an object's holders
    through the GCS object directory, pulls the serialized value from one
    of them, and caches it in the local store."""

    def __init__(self, store, node_id: str, gcs_address: str):
        from tpu_air_torch.control import GcsClient

        self.store = store
        self.node_id = node_id
        self.gcs = GcsClient(gcs_address)
        # advertise an address other hosts can reach: the interface that
        # routes toward the GCS (loopback only when the GCS is loopback)
        bind_host = _routable_host(gcs_address)
        self._listener = mpc.Listener((bind_host, 0), authkey=_authkey())
        host, port = self._listener.address
        self.address = f"{host}:{port}"
        self.gcs.kv_put(f"objplane/{node_id}", self.address.encode())
        self._stop = False
        self._thread = threading.Thread(target=self._serve, daemon=True)
        self._thread.start()

    # -- owner side ---------------------------------------------------------
    def put(self, value, object_id: Optional[str] = None) -> str:
        """Store locally and publish the location to the GCS directory."""
        ref = self.store.put(value, object_id)
        oid = getattr(ref, "id", object_id)
        self.gcs.publish_object(oid, self.node_id)
        return oid

    def _serve(self) -> None:
        from tpu_air_torch.core import serialization

        # airlint: disable=CC001 — GIL-atomic stop flag; close() connects
        # once after setting it, so a blocked accept() returns and sees it
        while not self._stop:
            try:
                conn = self._listener.accept()
            except OSError:
                return
            if self._stop:
                conn.close()
                return

            def handle(c):
                try:
                    while True:
                        object_id = c.recv()
                        if object_id is None:
                            return
                        if self.store.contains(object_id):
                            c.send(serialization.dumps(self.store.get(object_id)))
                        else:
                            c.send(None)
                except (EOFError, OSError):
                    pass
                finally:
                    c.close()

            threading.Thread(target=handle, args=(conn,), daemon=True).start()

    # -- consumer side --------------------------------------------------------
    def fetch(self, object_id: str):
        """Local hit, else pull from a holder named by the GCS directory and
        cache locally."""
        from tpu_air_torch.core import serialization

        if self.store.contains(object_id):
            return self.store.get(object_id)
        loc = self.gcs.locate_object(object_id)
        if loc is None:
            raise KeyError(f"object {object_id} not in the cluster directory")
        last_err: Optional[Exception] = None
        for node_id in loc["node_ids"]:
            if node_id == self.node_id:
                continue
            raw = self.gcs.kv_get(f"objplane/{node_id}")
            if raw is None:
                continue
            host, port = raw.decode().rsplit(":", 1)
            try:
                conn = mpc.Client((host, int(port)), authkey=_authkey())
                conn.send(object_id)
                blob = conn.recv()
                conn.send(None)
                conn.close()
            except (OSError, EOFError) as e:  # holder died: try the next one
                last_err = e
                continue
            if blob is not None:
                value = serialization.loads(blob)
                try:  # cache for later readers on this host; the value is in hand
                    self.store.put(value, object_id)
                    self.gcs.publish_object(object_id, self.node_id)
                except (OSError, RuntimeError):
                    pass
                return value
        raise KeyError(f"object {object_id} unreachable from {loc['node_ids']}: {last_err}")

    def close(self) -> None:
        """Stop serving: later fetches from other hosts find no one here.
        Closing a listener does not wake a thread blocked in its accept()
        (which would go on accepting), so close connects once first."""
        self._stop = True
        try:
            mpc.Client(self._listener.address, authkey=_authkey()).close()
        except OSError:
            pass
        self._thread.join(timeout=10)
        try:
            self._listener.close()
        except OSError:
            pass
        self.gcs.close()


# --------------------------------------------------------------------------
# local multi-process emulation (tests, one machine)
# --------------------------------------------------------------------------

_AGENT_MAIN = """\
import os, sys
from tpu_air_torch.parallel import distributed as D
pid = int(os.environ["TPU_AIR_PROCESS_ID"])
gcs = os.environ.get("TPU_AIR_GCS")
if gcs:
    # register with the C++ control plane + heartbeat (failure detection)
    try:
        from tpu_air_torch.control import GcsClient, HeartbeatThread
        ctrl = os.environ.get("TPU_AIR_CONTROL", "")
        GcsClient(gcs).register_node(f"host-{pid}", address=ctrl)
        HeartbeatThread(gcs, f"host-{pid}", interval=0.5, node_address=ctrl).start()
    except Exception as e:
        print(f"agent {pid}: gcs registration failed: {e}", file=sys.stderr)
D.ensure_initialized()
host, port = os.environ["TPU_AIR_CONTROL"].rsplit(":", 1)
D.agent_loop((host, int(port)), pid)
"""

# what spawn_local_cluster sets in host 0's environment (put back at shutdown)
_CLUSTER_ENV = ("TPU_AIR_COORDINATOR", "TPU_AIR_NUM_PROCESSES", "TPU_AIR_PROCESS_ID",
                "TPU_AIR_CONTROL", "TPU_AIR_NUM_CHIPS", "TPU_AIR_CHIPS_PER_HOST",
                "TPU_AIR_GCS", "TPU_AIR_AUTHKEY")


def _restore_env(saved: Dict[str, Optional[str]]) -> None:
    for k, v in saved.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _bind_coordinator(num_processes: int, timeout: datetime.timedelta, tries: int = 20):
    """Host 0's rendezvous store on a free loopback port, bound before any
    agent is told the port.  ``_free_port`` only names a port that was free:
    another process (an xdist worker) may bind it first, so a bind that
    finds it in use picks another."""
    for attempt in range(tries):
        port = _free_port()
        try:
            return port, _bind_store("127.0.0.1", port, num_processes, timeout)
        except RuntimeError as e:   # torch's DistNetworkError subclasses it
            if "in use" not in str(e).lower() or attempt == tries - 1:
                raise
    raise AssertionError("unreachable")


class LocalCluster:
    """N-process virtual cluster on one machine: process 0 is the caller
    (the driver script); the other hosts are agent subprocesses.
    ``gcs_missing`` says why the GCS daemon, and with it ``nodes()`` and
    the object plane, does not run (None when it does)."""

    def __init__(self, server: HostAgentServer, procs: List[subprocess.Popen],
                 gcs_proc: Optional[subprocess.Popen] = None,
                 gcs_address: Optional[str] = None,
                 heartbeat: Optional[Any] = None,
                 devices_per_process: int = 0,
                 gcs_missing: Optional[str] = None,
                 saved_env: Optional[Dict[str, Optional[str]]] = None):
        self.server = server
        self.procs = procs
        self.gcs_proc = gcs_proc
        self.gcs_address = gcs_address
        self.num_processes = server.num_processes
        self.devices_per_process = devices_per_process
        self.gcs_missing = gcs_missing
        self._heartbeat = heartbeat
        self._gcs_client = None
        self._saved_env = saved_env or {}

    def run(self, fn):
        return self.server.run(fn)

    def nodes(self) -> list:
        """Cluster membership from the C++ control plane (alive = heartbeat
        fresh).  Without the daemon it prints why and returns []."""
        if self.gcs_address is None:
            print(f"cluster: no gcs ({self.gcs_missing})", file=sys.stderr)
            return []
        try:
            if self._gcs_client is None:
                from tpu_air_torch.control import GcsClient

                self._gcs_client = GcsClient(self.gcs_address)
            return self._gcs_client.list_nodes()
        except (ConnectionError, OSError, RuntimeError):
            self._gcs_client = None
            return []

    def shutdown(self):
        if active_cluster() is self:
            set_active_cluster(None)
        self.server.shutdown()
        for p in self.procs:
            try:
                p.wait(timeout=10)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        if self._heartbeat is not None:
            self._heartbeat.stop()
        if self._gcs_client is not None:
            self._gcs_client.close()
        if self.gcs_proc is not None:
            self.gcs_proc.kill()
            self.gcs_proc.wait()
        _leave()
        # a later init() in this process must not join the dead cluster
        _restore_env(self._saved_env)


def spawn_local_cluster(
    num_processes: int, devices_per_process: int = 4, timeout: float = 120.0
) -> LocalCluster:
    """Start a local multi-host emulation: this process becomes host 0 of a
    ``num_processes``-process cluster of ``devices_per_process`` chip slots
    each; the other hosts run :func:`agent_loop` in subprocesses started
    with ``subprocess.Popen`` (a fresh interpreter, so no host inherits a
    CUDA context).  Every host's slots map onto this machine's devices (on
    one card, all of them on ``cuda:0``)."""
    if _RENDEZVOUS is not None:
        raise RuntimeError("this process already joined a multi-host cluster")
    saved_env = {k: os.environ.get(k) for k in _CLUSTER_ENV}
    rdv_timeout = datetime.timedelta(seconds=timeout)

    # C++ control plane: membership + heartbeats for the virtual hosts.
    # Without a protobuf toolchain the cluster runs without it and says why.
    from tpu_air_torch import _native

    gcs_proc, gcs_address = None, None
    gcs_missing = _native.gcs_missing()
    if gcs_missing is None:
        try:
            from tpu_air_torch.control import start_gcs

            gcs_proc, gcs_port = start_gcs(dead_after_ms=3000)
            gcs_address = f"127.0.0.1:{gcs_port}"
        except (RuntimeError, OSError) as e:
            gcs_missing = f"the daemon did not start: {e}"
    if gcs_missing is not None:
        print(f"spawn_local_cluster: no gcs ({gcs_missing})", file=sys.stderr)

    # per-cluster random control-plane key (see _authkey): in our env BEFORE
    # HostAgentServer binds its listener, so driver and agents agree
    os.environ.setdefault("TPU_AIR_AUTHKEY", secrets.token_hex(16))
    server = HostAgentServer(num_processes)
    host, port = server.address
    coord_port, store = _bind_coordinator(num_processes, rdv_timeout)
    coordinator = f"127.0.0.1:{coord_port}"

    env_base = dict(os.environ)
    env_base.pop("TPU_AIR_CHIP_IDS", None)
    env_base.update(
        TPU_AIR_COORDINATOR=coordinator,
        TPU_AIR_NUM_PROCESSES=str(num_processes),
        TPU_AIR_CONTROL=f"{host}:{port}",
        TPU_AIR_RENDEZVOUS_TIMEOUT_S=str(timeout),
        # the global chip pool: every slot a "chip", host boundaries at
        # devices_per_process (lease shapes); a later init() reads these
        TPU_AIR_NUM_CHIPS=str(num_processes * devices_per_process),
        TPU_AIR_CHIPS_PER_HOST=str(devices_per_process),
    )
    if gcs_address:
        env_base["TPU_AIR_GCS"] = gcs_address
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    procs = []
    for pid in range(1, num_processes):
        env = dict(env_base)
        env["TPU_AIR_PROCESS_ID"] = str(pid)
        procs.append(subprocess.Popen([sys.executable, "-c", _AGENT_MAIN], env=env, cwd=root))

    # become host 0
    for k in ("TPU_AIR_COORDINATOR", "TPU_AIR_NUM_PROCESSES", "TPU_AIR_CONTROL",
              "TPU_AIR_NUM_CHIPS", "TPU_AIR_CHIPS_PER_HOST"):
        os.environ[k] = env_base[k]
    os.environ["TPU_AIR_PROCESS_ID"] = "0"
    heartbeat = None

    def fail(why: str, cause: Optional[BaseException] = None):
        server._listener.close()  # unblocks the accept() so the thread exits
        for p in procs:
            p.kill()
            p.wait()
        if gcs_proc is not None:
            gcs_proc.kill()
            gcs_proc.wait()
        if heartbeat is not None:
            heartbeat.stop()
        _leave()
        _restore_env(saved_env)
        raise TimeoutError(why) from cause

    if gcs_address:
        from tpu_air_torch.control import GcsClient, HeartbeatThread

        os.environ["TPU_AIR_GCS"] = gcs_address
        client = GcsClient(gcs_address)
        client.register_node("host-0", address=f"{host}:{port}")
        client.close()
        heartbeat = HeartbeatThread(gcs_address, "host-0", interval=0.5,
                                    node_address=f"{host}:{port}")
        heartbeat.start()
    t = threading.Thread(target=server.wait_for_agents, kwargs={"timeout": timeout},
                         daemon=True)
    t.start()
    try:
        _rendezvous(coordinator, num_processes, 0, store=store, timeout=rdv_timeout)
    except RuntimeError as e:
        fail(f"host agents failed to join the rendezvous: {e}", e)
    t.join(timeout)
    if t.is_alive() or len(server._conns) < num_processes - 1:
        fail("host agents failed to connect")
    cluster = LocalCluster(server, procs, gcs_proc, gcs_address, heartbeat,
                           devices_per_process=devices_per_process,
                           gcs_missing=gcs_missing, saved_env=saved_env)
    set_active_cluster(cluster)
    return cluster
