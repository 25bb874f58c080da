"""Functions the hosts of a port cluster run, for tests/test_torch_multihost.py
and the CUDA test of tests/test_torch_cuda.py.  Imports torch and the port
only, so the host agents (fresh interpreters) never import JAX; the test
puts this directory on their ``PYTHONPATH`` so that cloudpickle sends these
functions by reference."""

import hashlib
import os
import sys
import time

import numpy as np
import torch

FEAT, ROWS_PER_DEV, LOCAL_DEVS = 16, 4, 4


def psum_rows(host: int) -> np.ndarray:
    """Host ``host``'s rows of the DDP step: one block of ``ROWS_PER_DEV``
    rows a device, each from a seed of its global row offset (as
    ``tests/_multihost_driver.py`` makes them)."""
    blocks = []
    for d in range(LOCAL_DEVS):
        start = (host * LOCAL_DEVS + d) * ROWS_PER_DEV
        blocks.append(np.random.default_rng(1000 + start).normal(
            size=(ROWS_PER_DEV, FEAT)).astype(np.float32))
    return np.concatenate(blocks)


def ddp_psum_step(token: str):
    """One data-parallel step of a linear model over the hosts' group: the
    global mean squared error, its gradient summed over the hosts, one SGD
    update; returns (loss, sum of the updated weights) as this host sees
    them."""
    from tpu_air_torch.parallel import distributed as D

    group = D.HostGroup(list(range(D.process_count())), token, torch.device("cpu"))
    with D.host_scope(group):
        x = torch.from_numpy(psum_rows(D.process_index()))
        y = x[:, :3].sum(1, keepdim=True)
        w = torch.nn.Parameter(torch.full((FEAT, 1), 0.1))
        n = D.all_reduce_sum(torch.tensor(float(len(x))))
        loss = ((x @ w - y) ** 2).sum() / n
        loss.backward()
        D.all_reduce_grads([w])
        total = D.all_reduce_sum(loss.detach().clone())
        with torch.no_grad():
            w2 = w - 0.05 * w.grad
        return float(total), float(w2.sum()), D.world(), group.backend


def foreign_modules():
    """Modules of JAX or of the JAX package this process imported."""
    return sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "flax", "tpu_air"))


def raise_on(host: int):
    from tpu_air_torch.parallel import distributed as D

    if D.process_index() == host:
        raise ValueError(f"boom on host {host}")
    return D.process_index()


def host_ids():
    from tpu_air_torch.parallel import distributed as D

    return D.process_index(), D.process_count()


def set_threads(n: int) -> None:
    torch.set_num_threads(n)


def echo(value):
    return value


def exit_on_agent(agent: int, code: int = 41) -> str:
    """Exit (without cleanup) in the agent whose ``PID`` env is ``agent``."""
    if int(os.environ.get("PID", "0")) == agent:
        os._exit(code)
    return "ok"


# -- the object plane on a host -------------------------------------------------------

_PLANES = {}


def _on(host: int) -> bool:
    from tpu_air_torch.parallel import distributed as D

    return D.process_index() == host


def host_start_plane(host: int, gcs_address: str, root: str) -> None:
    """On ``host``: serve a store of its own as node ``host-<host>``."""
    from tpu_air_torch.core.object_store import ObjectStore
    from tpu_air_torch.parallel.distributed import ObjectPlane

    if _on(host):
        _PLANES[host] = ObjectPlane(ObjectStore(root, create=True), f"host-{host}", gcs_address)


def host_plane_put(host: int, value, object_id: str) -> None:
    if _on(host):
        _PLANES[host].put(value, object_id)


def host_stop_plane(host: int) -> None:
    if _on(host) and host in _PLANES:
        _PLANES.pop(host).close()


# -- training functions ----------------------------------------------------------------


def params_digest(state) -> str:
    """sha256 over a state dict's names and bytes, in name order."""
    h = hashlib.sha256()
    for name in sorted(state):
        h.update(name.encode())
        h.update(state[name].detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def digest_t5_loop(config):
    """``t5_train_loop``, then this host's final logical parameters'
    digest written to ``config["digest_dir"]/host-<process index>``."""
    from tpu_air_torch.parallel import distributed as D
    from tpu_air_torch.parallel import sharding
    from tpu_air_torch.train.t5_trainer import t5_train_loop

    models = []
    shard_module = sharding.shard_module

    def keep(model, *args, **kwargs):
        models.append(model)
        return shard_module(model, *args, **kwargs)

    sharding.shard_module = keep
    try:
        t5_train_loop(config)
    finally:
        sharding.shard_module = shard_module
    digest = params_digest(sharding.gather_state_dict(models[-1]))
    with open(os.path.join(config["digest_dir"], f"host-{D.process_index()}"), "w") as f:
        f.write(digest)


def _checkpoint(i: int):
    """A checkpoint of iteration ``i`` from the session's rank 0 (the one
    that retains it), None elsewhere."""
    from tpu_air_torch.train import Checkpoint, session

    return Checkpoint.from_model(metrics={"i": i}) if session.get_world_rank() == 0 else None


def retry_loop(config):
    """Three reports with a checkpoint each; the first attempt (no resume)
    raises on every host after its first report."""
    from tpu_air_torch.train import Checkpoint, session

    start = 0
    if config.get("resume_from_checkpoint"):
        start = Checkpoint.from_directory(config["resume_from_checkpoint"]).get_metrics()["i"]
    for i in range(start, 3):
        session.report({"i": i + 1, "hosts": session.get_world_size()},
                       checkpoint=_checkpoint(i + 1))
        if i == 0 and not config.get("resume_from_checkpoint"):
            raise RuntimeError("simulated multihost crash")


def elastic_loop(config):
    """Six paced reports with a checkpoint each, resuming from one; every
    report's iteration is appended to ``config["trace_dir"]/host-<index>``
    with the attempt's world, so the test sees where each host stopped."""
    from tpu_air_torch.parallel import distributed as D
    from tpu_air_torch.train import Checkpoint, session

    start = 0
    if config.get("resume_from_checkpoint"):
        start = Checkpoint.from_directory(config["resume_from_checkpoint"]).get_metrics()["i"]
    path = os.path.join(config["trace_dir"], f"host-{D.process_index()}")
    for i in range(start, 6):
        rank, size = D.world()
        session.report({"i": i + 1, "hosts": session.get_world_size(), "world": [rank, size],
                        "loss": 10.0 - i},
                       checkpoint=_checkpoint(i + 1))
        with open(path, "a") as f:
            f.write(f"{i + 1} {size}\n")
        time.sleep(0.3)  # paced so the notice lands between reports
