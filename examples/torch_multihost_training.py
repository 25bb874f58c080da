"""Multi-host training on the PyTorch/CUDA port: one T5 fine-tune whose
lease spans hosts, the twin of ``examples/multihost_training.py`` on
``tpu_air_torch``.

A trainer whose lease is larger than one host runs on every host it spans,
through the cluster's host-agent plane: each host is one controller over
its share of the lease (here a ``(data, model)`` mesh of 2 x 2 slots), and
the hosts sum their data replicas' gradients over a group of one rank a
host (``tpu_air_torch/parallel/distributed.py``).  ``ScalingConfig(
num_workers=4, model_parallel=2)`` on 2 hosts x 4 slots is dp 4 x tp 2.

This example emulates the 2 hosts on one machine (``spawn_local_cluster``:
this process is host 0, host 1 an agent subprocess); every host's slots
map onto this machine's cards (on one card, all of them on ``cuda:0``).
On real hosts the same code runs under the env contract instead
(``TPU_AIR_COORDINATOR``, ``TPU_AIR_NUM_PROCESSES``, ``TPU_AIR_PROCESS_ID``
on every host, an agent on each host but the first).

    python examples/torch_multihost_training.py               # on the card
    python examples/torch_multihost_training.py --device cpu  # on the CPU

It prints the last epoch's metrics as JSON, then MULTIHOST-EXAMPLE-OK.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def set_threads(n: int) -> None:
    import torch

    torch.set_num_threads(n)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default=None,
                        help="'cpu' runs the kernels' plain versions; default: the card")
    args = parser.parse_args()

    from tpu_air_torch.parallel.distributed import spawn_local_cluster

    cluster = spawn_local_cluster(num_processes=2, devices_per_process=4)
    try:
        import functools

        import numpy as np
        import pandas as pd

        import tpu_air_torch
        from tpu_air_torch.models.t5.config import T5Config
        from tpu_air_torch.train import ScalingConfig, T5Trainer, TrainingArguments

        if args.device == "cpu":
            # the hosts share this machine's cores: each takes its share
            share = max(1, (os.cpu_count() or 2) // 2)
            cluster.run(functools.partial(set_threads, share))
        tpu_air_torch.init(num_cpus=1)
        rng = np.random.default_rng(0)
        seq = 16
        rows = pd.DataFrame({
            "input_ids": [rng.integers(2, 250, size=seq) for _ in range(32)],
            "attention_mask": [np.ones(seq, np.int64) for _ in range(32)],
            "labels": [rng.integers(2, 250, size=seq) for _ in range(32)],
        })
        trainer = T5Trainer(
            model_config=T5Config.tiny(),
            training_args=TrainingArguments(learning_rate=1e-4, per_device_train_batch_size=2,
                                            num_train_epochs=1),
            # 8 slots > 4 a host: the multi-host path, both hosts in the step
            scaling_config=ScalingConfig(num_workers=4, model_parallel=2),
            datasets={"train": rows},
            device=args.device,
        )
        result = trainer.fit()
        assert result.error is None, result.error
        m = result.metrics
        assert m["mesh_num_hosts"] == 2, m
        print(json.dumps({k: m[k] for k in ("loss", "mesh_data", "mesh_model", "mesh_num_hosts",
                                            "params_bytes_per_device", "params_bytes_total")}))
        tpu_air_torch.shutdown()
    finally:
        cluster.shutdown()
    print("MULTIHOST-EXAMPLE-OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
