"""tpu_air_torch.job — headless job submission (the Anyscale-job-CLI analog),
the counterpart of ``tpu_air.job``.

The reference packages W5 as a YAML job spec + CLI submit
(flan-t5-batch-inference-job-setup.yml:1-7: name / compute_config /
cluster_env / entrypoint; `anyscale job submit <yaml>`).  The entrypoint runs
headless on the local host; compute_config's ``num_chips``/``num_cpus`` are
passed to it as ``TPU_AIR_NUM_CHIPS``/``TPU_AIR_NUM_CPUS``.

CLI:  python -m tpu_air_torch.job submit <spec.yml> [--wait]
      python -m tpu_air_torch.job status <job_id>
      python -m tpu_air_torch.job logs <job_id>
      python -m tpu_air_torch.job list
"""

from .jobs import JobSpec, get_status, list_jobs, logs, submit, wait

__all__ = ["JobSpec", "get_status", "list_jobs", "logs", "submit", "wait"]
