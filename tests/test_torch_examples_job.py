"""The port's W1 -> W3 example through the jobs CLI: the job twin
``examples/torch_flan_t5_job.yml`` submitted as tests/test_examples_job.py
submits the JAX package's, at the example's CPU smoke dials; and the port's
W8 example, ``examples/torch_xgboost_e2e.py``, on a serve port of its own."""

import os

import pytest

from tpu_air.job import jobs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = 8353


def test_torch_flan_t5_job_submit_end_to_end(tmp_path, monkeypatch):
    monkeypatch.setenv("TPU_AIR_JOB_ROOT", str(tmp_path))
    spec = jobs.JobSpec.from_yaml(os.path.join(REPO, "examples", "torch_flan_t5_job.yml"))
    assert spec.name == "torch-flan-t5-batch-inference"
    assert spec.entrypoint.endswith("--smoke --device cpu")
    spec.working_dir = REPO
    job_id = jobs.submit(spec, wait_for_completion=True)
    st = jobs.get_status(job_id)
    log = jobs.logs(job_id)
    assert st["status"] == "succeeded", f"job failed:\n{log[-3000:]}"
    # the joined inputs and outputs of the 19-row eval split
    assert "instruction generated_output" in " ".join(log.split())
    assert "generated 19 outputs" in log


def test_example_without_a_card_refuses_unless_device_cpu():
    """Without CUDA and without --device cpu the example stops at
    tpu_air_torch.init(), before any work, instead of running on the CPU."""
    import subprocess
    import sys

    import torch

    if torch.cuda.is_available():
        return
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "examples", "torch_flan_t5_batch_inference.py"),
         "--smoke"], cwd=REPO, capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": REPO})
    assert proc.returncode != 0
    assert "num_chips=" in proc.stderr and "train rows" not in proc.stdout


@pytest.mark.slow
def test_torch_xgboost_e2e_example():
    """W8 on the port: train, tune (3 samples), batch predict, serve and POST."""
    import subprocess
    import sys

    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "examples", "torch_xgboost_e2e.py"),
         "--rows", "400", "--port", str(PORT), "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=400,
        env={**os.environ, "PYTHONPATH": REPO})
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "HTTP prediction: [{'predictions'" in proc.stdout
    assert "batch predictions: 120 rows" in proc.stdout
