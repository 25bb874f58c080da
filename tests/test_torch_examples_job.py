"""The port's W1 -> W3 example through the jobs CLI: the job twin
``examples/torch_flan_t5_job.yml`` submitted as tests/test_examples_job.py
submits the JAX package's, at the example's CPU smoke dials, through the JAX
package's runner and through the port's own (``python -m
tpu_air_torch.job``); and the port's W8 example,
``examples/torch_xgboost_e2e.py``, on a serve port of its own; and the
port's W2 example, ``examples/torch_tune_hpo_t5.py``."""

import json
import os
import subprocess
import sys

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


def test_torch_flan_t5_job_through_the_ports_cli(tmp_path):
    """W5 as the yml says to run it: ``python -m tpu_air_torch.job submit
    examples/torch_flan_t5_job.yml --wait``, then ``status`` and ``logs``
    through the same CLI, which imports nothing of the JAX package."""
    env = {**os.environ, "TPU_AIR_JOB_ROOT": str(tmp_path), "PYTHONPATH": REPO}

    def cli(*args):
        return subprocess.run([sys.executable, "-m", "tpu_air_torch.job", *args], cwd=REPO,
                              capture_output=True, text=True, timeout=600, env=env)

    sub = cli("submit", "examples/torch_flan_t5_job.yml", "--wait")
    assert sub.returncode == 0, sub.stdout[-2000:] + sub.stderr[-2000:]
    st = json.loads(sub.stdout)
    assert st["status"] == "succeeded" and st["spec"]["name"] == "torch-flan-t5-batch-inference"
    again = cli("status", st["job_id"])
    assert again.returncode == 0 and json.loads(again.stdout)["status"] == "succeeded"
    log = cli("logs", st["job_id"]).stdout
    assert "generated 19 outputs" in log
    listed = cli("list")
    assert [j["job_id"] for j in json.loads(listed.stdout)] == [st["job_id"]]


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


def test_torch_tune_hpo_example():
    """W2 on the port, the twin of tests/test_examples_job.py's
    ``test_tune_hpo_example``: ``examples/torch_tune_hpo_t5.py`` with 2
    trials on the CPU (one lease slot, the trials in turn)."""
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "examples", "torch_tune_hpo_t5.py"), "--trials", "2",
         "--device", "cpu"], cwd=REPO, capture_output=True, text=True, timeout=600,
        env={**os.environ, "PYTHONPATH": REPO})
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "best eval_loss" in proc.stdout and "errors: 0" in proc.stdout


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
