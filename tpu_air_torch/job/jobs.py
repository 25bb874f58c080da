"""Job runner: spec parsing, submission, status/log retrieval, copied from
``tpu_air/job/jobs.py`` (it imports neither JAX nor torch; the port keeps
its own copy so that its W5 job is submitted through the port).

Jobs run as detached subprocesses; state lives under
``$TPU_AIR_JOB_ROOT`` (default ``~/.tpu_air/jobs``)/<job_id>/:
  job.json    spec + pid + status (queued/running/succeeded/failed)
  driver.log  combined stdout/stderr of the entrypoint
"""

from __future__ import annotations

import json
import os
import shlex
import subprocess
import time
from dataclasses import asdict, dataclass, field
from typing import Any, Dict, List, Optional


def _job_root() -> str:
    root = os.environ.get(
        "TPU_AIR_JOB_ROOT", os.path.join(os.path.expanduser("~"), ".tpu_air", "jobs")
    )
    os.makedirs(root, exist_ok=True)
    return root


@dataclass
class JobSpec:
    """The YAML schema of the reference job file
    (flan-t5-batch-inference-job-setup.yml:1-7)."""

    name: str
    entrypoint: str
    compute_config: Any = None  # topology name or {num_cpus, num_chips}
    cluster_env: Optional[str] = None  # recorded; env building is out of scope
    working_dir: Optional[str] = None
    env: Dict[str, str] = field(default_factory=dict)

    @classmethod
    def from_yaml(cls, path: str) -> "JobSpec":
        import yaml

        with open(path) as f:
            raw = yaml.safe_load(f)
        known = {k: raw[k] for k in
                 ("name", "entrypoint", "compute_config", "cluster_env",
                  "working_dir", "env") if k in raw}
        if "name" not in known or "entrypoint" not in known:
            raise ValueError(f"job spec {path} must define 'name' and 'entrypoint'")
        return cls(**known)


def _job_dir(job_id: str) -> str:
    return os.path.join(_job_root(), job_id)


def _read_state(job_id: str) -> Dict[str, Any]:
    with open(os.path.join(_job_dir(job_id), "job.json")) as f:
        return json.load(f)


def _write_state(job_id: str, state: Dict[str, Any]) -> None:
    path = os.path.join(_job_dir(job_id), "job.json")
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(state, f, indent=2, default=str)
        f.flush()
        os.fsync(f.fileno())  # found by airlint CS002: the replace below is
        # atomic, but without fsync a power loss could keep the rename and
        # lose the bytes — `air job status` would read a torn job.json
    os.replace(tmp, path)


def _resolve_env(spec: JobSpec) -> Dict[str, str]:
    env = dict(os.environ)
    # the minimal cluster_env: the framework itself must be importable in the
    # job process even when running from a source checkout (the reference's
    # cluster_env ships the full dependency image; here we ship the path)
    pkg_parent = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    parts = [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p]
    if pkg_parent not in parts:
        env["PYTHONPATH"] = os.pathsep.join([pkg_parent] + parts)
    cc = spec.compute_config
    if isinstance(cc, dict):
        if "num_chips" in cc:
            env["TPU_AIR_NUM_CHIPS"] = str(cc["num_chips"])
        if "num_cpus" in cc:
            env["TPU_AIR_NUM_CPUS"] = str(cc["num_cpus"])
    env.update({k: str(v) for k, v in (spec.env or {}).items()})
    return env


def submit(spec_or_path, wait_for_completion: bool = False) -> str:
    """Start a job; returns its job_id.  The entrypoint runs detached with
    output teed to driver.log (the `anyscale job submit` analog)."""
    spec = (
        spec_or_path
        if isinstance(spec_or_path, JobSpec)
        else JobSpec.from_yaml(spec_or_path)
    )
    job_id = f"{spec.name}-{int(time.time())}-{os.urandom(3).hex()}"
    jdir = _job_dir(job_id)
    os.makedirs(jdir, exist_ok=True)
    log_path = os.path.join(jdir, "driver.log")

    state = {
        "job_id": job_id,
        "spec": asdict(spec),
        "status": "queued",
        "submitted_at": time.time(),
    }
    _write_state(job_id, state)

    log_f = open(log_path, "wb")  # airlint: disable=CS001 — driver.log is an append-only stream tailed by `air job logs`; readers tolerate a torn tail and there is no atomic-publish contract to seal
    env = _resolve_env(spec)
    env["TPU_AIR_JOB_ID"] = job_id
    proc = subprocess.Popen(
        spec.entrypoint if isinstance(spec.entrypoint, list)
        else shlex.split(spec.entrypoint),
        cwd=spec.working_dir or os.getcwd(),
        env=env,
        stdout=log_f,
        stderr=subprocess.STDOUT,
        start_new_session=True,  # detach: job survives the submitter
    )
    log_f.close()
    state.update(
        status="running",
        pid=proc.pid,
        pid_starttime=_proc_starttime(proc.pid),
        started_at=time.time(),
    )
    _write_state(job_id, state)

    # a tiny watcher keeps job.json's terminal status fresh without the
    # submitter having to stay alive (double-fork-free: daemon thread when
    # waiting, else the status poll in get_status reaps)
    if wait_for_completion:
        rc = proc.wait()
        state.update(
            status="succeeded" if rc == 0 else "failed",
            returncode=rc,
            finished_at=time.time(),
        )
        _write_state(job_id, state)
    return job_id


def _proc_starttime(pid: int) -> Optional[str]:
    """Field 22 (starttime) of /proc/<pid>/stat — a (pid, starttime) pair
    uniquely identifies a process across pid recycling.  Parsed after the
    last ')' so comm values containing spaces/parens can't skew fields."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            tail = f.read().rsplit(")", 1)[1].split()
        return tail[19]  # state is tail[0]; starttime is field 22 overall
    except (OSError, IndexError):
        return None


def _proc_state(pid: int) -> Optional[str]:
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0]
    except (OSError, IndexError):
        return None


def _refresh(state: Dict[str, Any]) -> Dict[str, Any]:
    """Poll liveness of a 'running' job by (pid, starttime) — detached, so no
    waitpid; the starttime marker guards against recycled pids."""
    if state.get("status") != "running":
        return state
    pid = state.get("pid")
    alive = False
    if pid:
        st = _proc_state(pid)
        same_proc = (
            state.get("pid_starttime") is None
            or _proc_starttime(pid) == state.get("pid_starttime")
        )
        alive = st is not None and st not in ("Z", "X") and same_proc
    if not alive:
        # terminal, but the return code is unknown (detached); infer from the
        # log tail — convention: entrypoints print nothing special; mark
        # finished with unknown rc
        state.update(status="finished", finished_at=state.get("finished_at", time.time()))
        _write_state(state["job_id"], state)
    return state


def get_status(job_id: str) -> Dict[str, Any]:
    return _refresh(_read_state(job_id))


def wait(job_id: str, timeout: Optional[float] = None, poll: float = 0.5) -> Dict[str, Any]:
    deadline = None if timeout is None else time.monotonic() + timeout
    while True:
        st = get_status(job_id)
        if st["status"] not in ("queued", "running"):
            return st
        if deadline is not None and time.monotonic() >= deadline:
            raise TimeoutError(f"job {job_id} still {st['status']} after {timeout}s")
        time.sleep(poll)


def logs(job_id: str) -> str:
    with open(os.path.join(_job_dir(job_id), "driver.log"), "rb") as f:
        return f.read().decode(errors="replace")


def list_jobs() -> List[Dict[str, Any]]:
    out = []
    root = _job_root()
    for name in sorted(os.listdir(root)):
        try:
            out.append(_refresh(_read_state(name)))
        except (FileNotFoundError, json.JSONDecodeError):
            continue
    return out
