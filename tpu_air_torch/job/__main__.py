"""CLI: python -m tpu_air_torch.job {submit,status,logs,list,wait} ..."""

from __future__ import annotations

import argparse
import json
import sys

from . import jobs


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="tpu_air_torch.job")
    sub = p.add_subparsers(dest="cmd", required=True)

    s = sub.add_parser("submit", help="submit a job from a YAML spec")
    s.add_argument("spec")
    s.add_argument("--wait", action="store_true")

    for name in ("status", "logs", "wait"):
        sp = sub.add_parser(name)
        sp.add_argument("job_id")

    sub.add_parser("list")

    args = p.parse_args(argv)
    if args.cmd == "submit":
        job_id = jobs.submit(args.spec, wait_for_completion=args.wait)
        st = jobs.get_status(job_id)
        print(json.dumps(st, indent=2, default=str))
        return 0 if st["status"] in ("queued", "running", "succeeded") else 1
    if args.cmd == "status":
        print(json.dumps(jobs.get_status(args.job_id), indent=2, default=str))
        return 0
    if args.cmd == "logs":
        sys.stdout.write(jobs.logs(args.job_id))
        return 0
    if args.cmd == "wait":
        st = jobs.wait(args.job_id)
        print(json.dumps(st, indent=2, default=str))
        return 0 if st["status"] in ("succeeded", "finished") else 1
    if args.cmd == "list":
        print(json.dumps(jobs.list_jobs(), indent=2, default=str))
        return 0
    return 2


if __name__ == "__main__":
    raise SystemExit(main())
