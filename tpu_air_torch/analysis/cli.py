"""airlint CLI.

Exit codes: 0 clean, 1 unsuppressed findings, 2 usage error.  ``--format
json`` (alias ``--json``) emits schema v2 documented in docs/ANALYSIS.md
(stable: version bumps on breaking change); ``--format sarif`` emits SARIF
2.1.0 for CI annotation.  ``--changed`` lints only the files changed vs
``git merge-base HEAD main`` plus their call-graph dependents — the whole
tree still feeds call resolution, so interprocedural findings stay exact.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import textwrap
from typing import List, Optional, Set

from . import analyze_paths, all_rules
from .findings import Severity

JSON_SCHEMA_VERSION = 2
SARIF_VERSION = "2.1.0"
_SARIF_SCHEMA = ("https://raw.githubusercontent.com/oasis-tcs/sarif-spec/"
                 "master/Schemata/sarif-schema-2.1.0.json")


def _build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="airlint",
        description="AST-based PyTorch/CUDA + actor-runtime hazard analyzer",
    )
    p.add_argument("paths", nargs="*", default=["tpu_air_torch"],
                   help="files or directories to analyze (default: "
                        "tpu_air_torch)")
    p.add_argument("--format", choices=("human", "json", "sarif"),
                   default="human", dest="fmt",
                   help="output format (default: human)")
    p.add_argument("--json", action="store_const", const="json", dest="fmt",
                   help="shorthand for --format json")
    p.add_argument("--changed", action="store_true",
                   help="lint only files changed vs the merge-base with "
                        "main (plus their call-graph dependents)")
    p.add_argument("--changed-base", default=None, metavar="REF",
                   help="diff base for --changed (default: "
                        "`git merge-base HEAD main`)")
    p.add_argument("--rules", default=None, metavar="ID[,ID...]",
                   help="run only these rule ids; a bare family prefix "
                        "selects the whole family (e.g. --rules CS,FI)")
    p.add_argument("--explain", default=None, metavar="RULE",
                   help="print one rule's doc + a minimal fires example "
                        "and exit")
    p.add_argument("--baseline", default=None, metavar="FILE",
                   help="suppress findings recorded in FILE — only *new* "
                        "findings fail the run (see --baseline-write)")
    p.add_argument("--baseline-write", action="store_true",
                   help="write the current findings to the --baseline file "
                        "(default: airlint_baseline.json) and exit 0")
    p.add_argument("--list-rules", action="store_true",
                   help="print the rule catalog and exit")
    p.add_argument("--show-suppressed", action="store_true",
                   help="also print findings silenced by suppressions")
    return p


def _list_rules() -> None:
    for r in sorted(all_rules(), key=lambda r: r.id):
        print(f"{r.id}  {r.severity:<7}  {r.name}")
        print(f"       {r.rationale}")


def _expand_rule_families(tokens: List[str]) -> List[str]:
    """``--rules CS,FI`` selects every registered rule whose id starts
    with the token; exact ids (and unknown tokens, which select_rules
    rejects with rc 2) pass through unchanged."""
    ids = sorted(r.id for r in all_rules())
    out = []
    for tok in tokens:
        tok = tok.strip()
        if not tok:
            continue
        family = [i for i in ids if i.startswith(tok)]
        if tok not in ids and family:
            out.extend(family)
        else:
            out.append(tok)
    return out


def _explain(rule_id: str) -> int:
    from .registry import JAX_ONLY_RULES, get_rule, known_rule_ids

    if rule_id in JAX_ONLY_RULES:
        print(f"{rule_id} — the JAX package's analyzer only: "
              f"{JAX_ONLY_RULES[rule_id]}")
        return 0
    if rule_id not in known_rule_ids():
        print(f"airlint: unknown rule id {rule_id!r} "
              "(see --list-rules)", file=sys.stderr)
        return 2
    r = get_rule(rule_id)
    print(f"{r.id} — {r.name} ({r.severity})")
    print(f"\n{r.rationale}")
    doc = getattr(r.check, "__doc__", None) if r.check else None
    if doc:
        import inspect

        print(f"\n{inspect.cleandoc(doc)}")
    if r.example:
        print("\nMinimal example that fires:\n")
        print(textwrap.indent(textwrap.dedent(r.example).strip(), "    "))
    else:
        print("\nExamples: docs/ANALYSIS.md rule catalog.")
    return 0


def _git(args: List[str]) -> Optional[str]:
    try:
        out = subprocess.run(["git"] + args, capture_output=True,
                             text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout if out.returncode == 0 else None


def changed_files(base: Optional[str] = None) -> Optional[Set[str]]:
    """Python files changed vs ``base`` (default: merge-base with main),
    plus untracked ones.  None when git is unusable here.

    Deletions are dropped and renames are followed to their new name —
    ``--changed`` must never hand the analyzer a path that no longer
    exists (it would surface as a spurious AL000 parse error)."""
    if base is None:
        mb = _git(["merge-base", "HEAD", "main"])
        base = mb.strip() if mb else "HEAD"
    diff = _git(["diff", "--name-status", "-M", base])
    if diff is None:
        return None
    paths = []
    for line in diff.splitlines():
        parts = line.split("\t")
        if len(parts) < 2:
            continue
        status = parts[0]
        if status.startswith("D"):
            continue  # deleted: nothing to analyze
        # renames/copies are "Rnnn\told\tnew" — the new name is last
        paths.append(parts[-1])
    untracked = _git(["ls-files", "--others", "--exclude-standard"]) or ""
    paths.extend(untracked.splitlines())
    return {os.path.normpath(p) for p in paths
            if p.endswith(".py") and os.path.isfile(p)}


BASELINE_VERSION = 1
DEFAULT_BASELINE = "airlint_baseline.json"


def _fingerprint(f) -> tuple:
    """Line-number independent identity: a baseline must survive edits
    above the finding, so only (rule, file, message) participate."""
    return (f.rule, os.path.normpath(f.path).replace(os.sep, "/"), f.message)


def _write_baseline(path: str, reports) -> None:
    entries = sorted({_fingerprint(f) for rep in reports for f in rep.active})
    with open(path, "w", encoding="utf-8") as fh:
        json.dump({
            "version": BASELINE_VERSION,
            "findings": [{"rule": r, "path": p, "message": m}
                         for r, p, m in entries],
        }, fh, indent=2)
        fh.write("\n")
    print(f"airlint: wrote {len(entries)} finding(s) to {path}",
          file=sys.stderr)


def _apply_baseline(path: str, reports) -> Optional[int]:
    """Mark baselined findings suppressed; count them.  None = bad file."""
    try:
        with open(path, "r", encoding="utf-8") as fh:
            data = json.load(fh)
        known = {(e["rule"], e["path"], e["message"])
                 for e in data["findings"]}
    except (OSError, ValueError, KeyError, TypeError) as e:
        print(f"airlint: cannot read baseline {path}: {e}", file=sys.stderr)
        return None
    n = 0
    for rep in reports:
        for f in rep.active:
            if _fingerprint(f) in known:
                f.suppressed = True
                f.suppress_reason = f"baseline ({path})"
                n += 1
    return n


def _human(reports, show_suppressed: bool) -> None:
    for rep in reports:
        shown = rep.findings if show_suppressed else rep.active
        for f in shown:
            mark = " [suppressed]" if f.suppressed else ""
            print(f"{f.location()}: {f.rule} {f.severity}: {f.message}{mark}")


def _json_out(reports) -> None:
    active = [f for rep in reports for f in rep.active]
    suppressed = [f for rep in reports for f in rep.suppressed]
    print(json.dumps({
        "version": JSON_SCHEMA_VERSION,
        "files_analyzed": len(reports),
        "findings": [f.to_dict() for f in active],
        "suppressed": [f.to_dict() for f in suppressed],
    }, indent=2))


def _sarif_out(reports) -> None:
    from .registry import META_RULES, get_rule

    ids = sorted({f.rule for rep in reports for f in rep.active})
    rules = []
    for rid in ids:
        r = get_rule(rid) if rid not in META_RULES else META_RULES[rid]
        rules.append({
            "id": r.id,
            "name": r.name,
            "shortDescription": {"text": r.name},
            "fullDescription": {"text": r.rationale},
            "defaultConfiguration": {
                "level": "error" if r.severity == Severity.ERROR
                else "warning"},
        })
    results = []
    for rep in reports:
        for f in rep.active:
            result = {
                "ruleId": f.rule,
                "level": "error" if f.severity == Severity.ERROR
                else "warning",
                "message": {"text": f.message},
                "locations": [{
                    "physicalLocation": {
                        "artifactLocation": {
                            "uri": f.path.replace(os.sep, "/")},
                        "region": {"startLine": f.line,
                                   "startColumn": max(f.col, 0) + 1},
                    }
                }],
            }
            if f.dataflow:
                result["properties"] = {"dataflow": f.dataflow}
            results.append(result)
    print(json.dumps({
        "$schema": _SARIF_SCHEMA,
        "version": SARIF_VERSION,
        "runs": [{
            "tool": {"driver": {
                "name": "airlint",
                "informationUri": "docs/ANALYSIS.md",
                "rules": rules,
            }},
            "results": results,
        }],
    }, indent=2))


def main(argv: Optional[List[str]] = None) -> int:
    args = _build_parser().parse_args(argv)
    if args.list_rules:
        _list_rules()
        return 0
    if args.explain:
        return _explain(args.explain)
    only = _expand_rule_families(args.rules.split(",")) if args.rules \
        else None
    changed = None
    if args.changed:
        changed = changed_files(args.changed_base)
        if changed is None:
            print("airlint: --changed needs a git checkout "
                  "(git diff failed); analyzing everything",
                  file=sys.stderr)
    try:
        reports = analyze_paths(args.paths, only=only, changed=changed)
    except KeyError as e:
        print(f"airlint: {e.args[0]}", file=sys.stderr)
        return 2
    except OSError as e:
        print(f"airlint: {e}", file=sys.stderr)
        return 2
    baseline_path = args.baseline or DEFAULT_BASELINE
    if args.baseline_write:
        _write_baseline(baseline_path, reports)
        return 0
    if args.baseline is not None:
        if _apply_baseline(args.baseline, reports) is None:
            return 2
    if args.fmt == "json":
        _json_out(reports)
    elif args.fmt == "sarif":
        _sarif_out(reports)
    else:
        _human(reports, args.show_suppressed)
    active = [f for rep in reports for f in rep.active]
    n_sup = sum(len(rep.suppressed) for rep in reports)
    if args.fmt == "human":
        errors = sum(f.severity == Severity.ERROR for f in active)
        warnings = len(active) - errors
        print(f"airlint: {len(reports)} file(s), {errors} error(s), "
              f"{warnings} warning(s), {n_sup} suppressed")
    return 1 if active else 0


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
