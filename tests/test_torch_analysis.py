"""The port's airlint (tpu_air_torch.analysis) against the JAX package's.

Pure stdlib on both sides, so this runs on any CPU box.  Six layers:

(a) tree parity — over tpu_air/, examples/ and tools/, the two analyzers
    give identical findings for every rule the port shares;
(b) fixture parity — the shared rules' firing and quiet snippets give
    identical reports through both ``analyze_source`` functions;
(c) package names — a two-module package resolves under ``tpu_air/`` for
    both analyzers and under ``tpu_air_torch/`` for the port's (the JAX
    analyzer's module naming is blind there);
(d) PT004 — JX004's fixtures, translated to PyTorch, fire on the same
    lines, plus the PyTorch-only syncs and the port's own sites;
(e) CLI parity — ``python -m tpu_air_torch.analysis`` and
    ``tools/airlint.py`` print the same JSON and SARIF, with the same exit
    codes, and share the baseline format;
(f) self-application — ``tpu_air_torch/`` is clean with every suppression
    reasoned, and ``tpu_air_torch/analysis/`` has no finding at all.
"""

import ast
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

import tpu_air.analysis as jax_lint
import tpu_air_torch.analysis as torch_lint
from tpu_air_torch.analysis.registry import JAX_ONLY_RULES

REPO = Path(__file__).resolve().parents[1]
SHARED = ["CC001", "CC002", "CC003", "RT001", "RT002", "RT003", "RT005",
          "CS001", "CS002", "CS003", "FI001"]


def _rows(reports):
    return [(f.rule, f.path, f.line, f.col, f.severity, f.message, f.suppressed)
            for rep in reports for f in rep.findings]


def _line_of(path, needle):
    with open(path, encoding="utf-8") as f:
        for i, ln in enumerate(f, start=1):
            if needle in ln:
                return i
    raise AssertionError(f"{path} has no line with {needle!r}")


@pytest.fixture(scope="module")
def port_tree():
    """The port's analyzer over tpu_air_torch/ with every rule it has."""
    return torch_lint.analyze_paths([str(REPO / "tpu_air_torch")])


# ---------------------------------------------------------------------------
# (a) tree parity
# ---------------------------------------------------------------------------


def test_tree_parity_with_the_jax_analyzer(monkeypatch):
    monkeypatch.chdir(REPO)
    paths = ["tpu_air", "examples", "tools"]
    want = _rows(jax_lint.analyze_paths(paths, only=SHARED))
    got = _rows(torch_lint.analyze_paths(paths, only=SHARED))
    assert got == want
    # the run is not vacuous: the JAX tree's reasoned suppressions show up
    assert any(row[-1] for row in want)


def test_shared_rules_are_the_jax_rules_letter_for_letter():
    jax_rules = {r.id: r for r in jax_lint.all_rules()}
    port_rules = {r.id: r for r in torch_lint.all_rules()}
    assert set(SHARED) <= set(port_rules)
    for rid in SHARED:
        j, p = jax_rules[rid], port_rules[rid]
        assert (p.name, p.severity, p.rationale) == (j.name, j.severity, j.rationale)
    for rid, meta in jax_lint.META_RULES.items():
        p = torch_lint.META_RULES[rid]
        assert (p.name, p.severity, p.rationale) == (meta.name, meta.severity, meta.rationale)
    # every rule of either analyzer is the port's, or JAX-only with a reason
    assert set(port_rules) == set(SHARED) | {"PT004"}
    assert set(jax_rules) - set(SHARED) == set(JAX_ONLY_RULES)


def test_readme_maps_every_jax_only_rule():
    with open(REPO / "README.md", encoding="utf-8") as f:
        readme = f.read()
    port = readme[readme.index("python -m tpu_air_torch.analysis"):]
    for rid in JAX_ONLY_RULES:
        assert f"`{rid}`" in port, rid


# ---------------------------------------------------------------------------
# (b) fixture parity (snippets after tests/test_airlint.py)
# ---------------------------------------------------------------------------

FIXTURES = {
    "CC001-fires": """\
        import threading

        class Counter:
            def __init__(self):
                self._n = 0
                self._thread = threading.Thread(target=self._loop)
                self._thread.start()

            def _loop(self):
                self._bump()

            def _bump(self):
                self._n = self._n + 1

            def read(self):
                return self._n
        """,
    "CC001-quiet": """\
        import threading

        class Counter:
            def __init__(self):
                self._n = 0
                self._lock = threading.Lock()
                self._thread = threading.Thread(target=self._loop)
                self._thread.start()

            def _loop(self):
                with self._lock:
                    self._n = self._n + 1

            def read(self):
                with self._lock:
                    return self._n
        """,
    "CC002-fires": """\
        import threading

        class Transfer:
            def __init__(self):
                self._a = threading.Lock()
                self._b = threading.Lock()

            def ab(self):
                with self._a:
                    self._grab_b()

            def _grab_b(self):
                with self._b:
                    pass

            def ba(self):
                with self._b:
                    with self._a:
                        pass
        """,
    "CC002-quiet": """\
        import threading

        class Transfer:
            def __init__(self):
                self._a = threading.Lock()
                self._b = threading.Lock()

            def ab(self):
                with self._a:
                    with self._b:
                        pass

            def ba(self):
                with self._a:
                    with self._b:
                        pass
        """,
    "CC003-fires": """\
        import threading
        import time

        class Pool:
            def __init__(self):
                self._lock = threading.Lock()

            def refresh(self):
                with self._lock:
                    self._rebuild()

            def _rebuild(self):
                time.sleep(1.0)
        """,
    "CC003-quiet": """\
        import threading
        import time

        class Pool:
            def __init__(self):
                self._lock = threading.Lock()

            def refresh(self):
                with self._lock:
                    n = 1
                time.sleep(1.0)
                return n
        """,
    "RT001-fires": """\
        import time
        import tpu_air_torch

        @tpu_air_torch.remote
        class Worker:
            def ping(self):
                time.sleep(1.0)
                return "ok"
        """,
    "RT001-quiet": """\
        import time
        import tpu_air_torch

        @tpu_air_torch.remote
        class Worker:
            def ping(self):
                return "ok"

        def wait_outside():
            time.sleep(1.0)
        """,
    "RT002-fires": """\
        def publish(store, batch):
            ref = store.put(batch)
            batch.append(1)
            return ref
        """,
    "RT002-quiet": """\
        def publish(store, batch):
            ref = store.put(batch)
            batch = list(batch)
            batch.append(1)
            return ref
        """,
    "RT003-fires": """\
        def fetch(loader):
            try:
                return loader()
            except Exception:
                return None
        """,
    "RT003-quiet": """\
        def fetch(loader):
            try:
                return loader()
            except Exception:  # loader failures degrade to a cache miss
                return None
        """,
    "RT005-fires": """\
        def keep_trying(op):
            while True:
                try:
                    return op()
                except Exception:  # transient: spin again
                    continue
        """,
    "RT005-quiet": """\
        import time

        def keep_trying(op, backoff):
            attempts = 0
            while attempts < 5:
                try:
                    return op()
                except Exception:  # transient: pace and retry under the bound
                    attempts += 1
                    time.sleep(backoff.next_delay(attempts))
        """,
    "CS001-fires": """\
        import json
        import os

        def publish(state, path):
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(state, f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
            with open("status.json", "w") as f:
                json.dump({"ok": True}, f)
        """,
    "CS001-quiet": """\
        import json
        import os

        def publish(state, path):
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(state, f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
        """,
    "CS002-fires": """\
        import json
        import os

        def seal(state, path):
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(state, f)
            os.replace(tmp, path)
        """,
    "CS002-quiet": """\
        import json
        import os

        def seal(state, path):
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(state, f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
        """,
    "CS003-fires": """\
        def checkpoint(store, cursors):
            store.put(cursors, object_id="ckpt")  # aircrash: commits epoch

        def run(store, chunk):
            checkpoint(store, [0])
            store.put(chunk, object_id="c0")  # aircrash: data epoch
        """,
    "CS003-quiet": """\
        def run(store, chunk):
            store.put(chunk, object_id="c0")  # aircrash: data epoch
            store.put([0], object_id="ckpt")  # aircrash: commits epoch
        """,
    "FI001-fires": """\
        import subprocess

        def launch(cmd):  # aircrash: entry
            subprocess.run(cmd)
        """,
    "FI001-quiet": """\
        import subprocess

        from tpu_air_torch.faults import plan as _faults

        def _guarded(cmd):
            _faults.perturb("launch.exec", key=str(cmd))
            subprocess.run(cmd)

        def launch(cmd):  # aircrash: entry
            _guarded(cmd)
        """,
    "AL000-fires": "def broken(:\n    pass\n",
    "AL001-fires": """\
        def fetch(loader):
            try:
                return loader()
            except Exception:  # airlint: disable=RT003
                return None
        """,
    "AL001-quiet": """\
        def fetch(loader):
            try:
                return loader()
            except Exception:  # airlint: disable=RT003 — fixture: any failure is a miss
                return None
        """,
    "AL002-fires": """\
        def publish(store, batch):
            ref = store.put(batch)
            batch.append(1)  # airlint: disable=RT002,ZZ999 — fixture: typo
            return ref
        """,
    "AL002-quiet": """\
        def publish(store, batch):
            ref = store.put(batch)
            # airlint: disable=RT002 — fixture: the caller copies first
            batch.append(1)
            return ref
        """,
    "file-level-suppression": """\
        # airlint: disable-file=CC001,RT003 — fixture: whole file opts out
        import threading

        class Gauge:
            def __init__(self):
                self._lock = threading.Lock()
                self._v = 0

            def bump(self):
                with self._lock:
                    self._v += 1

            def read(self):
                try:
                    return self._v
                except Exception:
                    return None
        """,
}


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_fixture_parity(name):
    src = textwrap.dedent(FIXTURES[name])
    want = _rows([jax_lint.analyze_source(src, path="fix.py", only=SHARED)])
    got = _rows([torch_lint.analyze_source(src, path="fix.py", only=SHARED)])
    assert got == want
    rule, kind = name.split("-", 1)
    if kind == "fires":
        assert rule in {row[0] for row in got if not row[-1]}, got
    elif kind == "quiet":
        assert not [row for row in got if row[0] == rule], got


# ---------------------------------------------------------------------------
# (c) package names
# ---------------------------------------------------------------------------

STATE = """\
    import threading

    class Stats:
        def __init__(self):
            self._lock = threading.Lock()
            self.total = 0

        def add(self, n):
            with self._lock:
                self._bump(n)

        def _bump(self, n):
            self.total = self.total + n
    """

RUNNER = """\
    import threading

    from {root}.engine.engine import Stats

    class Runner:
        def __init__(self):
            self.stats = Stats()
            self._thread = threading.Thread(target=self._run)

        def _run(self):
            self.stats._bump(1)
    """


def _write_package(base, root):
    """``{root}/engine/{__init__,engine}.py`` and ``{root}/serve/runner.py``:
    the runner's thread calls into the engine module's Stats without its
    lock; the engine package's ``__init__`` shares its stem with the
    module, as the port's ``engine/engine.py`` does."""
    for sub in ("", "engine", "serve"):
        (base / root / sub).mkdir(parents=True, exist_ok=True)
        (base / root / sub / "__init__.py").write_text("")
    (base / root / "engine" / "engine.py").write_text(textwrap.dedent(STATE))
    (base / root / "serve" / "runner.py").write_text(
        textwrap.dedent(RUNNER.format(root=root)))
    return str(base / root)


def _cc001(reports):
    return [(os.path.basename(f.path), f.line, f.message)
            for rep in reports for f in rep.active if f.rule == "CC001"]


def test_package_names_resolve_under_the_jax_root(tmp_path):
    tree = _write_package(tmp_path, "tpu_air")
    want = _cc001(jax_lint.analyze_paths([tree]))
    assert [(p, ln) for p, ln, _ in want] == [("engine.py", 13)]
    assert "Stats.total" in want[0][2] and "Runner._run" in want[0][2]
    assert _cc001(torch_lint.analyze_paths([tree])) == want


def test_package_names_resolve_under_the_port_root(tmp_path):
    """The gate the port had was blind here: the JAX analyzer names these
    modules by their bare stems, so ``engine/__init__.py`` and
    ``engine/engine.py`` collide and the import does not resolve."""
    tree = _write_package(tmp_path, "tpu_air_torch")
    got = _cc001(torch_lint.analyze_paths([tree]))
    assert [(p, ln) for p, ln, _ in got] == [("engine.py", 13)]
    assert "Runner._run" in got[0][2]
    assert _cc001(jax_lint.analyze_paths([tree])) == []


@pytest.mark.parametrize("root", ["tpu_air", "tpu_air_torch"])
def test_entry_points_and_funnels_follow_the_package_root(tmp_path, root):
    """FI001 reads ``{root}.serve`` as an entry package, and credits an
    actor call when ``{root}.core.remote`` carries the perturb hook."""
    for sub in ("", "core", "serve"):
        (tmp_path / root / sub).mkdir(parents=True, exist_ok=True)
        (tmp_path / root / sub / "__init__.py").write_text("")
    (tmp_path / root / "serve" / "api.py").write_text(textwrap.dedent("""\
        import subprocess

        def launch(cmd):
            subprocess.run(cmd)

        def call(actor):
            return actor.ping.remote()
        """))
    remote = tmp_path / root / "core" / "remote.py"
    remote.write_text("def dispatch(x):\n    return x\n")
    tree = [str(tmp_path / root)]
    fi = [(f.line, f.message.split("`")[1])
          for rep in torch_lint.analyze_paths(tree, only=["FI001"]) for f in rep.active]
    assert fi == [(4, "subprocess.run"), (7, "actor.ping.remote")]
    remote.write_text(textwrap.dedent("""\
        from {root}.faults import plan as _faults

        def dispatch(x):
            _faults.perturb("actor.call", key=str(x))
            return x
        """.format(root=root)))
    fi = [(f.line, f.message.split("`")[1])
          for rep in torch_lint.analyze_paths(tree, only=["FI001"]) for f in rep.active]
    assert fi == [(4, "subprocess.run")]


# ---------------------------------------------------------------------------
# (d) PT004, the counterpart of JX004
# ---------------------------------------------------------------------------

# (JX004 fixture, its PyTorch translation): PT004 must fire on the lines
# JX004 fires on
TRANSLATED = {
    "float-of-loss": ("""\
        def train_loop(batches, step):
            total = 0.0
            for batch in batches:
                loss = step(batch)
                total += float(loss)
            return total
        """, None),
    "deferred-after-loop": ("""\
        def train_loop(batches, step):
            losses = []
            for batch in batches:
                losses.append(step(batch))
            return sum(float(x) for x in losses)
        """, None),
    "cold-function": ("""\
        def summarize(batches, step):
            total = 0.0
            for batch in batches:
                loss = step(batch)
                total += float(loss)
            return total
        """, None),
    "loop-header": ("""\
        import numpy as np

        def decode_all(ids):
            out = []
            for i in np.asarray(ids).tolist():
                out.append(i)
            return out
        """, """\
        def decode_all(ids):
            out = []
            for i in ids.cpu().tolist():
                out.append(i)
            return out
        """),
    "item-and-tolist": ("""\
        def decode_loop(step, tok, n):
            out = []
            for _ in range(n):
                tok = step(tok)
                out.append(tok[0].item())
                out.extend(tok.tolist())
            return out
        """, None),
    "array-pull": ("""\
        import numpy as np

        def generate(step, tok, n):
            rows = []
            for _ in range(n):
                tok = step(tok)
                rows.append(np.asarray(tok))
            return rows
        """, None),
    "while-test": ("""\
        def train_until(step, state, tol):
            while float(state[0]) > tol:
                state = step(state)
            return state
        """, None),
    "nested-helper-is-cold": ("""\
        import numpy as np

        def train_epoch(step, batches):
            def stage(b):
                return np.asarray(b)
            for b in batches:
                step(stage(b))
        """, None),
    "int-of-subscript": ("""\
        import jax.numpy as jnp

        def decode_step_loop(step, tok, n):
            seen = []
            for _ in range(n):
                tok = step(tok)
                seen.append(int(tok[0]))
            return jnp.stack(seen)
        """, """\
        import torch

        def decode_step_loop(step, tok, n):
            seen = []
            for _ in range(n):
                tok = step(tok)
                seen.append(int(tok[0]))
            return torch.stack(seen)
        """),
}


@pytest.mark.parametrize("name", sorted(TRANSLATED))
def test_pt004_fires_where_jx004_fires(name):
    jax_src, torch_src = TRANSLATED[name]
    jax_src = textwrap.dedent(jax_src)
    torch_src = textwrap.dedent(torch_src or jax_src)
    want = [f.line for f in jax_lint.analyze_source(jax_src, "fix.py", only=["JX004"]).active]
    got = [f.line for f in torch_lint.analyze_source(torch_src, "fix.py", only=["PT004"]).active]
    assert got == want


def _pt004(src):
    rep = torch_lint.analyze_source(textwrap.dedent(src), "fix.py", only=["PT004"])
    return [(f.line, f.message.split(" ")[0]) for f in rep.active]


LOOP = """\
    import numpy as np
    import torch

    def decode_loop(step, tok, n, args):
        for _ in range(n):
            tok = step(tok)
            {stmt}
        return tok
    """


@pytest.mark.parametrize("stmt,desc", [
    ("x = tok.cpu()", ".cpu()"),
    ("x = tok.numpy()", ".numpy()"),
    ('x = tok.to("cpu")', '.to("cpu")'),
    ('x = tok.to(device="cpu", non_blocking=True)', '.to("cpu")'),
    ("torch.cuda.synchronize()", "torch.cuda.synchronize()"),
    ("done = bool(tok.all())", "bool(...)"),
    ("x = np.array(tok)", "np.array(...)"),
    ("x = tok.cpu().numpy()", ".cpu()"),          # one finding per chain
    ("x = int(tok.item())", ".item()"),
])
def test_pt004_fires_on_the_pytorch_syncs(stmt, desc):
    assert _pt004(LOOP.format(stmt=stmt)) == [(7, desc)]


@pytest.mark.parametrize("stmt", [
    "x = int(np.prod(tok.shape))",     # a module's function: host math
    "x = int(args.epochs)",            # an attribute: host config
    'x = tok.to("cuda")',
    "x = tok.to(tok.device)",
    "x = tok.cpu(memory_format=torch.contiguous_format)",
    "x = float(len(args))",
])
def test_pt004_stays_quiet_on_host_values(stmt):
    assert _pt004(LOOP.format(stmt=stmt)) == []


def test_pt004_reads_a_step_function_that_a_loop_calls():
    """The engine's shape: the decode step's one sync sits outside any loop
    of its own, and the serving loop calls the step every iteration."""
    step = """\
        class Engine:
            def _decode_all(self):
                nxt = self.tok.cpu()
                return nxt

            def step(self):
                self._decode_all()
        """
    assert _pt004(step) == []
    looped = step + """\

            def run(self):
                while True:
                    self.step()
        """
    ((line, desc),) = _pt004(looped)
    assert (line, desc) == (3, ".cpu()")
    rep = torch_lint.analyze_source(textwrap.dedent(looped), "fix.py", only=["PT004"])
    assert "which a loop calls every iteration" in rep.active[0].message


def test_pt004_sites_in_the_port_are_suppressed_with_reasons(port_tree):
    pkg = REPO / "tpu_air_torch"
    sites = {
        ("models/t5/generate.py", "bool(finished.all())"),
        ("models/lm/generate.py", "bool(done.all())"),
        ("engine/engine.py", "nxt = nxt.cpu().numpy()"),
        ("engine/engine.py", "token = int(nxt[slot.index])"),
        ("engine/t5_engine.py", "nxt = win.tok.cpu().numpy()"),
        ("engine/t5_engine.py", "token = int(nxt[row])"),
    }
    want = {(rel, _line_of(pkg / rel, needle)) for rel, needle in sites}
    hits = [f for rep in port_tree for f in rep.findings if f.rule == "PT004"]
    got = {(os.path.relpath(f.path, pkg), f.line) for f in hits}
    assert want <= got
    assert all(f.suppressed and f.suppress_reason for f in hits)


# ---------------------------------------------------------------------------
# (e) CLI parity
# ---------------------------------------------------------------------------


def _run(args, cwd):
    out = subprocess.run([sys.executable, *args], cwd=cwd, capture_output=True,
                         text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=str(REPO)))
    return out.returncode, out.stdout


def test_cli_parity(tmp_path):
    tree = tmp_path / "tree"
    tree.mkdir()
    (tree / "race.py").write_text(textwrap.dedent(FIXTURES["CC001-fires"]))
    (tree / "put.py").write_text(textwrap.dedent(FIXTURES["RT002-fires"]))
    (tree / "ok.py").write_text(textwrap.dedent(FIXTURES["AL002-quiet"]))
    port = ["-m", "tpu_air_torch.analysis"]
    jax = [str(REPO / "tools" / "airlint.py")]
    for flags in (["--json"], ["--format", "sarif"], ["--json", "--rules", "CC"],
                  ["--json", "--show-suppressed", "ok.py"]):
        args = flags if flags[-1].endswith(".py") else flags + ["."]
        rc_p, out_p = _run(port + args, tree)
        rc_j, out_j = _run(jax + args, tree)
        assert (rc_p, json.loads(out_p)) == (rc_j, json.loads(out_j)), flags
        assert rc_p == (0 if args[-1] == "ok.py" else 1)
    # a baseline either tool writes silences the same findings in the other
    base = tmp_path / "base.json"
    assert _run(port + ["--baseline", str(base), "--baseline-write", "."], tree)[0] == 0
    written = base.read_text()
    assert _run(jax + ["--baseline", str(base), "--baseline-write", "."], tree)[0] == 0
    assert base.read_text() == written
    for tool in (port, jax):
        rc, out = _run(tool + ["--json", "--baseline", str(base), "."], tree)
        assert rc == 0 and json.loads(out)["findings"] == []
    assert _run(port + ["--rules", "NOPE", "."], tree)[0] == 2


def test_cli_lists_the_port_rules_and_explains_the_jax_only_ones(capsys):
    from tpu_air_torch.analysis.cli import main

    assert main(["--list-rules"]) == 0
    listed = {ln.split()[0] for ln in capsys.readouterr().out.splitlines()
              if ln and not ln.startswith(" ")}
    assert listed == set(SHARED) | {"PT004"}
    assert main(["--explain", "JX008"]) == 0
    assert "queued in ROADMAP" in capsys.readouterr().out
    assert main(["--explain", "PT004"]) == 0
    assert "Minimal example" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# (f) self-application
# ---------------------------------------------------------------------------


def test_port_is_clean_and_every_suppression_is_reasoned(port_tree):
    assert len(port_tree) >= 100
    active = [f for rep in port_tree for f in rep.active]
    assert not active, "\n".join(f"{f.location()}: {f.rule}: {f.message}" for f in active)
    suppressed = [f for rep in port_tree for f in rep.suppressed]
    assert suppressed and all(f.suppress_reason.strip() for f in suppressed)


def test_engine_races_the_repair_exposed_name_their_lock(port_tree):
    """The nine CC001 sites in engine/engine.py the module-name repair
    exposed are guarded by _step_lock (taken by ``with`` or by
    _between_steps()'s explicit acquire()), and their suppressions say so."""
    fields = {"_decode_step", "_chunk_fn", "_copy_fn", "cache", "_adapter_a",
              "_adapter_b", "_cur_tok", "_pos", "_adapter_ids_host"}
    hits = {f.dataflow["field"]: f for rep in port_tree for f in rep.findings
            if f.rule == "CC001" and f.path.endswith(os.path.join("engine", "engine.py"))}
    assert fields <= set(hits)
    for name in fields:
        assert hits[name].suppressed and "_step_lock" in hits[name].suppress_reason, name


def test_analysis_package_has_no_finding_at_all():
    reports = torch_lint.analyze_paths([str(REPO / "tpu_air_torch" / "analysis")])
    findings = [f for rep in reports for f in rep.findings]
    assert not findings, "\n".join(f"{f.location()}: {f.rule}: {f.message}" for f in findings)


def test_analysis_package_imports_only_the_standard_library():
    pkg = REPO / "tpu_air_torch" / "analysis"
    bad = []
    for path in sorted(pkg.rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            bad += [f"{path.name}:{node.lineno} {n}" for n in names
                    if n.split(".")[0] not in sys.stdlib_module_names]
    assert bad == []
