"""The port stands alone: it imports neither JAX nor the JAX package, and its
entry points refuse to fall back to the CPU on their own."""

import ast
import os
import pkgutil
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "tpu_air_torch")
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "tpu_air")


def _modules():
    names = ["tpu_air_torch"]
    for info in pkgutil.walk_packages([PKG], prefix="tpu_air_torch."):
        names.append(info.name)
    return names


def _forbidden(name: str) -> bool:
    return name.split(".")[0] in FORBIDDEN


def test_importing_every_module_leaves_jax_and_tpu_air_out():
    """In a fresh interpreter, import the package and every submodule; no
    module of JAX, Flax or tpu_air may appear in sys.modules, and nothing is
    built (no _build directory appears)."""
    mods = _modules()
    assert "tpu_air_torch.models.t5.modeling" in mods
    assert "tpu_air_torch.ops.decode_attention" in mods
    assert "tpu_air_torch.train.lm_trainer" in mods
    for new in ("tpu_air_torch.train.t5_trainer", "tpu_air_torch.data.preprocessors",
                "tpu_air_torch.parallel.distributed", "tpu_air_torch.models.layers",
                "tpu_air_torch.core.runtime", "tpu_air_torch.core.object_store",
                "tpu_air_torch.core.worker_preload", "tpu_air_torch.faults.plan",
                "tpu_air_torch.observability.tracing", "tpu_air_torch.data.dataset",
                "tpu_air_torch.data.io", "tpu_air_torch.predict.batch_predictor",
                "tpu_air_torch.train.flax_msgpack", "tpu_air_torch.tune",
                "tpu_air_torch.tune.tuner", "tpu_air_torch.tune.schedulers",
                "tpu_air_torch.tune.search", "tpu_air_torch.tune.result_grid",
                "tpu_air_torch.train.gbdt_trainer", "tpu_air_torch.train.hist_gbdt",
                "tpu_air_torch.parallel.collectives", "tpu_air_torch.models.segformer",
                "tpu_air_torch.models.segformer.config",
                "tpu_air_torch.models.segformer.image_processor",
                "tpu_air_torch.models.segformer.modeling",
                "tpu_air_torch.models.segformer.convert",
                "tpu_air_torch.models.segformer.hf_import",
                "tpu_air_torch.train.segformer_trainer", "tpu_air_torch.predict.predictors",
                "tpu_air_torch.engine", "tpu_air_torch.engine.t5_engine",
                "tpu_air_torch.engine.scheduler", "tpu_air_torch.engine.metrics",
                "tpu_air_torch.engine.types", "tpu_air_torch.serve",
                "tpu_air_torch.serve.proxy", "tpu_air_torch.serve.deployment",
                "tpu_air_torch.serve.engine_deployment", "tpu_air_torch.serve.admission",
                "tpu_air_torch.serve.autoscaler", "tpu_air_torch.serve.supervisor",
                "tpu_air_torch.serve.predictor_deployment",
                "tpu_air_torch.serve.http_adapters", "tpu_air_torch.faults.retry",
                "tpu_air_torch.utils.metrics", "tpu_air_torch.observability.perf",
                "tpu_air_torch.observability.profiler", "tpu_air_torch.observability.slo",
                "tpu_air_torch.observability.timeseries", "tpu_air_torch.observability.watch",
                "tpu_air_torch.observability.dashboard",
                "tpu_air_torch.observability.trace_export",
                "tpu_air_torch.observability.postmortem"):
        assert new in mods, new
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
        "print(repr(bad))\n"
    )
    build_dir = os.path.join(PKG, "_build")
    built_before = os.path.exists(build_dir)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                         capture_output=True, text=True, timeout=120)
    assert out.stdout.strip() == "[]", out.stdout
    assert os.path.exists(build_dir) == built_before


def test_no_file_of_the_port_imports_jax_or_tpu_air():
    """A static scan of every file, the copied core included; the lazy
    imports inside functions count too."""
    assert os.path.exists(os.path.join(PKG, "core", "runtime.py"))
    offenders = []
    for dirpath, _, files in os.walk(PKG):
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(dirpath, f)
            with open(path) as fh:
                tree = ast.parse(fh.read(), path)
            for node in ast.walk(tree):
                if isinstance(node, ast.Import):
                    names = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and node.level == 0:
                    names = [node.module or ""]
                else:
                    continue
                offenders += [f"{path}:{node.lineno} {n}" for n in names if _forbidden(n)]
    assert offenders == []


def test_chip_smoke_imports_nothing_of_jax():
    with open(os.path.join(ROOT, "chip_smoke.py")) as fh:
        tree = ast.parse(fh.read())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
    assert [n for n in names if _forbidden(n)] == []
    assert any(n.startswith("tpu_air_torch") for n in names)


def test_entry_points_raise_without_cuda_unless_cpu_is_asked(monkeypatch, tmp_path):
    from tpu_air_torch.device import resolve_device
    from tpu_air_torch.models.lm import CausalLM, LMConfig
    from tpu_air_torch.models.segformer import (SegformerConfig,
                                                SegformerForImageClassification,
                                                SegformerForSemanticSegmentation,
                                                load_segformer_from_hf)
    from tpu_air_torch.models.t5.config import T5Config
    from tpu_air_torch.models.t5.hf_import import load_t5
    from tpu_air_torch.models.t5.modeling import T5ForConditionalGeneration
    from tpu_air_torch.predict.predictors import (SemanticSegmentationPredictor,
                                                  T5GenerativePredictor, TorchPredictor)
    from tpu_air_torch.train import Checkpoint, LMTrainer, SegformerTrainer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T5ForConditionalGeneration(T5Config.tiny())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        CausalLM(LMConfig.tiny())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LMTrainer(model_config=LMConfig.tiny())
    asset = os.path.join(ROOT, "tests", "assets", "flan_t5_tiny")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_t5(asset)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T5GenerativePredictor.from_pretrained(asset)
    seg = SegformerConfig.tiny()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SegformerForSemanticSegmentation(seg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SegformerForImageClassification(seg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SegformerTrainer(model_config=seg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_segformer_from_hf(str(tmp_path / "no_such_model"))
    cpu_model = SegformerForSemanticSegmentation(seg, device="cpu").init_weights(0)
    ckpt = Checkpoint.from_model(model_config=seg, params=cpu_model.state_dict(),
                                 path=str(tmp_path / "seg"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SemanticSegmentationPredictor.from_checkpoint(ckpt)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TorchPredictor.from_checkpoint(ckpt, apply_fn=lambda p, **f: p)
    assert SemanticSegmentationPredictor.from_checkpoint(
        ckpt, device="cpu").model.device == torch.device("cpu")
    # a T5 engine replica builds its model where the lease says, never on
    # the CPU by itself
    from tpu_air_torch.engine import T5EngineConfig
    from tpu_air_torch.serve import EngineDeployment

    t5 = T5ForConditionalGeneration(T5Config.tiny(), device="cpu").init_weights(0)
    t5_ckpt = Checkpoint.from_model(model_config=T5Config.tiny(), params=t5.state_dict(),
                                    path=str(tmp_path / "t5"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        EngineDeployment.func_or_class(t5_ckpt, T5EngineConfig())._ensure_engine()
    # the LM serving path: the predictor and the engine replica likewise
    from tpu_air_torch.predict import LMGenerativePredictor

    lm = CausalLM(LMConfig.tiny(), device="cpu").init_weights(0)
    lm_ckpt = Checkpoint.from_model(model_config=LMConfig.tiny(), params=lm.state_dict(),
                                    path=str(tmp_path / "lm"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LMGenerativePredictor.from_checkpoint(lm_ckpt)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        EngineDeployment.func_or_class(lm_ckpt)._ensure_engine()
    assert LMGenerativePredictor.from_checkpoint(
        lm_ckpt, device="cpu").model.device == torch.device("cpu")
    assert SegformerTrainer(model_config=seg, device="cpu").device == torch.device("cpu")
    assert resolve_device("cpu") == torch.device("cpu")
    model = T5ForConditionalGeneration(T5Config.tiny(), device="cpu")
    assert model.device == torch.device("cpu")
    assert CausalLM(LMConfig.tiny(), device="cpu").device == torch.device("cpu")
    assert LMTrainer(model_config=LMConfig.tiny(), device="cpu").device == torch.device("cpu")


def test_loading_a_jax_checkpoint_imports_nothing_of_jax(tmp_path):
    """In a fresh interpreter, a JAX-format checkpoint (written by the port,
    with a preprocessor that names the JAX package's copied classes) loads
    and predicts without JAX, flax or tpu_air in sys.modules; a preprocessor
    naming an uncopied tpu_air module is refused without importing it."""
    import pickle

    from tpu_air_torch.data.preprocessors import BatchMapper
    from tpu_air_torch.models.t5.config import T5Config
    from tpu_air_torch.models.t5.modeling import T5ForConditionalGeneration
    from tpu_air_torch.train import Checkpoint

    cfg = T5Config.tiny(vocab_size=384)
    model = T5ForConditionalGeneration(cfg, device="cpu").init_weights(0)
    path = str(tmp_path / "ckpt")
    Checkpoint.from_model(model_config=cfg, params=model.state_dict(), format="jax", path=path)
    # a pickle naming the JAX package's classes (protocol 2 names a class by
    # a newline-ended module path, so the path can be swapped in the bytes)
    blob = pickle.dumps(BatchMapper(len), protocol=2)
    assert b"tpu_air_torch.data.preprocessors\n" in blob
    with open(os.path.join(path, "preprocessor.pkl"), "wb") as f:
        f.write(blob.replace(b"tpu_air_torch.data.preprocessors", b"tpu_air.data.preprocessors"))
    with open(str(tmp_path / "bad.pkl"), "wb") as f:
        f.write(blob.replace(b"tpu_air_torch.data.preprocessors", b"tpu_air.data.block"))
    code = (
        "import sys, pandas as pd, numpy as np\n"
        "from tpu_air_torch.train import Checkpoint\n"
        "from tpu_air_torch.train.checkpoint import _load_pickle\n"
        "from tpu_air_torch.predict import T5GenerativePredictor\n"
        f"c = Checkpoint.from_directory({path!r})\n"
        "pp = c.get_preprocessor()\n"
        "assert type(pp).__module__ == 'tpu_air_torch.data.preprocessors', type(pp)\n"
        "p = T5GenerativePredictor(c.get_model(device='cpu'))\n"
        "out = p.predict({'input_ids': np.ones((2, 5), np.int64)}, max_new_tokens=3)\n"
        "assert len(out) == 2\n"
        "try:\n"
        f"    _load_pickle({str(tmp_path / 'bad.pkl')!r})\n"
        "    raise SystemExit('not refused')\n"
        "except Exception as e:\n"
        "    assert 'tpu_air.data.block' in str(e), e\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
        "print(repr(bad))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                         capture_output=True, text=True, timeout=120)
    assert out.stdout.strip().splitlines()[-1] == "[]", out.stdout


def test_core_lint_is_clean():
    """airlint's backend-neutral families (CC concurrency, RT actor runtime,
    CS crash safety, FI fault injection) find nothing unsuppressed in the
    port; the JAX (JX) and Pallas (PL) families do not apply to it."""
    import json

    out = subprocess.run([sys.executable, os.path.join(ROOT, "tools", "airlint.py"), "--json",
                          "--rules", "CC,RT,CS,FI", os.path.join(ROOT, "tpu_air_torch")],
                         cwd=ROOT, capture_output=True, text=True, timeout=300)
    report = json.loads(out.stdout)
    assert report["files_analyzed"] >= 50
    assert report["findings"] == [], report["findings"]
