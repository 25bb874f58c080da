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
                "tpu_air_torch.parallel.distributed", "tpu_air_torch.models.layers"):
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


def test_entry_points_raise_without_cuda_unless_cpu_is_asked(monkeypatch):
    from tpu_air_torch.device import resolve_device
    from tpu_air_torch.models.lm import CausalLM, LMConfig
    from tpu_air_torch.models.t5.config import T5Config
    from tpu_air_torch.models.t5.hf_import import load_t5
    from tpu_air_torch.models.t5.modeling import T5ForConditionalGeneration
    from tpu_air_torch.predict.predictors import T5GenerativePredictor
    from tpu_air_torch.train import LMTrainer

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
    assert resolve_device("cpu") == torch.device("cpu")
    model = T5ForConditionalGeneration(T5Config.tiny(), device="cpu")
    assert model.device == torch.device("cpu")
    assert CausalLM(LMConfig.tiny(), device="cpu").device == torch.device("cpu")
    assert LMTrainer(model_config=LMConfig.tiny(), device="cpu").device == torch.device("cpu")
