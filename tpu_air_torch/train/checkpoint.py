"""Checkpoint — the artifact a training run hands to the next stage (the
port's counterpart of ``tpu_air/train/checkpoint.py``).

A checkpoint is backed by a dict or by a directory::

    checkpoint/
      kind.json            # {"kind": "torch_model" | "dict"}
      model_config.json    # LMConfig / T5Config, tagged by "model_type"
      params.pt            # the model's state dict (torch.save, f32)
      metrics.json
      data.pkl             # a dict checkpoint written to a directory

Reading the JAX package's ``params.msgpack`` checkpoints waits for a later
slice (ROADMAP, next slices).
"""

from __future__ import annotations

import json
import os
import pickle
import shutil
import tempfile
from typing import Any, Dict, Optional

import torch


class Checkpoint:
    """A directory- or dict-backed immutable training artifact."""

    def __init__(self, data: Optional[Dict[str, Any]] = None, path: Optional[str] = None):
        if (data is None) == (path is None):
            raise ValueError("provide exactly one of data= or path=")
        self._data = data
        self._path = path

    # -- constructors ------------------------------------------------------
    @classmethod
    def from_dict(cls, data: Dict[str, Any]) -> "Checkpoint":
        return cls(data=dict(data))

    @classmethod
    def from_directory(cls, path: str) -> "Checkpoint":
        return cls(path=path)

    @classmethod
    def from_model(cls, model_config=None, params=None,
                   metrics: Optional[Dict[str, Any]] = None,
                   path: Optional[str] = None) -> "Checkpoint":
        """Write a model's config and state dict (``params``) into a directory
        checkpoint (a new temporary directory unless ``path`` is given)."""
        path = path or tempfile.mkdtemp(prefix="tpu_air_torch-ckpt-")
        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, "kind.json"), "w") as f:
            json.dump({"kind": "torch_model"}, f)
        if model_config is not None:
            with open(os.path.join(path, "model_config.json"), "w") as f:
                f.write(model_config.to_json())
        if params is not None:
            cpu = {k: v.detach().to("cpu") for k, v in params.items()}
            torch.save(cpu, os.path.join(path, "params.pt"))
        if metrics:
            with open(os.path.join(path, "metrics.json"), "w") as f:
                json.dump(metrics, f, default=float)
        return cls(path=path)

    # -- dict/directory interop -------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        if self._data is not None:
            return dict(self._data)
        out: Dict[str, Any] = {}
        for name, loader in (("model_config", self.get_model_config),
                             ("params", self.get_params),
                             ("metrics", self.get_metrics)):
            try:
                v = loader()
            except (FileNotFoundError, KeyError):
                v = None
            if v is not None:
                out[name] = v
        return out

    def to_directory(self, path: Optional[str] = None) -> str:
        if self._path is not None:
            if path and os.path.abspath(path) != os.path.abspath(self._path):
                shutil.copytree(self._path, path, dirs_exist_ok=True)
                return path
            return self._path
        path = path or tempfile.mkdtemp(prefix="tpu_air_torch-ckpt-")
        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, "kind.json"), "w") as f:
            json.dump({"kind": "dict"}, f)
        with open(os.path.join(path, "data.pkl"), "wb") as f:
            pickle.dump(self._data, f)
        return path

    @property
    def path(self) -> Optional[str]:
        return self._path

    def _dir_file(self, name: str) -> str:
        if self._path is None:
            raise KeyError(name)
        p = os.path.join(self._path, name)
        if not os.path.exists(p):
            raise FileNotFoundError(p)
        return p

    def _dict_backed(self) -> Optional[Dict[str, Any]]:
        if self._data is not None:
            return self._data
        try:
            # only a directory this class wrote holds data.pkl
            with open(self._dir_file("data.pkl"), "rb") as f:
                return pickle.load(f)
        except (FileNotFoundError, KeyError):
            return None

    # -- typed accessors ---------------------------------------------------
    def get_model_config(self):
        dd = self._dict_backed()
        if dd is not None and "model_config" in dd:
            return dd["model_config"]
        with open(self._dir_file("model_config.json")) as f:
            d = json.load(f)
        if d.get("model_type") == "causal_lm":
            from tpu_air_torch.models.lm import LMConfig

            return LMConfig.from_dict(d)
        from tpu_air_torch.models.t5.config import T5Config

        return T5Config.from_dict(d)

    def get_params(self) -> Optional[Dict[str, torch.Tensor]]:
        """The model's state dict, on the CPU."""
        if self._data is not None:
            return self._data.get("params")
        try:
            return torch.load(self._dir_file("params.pt"), map_location="cpu",
                              weights_only=True)
        except (FileNotFoundError, KeyError):
            dd = self._dict_backed()
            return dd.get("params") if dd else None

    def get_metrics(self) -> Dict[str, Any]:
        dd = self._dict_backed()
        if dd is not None:
            return dd.get("metrics", {})
        try:
            with open(self._dir_file("metrics.json")) as f:
                return json.load(f)
        except (FileNotFoundError, KeyError):
            return {}

    def __repr__(self):
        src = self._path if self._path else f"dict[{list((self._data or {}).keys())}]"
        return f"Checkpoint({src})"
