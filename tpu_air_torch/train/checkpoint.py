"""Checkpoint — the artifact a training run hands to the next stage (the
port's counterpart of ``tpu_air/train/checkpoint.py``).

A checkpoint bundles the model, its tokenizer and its fitted
preprocessor, which is what lets a trained model go on to prediction.  It
is backed by a dict or by a directory::

    checkpoint/
      kind.json            # {"kind": "torch_model" | "jax_model" | "dict"}
      model_config.json    # LMConfig / T5Config / SegformerConfig, tagged by "model_type"
      params.pt            # torch_model: the model's state dict (torch.save, f32)
      params.msgpack       # jax_model: the Flax param tree (flax's msgpack)
      tokenizer/           # the tokenizer's save_pretrained
      preprocessor.pkl     # the fitted preprocessor (cloudpickle)
      metrics.json
      extras.pkl           # a GBDT/sklearn estimator and its extras (cloudpickle);
                           # a jax_model SegFormer's batch-norm stats ("batch_stats")
      data.pkl             # a dict checkpoint written to a directory

Both directions with the JAX package: a ``jax_model`` directory that
``tpu_air.train.checkpoint.Checkpoint.from_model`` wrote loads here (its
``params.msgpack`` through :mod:`tpu_air_torch.train.flax_msgpack` and the
models' ``params_from_jax``, no flax needed), and ``from_model(...,
format="jax")`` writes one that the JAX package loads.  Pickled files
(``preprocessor.pkl``, ``extras.pkl``, ``data.pkl``) are read with
:class:`PortUnpickler`, which maps the JAX package's preprocessor,
tokenizer, GBDT (``HistGBDT``, ``BaggedGBDT``) and SegFormer
image-processor and config classes to the port's copies and refuses any
other ``tpu_air`` module, so loading never imports the JAX package.  What
cannot be read raises, naming it.

A SegFormer's batch-norm running stats are buffers of the port's model, in
its state dict; in the JAX layout they are the ``batch_stats`` collection,
which the JAX package keeps in ``extras.pkl`` beside ``params.msgpack``.
So a ``jax_model`` SegFormer checkpoint is read from both files, and
``from_model(..., format="jax")`` writes the stats there.

Loading morphs the type: ``get_params(dtype=...)`` and
``get_model(dtype=..., device=...)`` cast once, at load.
"""

from __future__ import annotations

import json
import os
import pickle
import shutil
import tempfile
from typing import Any, Dict, Optional, Tuple

import torch

from tpu_air_torch.device import DeviceLike


# The JAX package's modules the port has copied, by the module of the copy.
_COPIED_MODULES = {
    "tpu_air.data.preprocessors": "tpu_air_torch.data.preprocessors",
    "tpu_air.models.segformer.config": "tpu_air_torch.models.segformer.config",
    "tpu_air.models.segformer.image_processor": "tpu_air_torch.models.segformer.image_processor",
    "tpu_air.models.tokenizer": "tpu_air_torch.models.tokenizer",
    "tpu_air.train.gbdt_trainer": "tpu_air_torch.train.gbdt_trainer",
    "tpu_air.train.hist_gbdt": "tpu_air_torch.train.hist_gbdt",
}
_KINDS = ("torch_model", "jax_model", "dict")


def _port_module(module: str) -> str:
    """``module``, or the port's copy of it when it is a JAX package module
    the port copied; raises for any other ``tpu_air`` module."""
    if module != "tpu_air" and not module.startswith("tpu_air."):
        return module
    if module not in _COPIED_MODULES:
        raise pickle.UnpicklingError(
            f"the pickle names {module!r}, a module of the JAX package that the "
            f"port has not copied (it maps only {sorted(_COPIED_MODULES)})")
    return _COPIED_MODULES[module]


class PortUnpickler(pickle.Unpickler):
    """``pickle.Unpickler`` that resolves the JAX package's copied modules to
    the port's copies and refuses its other modules, for classes and for the
    module imports cloudpickle records (``subimport``) alike."""

    def find_class(self, module, name):
        if module.startswith("cloudpickle") and name in ("subimport", "dynamic_subimport"):
            importer = super().find_class(module, name)
            return lambda modname, *args: importer(_port_module(modname), *args)
        return super().find_class(_port_module(module), name)


def _load_pickle(path: str):
    with open(path, "rb") as f:
        return PortUnpickler(f).load()


def _model_class(config):
    from tpu_air_torch.models.lm import CausalLM, LMConfig
    from tpu_air_torch.models.segformer import (SegformerConfig,
                                                SegformerForSemanticSegmentation)
    from tpu_air_torch.models.t5.modeling import T5ForConditionalGeneration

    if isinstance(config, SegformerConfig):
        return SegformerForSemanticSegmentation
    return CausalLM if isinstance(config, LMConfig) else T5ForConditionalGeneration


def _params_to_jax(params: Dict[str, torch.Tensor], config
                   ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """(the Flax param tree, what goes into ``extras.pkl`` beside it: a
    SegFormer's ``batch_stats``)."""
    from tpu_air_torch.models.lm import LMConfig
    from tpu_air_torch.models.segformer import SegformerConfig

    if isinstance(config, LMConfig):
        from tpu_air_torch.models.lm.convert import params_to_jax

        return params_to_jax(params), {}
    if isinstance(config, SegformerConfig):
        from tpu_air_torch.models.segformer.convert import params_to_jax

        tree, batch_stats = params_to_jax(params, config)
        return tree, {"batch_stats": batch_stats}
    from tpu_air_torch.models.t5.convert import params_to_jax

    return params_to_jax(params, config), {}


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
    def from_model(cls, model_config=None, params=None, tokenizer=None,
                   preprocessor=None, metrics: Optional[Dict[str, Any]] = None,
                   path: Optional[str] = None, format: str = "torch",
                   sklearn_model=None, extras: Optional[Dict[str, Any]] = None,
                   ) -> "Checkpoint":
        """Write a model's config and state dict (``params``), its
        tokenizer and its preprocessor into a directory checkpoint (a new
        temporary directory unless ``path`` is given).  A GBDT or sklearn
        estimator (``sklearn_model``) goes into ``extras.pkl`` with
        ``extras``, as the JAX package lays it out.  ``params`` may be the
        model itself: a model split over a ``model`` axis
        (``parallel/sharding.py::shard_module``) writes its gathered logical
        state dict, which loads at any tensor-parallel degree.  ``format="jax"``
        writes the JAX package's layout (``kind`` ``jax_model``, the
        parameters as a Flax tree in ``params.msgpack``, a SegFormer's
        batch-norm stats as ``extras["batch_stats"]``), which
        ``tpu_air.train.checkpoint.Checkpoint`` loads; it needs
        ``model_config`` to lay the parameters out."""
        if format not in ("torch", "jax"):
            raise ValueError(f"format must be 'torch' or 'jax', got {format!r}")
        if format == "jax" and params is not None and model_config is None:
            raise ValueError("format='jax' needs model_config to lay out the parameters")
        if isinstance(params, torch.nn.Module):
            from tpu_air_torch.parallel.sharding import gather_state_dict

            params = gather_state_dict(params)
        path = path or tempfile.mkdtemp(prefix="tpu_air_torch-ckpt-")
        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, "kind.json"), "w") as f:
            json.dump({"kind": "jax_model" if format == "jax" else "torch_model"}, f)
        if model_config is not None:
            with open(os.path.join(path, "model_config.json"), "w") as f:
                f.write(model_config.to_json())
        if params is not None and format == "jax":
            from tpu_air_torch.train import flax_msgpack

            tree, beside = _params_to_jax(params, model_config)
            with open(os.path.join(path, "params.msgpack"), "wb") as f:
                f.write(flax_msgpack.dumps(tree))
            if beside:
                extras = {**(extras or {}), **beside}
        elif params is not None:
            cpu = {k: v.detach().to("cpu") for k, v in params.items()}
            torch.save(cpu, os.path.join(path, "params.pt"))
        if tokenizer is not None:
            tokenizer.save_pretrained(os.path.join(path, "tokenizer"))
        if preprocessor is not None:
            import cloudpickle  # a preprocessor may wrap a lambda, which pickle refuses

            with open(os.path.join(path, "preprocessor.pkl"), "wb") as f:
                cloudpickle.dump(preprocessor, f)
        if metrics:
            with open(os.path.join(path, "metrics.json"), "w") as f:
                json.dump(metrics, f, default=float)
        if sklearn_model is not None:
            extras = {"sklearn_model": sklearn_model, **(extras or {})}
        if extras:
            import cloudpickle

            with open(os.path.join(path, "extras.pkl"), "wb") as f:
                cloudpickle.dump(extras, f)
        return cls(path=path)

    # -- dict/directory interop -------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        if self._data is not None:
            return dict(self._data)
        out: Dict[str, Any] = {}
        for name, loader in (("model_config", self.get_model_config),
                             ("params", self.get_params),
                             ("preprocessor", self.get_preprocessor),
                             ("metrics", self.get_metrics),
                             ("extras", self._load_extras)):
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
            return _load_pickle(self._dir_file("data.pkl"))
        except (FileNotFoundError, KeyError):
            return None

    def _kind(self) -> str:
        with open(self._dir_file("kind.json")) as f:
            kind = json.load(f).get("kind")
        if kind not in _KINDS:
            raise ValueError(f"checkpoint {self._path}: kind {kind!r} is not one the port "
                             f"reads ({', '.join(_KINDS)})")
        return kind

    # -- typed accessors ---------------------------------------------------
    def get_model_config(self):
        dd = self._dict_backed()
        if dd is not None and "model_config" in dd:
            return dd["model_config"]
        with open(self._dir_file("model_config.json")) as f:
            d = json.load(f)
        if d.get("model_type") == "segformer" or "hidden_sizes" in d:
            from tpu_air_torch.models.segformer import SegformerConfig

            return SegformerConfig.from_dict(d)
        if d.get("model_type") == "causal_lm":
            from tpu_air_torch.models.lm import LMConfig

            return LMConfig.from_dict(d)
        from tpu_air_torch.models.t5.config import T5Config

        return T5Config.from_dict(d)

    def get_params(self, dtype=None) -> Optional[Dict[str, torch.Tensor]]:
        """The model's state dict, on the CPU; floating tensors cast to
        ``dtype`` (a name or a torch dtype) when one is given.  None only
        when the checkpoint holds no parameters; parameters it cannot read
        raise."""
        if self._data is not None:
            params = self._data.get("params")
        else:
            kind = self._kind()
            if kind == "dict":
                params = self._dict_backed().get("params")
            else:
                name = "params.pt" if kind == "torch_model" else "params.msgpack"
                path = os.path.join(self._path, name)
                if not os.path.exists(path):
                    return None
                if kind == "torch_model":
                    params = torch.load(path, map_location="cpu", weights_only=True)
                else:
                    params = self._params_from_msgpack(path)
        if params is None or dtype is None:
            return params
        from tpu_air_torch.models.layers import torch_dtype

        dt = torch_dtype(dtype)
        return {k: v.to(dt) if v.is_floating_point() else v for k, v in params.items()}

    def _params_from_msgpack(self, path: str) -> Dict[str, torch.Tensor]:
        """The JAX package's ``params.msgpack`` as the port's state dict,
        checked name by name and shape by shape against the model that
        ``model_config.json`` describes; a SegFormer's batch-norm stats come
        from ``extras.pkl``."""
        from tpu_air_torch.models.lm import LMConfig
        from tpu_air_torch.models.segformer import SegformerConfig
        from tpu_air_torch.train import flax_msgpack

        config = self.get_model_config()
        with open(path, "rb") as f:
            tree = flax_msgpack.loads(f.read())
        try:
            if isinstance(config, LMConfig):
                from tpu_air_torch.models.lm.convert import params_from_jax

                params = params_from_jax(tree)
            elif isinstance(config, SegformerConfig):
                from tpu_air_torch.models.segformer.convert import params_from_jax

                stats = (self._load_extras() or {}).get("batch_stats")
                if not stats:
                    raise KeyError("extras.pkl holds no batch_stats (the batch norm's "
                                   "running stats)")
                params = params_from_jax(tree, stats, config)
            else:
                from tpu_air_torch.models.t5.convert import params_from_jax

                params = params_from_jax(tree, config)
        except (KeyError, TypeError, ValueError, RuntimeError) as e:
            raise ValueError(f"checkpoint {self._path}: the Flax tree in params.msgpack "
                             f"does not convert to the {type(config).__name__} of "
                             f"model_config.json: {type(e).__name__}: {e}") from e
        want = {n: tuple(p.shape) for n, p in
                _model_class(config)(config, device="meta").state_dict().items()}
        got = {n: tuple(p.shape) for n, p in params.items()}
        if got != want:
            bad = sorted(n for n in set(want) | set(got) if want.get(n) != got.get(n))
            raise ValueError(f"checkpoint {self._path}: params.msgpack does not match "
                             f"model_config.json at {bad[:5]} "
                             f"(want {[want.get(n) for n in bad[:5]]}, "
                             f"got {[got.get(n) for n in bad[:5]]})")
        return params

    def get_model(self, dtype: Optional[str] = None, device: DeviceLike = None):
        """The model rebuilt from the config and parameters, on ``device``
        (``cuda:0`` by default).  With ``dtype`` the config computes in it
        and the parameters are cast to it once, here (the inference load);
        without, the parameters stay f32.  A GBDT or sklearn checkpoint
        gives its estimator."""
        dd = self._dict_backed()
        if dd is not None and "model" in dd:
            return dd["model"]
        extras = self._load_extras()
        if isinstance(extras, dict) and "sklearn_model" in extras:
            return extras["sklearn_model"]
        config = self.get_model_config()
        if dtype:
            config.dtype = dtype
        from tpu_air_torch.models.layers import torch_dtype

        params = self.get_params()
        if params is None:
            raise ValueError(f"{self!r} holds no parameters")
        model = _model_class(config)(config, device=device)
        model.load_state_dict(params)
        return model.to(torch_dtype(dtype)) if dtype else model

    def get_tokenizer(self, tokenizer_cls=None):
        """The tokenizer saved with the model: ``tokenizer_cls.from_pretrained``
        of its directory, or the port's ``auto_tokenizer``."""
        dd = self._dict_backed()
        if dd is not None and "tokenizer" in dd:
            return dd["tokenizer"]
        tok_dir = self._dir_file("tokenizer")
        if tokenizer_cls is not None:
            return tokenizer_cls.from_pretrained(tok_dir)
        from tpu_air_torch.models.tokenizer import auto_tokenizer

        return auto_tokenizer(tok_dir)

    def get_preprocessor(self):
        dd = self._dict_backed()
        if dd is not None:
            return dd.get("preprocessor")
        try:
            return _load_pickle(self._dir_file("preprocessor.pkl"))
        except (FileNotFoundError, KeyError):
            return None

    def get_metrics(self) -> Dict[str, Any]:
        dd = self._dict_backed()
        if dd is not None:
            return dd.get("metrics", {})
        try:
            with open(self._dir_file("metrics.json")) as f:
                return json.load(f)
        except (FileNotFoundError, KeyError):
            return {}

    def _load_extras(self):
        dd = self._dict_backed()
        if dd is not None:
            return dd.get("extras")
        try:
            return _load_pickle(self._dir_file("extras.pkl"))
        except (FileNotFoundError, KeyError):
            return None

    def __repr__(self):
        src = self._path if self._path else f"dict[{list((self._data or {}).keys())}]"
        return f"Checkpoint({src})"
