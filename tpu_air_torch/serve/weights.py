"""Live weights: a versioned store over the port's file object store, and the
health-gated canary controller that moves a serving fleet onto a version;
the counterpart of ``tpu_air/serve/weights.py``.

Three layers, bottom-up:

* :class:`WeightStore` — versioned full and adapter checkpoints.  Each
  tensor is one object (``w{version:06d}-{idx:04d}``) of an
  :class:`~tpu_air_torch.core.object_store.ObjectStore` (sealed atomically);
  a JSON manifest per version records each tensor's object id, shape,
  dtype and crc32.  The manifest is written LAST, through a temp file,
  fsync and rename, so a version exists only once every object it names is
  sealed: a publisher killed mid-publish leaves orphan objects and no
  manifest, and a retry reclaims the version number.  Every read is
  checked against the manifest: a corrupt or missing object raises
  :class:`WeightsIntegrityError`.  The store holds the JAX package's
  layout: the Flax parameter tree's "/"-joined paths over f32 numpy arrays
  (a port state dict goes in through ``models/lm/convert.py::params_to_jax``
  and comes back out through ``params_from_jax``), so one manifest schema
  serves both packages and either reads what the other wrote.

* probe helpers — a publish can pin a greedy probe: a fixed prompt set, its
  expected tokens and a sha256 fingerprint (and, for a tolerance gate, the
  last-position logits).  :func:`offline_greedy` is the reference decode it
  is computed with: one token per forward of the port's model, apart from
  the engine.

* :class:`WeightsController` — the canary state machine over a deployment
  handle.  ``promote()`` swaps ONE replica, runs the probe gate, holds a
  soak window, and only then swaps the rest of the fleet; any gate failure
  rolls the canary back to the prior version (tensors the engine kept:
  rollback reads no store) and shows in ``/-/stats`` under ``weights``.
  Adapter versions promote through the same gate as bank-row loads.  The
  soak reads no SLO monitor: the port has none (ROADMAP Queue 1 item 10),
  and with none installed the JAX package's soak is time-only too.

Concurrency: the store has one writer (the trainer); readers see only
sealed objects and renamed manifests.  Controller state is guarded by one
lock, and every replica call is made outside it.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import threading
import time
import zlib
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from tpu_air_torch.core.object_store import ObjectStore
from tpu_air_torch.faults import plan as _faults

__all__ = [
    "GateFailedError",
    "TornPublishError",
    "WeightStore",
    "WeightsController",
    "WeightsIntegrityError",
    "attach_weights",
    "compute_probe",
    "controller_stats",
    "install_controller",
    "offline_greedy",
    "probe_fingerprint",
    "probe_logits",
    "uninstall_controller",
]


class TornPublishError(Exception):
    """A publish died before its manifest landed.  The version does not
    exist: readers never see it, and a retry publishes under the same
    number."""


class WeightsIntegrityError(Exception):
    """A read failed validation: a missing object, a shape or dtype that
    differs from the manifest, or a crc32 mismatch."""


class GateFailedError(Exception):
    """The canary gate rejected a version (a probe mismatch, or the swap
    itself failing)."""


# ---------------------------------------------------------------------------
# param tree <-> flat tensor list
# ---------------------------------------------------------------------------

def _flatten(tree: Dict[str, Any], prefix: str = "") -> List[Tuple[str, Any]]:
    """Nested-dict params to sorted ``(path, leaf)`` pairs ("/"-joined)."""
    out: List[Tuple[str, Any]] = []
    for k in sorted(tree):
        v = tree[k]
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.extend(_flatten(v, path))
        else:
            out.append((path, v))
    return out


def _unflatten(pairs: List[Tuple[str, Any]]) -> Dict[str, Any]:
    root: Dict[str, Any] = {}
    for path, leaf in pairs:
        parts = path.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = leaf
    return root


def _as_tree(params: Dict[str, Any]) -> Dict[str, Any]:
    """What a publish stores: a Flax-style tree of numpy arrays as it is;
    the port's LM state dict as the JAX package's tree (``params_to_jax``);
    any other state dict by its names, floats as f32 (numpy has no bf16)."""
    if not any(isinstance(v, torch.Tensor) for v in params.values()):
        return params
    if "embedding" in params and "final_norm.weight" in params:
        from tpu_air_torch.models.lm.convert import params_to_jax

        return params_to_jax(params)
    return {k: (v.detach().cpu().float() if v.is_floating_point() else v.detach().cpu()).numpy()
            for k, v in params.items()}


# ---------------------------------------------------------------------------
# the versioned store
# ---------------------------------------------------------------------------

_MANIFEST_RE = re.compile(r"^manifest-(\d{6})\.json$")


class WeightStore:
    """Versioned weight checkpoints over the port's object store.

    ``root`` holds the manifests; tensor objects live in a private
    :class:`ObjectStore` at ``root/objects`` unless ``store`` hands in a
    shared one.  One writer; any number of readers."""

    def __init__(self, root: str, store: Optional[ObjectStore] = None):
        self.root = root
        os.makedirs(root, exist_ok=True)
        self._store = store or ObjectStore(os.path.join(root, "objects"), create=True)

    # -- version bookkeeping -------------------------------------------------
    def _manifest_path(self, version: int) -> str:
        return os.path.join(self.root, f"manifest-{version:06d}.json")

    def versions(self) -> List[int]:
        """Published (manifest-sealed) versions, ascending.  A manifest
        that does not parse is skipped: one bad file must not take down
        every reader."""
        out = []
        try:
            names = os.listdir(self.root)
        except OSError:
            return []
        for name in names:
            m = _MANIFEST_RE.match(name)
            if not m:
                continue
            try:
                with open(os.path.join(self.root, name)) as f:
                    json.load(f)
            except (OSError, ValueError):
                continue
            out.append(int(m.group(1)))
        return sorted(out)

    def latest_version(self) -> Optional[int]:
        vs = self.versions()
        return vs[-1] if vs else None

    def manifest(self, version: int) -> Dict[str, Any]:
        try:
            with open(self._manifest_path(version)) as f:
                return json.load(f)
        except OSError as e:
            raise KeyError(f"no published version {version}") from e

    # -- publish -------------------------------------------------------------
    def _next_version(self) -> int:
        # monotone over PUBLISHED versions: a torn publish sealed no
        # manifest, so a retry takes its number again
        return (self.latest_version() or 0) + 1

    def publish(self, params: Dict[str, Any], *,
                metadata: Optional[Dict[str, Any]] = None,
                probe: Optional[Dict[str, Any]] = None) -> int:
        """Publish a full weight tree (a Flax-style tree of numpy arrays,
        or the port's state dict); returns the new version id.

        Every tensor object is put (and sealed) FIRST, the manifest naming
        them is renamed into place LAST.  Fault hooks (site
        ``weights.publish``, keyed by tensor path, then ``manifest``):
        ``kill`` aborts before the manifest (:class:`TornPublishError`),
        ``corrupt`` flips a tensor's VALUES before checksumming (it loads
        cleanly and decodes wrong: the canary gate's quarry), ``delay``
        stalls in place."""
        return self._publish_kind(_as_tree(params), kind="full", metadata=metadata, probe=probe)

    def publish_adapter(self, name: str, a, b, *,
                        metadata: Optional[Dict[str, Any]] = None,
                        probe: Optional[Dict[str, Any]] = None) -> int:
        """Publish one tenant's LoRA head delta (``a`` ``[d, r]``, ``b``
        ``[r, V]``) as an adapter version, under the same discipline."""
        return self._publish_kind(
            {"a": np.asarray(a, np.float32), "b": np.asarray(b, np.float32)},
            kind="adapter", metadata={**(metadata or {}), "adapter": str(name)}, probe=probe)

    def _publish_kind(self, tree, *, kind, metadata, probe) -> int:
        version = self._next_version()
        tensors = []
        for i, (path, leaf) in enumerate(_flatten(tree)):
            arr = np.asarray(leaf)
            if _faults.enabled():
                spec = _faults.perturb("weights.publish", key=path)
                if spec is not None and spec.action == "kill":
                    raise TornPublishError(
                        f"airfault: publisher killed before shard {i} ({path}) of "
                        f"{kind} version {version}; no manifest written")
                if spec is not None and spec.action == "corrupt":
                    # bad VALUES under a valid checksum: a sign flip and a
                    # shift survive every dtype and change greedy argmaxes
                    arr = (arr * -1 + 1).astype(arr.dtype)
            oid = f"w{version:06d}-{i:04d}"
            tensors.append({
                "path": path,
                "object_id": oid,
                "shape": list(arr.shape),
                "dtype": str(arr.dtype),
                "crc32": zlib.crc32(np.ascontiguousarray(arr).tobytes()),
            })
            # a torn predecessor's orphan goes first: objects are immutable,
            # so a put over a live id would keep the old bytes
            self._store.delete(oid)
            self._store.put(arr, oid)  # aircrash: data weights-manifest
        manifest = {
            "version": version,
            "kind": kind,
            "tensors": tensors,
            "metadata": dict(metadata or {}),
            "probe": probe,
            "created_at": time.time(),
        }
        if _faults.enabled():
            _faults.perturb("weights.publish", key="manifest")
        self._write_manifest(version, manifest)
        return version

    def _write_manifest(self, version: int, manifest: Dict[str, Any]) -> None:
        path = self._manifest_path(version)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(manifest, f, sort_keys=True)
            f.flush()
            os.fsync(f.fileno())
        # aircrash: commits weights-manifest
        os.rename(tmp, path)  # written LAST: every object put precedes it

    # -- restore -------------------------------------------------------------
    def load(self, version: Optional[int] = None) -> Dict[str, Any]:
        """A version's tensors as a nested dict of numpy arrays, every read
        checked against the manifest (shape, dtype, crc32)."""
        if version is None:
            version = self.latest_version()
            if version is None:
                raise KeyError(f"weight store {self.root} has no published versions")
        man = self.manifest(version)
        pairs = []
        for t in man["tensors"]:
            try:
                arr = np.asarray(self._store.get(t["object_id"], timeout=10.0))
            except TimeoutError as e:
                raise WeightsIntegrityError(
                    f"version {version}: shard {t['object_id']} ({t['path']}) missing "
                    "from the object store") from e
            if list(arr.shape) != list(t["shape"]) or str(arr.dtype) != t["dtype"]:
                raise WeightsIntegrityError(
                    f"version {version}: shard {t['path']} is {arr.dtype}{list(arr.shape)}, "
                    f"manifest says {t['dtype']}{t['shape']}")
            crc = zlib.crc32(np.ascontiguousarray(arr).tobytes())
            if crc != int(t["crc32"]):
                raise WeightsIntegrityError(
                    f"version {version}: shard {t['path']} crc32 {crc:#x} != manifest "
                    f"{int(t['crc32']):#x}")
            pairs.append((t["path"], arr))
        return _unflatten(pairs)

    def load_adapter(self, version: int) -> Tuple[str, np.ndarray, np.ndarray]:
        """An adapter version: ``(tenant_name, a, b)``."""
        man = self.manifest(version)
        if man.get("kind") != "adapter":
            raise ValueError(f"version {version} is kind {man.get('kind')!r}, not an adapter")
        tree = self.load(version)
        return str(man["metadata"]["adapter"]), tree["a"], tree["b"]

    # -- retention -----------------------------------------------------------
    def gc(self, keep: int = 2) -> List[int]:
        """Delete all but the newest ``keep`` FULL versions (objects and
        manifests; adapter versions are evicted through the controller, not
        by retention).  Returns the versions removed."""
        full = [v for v in self.versions() if self.manifest(v).get("kind") == "full"]
        doomed = full[:-keep] if keep > 0 else full
        for v in doomed:
            try:
                man = self.manifest(v)
            except KeyError:
                continue
            for t in man.get("tensors", ()):
                try:
                    self._store.delete(t["object_id"])
                except OSError:
                    pass
            try:
                os.remove(self._manifest_path(v))
            except OSError:
                pass
        return doomed


# ---------------------------------------------------------------------------
# greedy probes
# ---------------------------------------------------------------------------

def probe_fingerprint(token_lists: Sequence[Sequence[int]]) -> str:
    """Canonical sha256 over a probe's greedy outputs."""
    canon = json.dumps([[int(t) for t in seq] for seq in token_lists], separators=(",", ":"))
    return hashlib.sha256(canon.encode()).hexdigest()


def _prefill(model, prompt: Sequence[int], total: int):
    """One cached forward over ``prompt`` (a fresh cache of ``total``
    positions): the last position's f32 hidden state and the cache."""
    from tpu_air_torch.models.lm.generate import init_cache

    dev = model.device
    ids = torch.tensor([[int(t) for t in prompt]], dtype=torch.long, device=dev)
    cache = init_cache(model, 1, total)
    hidden = model(ids, torch.arange(ids.shape[1], device=dev)[None], return_hidden=True,
                   decode=True, cache=cache)
    return hidden[0, -1].float(), cache


def offline_greedy(model, prompt: Sequence[int], max_new: int,
                   adapter_a=None, adapter_b=None) -> List[int]:
    """Reference greedy decode of the port's model, one token per forward:
    the loop probe fingerprints are pinned with, apart from the engine.
    Emits EOS (the model config's) inclusive, then stops, as an engine
    stream does.  ``adapter_a``/``adapter_b`` apply a LoRA head delta
    ``logits += (h @ a) @ b`` in f32."""
    from tpu_air_torch.models.lm.modeling import head_weight

    prompt = [int(t) for t in prompt]
    dev = model.device
    eos = model.config.eos_token_id
    with torch.inference_mode():
        head_w = head_weight(model).float()
        a = None if adapter_a is None else torch.as_tensor(
            np.asarray(adapter_a, np.float32)).to(dev)
        b = None if adapter_b is None else torch.as_tensor(
            np.asarray(adapter_b, np.float32)).to(dev)

        def pick(h):
            logits = h @ head_w
            if a is not None:
                logits = logits + (h @ a) @ b
            return int(torch.argmax(logits))

        h, cache = _prefill(model, prompt, len(prompt) + max_new)
        tok = pick(h)
        out, pos = [tok], len(prompt)
        while len(out) < max_new and (eos is None or tok != eos):
            hidden = model(torch.tensor([[tok]], device=dev), torch.tensor([[pos]], device=dev),
                           return_hidden=True, decode=True, cache=cache)
            pos += 1
            tok = pick(hidden[0, -1].float())
            out.append(tok)
    return out


def probe_logits(model, prompts: Sequence[Sequence[int]]) -> List[List[float]]:
    """Last-prompt-position f32 logits per probe prompt: the surface of the
    tolerance gate (for quantized bases, where exact greedy tokens are too
    strict)."""
    from tpu_air_torch.models.lm.modeling import head_weight

    out = []
    with torch.inference_mode():
        head_w = head_weight(model).float()
        for prompt in prompts:
            h, _ = _prefill(model, prompt, len(prompt))
            out.append([float(x) for x in (h @ head_w).cpu().numpy()])
    return out


def compute_probe(model, prompts: Sequence[Sequence[int]], max_new: int = 8, *,
                  adapter_a=None, adapter_b=None, with_logits: bool = False,
                  logit_tolerance: Optional[float] = None) -> Dict[str, Any]:
    """Pin a probe for a publish: the fixed prompts decoded greedily by
    ``model`` (which holds the candidate weights) and their fingerprint.
    The canary gate replays the prompts through the SERVING engine and
    requires the same fingerprint, or, with ``with_logits`` and
    ``logit_tolerance``, last-position logits within the tolerance."""
    toks = [offline_greedy(model, p, max_new, adapter_a=adapter_a, adapter_b=adapter_b)
            for p in prompts]
    probe: Dict[str, Any] = {
        "prompts": [[int(t) for t in p] for p in prompts],
        "max_new": int(max_new),
        "tokens": [[int(t) for t in seq] for seq in toks],
        "fingerprint": probe_fingerprint(toks),
    }
    if with_logits:
        probe["logits"] = probe_logits(model, probe["prompts"])
        probe["logit_tolerance"] = None if logit_tolerance is None else float(logit_tolerance)
    return probe


# ---------------------------------------------------------------------------
# the canary controller
# ---------------------------------------------------------------------------

class WeightsController:
    """Health-gated promotion of store versions onto a serving fleet.

    ``promote(version)`` drives the canary state machine::

        idle -> canary(swap replica 0) -> probe gate -> soak
             -> promote(rest of fleet) -> serving
                      \\-- any failure --> rollback(canary) -> idle

    Gate knobs: ``soak_s`` (how long the canary serves before the fleet
    follows), ``soak_poll_s``, ``probe_timeout_s`` (per-probe engine
    budget).  The probe rides in the version's manifest
    (``WeightStore.publish(..., probe=compute_probe(...))``); a version
    published without one passes a liveness-only gate (the prompts must
    merely decode) when ``probe_prompts`` is set, else goes straight to the
    soak."""

    def __init__(self, handle, store_root: str, *,
                 probe_prompts: Optional[Sequence[Sequence[int]]] = None,
                 probe_max_new: int = 8,
                 soak_s: float = 0.5,
                 soak_poll_s: float = 0.05,
                 probe_timeout_s: float = 60.0):
        self._handle = handle
        self.store = WeightStore(store_root)
        self._probe_prompts = ([[int(t) for t in p] for p in probe_prompts]
                               if probe_prompts else None)
        self._probe_max_new = int(probe_max_new)
        self.soak_s = float(soak_s)
        self.soak_poll_s = float(soak_poll_s)
        self.probe_timeout_s = float(probe_timeout_s)
        self._lock = threading.Lock()
        self._state = "idle"
        self._current_version: Optional[int] = None
        self._promotions = 0
        self._rollbacks = 0
        self._gate_failures: Dict[str, int] = {}
        self._last_error: Optional[str] = None
        self._last_stall_ms = 0.0

    # -- replica RPC plumbing ------------------------------------------------
    def _replicas(self) -> list:
        with self._handle._lock:
            return list(self._handle._replicas)

    @staticmethod
    def _call(replica, method: str, *args, **kwargs):
        from tpu_air_torch.core import api as core_api

        return core_api.get(replica.handle.remote(method, tuple(args), dict(kwargs)))

    def _set_state(self, state: str) -> None:
        with self._lock:
            self._state = state

    def _record_gate_failure(self, reason: str, err: str) -> None:
        with self._lock:
            self._gate_failures[reason] = self._gate_failures.get(reason, 0) + 1
            self._last_error = err
            self._state = "idle"

    # -- the gate ------------------------------------------------------------
    def _probe_gate(self, replica, man: Dict[str, Any],
                    adapter_id: Optional[str] = None) -> None:
        probe = (man or {}).get("probe")
        prompts = (probe or {}).get("prompts") or self._probe_prompts
        if not prompts:
            return  # nothing pinned and no liveness prompts configured
        max_new = int((probe or {}).get("max_new", self._probe_max_new))
        toks = self._call(replica, "weights_probe", prompts, max_new,
                          adapter_id=adapter_id, timeout_s=self.probe_timeout_s)
        if probe is None:
            return  # liveness only: the prompts decoded without error
        tol = probe.get("logit_tolerance")
        if probe.get("logits") is not None and tol is not None:
            got = self._call(replica, "weights_probe_logits", prompts)
            worst = 0.0
            for g, want in zip(got, probe["logits"]):
                worst = max(worst, max(abs(float(x) - float(y)) for x, y in zip(g, want)))
            if worst > float(tol):
                raise GateFailedError(f"probe logits drifted {worst:.3e} > tolerance {tol}")
            return
        got_fp = probe_fingerprint(toks)
        if got_fp != probe["fingerprint"]:
            raise GateFailedError(f"probe fingerprint mismatch: canary {got_fp[:12]} != "
                                  f"pinned {probe['fingerprint'][:12]}")

    def _soak_gate(self) -> None:
        """The canary serves for ``soak_s`` before the fleet follows.  The
        port has no SLO burn monitor (ROADMAP Queue 1 item 10), so the soak
        is time-only, as the JAX package's is with none installed."""
        deadline = time.monotonic() + self.soak_s
        while time.monotonic() < deadline:
            time.sleep(self.soak_poll_s)

    # -- promotion -----------------------------------------------------------
    def promote(self, version: Optional[int] = None) -> Dict[str, Any]:
        """Canary-promote a store version across the fleet.  Returns a
        result dict (``promoted`` bool, ``version``, ``reason`` on
        failure); raises only on misuse (no replicas, no versions)."""
        if version is None:
            version = self.store.latest_version()
            if version is None:
                raise KeyError(f"weight store {self.store.root} has no versions")
        man = self.store.manifest(version)
        replicas = self._replicas()
        if not replicas:
            raise RuntimeError("no live replicas to promote onto")
        if man.get("kind") == "adapter":
            return self._promote_adapter(version, man, replicas)
        return self._promote_full(version, man, replicas)

    def _promote_full(self, version: int, man: Dict[str, Any],
                      replicas: list) -> Dict[str, Any]:
        canary, rest = replicas[0], replicas[1:]
        self._set_state("canary")
        try:
            stall = self._call(canary, "weights_swap", self.store.root, version)
            self._set_state("soaking")
            self._probe_gate(canary, man)
            self._soak_gate()
        except Exception as e:  # noqa: BLE001 — every gate failure rolls back
            reason = "probe" if isinstance(e, GateFailedError) else "swap_failed"
            try:
                self._call(canary, "weights_rollback")
            except Exception:  # noqa: BLE001 — the replica may be gone; its
                pass           # restart rebuilds it from its checkpoint
            with self._lock:
                self._rollbacks += 1
            self._record_gate_failure(reason, f"v{version}: {e}")
            return {"promoted": False, "version": version, "reason": str(e)}
        self._set_state("promoting")
        stalls = [stall]
        for replica in rest:
            try:
                stalls.append(self._call(replica, "weights_swap", self.store.root, version))
            except Exception as e:  # noqa: BLE001 — a dead replica's restart
                # rebuilds it; surface the failure, don't fail the promotion
                with self._lock:
                    self._last_error = f"fleet swap on {replica._actor_id}: {e}"
        with self._lock:
            self._state = "serving"
            self._current_version = version
            self._promotions += 1
            self._last_stall_ms = max(float(s) for s in stalls)
        return {"promoted": True, "version": version,
                "max_stall_ms": max(float(s) for s in stalls)}

    def _promote_adapter(self, version: int, man: Dict[str, Any],
                         replicas: list) -> Dict[str, Any]:
        """Adapter sub-swap under the same gate: load on the canary, probe
        UNDER the adapter, soak, then load fleet-wide.  Rollback is an
        unload: the shared base was never touched."""
        name, a, b = self.store.load_adapter(version)
        canary, rest = replicas[0], replicas[1:]
        self._set_state("canary")
        try:
            self._call(canary, "weights_load_adapter", name, np.asarray(a), np.asarray(b))
            self._set_state("soaking")
            self._probe_gate(canary, man, adapter_id=name)
            self._soak_gate()
        except Exception as e:  # noqa: BLE001 — same rollback contract
            try:
                self._call(canary, "weights_unload_adapter", name)
            except Exception:  # noqa: BLE001 — best-effort unload
                pass
            with self._lock:
                self._rollbacks += 1
            self._record_gate_failure("adapter", f"adapter v{version}: {e}")
            return {"promoted": False, "version": version, "adapter": name, "reason": str(e)}
        self._set_state("promoting")
        for replica in rest:
            try:
                self._call(replica, "weights_load_adapter", name, np.asarray(a), np.asarray(b))
            except Exception as e:  # noqa: BLE001 — surface, don't fail
                with self._lock:
                    self._last_error = f"adapter load on {replica._actor_id}: {e}"
        with self._lock:
            self._state = "serving"
            self._promotions += 1
        return {"promoted": True, "version": version, "adapter": name}

    def evict_adapter(self, name: str) -> int:
        """Unload a tenant adapter fleet-wide; returns the replicas that
        held it."""
        n = 0
        for replica in self._replicas():
            try:
                if self._call(replica, "weights_unload_adapter", name):
                    n += 1
            except Exception:  # noqa: BLE001 — the replica may be mid-restart
                continue
        return n

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "state": self._state,
                "current_version": self._current_version,
                "latest_published": self.store.latest_version(),
                "promotions": self._promotions,
                "rollbacks": self._rollbacks,
                "gate_failures": dict(self._gate_failures),
                "last_error": self._last_error,
                "last_stall_ms": self._last_stall_ms,
            }


# ---------------------------------------------------------------------------
# registry (the /-/stats "weights" section)
# ---------------------------------------------------------------------------

_controllers: Dict[str, WeightsController] = {}
_controllers_lock = threading.Lock()


def install_controller(route_prefix: str, ctl: WeightsController) -> WeightsController:
    with _controllers_lock:
        _controllers[route_prefix] = ctl
    return ctl


def uninstall_controller(route_prefix: str) -> None:
    with _controllers_lock:
        _controllers.pop(route_prefix, None)


def controller_stats() -> Dict[str, Any]:
    with _controllers_lock:
        ctls = dict(_controllers)
    return {prefix: ctl.stats() for prefix, ctl in ctls.items()}


def attach_weights(route_prefix: str, store_root: str, **gate_kw: Any) -> WeightsController:
    """Bind a :class:`WeightsController` to a deployed route: looks the
    route's handle up in the running proxy and registers the controller,
    so its state shows under ``/-/stats`` -> ``weights``."""
    from tpu_air_torch.serve import proxy as _proxy

    with _proxy._state.lock:
        handle = _proxy._state.routes.get(route_prefix)
    if handle is None:
        raise KeyError(f"no deployment at route {route_prefix!r}")
    return install_controller(route_prefix, WeightsController(handle, store_root, **gate_kw))
