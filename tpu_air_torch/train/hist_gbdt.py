"""Histogram-based gradient-boosted trees with allreduce-merged statistics.

The reference's ``XGBoostTrainer`` (Introduction_to_Ray_AI_Runtime.ipynb:cc-32)
trains xgboost with ``tree_method="approx"``: every rank holds its row shard,
per-node gradient/hessian HISTOGRAMS are allreduced through rabit, and all
ranks grow the SAME tree on the merged (global) statistics.  This module is
that algorithm over the host-side collectives facade (SURVEY.md §2D); this
module is the port's copy of ``tpu_air/train/hist_gbdt.py``, numpy only:

* quantile bin edges are built from rank-local candidate quantiles merged by
  weighted pooling (the quantile-sketch-merge analog — like xgboost's approx
  sketch, the edges depend slightly on the sharding, but are identical on
  every rank);
* per boosting round a tree grows depth-wise: each depth's
  (node, feature, bin) gradient/hessian/count histograms are summed over
  local rows, allreduced, and the identical merged histograms drive the
  identical split choice on every rank — so after every round **all ranks
  hold bit-identical trees** (rabit semantics; asserted by
  tests/test_train.py and tests/test_torch_gbdt.py), unlike bagging where each rank's model differs;
* split gain and leaf values use the standard second-order formulas
  (gain = GL^2/(HL+lambda) + GR^2/(HR+lambda) - G^2/(H+lambda),
  leaf = -eta * G/(H+lambda)).

Objectives: ``binary:logistic`` (grad = p - y, hess = p(1-p)) and
``reg:squarederror`` (grad = pred - y, hess = 1).  Single-process training is
the world_size=1 special case of the same code path, so metrics no longer
shift in kind between ``num_workers=1`` and ``num_workers=N``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import numpy as np


def _sigmoid(x):
    out = np.empty_like(x)
    pos = x >= 0
    out[pos] = 1.0 / (1.0 + np.exp(-x[pos]))
    ex = np.exp(x[~pos])
    out[~pos] = ex / (1.0 + ex)
    return out


class _NoComm:
    """world_size=1: allreduce is the identity."""

    rank = 0
    world = 1

    def allreduce_sum(self, arr: np.ndarray, tag: str) -> np.ndarray:
        return arr

    def allgather(self, obj: Any, tag: str) -> List[Any]:
        return [obj]


class CollectivesComm:
    """Adapter over tpu_air_torch.parallel.collectives for the worker actors."""

    def __init__(self, rank: int, world: int, namespace: str,
                 timeout: float = 3600.0):
        self.rank = rank
        self.world = world
        self.namespace = namespace
        self.timeout = timeout
        self._seq = 0
        self._names: List[str] = []

    def _name(self, tag: str) -> str:
        self._seq += 1
        name = f"{self.namespace}-{tag}-{self._seq}"
        self._names.append(name)
        return name

    def drain_store_keys(self) -> List[str]:
        """Store keys of completed collectives (safe to delete once every
        rank has returned from the calls — the facade has no auto-cleanup)."""
        keys = [f"ar-{n}-{r}" for n in self._names for r in range(self.world)]
        self._names.clear()
        return keys

    def allreduce_sum(self, arr: np.ndarray, tag: str) -> np.ndarray:
        from tpu_air_torch.parallel.collectives import allreduce

        # reduce_fn sees the rank-ordered list on every rank -> the summed
        # array is bit-identical everywhere (the determinism the tree
        # growth relies on)
        return allreduce(
            np.asarray(arr), name=self._name(tag), rank=self.rank,
            world_size=self.world,
            reduce_fn=lambda vals: np.sum(np.stack(vals, axis=0), axis=0),
            timeout=self.timeout,
        )

    def allgather(self, obj: Any, tag: str) -> List[Any]:
        from tpu_air_torch.parallel.collectives import allreduce

        return allreduce(
            obj, name=self._name(tag), rank=self.rank,
            world_size=self.world, reduce_fn=list, timeout=self.timeout,
        )


class HistGBDT:
    """The merged-histogram booster.  Scoring API matches what
    ``GBDTPredictor`` expects (``predict`` / ``predict_proba``)."""

    def __init__(
        self,
        objective: str = "binary:logistic",
        eta: float = 0.3,
        max_depth: int = 6,
        min_child_weight: float = 1.0,
        reg_lambda: float = 1.0,
        max_bins: int = 256,
    ):
        self.objective = objective
        self.is_classif = "logistic" in objective or "binary" in objective
        self.eta = float(eta)
        self.max_depth = int(max_depth)
        self.min_child_weight = float(min_child_weight)
        self.reg_lambda = float(reg_lambda)
        self.max_bins = int(max_bins)
        self.trees: List[Dict[str, np.ndarray]] = []
        self._edges: Optional[List[np.ndarray]] = None  # per-feature cut values
        # training state (rank-local; dropped on checkpointing via __getstate__
        # staying intact — state is plain numpy, picklable, but only trees and
        # edges are needed to score)
        self._Xb = None
        self._g = None
        self._margin = None
        self._y = None
        self._comm = _NoComm()

    # -- setup ---------------------------------------------------------------
    def setup(self, X: np.ndarray, y: np.ndarray, comm=None) -> None:
        """Bind the rank-local shard and build the (merged) bin edges."""
        self._comm = comm or _NoComm()
        X = np.asarray(X, dtype=np.float64)
        self._y = np.asarray(y, dtype=np.float64)
        self._edges = self._build_edges(X)
        self._Xb = self._digitize(X)
        self._margin = np.zeros(len(X), dtype=np.float64)

    def _build_edges(self, X: np.ndarray) -> List[np.ndarray]:
        grid = np.linspace(0.0, 1.0, self.max_bins + 1)[1:-1]
        local = [
            (np.quantile(X[:, j], grid) if len(X) else np.zeros(0))
            for j in range(X.shape[1])
        ]
        gathered = self._comm.allgather(
            {"cands": local, "n": len(X)}, "bin-edges"
        )
        edges: List[np.ndarray] = []
        for j in range(X.shape[1]):
            vals, wts = [], []
            for part in gathered:
                c = np.asarray(part["cands"][j], dtype=np.float64)
                if len(c) == 0:
                    continue
                vals.append(c)
                wts.append(np.full(len(c), part["n"] / len(c)))
            if not vals:
                edges.append(np.zeros(0))
                continue
            v = np.concatenate(vals)
            w = np.concatenate(wts)
            order = np.argsort(v, kind="stable")
            v, w = v[order], w[order]
            cum = np.cumsum(w)
            targets = np.linspace(0, cum[-1], self.max_bins + 1)[1:-1]
            picked = v[np.searchsorted(cum, targets, side="left").clip(0, len(v) - 1)]
            edges.append(np.unique(picked))
        return edges

    def _digitize(self, X: np.ndarray) -> np.ndarray:
        Xb = np.empty(X.shape, dtype=np.int32)
        for j, e in enumerate(self._edges):
            # bin b: value <= edges[b] for b < len(e); last bin is the rest.
            Xb[:, j] = np.searchsorted(e, X[:, j], side="left")
        return Xb

    # -- boosting ------------------------------------------------------------
    def _grad_hess(self):
        if self.is_classif:
            p = _sigmoid(self._margin)
            return p - self._y, p * (1.0 - p)
        return self._margin - self._y, np.ones_like(self._margin)

    def fit_one_round(self) -> None:
        """Grow ONE tree on merged histograms and update local margins."""
        g, h = self._grad_hess()
        Xb = self._Xb
        n, F = Xb.shape
        B = self.max_bins
        # tree arrays (preallocated worst case: full binary tree)
        max_nodes = 2 ** (self.max_depth + 1)
        feat = np.full(max_nodes, -1, dtype=np.int32)
        cutb = np.zeros(max_nodes, dtype=np.int32)
        cutv = np.zeros(max_nodes, dtype=np.float64)
        left = np.full(max_nodes, -1, dtype=np.int32)
        right = np.full(max_nodes, -1, dtype=np.int32)
        leaf = np.zeros(max_nodes, dtype=np.float64)
        node_g = np.zeros(max_nodes)
        node_h = np.zeros(max_nodes)
        n_nodes = 1

        pos = np.zeros(n, dtype=np.int32)  # row -> node id
        active = [0]
        first_level = True
        for depth in range(self.max_depth):
            if not active:
                break
            slot = {nid: s for s, nid in enumerate(active)}
            S = len(active)
            # (S, F, B) histograms of grad / hess / count over LOCAL rows
            row_slot = np.full(n, -1, dtype=np.int64)
            for nid, s in slot.items():
                row_slot[pos == nid] = s
            live = row_slot >= 0
            hist = np.zeros((3, S, F, B), dtype=np.float64)
            if live.any():
                rs = row_slot[live]
                gl = g[live]
                hl = h[live]
                for j in range(F):
                    key = rs * B + Xb[live, j]
                    hist[0, :, j, :] += np.bincount(
                        key, weights=gl, minlength=S * B
                    ).reshape(S, B)
                    hist[1, :, j, :] += np.bincount(
                        key, weights=hl, minlength=S * B
                    ).reshape(S, B)
                    hist[2, :, j, :] += np.bincount(
                        key, minlength=S * B
                    ).reshape(S, B)
            # THE rabit analog: merged histograms are identical on all ranks,
            # so the split decisions below are identical on all ranks.
            hist = self._comm.allreduce_sum(hist, f"hist-d{depth}")

            next_active = []
            for nid, s in slot.items():
                G = hist[0, s, 0, :].sum()
                H = hist[1, s, 0, :].sum()
                if first_level:
                    node_g[nid], node_h[nid] = G, H
                best = self._best_split(hist[:, s], G, H)
                if best is None:
                    continue  # stays a leaf
                j, b, GL, HL = best
                l_id, r_id = n_nodes, n_nodes + 1
                n_nodes += 2
                feat[nid], cutb[nid] = j, b
                cutv[nid] = (
                    self._edges[j][b] if b < len(self._edges[j]) else np.inf
                )
                left[nid], right[nid] = l_id, r_id
                node_g[l_id], node_h[l_id] = GL, HL
                node_g[r_id], node_h[r_id] = G - GL, H - HL
                in_node = pos == nid
                go_left = in_node & (Xb[:, j] <= b)
                pos[go_left] = l_id
                pos[in_node & ~go_left] = r_id
                next_active += [l_id, r_id]
            active = next_active
            first_level = False

        internal = left[:n_nodes] >= 0
        leaf[:n_nodes] = np.where(
            internal, 0.0,
            -self.eta * node_g[:n_nodes] / (node_h[:n_nodes] + self.reg_lambda),
        )
        tree = {
            "feat": feat[:n_nodes].copy(), "cutv": cutv[:n_nodes].copy(),
            "cutb": cutb[:n_nodes].copy(), "left": left[:n_nodes].copy(),
            "right": right[:n_nodes].copy(), "leaf": leaf[:n_nodes].copy(),
        }
        self.trees.append(tree)
        # rebind, not in-place: the runtime round-trips actor state through
        # the object store, whose zero-copy reads come back READ-ONLY
        self._margin = self._margin + leaf[pos]

    def _best_split(self, hist_sfb, G, H):
        """Best (feature, bin) by gain over the merged histograms; None when
        no split clears min_child_weight / positive gain.  Deterministic
        tie-break: lowest feature, then lowest bin."""
        lam = self.reg_lambda
        parent = G * G / (H + lam)
        best = None
        best_gain = 1e-12
        for j in range(hist_sfb.shape[1]):
            GL = np.cumsum(hist_sfb[0, j, :-1])
            HL = np.cumsum(hist_sfb[1, j, :-1])
            GR, HR = G - GL, H - HL
            ok = (HL >= self.min_child_weight) & (HR >= self.min_child_weight)
            gain = np.where(
                ok, GL**2 / (HL + lam) + GR**2 / (HR + lam) - parent, -np.inf
            )
            b = int(np.argmax(gain))
            if gain[b] > best_gain:
                best_gain = float(gain[b])
                best = (j, b, float(GL[b]), float(HL[b]))
        return best

    # -- metrics over the CURRENT margins (global via allreduced sums) -------
    def local_metric_sums(self) -> Dict[str, float]:
        if self.is_classif:
            p = _sigmoid(self._margin)
            eps = 1e-7
            pc = np.clip(p, eps, 1 - eps)
            ll = -np.sum(self._y * np.log(pc) + (1 - self._y) * np.log(1 - pc))
            return {
                "n": float(len(self._y)),
                "ll_sum": float(ll),
                "err_sum": float(np.sum((p > 0.5) != self._y)),
            }
        return {
            "n": float(len(self._y)),
            "se_sum": float(np.sum((self._margin - self._y) ** 2)),
        }

    # -- scoring (raw feature values; no training state needed) --------------
    def predict_margin(self, X: np.ndarray) -> np.ndarray:
        X = np.asarray(X, dtype=np.float64)
        out = np.zeros(len(X), dtype=np.float64)
        for t in self.trees:
            node = np.zeros(len(X), dtype=np.int32)
            for _ in range(self.max_depth + 1):
                f = t["feat"][node]
                internal = f >= 0
                if not internal.any():
                    break
                fx = X[np.arange(len(X)), np.maximum(f, 0)]
                go_left = internal & (fx <= t["cutv"][node])
                node = np.where(
                    go_left, t["left"][node],
                    np.where(internal, t["right"][node], node),
                )
            out += t["leaf"][node]
        return out

    def _proba(self, X: np.ndarray) -> np.ndarray:
        p = _sigmoid(self.predict_margin(X))
        return np.stack([1.0 - p, p], axis=1)

    def __getattr__(self, name):
        # predict_proba exists ONLY on classifier boosters, so the
        # hasattr(model, "predict_proba") branch GBDTPredictor takes stays
        # honest for regression boosters
        if name == "predict_proba" and self.__dict__.get("is_classif"):
            return self._proba
        raise AttributeError(name)

    def scoring_copy(self) -> "HistGBDT":
        """A copy carrying only what scoring needs (trees + edges +
        hyperparams) — what checkpoints ship.  NOT ``__getstate__``: the
        runtime pickles live actor instances (and this model inside them)
        through the object store, and silently dropping training state in
        the pickle protocol would corrupt those."""
        m = HistGBDT.__new__(HistGBDT)
        m.__dict__.update({
            k: v for k, v in self.__dict__.items()
            if k not in ("_Xb", "_margin", "_y", "_comm")
        })
        m._Xb = m._margin = m._y = None
        m._comm = _NoComm()
        return m

    def predict(self, X: np.ndarray) -> np.ndarray:
        if self.is_classif:
            return (self.predict_margin(X) > 0.0).astype(np.int64)
        return self.predict_margin(X)

    def signature(self) -> bytes:
        """Stable byte serialization of the booster structure — equal across
        ranks iff the trees are bit-identical (the rabit-semantics test)."""
        import hashlib

        hsh = hashlib.sha256()
        for t in self.trees:
            for k in ("feat", "cutv", "cutb", "left", "right", "leaf"):
                hsh.update(k.encode())
                hsh.update(np.ascontiguousarray(t[k]).tobytes())
        return hsh.digest()
