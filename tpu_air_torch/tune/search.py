"""Search-space primitives, copied from ``tpu_air/tune/search.py`` (numpy
only): the same space and seed give the same trial configs (SURVEY.md §1-L4).

Parity surface: ``tune.choice`` (Model_finetuning…ipynb:cc-57),
``tune.uniform``/``tune.randint`` (Introduction_to_Ray_AI_Runtime.ipynb:cc-45),
plus the standard companions (loguniform/quniform/grid_search) so user sweeps
don't hit a wall one symbol past the reference.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np


class Domain:
    """A sampleable hyperparameter domain."""

    def sample(self, rng: np.random.Generator) -> Any:
        raise NotImplementedError


class Categorical(Domain):
    def __init__(self, categories: Sequence[Any]):
        if not categories:
            raise ValueError("choice() requires a non-empty sequence")
        self.categories = list(categories)

    def sample(self, rng):
        return self.categories[int(rng.integers(0, len(self.categories)))]

    def __repr__(self):
        return f"choice({self.categories})"


class Float(Domain):
    def __init__(self, lower: float, upper: float, log: bool = False, q: float = 0):
        if upper <= lower:
            raise ValueError("upper must be > lower")
        if log and lower <= 0:
            raise ValueError("loguniform requires lower > 0")
        self.lower, self.upper, self.log, self.q = lower, upper, log, q

    def sample(self, rng):
        if self.log:
            v = math.exp(rng.uniform(math.log(self.lower), math.log(self.upper)))
        else:
            v = rng.uniform(self.lower, self.upper)
        if self.q:
            v = min(self.upper, max(self.lower, round(v / self.q) * self.q))
        return float(v)

    def __repr__(self):
        kind = "loguniform" if self.log else "uniform"
        return f"{kind}({self.lower}, {self.upper})"


class Integer(Domain):
    def __init__(self, lower: int, upper: int):
        if upper <= lower:
            raise ValueError("upper must be > lower")
        self.lower, self.upper = lower, upper

    def sample(self, rng):
        return int(rng.integers(self.lower, self.upper))

    def __repr__(self):
        return f"randint({self.lower}, {self.upper})"


class GridSearch:
    """Marker for exhaustive grid axes (expanded, not sampled)."""

    def __init__(self, values: Sequence[Any]):
        self.values = list(values)

    def __repr__(self):
        return f"grid_search({self.values})"


class SampleFrom:
    """Marker for a user-supplied sampler fn (``tune.sample_from``); plain
    callables in a config are passed through untouched."""

    def __init__(self, fn):
        self.fn = fn

    def __repr__(self):
        return f"sample_from({self.fn!r})"


def choice(categories: Sequence[Any]) -> Categorical:
    return Categorical(categories)


def uniform(lower: float, upper: float) -> Float:
    return Float(lower, upper)


def loguniform(lower: float, upper: float) -> Float:
    return Float(lower, upper, log=True)


def quniform(lower: float, upper: float, q: float) -> Float:
    return Float(lower, upper, q=q)


def randint(lower: int, upper: int) -> Integer:
    return Integer(lower, upper)


def grid_search(values: Sequence[Any]) -> GridSearch:
    return GridSearch(values)


def sample_from(fn) -> SampleFrom:
    return SampleFrom(fn)


def _grid_axes(space: Dict[str, Any], prefix: Tuple = ()) -> List[Tuple[Tuple, List[Any]]]:
    axes = []
    for k, v in space.items():
        if isinstance(v, GridSearch):
            axes.append((prefix + (k,), v.values))
        elif isinstance(v, dict):
            axes.extend(_grid_axes(v, prefix + (k,)))
    return axes


def _set_path(d: Dict[str, Any], path: Tuple, value: Any) -> None:
    for k in path[:-1]:
        d = d[k]
    d[path[-1]] = value


def sample_space(space: Dict[str, Any], rng: np.random.Generator) -> Dict[str, Any]:
    """One concrete config: Domains sampled, dicts recursed, literals kept.
    GridSearch leaves must be resolved by the caller (expand_grid)."""
    out: Dict[str, Any] = {}
    for k, v in space.items():
        if isinstance(v, Domain):
            out[k] = v.sample(rng)
        elif isinstance(v, dict):
            out[k] = sample_space(v, rng)
        elif isinstance(v, GridSearch):
            raise ValueError("grid_search must be expanded before sampling")
        elif isinstance(v, SampleFrom):
            out[k] = v.fn(out)  # sees previously-resolved keys (spec dict)
        else:
            out[k] = v  # literals — including callables — pass through
    return out


def expand_grid(space: Dict[str, Any]) -> List[Dict[str, Any]]:
    """Expand grid_search axes into the cross-product of sub-spaces (each
    still containing Domains for sample_space)."""
    import copy
    import itertools

    axes = _grid_axes(space)
    if not axes:
        return [space]
    out = []
    for combo in itertools.product(*(vals for _, vals in axes)):
        s = copy.deepcopy(space)
        for (path, _), val in zip(axes, combo):
            _set_path(s, path, val)
        out.append(s)
    return out
