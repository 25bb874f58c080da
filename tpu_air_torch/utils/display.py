"""Display helpers (reference: NLP_workloads/Text_generation/utils.py:7-27),
copied from ``tpu_air/utils/display.py``: the port imports nothing of
``tpu_air``."""

from __future__ import annotations

import random
from typing import Optional

import pandas as pd


def get_random_elements(dataset, num_examples: int = 2, seed: Optional[int] = None):
    """Sample ``num_examples`` random rows into a DataFrame; raises if
    over-sampling (same contract as the reference helper)."""
    try:
        n = dataset.count()
        rows = dataset.take_all()
    except AttributeError:
        rows = list(dataset)
        n = len(rows)
    if num_examples > n:
        raise ValueError(
            f"Can't pick {num_examples} elements from a dataset of size {n}"
        )
    rng = random.Random(seed)
    picks = rng.sample(range(n), num_examples)
    return pd.DataFrame([rows[i] for i in picks])
