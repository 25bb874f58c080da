"""HTTP body adapters: raw request bytes → the replica's input type.  Copied from
``tpu_air/serve/http_adapters.py`` (the port imports nothing of ``tpu_air``).

The reference uses ``ray.serve.http_adapters.pandas_read_json``
(Introduction_to_Ray_AI_Runtime.ipynb:cc-70-71) so clients can POST a list of
row dicts and the Predictor receives a DataFrame.
"""

from __future__ import annotations

import json
from typing import Any


def json_request(body: bytes) -> Any:
    """Parse the request body as JSON, passed through unchanged."""
    return json.loads(body) if body else None


def pandas_read_json(body: bytes):
    """JSON list-of-rows (or dict-of-columns) → pandas DataFrame."""
    import io

    import pandas as pd

    obj = json.loads(body)
    if isinstance(obj, dict):
        # single record or column-oriented dict
        if all(not isinstance(v, (list, dict)) for v in obj.values()):
            return pd.DataFrame([obj])
        return pd.DataFrame(obj)
    return pd.read_json(io.StringIO(json.dumps(obj)), orient="records")
