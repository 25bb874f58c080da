#!/usr/bin/env python3
"""Time the port's decode kernel against other builds of it, in turns, on one card.

    python3 tools/torch_decode_in_turns.py --other parent=DIR [--other NAME=DIR ...]
        [--shapes lm,w3_cross,...] [--dtype bfloat16|float16|float32] [--sweep] [--out FILE]

Each ``DIR`` holds a copy of the port's ``tpu_air_torch/ops`` package (for
example ``git archive <commit> tpu_air_torch/ops`` unpacked into a
git-ignored directory, or a copy with the kernel's constants changed); it is
imported under a name of its own and builds its kernels into the ``_build``
directory beside it.  At every shape the same cold input sets (cycled
through ``chip_smoke.COLD_BYTES`` of slabs, ``chip_smoke.decode_step_inputs``) go through
this tree's ``decode_attention`` and each other build's, and each build's
device time (``chip_smoke.device_ms``) and host time a call
(``chip_smoke.host_us``) are taken in turns: other, this, this, other.
Each build's output is held against ``decode_attention_reference`` at the
tolerance of ``chip_smoke.TOL``.  Prints one line a shape and build and,
last, a JSON object of every reading beside the card's name and power
limit (written to ``--out`` as well).  ``lm_one_key`` is the LM engine's
grid with one live key a row: its time is the call's fixed cost at that
grid, what is left of ``lm``'s once the bytes are gone.  ``int8_cross`` and
``int8_self`` are 32 (b)'s int8 steps: int8 K/V with per-channel or
per-position scales under a ``--dtype`` query.  ``--sweep`` also
times this tree's kernel at the ``lm``, ``w3_cross``, ``w3_self`` and int8 shapes
with the chunk forced to each cluster size from 1 to 8 (no turns).  Needs a
CUDA card and ``nvcc``.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import sys
import threading
from functools import partial

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from tpu_air_torch.ops import decode_attention as this  # noqa: E402

ITERS = 200          # calls a device-time reading queues
# name: (b, L, h, d, kind); "lm" is the LM engine's step (per-row prefix
# mask), "lm_one_key" its grid with one live key a row, the rest
# chip_smoke's decode_inputs kinds
SHAPES = {
    "lm": (16, 1024, 8, 128, "lm"),
    "lm_one_key": (16, 1024, 8, 128, "lm_one_key"),
    "w3_cross": (64, 512, 12, 64, "cross"),
    "w3_self": (64, 129, 12, 64, "self"),
    "split": (8, 4096, 12, 64, "cross"),
    "b8_cross": (8, 512, 12, 64, "cross"),
    "b8_self33": (8, 33, 12, 64, "self"),
    "b8_self65": (8, 65, 12, 64, "self"),
    "int8_cross": (64, 512, 12, 64, "int8_chan"),
    "int8_self": (64, 33, 12, 64, "int8_pos"),
}


def load_build(name: str, path: str):
    """``decode_attention`` of the ops package at ``path``, imported as
    ``decode_build_<name>``."""
    pkg = f"decode_build_{name}"
    spec = importlib.util.spec_from_file_location(pkg, os.path.join(path, "__init__.py"),
                                                  submodule_search_locations=[path])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[pkg] = mod
    spec.loader.exec_module(mod)
    return importlib.import_module(f"{pkg}.decode_attention")


def build_all(mods) -> None:
    """Compile every build's decode kernel, one nvcc each, all at once."""
    errors = []

    def one(m):
        try:
            m._build.build([m._NAME])
        except RuntimeError as e:  # gathered, then raised once
            errors.append(str(e))

    threads = [threading.Thread(target=one, args=(m,)) for m in mods]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise RuntimeError("\n".join(errors))


def sweep(mod, call, L) -> dict:
    """{cluster size: device ms} of ``call`` with the module's chunk forced
    to each cluster size from 1 to 8 that whole stages allow."""
    saved, out = mod.split_chunk, {}
    try:
        for c in range(1, mod._MAX_CLUSTER + 1):
            chunk = L if c == 1 else -(-(-(-L // c)) // mod._STAGE_POS) * mod._STAGE_POS
            if -(-L // chunk) != c:
                continue
            mod.split_chunk = lambda *_, chunk=chunk: chunk
            out[c] = cs.device_ms(call, ITERS)
    finally:
        mod.split_chunk = saved
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", action="append", default=[], metavar="NAME=DIR",
                    help="another build's ops package directory")
    ap.add_argument("--shapes", default=",".join(SHAPES))
    ap.add_argument("--dtype", default="bfloat16", choices=("bfloat16", "float16", "float32"))
    ap.add_argument("--sweep", action="store_true",
                    help="time this tree's kernel at every cluster size too")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_decode_in_turns: no CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    dtype = getattr(torch, args.dtype)
    builds = {"this": this}
    for spec in args.other:
        name, path = spec.split("=", 1)
        builds[name] = load_build(name, os.path.abspath(path))
    build_all(builds.values())
    card = cs.card_line()
    print(f"[turns] card: {card}; builds: {list(builds)}; {args.dtype}", flush=True)
    out = {"card": card, "dtype": args.dtype, "shapes": {}}
    for key in args.shapes.split(","):
        shape = SHAPES[key]
        # the LM engine's mask as [lm serve] (f) draws it
        rng = np.random.default_rng(cs.SEED + (44 if key == "lm" else 60))
        sets, nbytes, flops = cs.decode_step_inputs(rng, *shape[:4], dtype, dev, shape[4])
        q, k, v, kw = sets[0]
        # bf16/f16 K/V at the tensor cores' rate, as [timing] states it; f32
        # and int8 at the f32 rate, as 32 (b) does
        b_ms, b_by = cs.bound_ms(nbytes, flops, cs.PEAK_BF16_FLOP_S if k.element_size() == 2
                                 else cs.PEAK_F32_FLOP_S)
        want = this.decode_attention_reference(q, k, v, **kw)
        b, L, h, d, _ = shape
        row = {"shape": shape, "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes,
               "chunk": this.plan_chunk(b, h, d, L, k.dtype,
                                        torch.cuda.get_device_properties(dev).multi_processor_count,
                                        "kv_mask" in kw),
               "builds": {}}
        calls = {n: cs.cycled([partial(m.decode_attention, *s[:3], **s[3]) for s in sets])
                 for n, m in builds.items()}
        for n, m in builds.items():
            err = cs.scaled_err(m.decode_attention(q, k, v, **kw), want)
            if not err < cs.TOL[dtype]:
                raise AssertionError(f"[turns] {n} at {key}: {err} >= {cs.TOL[dtype]}")
            row["builds"][n] = {"err": err, "ms": [], "host_us": []}
        others = [n for n in builds if n != "this"] or ["this"]
        for other in others:
            for n in (other, "this", "this", other) if other != "this" else ("this",):
                r = row["builds"][n]
                r["ms"].append(cs.device_ms(calls[n], ITERS))
                r["host_us"].append(cs.host_us(calls[n]))
        for n, r in row["builds"].items():
            print(f"[turns] {key} {shape}: {n} {np.mean(r['ms']):.4f} ms ({', '.join(f'{x:.4f}' for x in r['ms'])}), "
                  f"host {np.mean(r['host_us']):.1f} us/call, err {r['err']:.2e}; bound "
                  f"{b_ms:.4f} ms by {b_by}, chunk {row['chunk']}", flush=True)
        if args.sweep and key in ("lm", "w3_cross", "w3_self", "int8_cross", "int8_self"):
            row["by_cluster"] = sweep(this, calls["this"], L)
            print(f"[turns] {key}: this tree by cluster size "
                  + ", ".join(f"{c} {ms:.4f} ms" for c, ms in row["by_cluster"].items()), flush=True)
        out["shapes"][key] = row
        del sets, calls, q, k, v, kw, want
        torch.cuda.empty_cache()
    line = json.dumps(out)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
