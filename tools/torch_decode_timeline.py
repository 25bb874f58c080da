#!/usr/bin/env python3
"""Where one decode call's time goes, block by block, on one card.

    python3 tools/torch_decode_timeline.py [--shapes int8_cross,w3_cross,...]
        [--out FILE]

Copies this tree's ``tpu_air_torch/ops`` into ``tpu_air_torch/_build/
timeline_ops`` (git-ignored), inserts ``%globaltimer`` stamps into the copy
of ``decode_ring_kernel`` and a C entry that reads them back, builds it, and
times one call at each shape (inputs from ``chip_smoke.decode_step_inputs``,
each set called once first; the call queued behind a sleep kernel).  Thread
0 of each block stamps its start, the end of its mask pass, warp 0's first
unit in shared memory, the end of warp 0's walk, the end of the block's
merge barrier and its last store, with its SM and warp 0's count of units.
Prints, per shape, the call's span and the median and largest time of each
part over the blocks, and the slowest block's stamps; the JSON of every
shape is the last line (and ``--out``).  The stamps add a few instructions
a block: the parts' shares, not the call's time, are the reading.  Needs a
CUDA card and ``nvcc``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))

import chip_smoke as cs  # noqa: E402
import torch_decode_in_turns as turns  # noqa: E402

# name: ((b, L, h, d, kind), query type), kinds as chip_smoke.decode_step_inputs takes them
SHAPES = {
    "int8_cross": ((64, 512, 12, 64, "int8_chan"), torch.bfloat16),
    "int8_self": ((64, 33, 12, 64, "int8_pos"), torch.bfloat16),
    "w3_cross": ((64, 512, 12, 64, "cross"), torch.bfloat16),
    "f32_cross": ((64, 512, 12, 64, "cross"), torch.float32),
    "lm": ((16, 1024, 8, 128, "lm"), torch.bfloat16),
}
MAX_BLOCKS = 65536
# (anchor in decode_attention.cu, text put after it); each anchor must occur
STAMPS = (
    ("constexpr float kMaskFloor = -1e20f;",
     "\n__device__ unsigned long long g_tl[65536 * 8];\n"
     "__device__ __forceinline__ unsigned long long gtimer() {\n"
     "  unsigned long long t;\n"
     "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t));\n"
     "  return t;\n}\n"
     "__device__ __forceinline__ unsigned long long smid() {\n"
     "  unsigned r;\n"
     "  asm volatile(\"mov.u32 %0, %%smid;\" : \"=r\"(r));\n"
     "  return r;\n}\n"),
    ("decode_ring_kernel(const RingParams p) {",
     "\n  const unsigned long long t0 = gtimer();\n"
     "  unsigned long long t1 = 0, t2 = 0, t3 = 0, t4 = 0;\n"
     "  const long long tl_at = (blockIdx.x + (long long)gridDim.x * (blockIdx.y + "
     "(long long)gridDim.y * blockIdx.z)) * 8;\n"
     "  auto stamp = [&]() {\n"
     "    if (threadIdx.x == 0) {\n"
     "      unsigned long long* r = g_tl + tl_at;\n"
     "      r[0] = t0; r[1] = t1; r[2] = t2; r[3] = t3; r[4] = t4; r[5] = gtimer();\n"
     "      r[6] = smid();\n"
     "    }\n"
     "  };"),
    ("  if (nrank > 1) hopper::cluster_arrive();  // phase 0", None),
    ("    hopper::mbar_wait(&wfull[slot], phase);", "\n    if (j == 0) t2 = gtimer();"),
    ("  float* md_s = acc_s + kRingWarps * span;         // [warp][m of G heads, den of G]\n"
     "  __syncthreads();", "\n  t4 = gtimer();\n  if (threadIdx.x == 0) g_tl[tl_at + 7] = mine;"),
    ("    if (rank != 0) return;", None),
)
READ_BACK = ("\nint decode_timeline(unsigned long long* host, int n) {\n"
             "  return cudaMemcpyFromSymbol(host, g_tl, (size_t)n * 8);\n}\n")


def instrument(src: str) -> str:
    """The kernel source with the stamps in (see the module docstring)."""
    for anchor, after in STAMPS:
        if src.count(anchor) != 1:
            raise RuntimeError(f"anchor not found once in decode_attention.cu: {anchor!r}")
        if anchor.startswith("  if (nrank > 1) hopper::cluster_arrive"):
            src = src.replace(anchor, "  t1 = gtimer();\n" + anchor)
        elif anchor == "    if (rank != 0) return;":
            src = src.replace(anchor, "    if (rank != 0) {\n      stamp();\n      return;\n    }")
        elif anchor.startswith("  float* md_s"):
            src = src.replace(anchor, "  t3 = gtimer();\n" + anchor + after)
        else:
            src = src.replace(anchor, anchor + after)
    end = "      static_cast<TQ*>(p.out)[at] = from_f32<TQ>(y);\n    }\n  }\n}"
    if src.count(end) != 1:
        raise RuntimeError("the kernel's last store was not found once")
    src = src.replace(end, end[:-1] + "  stamp();\n}")
    entry = 'extern "C" {\n'
    return src.replace(entry, entry + READ_BACK, 1)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--shapes", default=",".join(SHAPES))
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_decode_timeline: no CUDA card", file=sys.stderr)
        return 2
    work = os.path.join(ROOT, "tpu_air_torch", "_build", "timeline_ops")
    shutil.rmtree(work, ignore_errors=True)
    shutil.copytree(os.path.join(ROOT, "tpu_air_torch", "ops"), os.path.join(work, "ops"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    path = os.path.join(work, "ops", "csrc", "decode_attention.cu")
    with open(path) as f:
        src = instrument(f.read())
    with open(path, "w") as f:
        f.write(src)
    mod = turns.load_build("timeline", os.path.join(work, "ops"))
    mod._build.build([mod._NAME])
    read = mod._build.kernel_fn(mod._NAME, "decode_timeline", [ctypes.c_void_p, ctypes.c_int])
    dev = torch.device("cuda", 0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    card = cs.card_line()
    print(f"[timeline] card: {card}", flush=True)
    out = {"card": card, "shapes": {}}
    buf = (ctypes.c_ulonglong * (MAX_BLOCKS * 8))()
    for key in args.shapes.split(","):
        (b, L, h, d, kind), dt = SHAPES[key]
        rng = np.random.default_rng(cs.SEED + 60)
        sets, nbytes, _ = cs.decode_step_inputs(rng, b, L, h, d, dt, dev, kind)
        for q, k, v, kw in sets:
            mod.decode_attention(q, k, v, **kw)
        q, k, v, kw = sets[-1]
        torch.cuda._sleep(50_000_000)
        mod.decode_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        if read(ctypes.addressof(buf), MAX_BLOCKS * 8) != 0:
            raise RuntimeError("reading the stamps back failed")
        g = mod.ring_group(h, d, k.element_size())
        chunks = -(-L // mod.plan_chunk(b, h, d, L, k.dtype, sms, "kv_mask" in kw))
        blocks = h // g * b * chunks
        a = np.frombuffer(buf, dtype=np.uint64).reshape(-1, 8)[:blocks].astype(np.int64)
        t = (a[:, :6] - a[:, 0].min()) / 1e3                       # µs from the first start
        first = np.where(a[:, 2] > 0, t[:, 2] - t[:, 1], 0.0)      # 0: no unit to wait for
        parts = {"start": t[:, 0], "mask pass": t[:, 1] - t[:, 0], "first unit": first,
                 "walk": t[:, 3] - t[:, 1], "warps' barrier": t[:, 4] - t[:, 3],
                 "merge and store": t[:, 5] - t[:, 4], "block": t[:, 5] - t[:, 0]}
        slow = int(np.argmax(t[:, 5]))
        row = {"shape": [b, L, h, d, kind, str(dt)], "blocks": blocks, "chunks": chunks,
               "bytes": nbytes, "span_us": float(t[:, 5].max()),
               "blocks_per_sm_max": int(np.bincount(a[:, 6]).max()),
               "parts_us": {n: [float(np.median(x)), float(x.max())] for n, x in parts.items()},
               "warp0_units": [float(np.median(a[:, 7])), int(a[:, 7].max())],
               "slowest_block_us": [float(x) for x in t[slow]], "slowest_units": int(a[slow, 7])}
        out["shapes"][key] = row
        print(f"[timeline] {key} {row['shape']}: {blocks} blocks ({chunks} chunks a row, at "
              f"most {row['blocks_per_sm_max']} an SM), span {row['span_us']:.2f} us; median / "
              "largest " + ", ".join(f"{n} {m:.2f} / {x:.2f}" for n, (m, x) in
                                     row["parts_us"].items())
              + f" us; warp 0's units {row['warp0_units']}; the slowest block's stamps "
              f"{[round(x, 2) for x in row['slowest_block_us']]} us with {row['slowest_units']} "
              "units", flush=True)
        del sets, q, k, v, kw
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
