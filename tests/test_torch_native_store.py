"""The port's C++ shared-memory arena (tpu_air_torch/_native/store.cpp,
tpu_air_torch/core/shm_arena.py) and the object store's arena branches:
the twins of tests/test_native_store.py on the port, then the two
packages' arenas against each other — raw chunks and store objects read
bytewise across packages from one ``__arena__`` file, and equal ``stats()``
after the same sequence of puts, deletes and unpins."""

import gc
import multiprocessing
import os

import numpy as np
import pytest

from tpu_air.core.object_store import ObjectStore as JaxObjectStore
from tpu_air.core.shm_arena import Arena as JaxArena
from tpu_air_torch import _native
from tpu_air_torch.core.object_store import ObjectStore, new_object_id
from tpu_air_torch.core.shm_arena import Arena, open_arena

SEED = 0


@pytest.fixture()
def store(tmp_path):
    s = ObjectStore(str(tmp_path / "store"), create=True)
    yield s
    s.destroy()


def _small_arena_store(tmp_path, capacity=1 << 20, slots=1 << 10) -> ObjectStore:
    root = str(tmp_path / "store")
    os.makedirs(root)
    Arena(os.path.join(root, "__arena__"), create=True, capacity=capacity, slots=slots)
    return ObjectStore(root)


def test_arena_available(store):
    assert store._arena is not None, "native arena must build in this environment"
    # built from the port's own source into tpu_air_torch/_build/
    path = _native.store_lib_path()
    assert os.path.dirname(path) == _native.BUILD_DIR and os.path.exists(path)
    assert os.path.basename(path).startswith("libtpu_air_torch_store-")


def test_roundtrip_through_arena(store):
    arr = np.arange(10000, dtype=np.float64)
    ref = store.put({"x": arr, "tag": "hello"})
    # object must live in the arena, not a file
    assert store._arena.contains(ref.id)
    assert not os.path.exists(os.path.join(store.root, ref.id))
    out = store.get(ref.id)
    np.testing.assert_array_equal(out["x"], arr)
    assert out["tag"] == "hello"


def test_zero_copy_read_is_view(store):
    arr = np.arange(4096, dtype=np.uint8)
    ref = store.put(arr)
    out = store.get(ref.id)
    # zero-copy contract: backed by the shared mapping, not a fresh copy
    assert not out.flags["OWNDATA"]


def test_large_object_falls_back_to_file(tmp_path):
    # 1 MB arena → an 8 MB payload must take the file path
    s = _small_arena_store(tmp_path)
    big = np.zeros(1 << 23, dtype=np.uint8)
    ref = s.put(big)
    assert os.path.exists(os.path.join(s.root, ref.id))
    np.testing.assert_array_equal(s.get(ref.id), big)
    # small objects still use the arena
    small_ref = s.put(b"tiny")
    assert s._arena.contains(small_ref.id)
    assert s.get(small_ref.id) == b"tiny"
    s.destroy()


def test_delete_tombstones_and_id_reuse_safe(store):
    ref = store.put([1, 2, 3])
    assert store.contains(ref.id)
    store.delete(ref.id)
    assert not store.contains(ref.id)
    # a tombstoned slot doesn't break probing for other ids
    for _ in range(32):
        r = store.put("v")
        assert store.get(r.id) == "v"


def test_stats_track_objects(store):
    before = store._arena.stats()
    store.put(np.zeros(1000, np.uint8))
    after = store._arena.stats()
    assert after["live_objects"] == before["live_objects"] + 1
    assert after["sealed_bytes"] > before["sealed_bytes"]
    assert after["used"] <= after["capacity"]


def _child_put(root, oid, q):
    s = ObjectStore(root)
    s.put(np.full(5000, 7, dtype=np.int32), object_id=oid)
    q.put("done")


def test_cross_process_visibility(store):
    """Writer in a forked child, reader in the parent — the acquire/release
    seal protocol on the shared mapping."""
    ctx = multiprocessing.get_context("fork")
    oid = new_object_id()
    q = ctx.Queue()
    p = ctx.Process(target=_child_put, args=(store.root, oid, q))
    p.start()
    out = store.get(oid, timeout=30)
    assert q.get(timeout=10) == "done"
    p.join(timeout=10)
    assert not p.is_alive()
    np.testing.assert_array_equal(out, np.full(5000, 7, dtype=np.int32))


def test_concurrent_writers_distinct_objects(store):
    """N forked writers allocate concurrently from the bump allocator."""
    ctx = multiprocessing.get_context("fork")
    oids = [new_object_id() for _ in range(8)]
    q = ctx.Queue()
    procs = [ctx.Process(target=_child_put, args=(store.root, oid, q)) for oid in oids]
    for p in procs:
        p.start()
    for oid in oids:
        np.testing.assert_array_equal(store.get(oid, timeout=30),
                                      np.full(5000, 7, dtype=np.int32))
    assert [q.get(timeout=10) for _ in oids] == ["done"] * len(oids)
    for p in procs:
        p.join(timeout=10)
        assert not p.is_alive()


def test_open_arena_missing_compiler_is_none(tmp_path, monkeypatch):
    """Fallback contract: when the native build fails, the store still works
    through the file path."""
    def boom():
        raise OSError("no compiler")

    monkeypatch.setattr(_native, "load_store_lib", boom)
    root = str(tmp_path / "store2")
    os.makedirs(root)
    assert open_arena(root, create=True) is None
    s = ObjectStore(root)
    assert s._arena is None
    ref = s.put({"a": 1})
    assert s.get(ref.id) == {"a": 1}
    assert os.path.exists(os.path.join(root, ref.id))
    s.destroy()


# -- object spilling -----------------------------------------------------------


def _budgeted_store(tmp_path, monkeypatch, budget, arena_cap=1 << 16):
    # tiny arena so multi-KB payloads take the file path, tiny file budget so
    # the file path spills
    monkeypatch.setenv("TPU_AIR_STORE_BYTES", str(budget))
    monkeypatch.setenv("TPU_AIR_SPILL_DIR", str(tmp_path / "spill"))
    return _small_arena_store(tmp_path, capacity=arena_cap, slots=1 << 8)


def test_spill_on_budget_and_transparent_restore(tmp_path, monkeypatch):
    s = _budgeted_store(tmp_path, monkeypatch, budget=300_000)
    arrays = {}
    refs = []
    for i in range(8):  # 8 x ~100KB against a 300KB tmpfs budget
        arr = np.full(100_000, i, dtype=np.uint8)
        refs.append(s.put(arr))
        arrays[refs[-1].id] = arr
    spill = s.spill_stats()
    assert spill["spilled_objects"] >= 4, spill
    # the root stays under budget (modulo the newest object)
    root_bytes = sum(os.path.getsize(os.path.join(s.root, n))
                     for n in os.listdir(s.root) if not n.startswith(("__", ".")))
    assert root_bytes <= 300_000 + 100_064
    # every object — resident or spilled — restores transparently
    for ref in refs:
        np.testing.assert_array_equal(s.get(ref.id), arrays[ref.id])
    # delete reaches spilled objects too
    for ref in refs:
        s.delete(ref.id)
    assert s.spill_stats()["spilled_objects"] == 0
    s.destroy()


def test_spill_oldest_first_and_oversized_object(tmp_path, monkeypatch):
    import time

    s = _budgeted_store(tmp_path, monkeypatch, budget=250_000)
    first = s.put(np.zeros(100_000, dtype=np.uint8))
    time.sleep(0.05)  # mtime-ordered eviction needs distinct stamps
    second = s.put(np.ones(100_000, dtype=np.uint8))
    time.sleep(0.05)
    s.put(np.full(100_000, 2, dtype=np.uint8))  # pushes over budget
    assert os.path.exists(s._spill_path(first.id)), "oldest object not spilled"
    assert not os.path.exists(s._path(first.id))
    assert os.path.exists(s._path(second.id)), "newer object wrongly evicted"
    # an object larger than the whole budget goes straight to disk
    huge = s.put(np.zeros(400_000, dtype=np.uint8))
    assert os.path.exists(s._spill_path(huge.id))
    assert s.get(huge.id).shape == (400_000,)
    s.destroy()


_SPILL_SCRIPT = """
import numpy as np
import tpu_air_torch
from tpu_air_torch.core import runtime as rt_mod

if __name__ == "__main__":
    tpu_air_torch.init(num_cpus=2, num_chips=0)
    import tpu_air_torch.data as data
    ds = data.from_items([{"x": np.zeros(100_000, dtype=np.uint8) + i} for i in range(12)])
    out = ds.map_batches(lambda df: df, batch_size=1).take_all()
    assert len(out) == 12
    sums = sorted(int(r["x"].sum()) for r in out)
    assert sums == sorted(i * 100_000 for i in range(12)), sums[:3]
    store = rt_mod.get_runtime().store
    assert store._arena is not None and store._arena.stats()["capacity"] == 1 << 16
    spill = store.spill_stats()
    assert spill["spilled_objects"] > 0, f"nothing spilled: {spill}"
    print("SPILL_E2E_OK", spill["spilled_objects"])
    tpu_air_torch.shutdown()
"""


def test_dataset_larger_than_budget_spills_and_completes(tmp_path):
    """End to end: a map_batches pipeline whose blocks exceed the tmpfs
    budget completes correctly, with spilled blocks restored on read; the
    runtime's arena is TPU_AIR_ARENA_BYTES large."""
    import subprocess
    import sys

    script = tmp_path / "spill_e2e.py"
    script.write_text(_SPILL_SCRIPT)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["TPU_AIR_STORE_BYTES"] = "400000"
    env["TPU_AIR_SPILL_DIR"] = str(tmp_path / "spill")
    env["TPU_AIR_ARENA_BYTES"] = str(1 << 16)  # tiny arena: blocks hit files
    env["PYTHONPATH"] = os.pathsep.join([root, env.get("PYTHONPATH", "")])
    proc = subprocess.run([sys.executable, str(script)], env=env, capture_output=True,
                          text=True, timeout=180, cwd=root)
    assert proc.returncode == 0, f"stdout={proc.stdout}\nstderr={proc.stderr[-2000:]}"
    assert "SPILL_E2E_OK" in proc.stdout


# -- native ownership, reference counts, block reuse ---------------------------


def test_delete_reclaims_space_for_reuse(tmp_path):
    """An unpinned delete returns the block to the shared free list and a
    later alloc reuses it — the arena no longer only grows."""
    s = _small_arena_store(tmp_path)
    payload = np.zeros(200_000, dtype=np.uint8)
    # churn 50 x 200KB through a 1MB arena: without reuse this needs 10MB
    for i in range(50):
        ref = s.put(payload + (i % 251))
        assert s._arena.contains(ref.id), f"round {i} fell back to file"
        val = s.get(ref.id)
        assert val[0] == i % 251
        del val
        gc.collect()  # drop the value's pin before deleting
        s.delete(ref.id)
    st = s._arena.stats()
    assert st["used"] <= (1 << 20), st
    assert not [n for n in os.listdir(s.root) if not n.startswith("__")]
    s.destroy()


def test_pinned_object_survives_delete_until_value_dies(tmp_path):
    """Delete while a zero-copy reader holds the value parks the object
    (ZOMBIE); its bytes stay valid; the last reference's death releases the
    pin and reclaims the block."""
    s = _small_arena_store(tmp_path)
    arr = np.arange(50_000, dtype=np.uint32)
    ref = s.put(arr)
    val = s.get(ref.id)  # zero-copy view, pinned
    assert s._arena.pins(ref.id) == 1
    s.delete(ref.id)
    assert not s.contains(ref.id)  # invisible immediately
    # hammer the arena with new objects that would love the freed block
    for i in range(20):
        s.put(np.full(60_000, i, dtype=np.uint8))
    np.testing.assert_array_equal(val, arr)  # bytes never reused while pinned
    free_before = s._arena.stats()["free_bytes"]
    del val
    gc.collect()
    free_after = s._arena.stats()["free_bytes"]
    assert free_after > free_before, "last unpin did not reclaim the zombie"
    s.destroy()


def test_self_contained_values_release_pin_immediately(tmp_path):
    s = _small_arena_store(tmp_path)
    ref = s.put({"k": "v", "n": 17})  # no out-of-band buffers
    v = s.get(ref.id)
    assert v == {"k": "v", "n": 17}
    assert s._arena.pins(ref.id) == 0, "a value with no buffers must not hold a pin"
    s.destroy()


def test_derived_object_outliving_container_keeps_pin(tmp_path):
    """The pin is tied to the out-of-band BUFFERS, not the top-level value: a
    Series extracted from a DataFrame (or an array pulled out of a dict)
    outlives its container while still referencing arena bytes."""
    import pandas as pd

    s = _small_arena_store(tmp_path, capacity=1 << 21)
    # case 1: array extracted from a dict container
    arr = np.arange(30_000, dtype=np.uint32)
    ref = s.put({"payload": arr, "meta": "x"})
    val = s.get(ref.id)
    inner = val["payload"]          # derived: shares the arena bytes
    del val
    gc.collect()                    # container dies; pin must survive
    s.delete(ref.id)
    for i in range(20):             # block-reuse pressure
        s.put(np.full(40_000, i, dtype=np.uint8))
    np.testing.assert_array_equal(inner, arr)
    del inner
    gc.collect()

    # case 2: Series extracted from a DataFrame
    df = pd.DataFrame({"a": np.arange(20_000, dtype=np.int64), "b": np.ones(20_000)})
    ref2 = s.put(df)
    got = s.get(ref2.id)
    series = got["a"]               # derived view of the block manager
    del got
    gc.collect()
    s.delete(ref2.id)
    for i in range(20):
        s.put(np.full(40_000, i, dtype=np.uint8))
    np.testing.assert_array_equal(series.to_numpy(), np.arange(20_000, dtype=np.int64))
    s.destroy()


def test_reput_same_id_while_old_generation_zombie(tmp_path):
    """Pin disambiguation: unpinning an old generation must not touch a
    re-put of the same id."""
    s = _small_arena_store(tmp_path)
    oid = new_object_id()
    s.put(np.zeros(10_000, dtype=np.uint8), oid)
    old = s.get(oid)          # pin generation 1
    s.delete(oid)             # gen 1 → zombie
    s.put(np.ones(10_000, dtype=np.uint8), oid)  # gen 2, same id
    new = s.get(oid)
    assert new[0] == 1 and old[0] == 0
    del old
    gc.collect()              # unpin gen 1 → reclaimed
    assert s._arena.pins(oid) == 1, "gen-2 pin must survive gen-1 unpin"
    np.testing.assert_array_equal(new, np.ones(10_000, dtype=np.uint8))
    s.destroy()


# -- the two packages' arenas against each other --------------------------------

_ARENAS = {"port": Arena, "jax": JaxArena}


def _chunks(rng) -> list:
    """A header-like bytes chunk, a memoryview chunk and a bytearray chunk."""
    return [bytes(rng.integers(0, 256, 37, dtype=np.uint8)),
            memoryview(rng.integers(0, 256, 5000, dtype=np.uint8).tobytes()),
            bytearray(rng.integers(0, 256, 123, dtype=np.uint8).tobytes())]


@pytest.mark.parametrize("writer,reader", [("port", "jax"), ("jax", "port")])
def test_raw_chunks_read_bytewise_across_packages(writer, reader, tmp_path):
    """Chunks that one package's ``Arena`` writes into an ``__arena__`` file
    are read bytewise by the other package's ``Arena`` on the same file,
    pinned and unpinned there; a delete there reaches the writer."""
    path = str(tmp_path / "__arena__")
    w = _ARENAS[writer](path, create=True, capacity=1 << 20, slots=1 << 10)
    r = _ARENAS[reader](path)
    rng = np.random.default_rng(SEED)
    objs = {f"obj-{i}": _chunks(rng) for i in range(8)}
    for oid, chunks in objs.items():
        assert w.put_chunks(oid, chunks)
    for oid, chunks in objs.items():
        want = b"".join(bytes(c) for c in chunks)
        assert bytes(r.lookup(oid)) == want
        view, off = r.lookup_pin(oid)
        assert bytes(view) == want and w.pins(oid) == 1
        r.unpin(oid, off)
        assert w.pins(oid) == 0
    r.delete("obj-0")
    assert not w.contains("obj-0") and w.contains("obj-1")
    assert r.stats() == w.stats()
    r.close()
    w.close()


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_store_objects_read_across_packages(writer, tmp_path):
    """Both packages' stores on one directory share its arena: a value one
    puts (a dict of arrays, in the arena) the other gets equal, zero-copy,
    with the same serialization."""
    root = str(tmp_path / "store")
    stores = {"port": ObjectStore(root, create=True), "jax": JaxObjectStore(root)}
    w, r = stores[writer], stores["jax" if writer == "port" else "port"]
    assert w._arena is not None and r._arena is not None
    rng = np.random.default_rng(SEED)
    value = {"k": rng.standard_normal((64, 33)).astype(np.float32),
             "v": rng.integers(0, 1 << 15, 4096, dtype=np.int16), "tag": "page"}
    ref = w.put(value)
    assert w._arena.contains(ref.id) and not os.path.exists(os.path.join(root, ref.id))
    got = r.get(ref.id, timeout=10)
    assert got["tag"] == "page" and not got["k"].flags["OWNDATA"]
    for key in ("k", "v"):
        assert got[key].dtype == value[key].dtype
        assert got[key].tobytes() == value[key].tobytes()
    assert w._arena.pins(ref.id) == 1
    del got
    gc.collect()
    assert w._arena.pins(ref.id) == 0
    stores["jax"]._arena.close()
    stores["port"].destroy()


def _op_sequence(seed: int, n: int = 120) -> list:
    """A seeded sequence of arena operations: puts of random sizes, pins,
    unpins, deletes (of pinned objects too, which park as zombies)."""
    rng = np.random.default_rng(seed)
    ops, live, pinned = [], [], []
    for i in range(n):
        r = rng.random()
        if r < 0.45 or not live:
            oid = f"o{i}"
            ops.append(("put", oid, int(rng.integers(1, 60_000))))
            live.append(oid)
        elif r < 0.65:
            oid = live[int(rng.integers(len(live)))]
            ops.append(("pin", oid))
            pinned.append(oid)
        elif r < 0.8 and pinned:
            ops.append(("unpin", pinned.pop(int(rng.integers(len(pinned))))))
        else:
            oid = live.pop(int(rng.integers(len(live))))
            ops.append(("delete", oid))
    ops += [("unpin", oid) for oid in pinned]
    return ops


@pytest.mark.parametrize("seed", [SEED, SEED + 1, SEED + 2])
def test_same_operations_give_equal_stats(seed, tmp_path):
    """The same sequence of puts, deletes and unpins on the port's arena and
    on the JAX package's (each on its own file, same capacity and slots)
    gives equal ``stats()`` after every operation, and equal offsets."""
    arenas = {name: cls(str(tmp_path / f"{name}.arena"), create=True,
                        capacity=1 << 20, slots=1 << 8) for name, cls in _ARENAS.items()}
    pins = {name: {} for name in arenas}
    for step, op in enumerate(_op_sequence(seed)):
        seen = {}
        for name, a in arenas.items():
            kind, oid = op[0], op[1]
            if kind == "put":
                seen[name] = a.put_chunks(oid, [bytes([step % 256]) * op[2]])
            elif kind == "pin":
                got = a.lookup_pin(oid)
                seen[name] = None if got is None else got[1]
                if got is not None:
                    pins[name].setdefault(oid, []).append(got[1])
            elif kind == "unpin":
                offs = pins[name].get(oid) or []
                if offs:
                    a.unpin(oid, offs.pop())
            else:
                a.delete(oid)
            seen[name] = (seen.get(name), a.stats())
        assert seen["port"] == seen["jax"], (step, op)
    for a in arenas.values():
        a.close()
