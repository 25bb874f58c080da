"""The port's ring attention on the CPU against the JAX package's.

The same q, k, v and output cotangent, made from a numpy seed, go through
``tpu_air.ops.ring_attention.ring_attention_sharded`` on a ``sequence``
mesh of P host devices (the Pallas flash kernels in interpret mode, the
gradient through JAX's transpose of ``ppermute``) and through the port's
ring: :func:`ring_attention` over a gloo group of P worker processes, and
:func:`ring_attention_in_memory` over all P shards in this process (the
form ``chip_smoke.py`` runs on one card), where every hop takes the flash
kernels' plain versions.  P is 2 and 4, causal and not; everything is f32.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

from tpu_air.ops.ring_attention import ring_attention_sharded  # noqa: E402
from tpu_air_torch.ops import flash_attention as tflash  # noqa: E402
from tpu_air_torch.ops import ring_attention as tring  # noqa: E402

BH, L, D = 4, 256, 32
CASES = [(p, causal) for p in (2, 4) for causal in (False, True)]
FWD_TOL = dict(atol=2e-5, rtol=1e-4)
GRAD_TOL = dict(atol=1e-4, rtol=1e-3)


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    return tuple(rng.standard_normal((BH, L, D), dtype=np.float32) for _ in range(4))


_JAX = {}


def _jax_ring(inputs, p, causal):
    """(out, dq, dk, dv) of the JAX package's ring on p host devices; each
    case is traced once for the module."""
    if (p, causal) not in _JAX:
        q, k, v, do = (jnp.asarray(x) for x in inputs)
        mesh = Mesh(np.array(jax.devices()[:p]), ("sequence",))

        def f(q, k, v):
            out = ring_attention_sharded(q, k, v, mesh, causal=causal)
            return (out * do).sum(), out

        (_, out), grads = jax.jit(jax.value_and_grad(f, argnums=(0, 1, 2), has_aux=True))(
            q, k, v)
        # the JAX ring keeps each local shard L/P long
        assert out.addressable_shards[0].data.shape == (BH, L // p, D)
        _JAX[(p, causal)] = tuple(np.asarray(x) for x in (out, *grads))
    return _JAX[(p, causal)]


def _assert_matches(got, want, what):
    names = ("out", "dq", "dk", "dv")
    for name, g, w in zip(names, got, want):
        tol = FWD_TOL if name == "out" else GRAD_TOL
        np.testing.assert_allclose(g, w, err_msg=f"{what} {name}", **tol)


@pytest.fixture(scope="module")
def gloo_ring(inputs):
    """Every case over gloo in one group of 4 worker processes."""
    from _ring_workers import ring_rank
    from tpu_air_torch.parallel.distributed import run_workers

    outs = run_workers(ring_rank, (*inputs, CASES), 4, torch.device("cpu"))
    errors = [o["error"] for o in outs if o.get("error")]
    assert not errors, errors
    return [o["cases"] for o in outs]


@pytest.mark.parametrize("p, causal", CASES)
def test_ring_over_gloo_matches_jax(inputs, gloo_ring, p, causal):
    """Each rank's output and gradient shards, put together in rank order,
    equal the JAX package's ring; each local shard is L/P long.  With P = 2
    the two pairs of ranks each run the whole ring."""
    want = _jax_ring(inputs, p, causal)
    rings = [gloo_ring[:2], gloo_ring[2:]] if p == 2 else [gloo_ring]
    for ranks in rings:
        parts = [r[(p, causal)] for r in ranks]
        assert [x["rank"] for x in parts] == list(range(p))
        assert all(x["local_len"] == L // p for x in parts)
        got = [np.concatenate([x[n] for x in parts], axis=1) for n in ("out", "dq", "dk", "dv")]
        _assert_matches(got, want, f"gloo P={p} causal={causal}")


def _in_memory(inputs, p, causal, shape=(BH, L, D)):
    q, k, v, do = (torch.from_numpy(x.reshape(shape)) for x in inputs)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    shards = [list(t.chunk(p, dim=-2)) for t in leaves]
    assert all(s.shape[-2] == L // p for s in shards[0])
    outs = tring.ring_attention_in_memory(*shards, causal=causal)
    out = torch.cat(outs, dim=-2)
    out.backward(do)
    return [t.detach().reshape(BH, L, D).numpy()
            for t in (out, *(x.grad for x in leaves))]


@pytest.mark.parametrize("p, causal", CASES)
def test_ring_in_memory_matches_jax(inputs, p, causal):
    """All P ranks of a sequence in one process, rotated by reference: the
    same outputs and gradients, with (B*H, L/P, D) shards and with
    (B, H, L/P, D) ones."""
    want = _jax_ring(inputs, p, causal)
    _assert_matches(_in_memory(inputs, p, causal), want, f"in memory P={p}")
    _assert_matches(_in_memory(inputs, p, causal, (2, BH // 2, L, D)), want,
                    f"in memory 4-D P={p}")


@pytest.mark.parametrize("p, causal", CASES)
def test_hops_launch_once_per_live_hop(inputs, monkeypatch, p, causal):
    """The plain forward runs once per live hop (causal: P diagonal hops,
    P(P-1)/2 visible ones; otherwise P^2 visible ones) and never for a
    masked hop; the plain backward runs once per live hop too."""
    calls = {"fwd": [], "bwd": []}
    fwd, bwd = tflash.flash_attention_reference, tflash.flash_attention_backward_reference

    def counting_fwd(*args, **kw):
        calls["fwd"].append(args[-1] if "causal" not in kw else kw["causal"])
        return fwd(*args, **kw)

    def counting_bwd(*args, **kw):
        calls["bwd"].append(args[-1])
        return bwd(*args, **kw)

    monkeypatch.setattr(tflash, "flash_attention_reference", counting_fwd)
    monkeypatch.setattr(tflash, "flash_attention_backward_reference", counting_bwd)
    _in_memory(inputs, p, causal)
    live = tring.live_hops(p, causal)
    assert live == (p * (p + 1) // 2 if causal else p * p)
    for kind in ("fwd", "bwd"):
        assert len(calls[kind]) == live, (kind, calls[kind])
        assert sum(calls[kind]) == (p if causal else 0)


def test_hop_kinds_and_merge():
    """Hop types by owner, and the merge's empty state: merging into
    lse = -1e30 returns the other side exactly."""
    assert [tring.hop_kind(2, o, True) for o in range(4)] == [
        tring.VISIBLE, tring.VISIBLE, tring.DIAGONAL, tring.MASKED]
    assert {tring.hop_kind(0, o, False) for o in range(4)} == {tring.VISIBLE}
    rng = np.random.default_rng(1)
    o = torch.from_numpy(rng.standard_normal((3, 5, 4), dtype=np.float32))
    lse = torch.from_numpy(rng.standard_normal((3, 5), dtype=np.float32))
    out, lse2 = tring._merge(torch.zeros_like(o), torch.full_like(lse, tring.NEG_INF), o, lse)
    assert torch.equal(out, o) and torch.equal(lse2, lse)


def test_ring_refuses_without_a_group():
    """No process group raises, naming the in-memory form rather than
    falling back to it; shards of different shapes raise."""
    q = torch.zeros(2, 8, 16)
    with pytest.raises(ValueError, match="ring_attention_in_memory"):
        tring.ring_attention(q, q, q, None)
    with pytest.raises(ValueError, match="shape"):
        tring.ring_attention_in_memory([q], [q], [q[:, :4]])
