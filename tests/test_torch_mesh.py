"""The port's device meshes and parameter partitioning rules
(``tpu_air_torch/parallel/{mesh,sharding}.py``) against ``tpu_air.parallel``.

* ``make_mesh``, ``visible_devices`` (with ``TPU_AIR_CHIP_IDS``, wrapping
  included), ``data_parallel_mesh`` and ``topology`` give the JAX
  functions' shapes, device order and error texts over a grid of shapes.
  The JAX side meshes the 8 host devices ``tests/conftest.py`` forces; the
  port's side 8 CPU devices named ``cpu:0``..``cpu:7`` (the port enumerates
  CUDA devices, and the test puts the CPU list in their place).
* ``lm_param_spec`` / ``t5_param_spec`` give the JAX rules' axes on every
  path of the tiny LM and tiny T5 trees; ``param_specs`` on the port's
  state dict (the kernel's spec reversed on its ``[out, in]`` weight)
  equals ``_param_shardings`` over JAX meshes, the divisibility drop
  included.
* ``shard_params`` slices put back together are the whole weights,
  bitwise; ``shard_params_from_jax`` is the conversion then the sharding.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from tpu_air.models import lm as jlm  # noqa: E402
from tpu_air.models.t5 import T5Config as JT5Config  # noqa: E402
from tpu_air.models.t5 import T5ForConditionalGeneration  # noqa: E402
from tpu_air.parallel import mesh as jmesh  # noqa: E402
from tpu_air.parallel import sharding as jsharding  # noqa: E402
from tpu_air_torch.models import lm as tlm  # noqa: E402
from tpu_air_torch.parallel import mesh as tmesh  # noqa: E402
from tpu_air_torch.parallel import sharding as tsharding  # noqa: E402

N_DEV = 8
CPUS = [torch.device("cpu", i) for i in range(N_DEV)]


@pytest.fixture(autouse=True)
def _eight_devices(monkeypatch):
    """The port enumerates 8 CPU devices where it would enumerate CUDA
    ones; no lease unless a test sets one."""
    monkeypatch.setattr(tmesh, "platform_devices", lambda: list(CPUS))
    monkeypatch.delenv("TPU_AIR_CHIP_IDS", raising=False)
    assert len(jax.devices()) == N_DEV     # tests/conftest.py forces 8 host devices


def _jdevs():
    return jax.devices()[:N_DEV]


def _ids(devs):
    """Device positions: JAX device ids, torch device indices."""
    return [getattr(d, "id", None) if not isinstance(d, torch.device) else d.index
            for d in devs]


def _outcome(fn):
    try:
        return ("ok", fn())
    except ValueError as e:
        return ("error", str(e))


MESH_CASES = [
    (("data",), None), (("data", "model"), None), (("data", "model"), (2, 4)),
    (("data", "model"), (-1, 2)), (("data", "model"), (4, -1)), (("data", "model"), (1, 8)),
    (("data", "model"), (8, 1)), (("data", "model"), (3, -1)), (("data", "model"), (2, 2)),
    (("data", "model"), (-1, 16)), (("data", "model", "seq"), (2, -1, 2)),
]


@pytest.mark.parametrize("axes,shape", MESH_CASES)
def test_make_mesh_matches_jax(axes, shape):
    def j():
        m = jmesh.make_mesh(axes, shape, devices=_jdevs())
        return dict(m.shape), m.axis_names, _ids(m.devices.flat)

    def t():
        m = tmesh.make_mesh(axes, shape, devices=CPUS)
        return dict(m.shape), m.axis_names, _ids(m.devices.flat)

    assert _outcome(t) == _outcome(j)


@pytest.mark.parametrize("lease", [None, "1,3", "0,2,4,6", "6,9,10", "15,0"])
def test_visible_devices_and_lease_wrapping_match_jax(monkeypatch, lease):
    if lease is not None:
        monkeypatch.setenv("TPU_AIR_CHIP_IDS", lease)
    assert tmesh.leased_chip_ids() == jmesh.leased_chip_ids()
    assert _ids(tmesh.visible_devices()) == _ids(jmesh.visible_devices())
    for n in (None, 1, 2, 5, 9):
        if n is not None and lease is not None and n > len(lease.split(",")) + 1:
            continue
        want = _outcome(lambda: _ids(jmesh.data_parallel_mesh(n).devices.flat))
        got = _outcome(lambda: _ids(tmesh.data_parallel_mesh(n).devices.flat))
        assert got == want, n


def test_mesh_shape_reads_by_axis_and_may_repeat_a_device():
    m = tmesh.make_mesh(("data", "model"), (2, 2), devices=[torch.device("cpu")] * 4)
    assert m.shape["data"] == 2 and m.shape["model"] == 2 and m.size == 4
    assert list(m.shape) == ["data", "model"]
    assert all(d == torch.device("cpu") for d in m.devices.flat)


def test_topology_keys_match_jax(monkeypatch):
    monkeypatch.setenv("TPU_AIR_CHIP_IDS", "0,1,2")
    want, got = jmesh.topology(), tmesh.topology()
    want.pop("coords", None)
    assert set(got) == set(want)
    for key in ("platform", "num_devices", "num_visible", "device_kind", "process_count"):
        assert got[key] == want[key], key


def test_no_cuda_and_no_devices_raises(monkeypatch):
    monkeypatch.undo()
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA"):
        tmesh.make_mesh(("data",))


# -- partitioning rules ---------------------------------------------------------------------


def _jax_lm(cfg):
    model = jlm.CausalLM(cfg)
    return model.init(jax.random.PRNGKey(0), jnp.ones((1, 8), jnp.int32))["params"]


@pytest.fixture(scope="module")
def lm_params():
    params = _jax_lm(jlm.LMConfig.tiny())
    return jax.tree_util.tree_map(np.asarray, params)


@pytest.fixture(scope="module")
def t5_params():
    cfg = JT5Config.tiny()
    model = T5ForConditionalGeneration(cfg)
    ids = jnp.ones((1, 8), jnp.int32)
    return model.init(jax.random.PRNGKey(0), ids, jnp.ones_like(ids), ids)["params"]


def _paths(params):
    flat, _ = jax.tree_util.tree_flatten_with_path(params)
    return [(jsharding._path_names(p), leaf) for p, leaf in flat]


@pytest.mark.parametrize("family", ["lm", "t5"])
def test_param_spec_rules_match_jax_on_every_path(family, lm_params, t5_params):
    params = lm_params if family == "lm" else t5_params
    jrule = jsharding.lm_param_spec if family == "lm" else jsharding.t5_param_spec
    trule = tsharding.lm_param_spec if family == "lm" else tsharding.t5_param_spec
    paths = _paths(params)
    assert len(paths) > 10
    sharded = 0
    for names, leaf in paths:
        want = tuple(jrule(names, leaf))
        assert trule(names, leaf) == want, names
        sharded += bool(want)
    assert sharded > 0


def _normalize(spec):
    spec = tuple(spec)
    return () if all(a is None for a in spec) else spec


def _jax_torch_specs(jparams, state_dict, dp, tp):
    """(JAX ``_param_shardings`` spec mapped to the port's layout, the
    port's ``param_spec``) for every port parameter."""
    jm = jmesh.make_mesh(("data", "model"), (dp, tp), devices=_jdevs()[:dp * tp])
    tm = tmesh.make_mesh(("data", "model"), (dp, tp), devices=CPUS[:dp * tp])
    jsh = jsharding.lm_param_shardings(jparams, jm)
    tspecs = tsharding.param_specs(state_dict, tm)
    out = {}
    for name, t in state_dict.items():
        path, transposed = tsharding.lm_flax_path(name)
        node = jsh
        for key in path:
            node = node[key]
        spec = tuple(node.spec)
        if transposed:
            spec = tuple(spec + (None,) * (t.dim() - len(spec)))[::-1]
        out[name] = (_normalize(spec), tspecs[name])
    return out


@pytest.mark.parametrize("dp,tp", [(1, 1), (2, 1), (2, 2), (1, 4), (1, 8), (4, 2)])
def test_param_specs_match_param_shardings(lm_params, dp, tp):
    sd = tlm.params_from_jax(lm_params)
    pairs = _jax_torch_specs(lm_params, sd, dp, tp)
    assert {n: w for n, (w, _) in pairs.items()} == {n: g for n, (_, g) in pairs.items()}
    if tp > 1:
        assert pairs["layers.0.attn.q.weight"][1] == ("model", None)
        assert pairs["layers.1.mlp.down.weight"][1] == (None, "model")
        assert pairs["embedding"][1] == ()


@pytest.mark.parametrize("tp", [2, 4, 8])
def test_divisibility_drop_matches_jax(tp):
    """3 heads of 10 (q's 30 outputs) and d_ff 90: tp 4 and 8 divide
    neither, tp 2 divides both widths but not the heads."""
    cfg = jlm.LMConfig(vocab_size=96, d_model=40, n_layers=1, n_heads=3, head_dim=10,
                       d_ff=90, max_seq_len=64)
    jparams = jax.tree_util.tree_map(np.asarray, _jax_lm(cfg))
    sd = tlm.params_from_jax(jparams)
    pairs = _jax_torch_specs(jparams, sd, 1, tp)
    for name, (want, got) in pairs.items():
        assert got == want, name
    dropped = [n for n, (_, g) in pairs.items() if "weight" in n and "norm" not in n and not g]
    assert dropped if tp > 2 else not dropped


def _mesh(dp, tp):
    return tmesh.make_mesh(("data", "model"), (dp, tp), devices=CPUS[:dp * tp])


@pytest.mark.parametrize("dp,tp", [(1, 2), (2, 2), (1, 4)])
def test_shards_put_back_together_are_the_whole_weights(lm_params, dp, tp):
    sd = tlm.params_from_jax(lm_params)
    mesh = _mesh(dp, tp)
    shards = tsharding.shard_params(sd, mesh)
    specs = tsharding.param_specs(sd, mesh)
    assert shards.shape == (dp, tp)
    for name, whole in sd.items():
        dims = [d for d, a in enumerate(specs[name]) if a == "model"]
        for r in range(dp):
            parts = [shards[r, s][name] for s in range(tp)]
            # (a CPU tensor's device carries no index)
            assert all(p.device.type == mesh.devices[r, s].type for s, p in enumerate(parts))
            if dims:
                assert torch.equal(torch.cat(parts, dims[0]), whole), name
                assert parts[0].shape[dims[0]] * tp == whole.shape[dims[0]]
            else:
                assert all(torch.equal(p, whole) for p in parts), name
    rep = tsharding.replicate(sd, mesh)
    assert all(torch.equal(rep[idx][n], t) for idx in np.ndindex(rep.shape)
               for n, t in sd.items())


def test_shard_params_from_jax_is_conversion_then_sharding(lm_params):
    mesh = _mesh(2, 2)
    got = tlm.shard_params_from_jax(lm_params, mesh)
    want = tsharding.shard_params(tlm.params_from_jax(lm_params), mesh)
    for idx in np.ndindex(mesh.devices.shape):
        assert got[idx].keys() == want[idx].keys()
        assert all(torch.equal(got[idx][n], want[idx][n]) for n in want[idx])


def test_every_lm_parameter_has_a_flax_path(lm_params):
    sd = tlm.params_from_jax(lm_params)
    model = tlm.CausalLM(tlm.LMConfig.tiny(), device="meta")
    assert set(sd) == set(model.state_dict())
    for name in sd:
        path, transposed = tsharding.lm_flax_path(name)
        node = lm_params
        for key in path:
            node = node[key]
        assert tuple(np.shape(node)) == (tuple(sd[name].shape)[::-1] if transposed
                                         else tuple(sd[name].shape)), name
    with pytest.raises(KeyError):
        tsharding.lm_flax_path("layers.0.attn.qq.weight")
