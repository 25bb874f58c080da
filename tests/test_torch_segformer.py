"""The port's SegFormer on the CPU against the JAX package's, on the same
weights and inputs.

Weights come from a JAX init of ``SegformerConfig.tiny()`` or from a
``transformers.SegformerForSemanticSegmentation`` built from the HF-shaped
tiny config of ``tests/test_segformer.py`` (no download), carried across
with ``params_from_jax`` / ``convert_segformer_state_dict``; inputs come
from numpy seeds.  Everything is float32.

Tolerances, each with its reason:
- logits, max abs 2e-4: the JAX package's own bound against HF
  (tests/test_segformer.py); the two frameworks sum convolutions and
  matmuls in other orders over a few layers;
- batch-norm running stats after one train-mode forward, 1e-5: the same
  moments of O(1) activations, summed in another order;
- losses and gradients, 1e-5 relative: one f32 cross-entropy;
- image processing: labels exact; resized pixels within 1 grey level of
  PIL's (the torch and PIL antialiased filters round differently);
  post-processed class maps equal except where an image's top two logits
  are within 1e-4 of each other (there the resize's rounding may flip the
  argmax).
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from tpu_air.models import segformer as J  # noqa: E402
from tpu_air.models.segformer import image_processor as jproc  # noqa: E402
from tpu_air_torch.models import segformer as P  # noqa: E402
from tpu_air_torch.models.segformer import image_processor as pproc  # noqa: E402
from tpu_air_torch.models.segformer.convert import (  # noqa: E402
    params_from_jax,
    params_to_jax,
)
from tpu_air_torch.models.segformer.modeling import BatchNorm  # noqa: E402

ATOL = 2e-4
STATS_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny tensors: one torch thread, so these tests add little CPU load
    beside the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _hf_config(**kw):
    import transformers

    return transformers.SegformerConfig(
        num_encoder_blocks=4, depths=[1, 1, 1, 1], sr_ratios=[4, 2, 2, 1],
        hidden_sizes=[8, 16, 24, 32], patch_sizes=[7, 3, 3, 3], strides=[4, 2, 2, 2],
        num_attention_heads=[1, 2, 2, 4], mlp_ratios=[2, 2, 2, 2], decoder_hidden_size=32,
        num_labels=6, drop_path_rate=0.0, hidden_dropout_prob=0.0,
        attention_probs_dropout_prob=0.0, classifier_dropout_prob=0.0, **kw)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


@pytest.fixture(scope="module")
def hf_pair():
    """(HF torch model, port config, Flax params, batch_stats, port model)."""
    import transformers

    transformers.set_seed(42)
    hf = transformers.SegformerForSemanticSegmentation(_hf_config()).eval()
    cfg = J.config_from_hf(hf.config)
    sd = {k: v.detach().numpy() for k, v in hf.state_dict().items()}
    params, stats = J.convert_segformer_state_dict(sd, cfg)
    pcfg = P.SegformerConfig.from_json(cfg.to_json())
    model = P.SegformerForSemanticSegmentation(pcfg, device="cpu")
    model.load_state_dict(params_from_jax(params, stats, pcfg))
    return hf, pcfg, params, stats, model


def _jax_init(cfg, seed=0, hw=(64, 64)):
    model = J.SegformerForSemanticSegmentation(cfg)
    v = jax.jit(model.init)(jax.random.PRNGKey(seed), jnp.zeros((1, *hw, cfg.num_channels)))
    params = _tree_map(np.asarray, v["params"])
    stats = _tree_map(np.asarray, v["batch_stats"])
    # running stats away from their init (0, 1), so the momentum shows
    rng = np.random.default_rng(seed + 100)
    bn = stats["decode_head"]["batch_norm"]
    bn["mean"] = rng.normal(size=bn["mean"].shape).astype(np.float32)
    bn["var"] = rng.uniform(0.5, 2.0, size=bn["var"].shape).astype(np.float32)
    return model, params, stats


def _configs():
    """(name, JAX config): tiny with dropout off, and the HF-shaped tiny."""
    tiny = J.SegformerConfig.tiny(classifier_dropout_prob=0.0)
    hf_shaped = J.config_from_hf(_hf_config())
    return [("tiny", tiny), ("hf_shaped", hf_shaped)]


def _port(cfg, params, stats):
    pcfg = P.SegformerConfig.from_json(cfg.to_json())
    model = P.SegformerForSemanticSegmentation(pcfg, device="cpu")
    model.load_state_dict(params_from_jax(params, stats, pcfg))
    return model


def _pixels(seed, b=2, hw=(64, 64)):
    return np.random.default_rng(seed).normal(size=(b, *hw, 3)).astype(np.float32)


def test_config_round_trips_and_keeps_every_preset():
    for name in ("mit_b0", "mit_b1", "mit_b2", "mit_b3", "mit_b4", "mit_b5", "tiny"):
        j, p = getattr(J.SegformerConfig, name)(), getattr(P.SegformerConfig, name)()
        assert dataclasses.asdict(j) == dataclasses.asdict(p), name
        assert P.SegformerConfig.from_json(j.to_json()) == p
    assert '"model_type": "segformer"' in P.SegformerConfig.mit_b0().to_json()


@pytest.mark.parametrize("name,cfg", _configs(), ids=[n for n, _ in _configs()])
@pytest.mark.parametrize("hw", [(64, 64), (48, 80)])
def test_eval_logits_match_jax(name, cfg, hw):
    jmodel, params, stats = _jax_init(cfg, hw=hw)
    model = _port(cfg, params, stats)
    px = _pixels(1, hw=hw)
    want = np.asarray(jax.jit(jmodel.apply)({"params": params, "batch_stats": stats},
                                            jnp.asarray(px)))
    with torch.no_grad():
        got = model(torch.from_numpy(px)).numpy()
    assert got.shape == want.shape == (2, hw[0] // 4, hw[1] // 4, cfg.num_labels)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("name,cfg", _configs(), ids=[n for n, _ in _configs()])
def test_train_mode_logits_and_batch_stats_match_jax(name, cfg):
    """One train-mode forward (dropout and drop-path at 0): the batch norm
    normalizes with the batch's moments and moves its running stats by
    Flax's rule, the biased variance included."""
    jmodel, params, stats = _jax_init(cfg)
    model = _port(cfg, params, stats).train()
    px = _pixels(2)
    want, upd = jax.jit(lambda v, x: jmodel.apply(
        v, x, deterministic=False, rngs={"dropout": jax.random.PRNGKey(0)},
        mutable=["batch_stats"]))({"params": params, "batch_stats": stats}, jnp.asarray(px))
    got = model(torch.from_numpy(px))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=ATOL, rtol=0)
    bn = upd["batch_stats"]["decode_head"]["batch_norm"]
    np.testing.assert_allclose(model.decode_head.batch_norm.running_mean.numpy(),
                               np.asarray(bn["mean"]), atol=STATS_TOL, rtol=0)
    np.testing.assert_allclose(model.decode_head.batch_norm.running_var.numpy(),
                               np.asarray(bn["var"]), atol=STATS_TOL, rtol=0)
    assert not np.allclose(np.asarray(bn["var"]), stats["decode_head"]["batch_norm"]["var"])


def test_batch_norm_takes_the_biased_variance_unlike_torch_batchnorm2d():
    """2 images of 8x8: n = 128 values a channel, so ``nn.BatchNorm2d``'s
    unbiased update moves the running variance 128/127 as far as Flax's
    (and the port's) biased one; the port equals Flax's ``nn.BatchNorm``."""
    import flax.linen as fnn

    c = 4
    x = np.random.default_rng(3).normal(1.0, 2.0, size=(2, 8, 8, c)).astype(np.float32)
    ours = BatchNorm(c, torch.float32).train()
    y = ours(torch.from_numpy(x))
    ref = torch.nn.BatchNorm2d(c, momentum=0.1, eps=1e-5).train()
    ref(torch.from_numpy(x).permute(0, 3, 1, 2))
    ratio = (ref.running_var - 0.9) / (ours.running_var - 0.9)
    np.testing.assert_allclose(ratio.numpy(), 128 / 127, rtol=1e-5)

    fbn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    v = fbn.init(jax.random.PRNGKey(0), jnp.asarray(x))
    fy, upd = fbn.apply(v, jnp.asarray(x), mutable=["batch_stats"])
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(fy), atol=1e-5, rtol=0)
    np.testing.assert_allclose(ours.running_var.numpy(),
                               np.asarray(upd["batch_stats"]["var"]), atol=1e-6, rtol=0)
    np.testing.assert_allclose(ours.running_mean.numpy(),
                               np.asarray(upd["batch_stats"]["mean"]), atol=1e-6, rtol=0)


def test_segmentation_loss_with_ignored_pixels_matches_jax():
    rng = np.random.default_rng(4)
    logits = rng.normal(size=(2, 4, 5, 7)).astype(np.float32)
    labels = rng.integers(0, 7, size=(2, 16, 20)).astype(np.int32)
    labels[0, :6] = 255
    labels[1, :, 3:9] = 255
    want = float(J.segmentation_loss(jnp.asarray(logits), jnp.asarray(labels)))
    got = float(P.segmentation_loss(torch.from_numpy(logits), torch.from_numpy(labels)))
    assert abs(got - want) <= 1e-5 * abs(want)
    none = np.full_like(labels, 255)
    assert float(P.segmentation_loss(torch.from_numpy(logits), torch.from_numpy(none))) == 0.0
    assert float(J.segmentation_loss(jnp.asarray(logits), jnp.asarray(none))) == 0.0


def test_loss_gradients_match_jax():
    """The train-mode loss and every parameter's gradient (dropout off),
    the batch norm's through its batch moments included."""
    cfg = J.SegformerConfig.tiny(classifier_dropout_prob=0.0)
    jmodel, params, stats = _jax_init(cfg)
    model = _port(cfg, params, stats).train()
    px = _pixels(5)
    labels = np.random.default_rng(6).integers(0, cfg.num_labels, size=(2, 64, 64))
    labels[:, :10] = 255
    labels = labels.astype(np.int32)

    def lf(p):
        logits, _ = jmodel.apply({"params": p, "batch_stats": stats}, jnp.asarray(px),
                                 deterministic=False, rngs={"dropout": jax.random.PRNGKey(0)},
                                 mutable=["batch_stats"])
        return J.segmentation_loss(logits, jnp.asarray(labels))

    want, jgrads = jax.jit(jax.value_and_grad(lf))(params)
    loss = P.segmentation_loss(model(torch.from_numpy(px)), torch.from_numpy(labels).long())
    loss.backward()
    assert abs(loss.item() - float(want)) <= 1e-5 * abs(float(want))
    grads = {n: p.grad for n, p in model.named_parameters()}
    grads.update({n: b for n, b in model.named_buffers()})
    gtree, _ = params_to_jax(grads, P.SegformerConfig.from_json(cfg.to_json()))
    flat_j = jax.tree_util.tree_leaves_with_path(jgrads)
    assert len(flat_j) == len([n for n, _ in model.named_parameters()])
    # the linear_c biases feed the batch norm, whose batch mean cancels them:
    # their gradient is 0 in exact arithmetic and rounding noise in both
    # frameworks, so each tensor is held to 1e-4 of its own largest entry
    # plus 1e-6 of the largest gradient entry of the model
    biggest = max(float(np.abs(np.asarray(g)).max()) for _, g in flat_j)
    for path, g in flat_j:
        node = gtree
        for k in path:
            node = node[k.key]
        g = np.asarray(g)
        bound = 1e-4 * np.abs(g).max() + 1e-6 * biggest
        assert np.abs(node - g).max() <= bound, jax.tree_util.keystr(path)


def test_hf_state_dict_through_the_converter_matches_transformers(hf_pair):
    hf, _, _, _, model = hf_pair
    img = np.random.default_rng(0).normal(size=(2, 3, 64, 64)).astype(np.float32)
    with torch.no_grad():
        want = hf(pixel_values=torch.from_numpy(img)).logits.numpy()
        got = model(torch.from_numpy(img.transpose(0, 2, 3, 1))).numpy()
    assert want.shape == (2, 6, 16, 16)
    np.testing.assert_allclose(got.transpose(0, 3, 1, 2), want, atol=ATOL, rtol=2e-3)


@pytest.mark.parametrize("head", [True, False], ids=["segmentation", "bare_backbone"])
def test_load_segformer_from_hf_matches_the_jax_loader(tmp_path, head):
    """A local HF directory (saved from a model built from the config: no
    download) through both packages' loaders; a bare backbone (the
    `nvidia/mit-b0` form) gets a decode head initialized from the seed,
    so there only the encoder's features are compared."""
    import transformers

    transformers.set_seed(7)
    cls = transformers.SegformerForSemanticSegmentation if head else transformers.SegformerModel
    cls(_hf_config()).save_pretrained(str(tmp_path))
    jmodel, jvars = J.load_segformer_from_hf(str(tmp_path), num_labels=6)
    model = P.load_segformer_from_hf(str(tmp_path), num_labels=6, device="cpu")
    assert model.config.num_labels == 6 and not model.training
    px = _pixels(12)
    with torch.no_grad():
        feats = model.features(torch.from_numpy(px))
        logits = model(torch.from_numpy(px)).numpy()
    want = jax.jit(lambda v, x: jmodel.apply(v, x, method="features"))(jvars, jnp.asarray(px))
    for f, w in zip(feats, want):
        np.testing.assert_allclose(f.numpy(), np.asarray(w), atol=ATOL, rtol=0)
    assert logits.shape == (2, 16, 16, 6)
    if head:
        want = jax.jit(jmodel.apply)(jvars, jnp.asarray(px))
        np.testing.assert_allclose(logits, np.asarray(want), atol=ATOL, rtol=0)


def test_classification_model_matches_jax():
    cfg = J.SegformerConfig.tiny()
    jmodel = J.SegformerForImageClassification(cfg, num_classes=5)
    v = jax.jit(jmodel.init)(jax.random.PRNGKey(1), jnp.zeros((1, 32, 32, 3)))
    params = _tree_map(np.asarray, v["params"])
    pcfg = P.SegformerConfig.from_json(cfg.to_json())

    def cls(c, device):
        return P.SegformerForImageClassification(c, num_classes=5, device=device)

    model = cls(pcfg, "cpu")
    model.load_state_dict(params_from_jax(params, {}, pcfg, model_cls=cls))
    px = _pixels(7, hw=(32, 32))
    want = np.asarray(jax.jit(jmodel.apply)({"params": params}, jnp.asarray(px)))
    with torch.no_grad():
        got = model(torch.from_numpy(px)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_params_round_trip_both_ways(hf_pair):
    _, pcfg, params, stats, model = hf_pair
    sd = model.state_dict()
    p2, s2 = params_to_jax(sd, pcfg)
    back = params_from_jax(p2, s2, pcfg)
    assert back.keys() == sd.keys()
    for k in sd:
        assert torch.equal(back[k], sd[k]), k
    for tree, ref in ((p2, params), (s2, stats)):
        flat = jax.tree_util.tree_leaves_with_path(ref)
        assert len(flat) == len(jax.tree_util.tree_leaves(tree))
        for path, leaf in flat:
            node = tree
            for k in path:
                node = node[k.key]
            np.testing.assert_array_equal(node, np.asarray(leaf))


def test_params_from_jax_refuses_a_missing_or_misshapen_array(hf_pair):
    _, pcfg, params, stats, _ = hf_pair
    with pytest.raises(KeyError, match="batch_stats/decode_head/batch_norm/mean"):
        params_from_jax(params, {}, pcfg)
    bad = _tree_map(lambda a: a, params)
    bad["encoder"]["block_0_0"]["attention"]["query"]["kernel"] = np.zeros((8, 9), np.float32)
    with pytest.raises(ValueError, match="block_0_0.attention.query.weight"):
        params_from_jax(bad, stats, pcfg)


def _ade_like(seed, n, sizes):
    rng = np.random.default_rng(seed)
    imgs = [rng.integers(0, 256, size=(*sizes[i % len(sizes)], 3)).astype(np.uint8)
            for i in range(n)]
    lbls = [rng.integers(0, 151, size=im.shape[:2]).astype(np.uint8) for im in imgs]
    return imgs, lbls


@pytest.mark.parametrize("size,sizes", [(32, [(48, 40), (40, 48)]),
                                        (64, [(67, 51), (120, 96), (40, 48)])])
def test_image_processor_matches_the_jax_copy(size, sizes):
    imgs, lbls = _ade_like(8, 4, sizes)
    kw = dict(size=size, do_reduce_labels=True)
    want = jproc.SegformerImageProcessor(**kw)(imgs, segmentation_maps=lbls)
    got = pproc.SegformerImageProcessor(**kw)(imgs, segmentation_maps=lbls)
    np.testing.assert_array_equal(got["labels"], want["labels"])
    raw = dict(size=size, do_rescale=False, do_normalize=False)
    want_px = jproc.SegformerImageProcessor(**raw)(imgs)["pixel_values"]
    got_px = pproc.SegformerImageProcessor(**raw)(imgs)["pixel_values"]
    assert got_px.shape == want_px.shape == (4, size, size, 3)
    assert np.abs(got_px - want_px).max() <= 1.0
    # normalized: 1 grey level over the smallest std
    np.testing.assert_allclose(got["pixel_values"], want["pixel_values"],
                               atol=1.0 / 255 / 0.224 + 1e-6, rtol=0)
    first = pproc.SegformerImageProcessor(**kw, data_format="channels_first")(imgs)
    assert first["pixel_values"].shape == (4, 3, size, size)


def test_labels_above_255_resize_exactly_like_the_jax_copy():
    rng = np.random.default_rng(9)
    lbl = rng.integers(0, 4000, size=(37, 53)).astype(np.int32)
    want = jproc.SegformerImageProcessor(size=24)._process_label(lbl)
    got = pproc.SegformerImageProcessor(size=24)._process_label(lbl)
    np.testing.assert_array_equal(got, want)
    assert got.max() > 255


@pytest.mark.parametrize("sizes", [[(31, 33), (70, 45)], [(16, 16), (9, 13)]])
def test_post_processed_maps_match_the_jax_copy(sizes):
    rng = np.random.default_rng(10)
    logits = rng.normal(size=(2, 16, 16, 6)).astype(np.float32)
    want = jproc.SegformerImageProcessor().post_process_semantic_segmentation(
        logits, target_sizes=sizes)
    proc = pproc.SegformerImageProcessor()
    got = proc.post_process_semantic_segmentation(logits, target_sizes=sizes)
    from_tensor = proc.post_process_semantic_segmentation(torch.from_numpy(logits),
                                                          target_sizes=sizes)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape == tuple(sizes[i]) and g.dtype == np.int32
        np.testing.assert_array_equal(from_tensor[i], g)
        up = pproc._resize(logits[i], *sizes[i], nearest=False)
        top2 = np.sort(up, axis=-1)[..., -2:]
        near_tie = (top2[..., 1] - top2[..., 0]) < 1e-4
        assert ((g == w) | near_tie).all()
        assert (g == w).mean() > 0.99
    plain = proc.post_process_semantic_segmentation(logits)
    assert plain[0].shape == (16, 16)
    np.testing.assert_array_equal(plain[0], logits[0].argmax(-1))


def test_collate_and_aliases_are_the_jax_copy():
    rng = np.random.default_rng(11)
    chw = [rng.normal(size=(3, 8, 9)).astype(np.float32) for _ in range(2)]
    np.testing.assert_array_equal(pproc.collate_pixel_batch(chw), jproc.collate_pixel_batch(chw))
    assert pproc.SegformerFeatureExtractor is pproc.SegformerImageProcessor
    gray = rng.integers(0, 256, size=(10, 12)).astype(np.uint8)
    np.testing.assert_array_equal(pproc._to_numpy_image(gray), jproc._to_numpy_image(gray))
