"""The port's display and segmentation helpers (``tpu_air_torch.utils``)
against the JAX package's copies (``tpu_air.utils``) on the CPU: the same
inputs and seeds give the same samples, palette, labels, overlays and
figures."""

import numpy as np
import pandas as pd
import pytest
from PIL import Image

import tpu_air.utils as jutils
import tpu_air_torch
import tpu_air_torch.data as tdata
import tpu_air_torch.utils as tutils

ROWS = [{"instruction": f"say {i}", "output": str(i)} for i in range(12)]


class _Rows:
    """A dataset as the helper reads one: ``count()`` and ``take_all()``."""

    def __init__(self, rows):
        self.rows = list(rows)

    def count(self):
        return len(self.rows)

    def take_all(self):
        return list(self.rows)


@pytest.fixture
def port_runtime():
    tpu_air_torch.init(num_cpus=2, num_chips=1)
    yield
    tpu_air_torch.shutdown()


@pytest.mark.parametrize("seed", [0, 7])
def test_get_random_elements_matches_the_jax_helper(seed):
    got = tutils.get_random_elements(_Rows(ROWS), 4, seed=seed)
    want = jutils.get_random_elements(_Rows(ROWS), 4, seed=seed)
    pd.testing.assert_frame_equal(got, want)
    with pytest.raises(ValueError, match="Can't pick 13"):
        tutils.get_random_elements(_Rows(ROWS), 13)


def test_get_random_elements_samples_a_port_dataset(port_runtime):
    got = tutils.get_random_elements(tdata.from_items(ROWS), 5, seed=3)
    want = jutils.get_random_elements(_Rows(ROWS), 5, seed=3)
    pd.testing.assert_frame_equal(got, want)


def test_palette_labels_and_indices_match_the_jax_helpers():
    assert tutils.ade_palette() == jutils.ade_palette()
    assert len(tutils.ade_palette()) == 151 and tutils.ade_palette()[0] == [0, 0, 0]
    assert tutils.get_labels() == jutils.get_labels() and len(tutils.get_labels()) == 150
    assert tutils.get_image_indices(50, 6, seed=3) == jutils.get_image_indices(50, 6, seed=3)
    with pytest.raises(ValueError):
        tutils.get_image_indices(3, 4)


def test_overlays_and_figures_match_the_jax_helpers(tmp_path):
    rng = np.random.default_rng(0)
    images = [rng.integers(0, 256, (24, 32, 3)).astype(np.uint8),
              Image.fromarray(rng.integers(0, 256, (24, 32)).astype(np.uint8), mode="L")]
    maps = [rng.integers(0, 151, (24, 32)) for _ in images]
    for im, sm in zip(images, maps):
        np.testing.assert_array_equal(tutils.prepare_pixels_with_segmentation(im, sm, alpha=0.3),
                                      jutils.prepare_pixels_with_segmentation(im, sm, alpha=0.3))
        np.testing.assert_array_equal(np.asarray(tutils.convert_image_to_rgb(im)),
                                      np.asarray(jutils.convert_image_to_rgb(im)))
    fig = tutils.visualize_predictions(images, maps, save_path=str(tmp_path / "pred.png"))
    assert len(fig.axes) == 4 and (tmp_path / "pred.png").stat().st_size > 0
    fig = tutils.display_example_images(images, n=2, seed=1, save_path=str(tmp_path / "ex.png"))
    assert len(fig.axes) == 2 and (tmp_path / "ex.png").stat().st_size > 0
