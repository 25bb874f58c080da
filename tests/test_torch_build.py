"""CPU tests of what surrounds the port's CUDA kernels: the build cache key
of ``tpu_air_torch/ops/_build.py`` and the flash wrapper's 16-byte row rule.
Neither needs ``nvcc`` or a card."""

import pathlib
import shutil

import pytest
import torch

from tpu_air_torch.ops import _build
from tpu_air_torch.ops import flash_attention as tflash


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    """A copy of ``ops/csrc`` that ``_build`` reads instead of the real one."""
    copy = tmp_path / "csrc"
    shutil.copytree(_build.CSRC_DIR, copy)
    monkeypatch.setattr(_build, "CSRC_DIR", str(copy))
    return copy


def test_the_kernels_share_a_header():
    assert sorted(p.name for p in pathlib.Path(_build.CSRC_DIR).glob("*.cuh")) == ["hopper.cuh"]


@pytest.mark.parametrize("name", _build.sources())
def test_lib_path_is_stable_while_nothing_changes(csrc, name):
    first = _build._lib_path(name)
    assert _build._lib_path(name) == first
    (csrc / "README").write_text("not a source")        # neither .cu nor .cuh
    assert _build._lib_path(name) == first
    assert first.startswith(_build.BUILD_DIR) and first.endswith(".so")


@pytest.mark.parametrize("name", _build.sources())
def test_lib_path_follows_every_shared_header(csrc, name):
    """Editing a header, adding one, or editing the source itself each give
    the library a new name, so a stale build is never loaded."""
    seen = {_build._lib_path(name)}
    header = csrc / "hopper.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    seen.add(_build._lib_path(name))
    (csrc / "zz_extra.cuh").write_text("#pragma once\n")
    seen.add(_build._lib_path(name))
    src = csrc / f"{name}.cu"
    src.write_text(src.read_text() + "\n// edited\n")
    seen.add(_build._lib_path(name))
    assert len(seen) == 4


def test_lib_path_differs_between_sources(csrc):
    paths = [_build._lib_path(n) for n in _build.sources()]
    assert len(set(paths)) == len(paths)


def _view(offset=0, b=2, L=16, h=3, d=64, row=None, dtype=torch.bfloat16):
    """A (b, h, L, d) view of a [b, L, h, row] buffer (row >= d) that starts
    ``offset`` elements into its storage, as the model views projections."""
    row = d if row is None else row
    base = torch.zeros(offset + b * L * h * row, dtype=dtype)
    return base[offset:].view(b, L, h, row)[..., :d].transpose(1, 2)


def _t5_head(dtype=torch.bfloat16):
    """Head 1 of a [b, L, h*d] = [2, 16, 768] slab, as (b, 1, L, 64)."""
    slab = torch.zeros(2, 16, 768, dtype=dtype)
    return slab.view(2, 16, 12, 64)[:, :, 1:2].transpose(1, 2)


VIEWS = {
    "contiguous": lambda: torch.zeros(2, 3, 16, 64, dtype=torch.bfloat16),
    "lm_projection": lambda: _view(b=1, L=32, h=8, d=128),   # row stride 1024
    "t5_head_slice": _t5_head,                                 # offset 64, stride 768
    "offset_3_elements": lambda: _view(offset=3),
    "row_stride_20": lambda: _view(d=16, row=20),
}


@pytest.mark.parametrize("case, aligned", [
    ("contiguous", True), ("lm_projection", True), ("t5_head_slice", True),
    ("offset_3_elements", False), ("row_stride_20", False),
])
def test_rows_16b_aligned(case, aligned):
    assert tflash._rows_16b_aligned(VIEWS[case]()) is aligned


@pytest.mark.parametrize("case", ["offset_3_elements", "row_stride_20"])
def test_misaligned_bf16_view_is_copied(case):
    t = VIEWS[case]()
    t.copy_(torch.randn(t.shape).to(torch.bfloat16))
    got = tflash._aligned(t)
    assert got.data_ptr() != t.data_ptr()
    assert tflash._rows_16b_aligned(got)
    assert got.shape == t.shape and torch.equal(got, t)


@pytest.mark.parametrize("case", ["contiguous", "lm_projection", "t5_head_slice"])
def test_aligned_bf16_view_is_used_as_it_is(case):
    t = VIEWS[case]()
    assert tflash._aligned(t) is t


def test_f32_views_are_never_copied():
    """f32 runs on the CUDA-core kernels, which read scalars."""
    t = _view(offset=3, dtype=torch.float32)
    assert not tflash._rows_16b_aligned(t)
    assert tflash._aligned(t) is t
