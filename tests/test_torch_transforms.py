"""The port's PIL-exact transform stack: the numpy host copy equals
vlsa_tpu's byte for byte (vlsa_tpu's own tests hold that against PIL), and
the torch device stack, run here on CPU tensors, equals the host stack byte
for byte in its integer stages (resize, crop) and within 1 ulp of f32 in the
normalize (the contract of vlsa_tpu/data/transforms_device.py:86-96)."""
import numpy as np
import pytest
import torch

from vlsa_tpu.data import transforms as jt
from vlsa_tpu_torch.data import transforms as tt
from vlsa_tpu_torch.data.transforms_device import build_device_preprocess

RNG = np.random.default_rng(3)


@pytest.mark.parametrize("in_size,out_size", [(512, 448), (448, 448), (96, 448), (97, 53),
                                              (61, 41), (600, 448)])
def test_resample_tables_equal(in_size, out_size):
    np.testing.assert_array_equal(tt._resample_matrix_u8(in_size, out_size),
                                  jt._resample_matrix_u8(in_size, out_size))
    for a, b in zip(tt._resample_taps_u8(in_size, out_size),
                    jt._resample_taps_u8(in_size, out_size)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("in_hw,out_hw", [((96, 80), (224, 224)), ((600, 512), (300, 256)),
                                          ((300, 500), (224, 224)), ((97, 61), (53, 41)),
                                          ((448, 448), (224, 224))])
def test_resize_bicubic_equals_jax(in_hw, out_hw):
    img = RNG.integers(0, 256, size=in_hw + (3,), dtype=np.uint8)
    np.testing.assert_array_equal(tt.resize_bicubic_u8(img, out_hw),
                                  jt.resize_bicubic_u8(img, out_hw))


@pytest.mark.parametrize("in_hw,size", [((40, 30), 48), ((97, 61), 53), ((30, 100), 64),
                                        ((512, 512), 160)])
def test_crop_and_tile_stack_equal_jax(in_hw, size):
    """Crop with zero padding (an image smaller than the crop), the
    shortest-edge resize, and the whole per-tile stack."""
    img = RNG.integers(0, 256, size=in_hw + (3,), dtype=np.uint8)
    np.testing.assert_array_equal(tt.center_crop(img, size), jt.center_crop(img, size))
    np.testing.assert_array_equal(tt.resize_shortest_edge(img, size),
                                  jt.resize_shortest_edge(img, size))
    np.testing.assert_array_equal(tt.preprocess_tile(img, size), jt.preprocess_tile(img, size))


def test_batch_paths_equal_jax():
    """The vectorised same-size path and the per-tile path of mixed sizes."""
    same = [RNG.integers(0, 256, size=(64, 64, 3), dtype=np.uint8) for _ in range(3)]
    mixed = same[:2] + [RNG.integers(0, 256, size=(70, 50, 3), dtype=np.uint8)]
    for tiles in (same, mixed):
        np.testing.assert_array_equal(tt.preprocess_batch(tiles, 64),
                                      jt.preprocess_batch(tiles, 64))
    assert tt.OPENAI_DATASET_MEAN == jt.OPENAI_DATASET_MEAN
    assert tt.OPENAI_DATASET_STD == jt.OPENAI_DATASET_STD


@pytest.mark.parametrize("in_hw,size", [((448, 448), 96), ((512, 512), 96), ((600, 512), 96),
                                        ((300, 500), 96), ((97, 61), 96), ((512, 512), 448)])
def test_device_stack_byte_exact_on_cpu(in_hw, size):
    tiles = RNG.integers(0, 256, size=(1 if size == 448 else 2,) + in_hw + (3,), dtype=np.uint8)
    got_u8 = build_device_preprocess(in_hw, size, normalize=False)(torch.from_numpy(tiles))
    want_u8 = np.stack([tt.center_crop(tt.resize_shortest_edge(t, size), size) for t in tiles])
    assert got_u8.dtype == torch.uint8 and got_u8.shape == (len(tiles), size, size, 3)
    np.testing.assert_array_equal(got_u8.numpy(), want_u8)
    got = build_device_preprocess(in_hw, size)(torch.from_numpy(tiles))
    assert got.dtype == torch.float32 and got.shape == (len(tiles), 3, size, size)
    want = np.stack([tt.preprocess_tile(t, size) for t in tiles])
    np.testing.assert_array_max_ulp(got.numpy(), want, maxulp=1)


def test_device_stack_checks_its_input():
    fn = build_device_preprocess((64, 64), 32)
    with pytest.raises(ValueError, match="u8"):
        fn(torch.zeros(1, 64, 64, 3, dtype=torch.float32))
    with pytest.raises(ValueError, match="u8"):
        fn(torch.zeros(1, 48, 64, 3, dtype=torch.uint8))
