"""The dense gather's launch geometry (``ops/cuda_warp.py::warp_block``),
on the CPU: the block tile is a power of two per axis, at most 256
voxels, within the volume's extent, and every block aligned on it lies
inside one TPU tile of the adaptive windows (``ops/tiles.py``), so that
the kernel can read the tile's base once per block.  No JAX, no card."""
import math

import pytest

from interpol_tpu_torch.ops.cuda_warp import warp_block
from interpol_tpu_torch.ops.tiles import lifted_tile

SHAPES = [
    (256, 256, 256), (128, 128, 128), (11, 12, 13), (19, 24, 37),
    (20, 17, 140), (16, 10, 30), (20, 18, 24), (5, 7, 9), (2, 3, 200),
    (1, 1, 1), (7, 1, 1), (1, 9, 1), (64, 64, 400), (9, 10, 385),
    (30, 17), (30, 140), (33, 18), (8, 257), (40,), (300,), (3,),
]


def _lift(ishape):
    """The kernel's 3-D shape and the pull family's tile of a D-dim
    volume, lifted with leading size-1 axes (as ``cuda_warp._lift3``)."""
    nd = 3 - len(ishape)
    return ((1,) * nd + tuple(ishape),
            (1,) * nd + tuple(lifted_tile(ishape)))


@pytest.mark.parametrize("ishape", SHAPES)
def test_block_tile_fits_the_volume_and_the_tpu_tile(ishape):
    shape3, tile3 = _lift(ishape)
    logs = warp_block(shape3)
    ext = [1 << l for l in logs]
    assert all(isinstance(l, int) and l >= 0 for l in logs)
    assert math.prod(ext) <= 256
    for n, e in zip(shape3, ext):
        # no axis wider than the volume's own extent, rounded up to 2^k
        assert e <= 1 << max(n - 1, 0).bit_length()
    for n, e, t in zip(shape3, ext, tile3):
        for start in range(0, n, e):
            last = min(start + e, n) - 1
            assert start // t == last // t, (shape3, ext, tile3, start)


def test_block_tile_of_the_main_path():
    # 2 x * 4 y * 32 z voxels at 256^3: one warp per z-row segment of 32
    assert warp_block((256, 256, 256)) == (1, 2, 5)
    # lifted 2-D and 1-D volumes keep every thread on the image
    assert warp_block((1, 30, 140)) == (0, 3, 5)
    assert warp_block((1, 1, 300)) == (0, 0, 7)
    # a short z axis gives its threads to y and x
    assert warp_block((11, 12, 13)) == (2, 2, 4)
