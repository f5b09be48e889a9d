"""Tile-layout helpers (component C6): padding + block-cyclic pack/unpack,
and the mesh shape derived from the device count."""

import numpy as np
import pytest

from tileqr.core import layout


def test_pad_to_tiles_roundtrip(rng):
    import jax.numpy as jnp

    a = rng.standard_normal((100, 70)).astype(np.float32)
    ap, (m, n) = layout.pad_to_tiles(jnp.asarray(a), 64)
    assert ap.shape == (128, 128) and (m, n) == (100, 70)
    assert np.allclose(np.asarray(ap)[:100, :70], a)
    assert np.allclose(np.asarray(ap)[100:], 0)


def test_block_cyclic_roundtrip(rng):
    a = rng.standard_normal((8 * 16, 4 * 16)).astype(np.float32)
    t = layout.to_block_cyclic(a, 16, pr=4, pc=2)
    assert t.shape == (4, 2, 2, 2, 16, 16)
    back = layout.from_block_cyclic(t, 16)
    assert (back == a).all()
    # owner map: tile (i, j) on device (i % pr, j % pc)
    i, j = 5, 3
    assert (t[5 % 4, 3 % 2, 5 // 4, 3 // 2] == a[i * 16 : (i + 1) * 16, j * 16 : (j + 1) * 16]).all()


def test_owner_and_counts():
    assert layout.block_cyclic_owner(5, 3, 4, 2) == (1, 1)
    assert layout.local_tile_counts(10, 6, 4, 2, 1, 0) == (3, 3)


@pytest.mark.parametrize("n_devices,shape", [(1, (1, 1)), (4, (2, 2)), (8, (4, 2))])
def test_mesh_shape_for_device_count(n_devices, shape):
    """The default sharded mesh is derived from the device count: the
    widest pr >= pc factorization (one card, a four-card host, eight)."""
    from tileqr.core.config import QRConfig, mesh_shape_for

    assert mesh_shape_for(n_devices) == shape
    assert QRConfig().mesh_shape is None
