"""End-to-end parallel (sharded) codec tests on the 8-device CPU mesh.

Parity contract: every slab payload of a
mesh-encoded SZRA container must be byte-identical to the serial
`api.compress` of that slab, and the sharded decode must reproduce the
serial decode bit-exactly.  This is the device-mesh analog of the
reference OpenMP codec's three phases (sz_omp.c:209-325 encode,
sz_omp.c:366 decode) with the shared-histogram psum replaced by
per-slab self-contained streams (the MPI-chunk pattern the reference
uses for multi-node scaling, test_mpio.c).
"""

import numpy as np
import pytest

import sz_tpu
from sz_tpu import api, ra
from sz_tpu.config import SZConfig, ErrorBoundMode
from sz_tpu.parallel import slab


def synth(shape, dtype=np.float32, seed=0, dense_fraction=0.0):
    rng = np.random.default_rng(seed)
    axes = [np.linspace(0, 4 * np.pi, n) for n in shape]
    grids = np.meshgrid(*axes, indexing="ij")
    field = np.sin(grids[0])
    for g in grids[1:]:
        field = field * np.cos(g)
    field = field + 0.05 * rng.standard_normal(shape)
    if dense_fraction:
        # flat region to trigger the use_mean (dense_pos) path
        mask = rng.random(shape) < dense_fraction
        field[mask] = 0.25
    return field.astype(dtype)


def _assert_slab_parity(data, cfg, n_dev=8):
    blob = slab.compress_sharded(data, cfg, n_devices=n_dev)
    r = ra.Reader(blob)
    assert r.n_slabs == n_dev
    for i in range(n_dev):
        a, b = int(r.starts[i]), int(r.starts[i + 1])
        serial = api.compress(np.ascontiguousarray(data[a:b]), cfg)
        assert r.slab_bytes(i) == serial, f"slab {i} diverges from serial"
    return blob


def test_sharded_3d_slab_bytes_match_serial():
    data = synth((32, 20, 24))
    cfg = SZConfig().with_bound(ErrorBoundMode.ABS, 1e-3)
    _assert_slab_parity(data, cfg)


def test_sharded_3d_use_mean_slabs():
    # dense region → per-slab use_mean=True streams
    data = synth((32, 16, 16), dense_fraction=0.4)
    cfg = SZConfig().with_bound(ErrorBoundMode.ABS, 1e-3)
    blob = _assert_slab_parity(data, cfg)
    out = slab.decompress_sharded(blob, n_devices=8)
    assert np.abs(out - data).max() <= 1e-3 * (1 + 1e-6)


def test_sharded_2d():
    data = synth((64, 96))
    cfg = SZConfig().with_bound(ErrorBoundMode.ABS, 1e-4)
    _assert_slab_parity(data, cfg)


def test_sharded_double():
    data = synth((16, 12, 18), dtype=np.float64, seed=3)
    cfg = SZConfig().with_bound(ErrorBoundMode.ABS, 1e-6)
    _assert_slab_parity(data, cfg)


def test_sharded_rel_mode_per_slab_bounds():
    # REL resolves the bound from each slab's own value range
    data = synth((32, 14, 10), seed=7)
    cfg = SZConfig().with_bound(ErrorBoundMode.REL, 1e-4)
    _assert_slab_parity(data, cfg)


def test_sharded_decode_bit_identical_to_serial():
    data = synth((32, 20, 24), seed=1)
    cfg = SZConfig().with_bound(ErrorBoundMode.ABS, 1e-3)
    blob = slab.compress_sharded(data, cfg, n_devices=8)
    sharded = slab.decompress_sharded(blob, n_devices=8)
    serial = ra.decompress(blob)
    assert sharded.dtype == serial.dtype
    assert np.array_equal(sharded, serial), "sharded decode != serial"
    assert np.abs(sharded - data).max() <= 1e-3 * (1 + 1e-6)


def test_sharded_fallback_constant_field():
    # constant slabs can't use the fast path; container still correct
    data = np.full((16, 8, 8), 3.25, np.float32)
    cfg = SZConfig().with_bound(ErrorBoundMode.ABS, 1e-3)
    blob = slab.compress_sharded(data, cfg, n_devices=8)
    out = slab.decompress_sharded(blob, n_devices=8)
    assert np.array_equal(out, data)


def test_sharded_region_decode():
    data = synth((40, 12, 12), seed=5)
    cfg = SZConfig().with_bound(ErrorBoundMode.ABS, 1e-3)
    blob = slab.compress_sharded(data, cfg, n_devices=8)
    r = ra.Reader(blob)
    region = r.decode_region(7, 22)
    np.testing.assert_array_equal(region, ra.decompress(blob)[7:22])


def test_sharded_device_input_bytes_identical():
    """compress_sharded of a device-resident sharded jax.Array (the SPMD
    checkpoint-compression case) must produce the exact container of the
    numpy-input path — covering the device range scan, the sharded
    optimizer gathers and the dense-mean extraction."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    for shape, dense in (((32, 20, 24), 0.0), ((32, 16, 16), 0.4)):
        data = synth(shape, dense_fraction=dense)
        cfg = SZConfig().with_bound(ErrorBoundMode.ABS, 1e-3)
        host_blob = slab.compress_sharded(data, cfg, n_devices=8)
        mesh = slab._mesh(8)
        sharded = jax.device_put(
            jnp.asarray(data),
            NamedSharding(mesh, P(slab.AXIS, None, None)))
        dev_blob = slab.compress_sharded(sharded, cfg, n_devices=8)
        assert dev_blob == host_blob


def test_sharded_device_input_rel_2d():
    import jax.numpy as jnp

    data = synth((40, 37))
    cfg = SZConfig().with_bound(ErrorBoundMode.REL, 1e-3)
    host_blob = slab.compress_sharded(data, cfg, n_devices=8)
    dev_blob = slab.compress_sharded(jnp.asarray(data), cfg, n_devices=8)
    assert dev_blob == host_blob


def test_sharded_device_input_fallback():
    """Ineligible device input (constant field) must fall back through
    the numpy materialization, identical to the host call."""
    import jax.numpy as jnp

    data = np.full((16, 12, 12), 3.0, np.float32)
    cfg = SZConfig().with_bound(ErrorBoundMode.ABS, 1e-3)
    assert (slab.compress_sharded(jnp.asarray(data), cfg, n_devices=8)
            == slab.compress_sharded(data, cfg, n_devices=8))


def test_sharded_roundtrip_stays_on_mesh():
    """Restore path: decompress_sharded(as_jax=True) of a container made
    from a sharded device array returns a device array still sharded
    over the mesh, bit-identical to the numpy decode."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    # large/smooth enough that every slab stays on the regression path
    # (tiny noisy slabs legitimately StoreOriData -> serial fallback)
    data = synth((64, 32, 32))
    cfg = SZConfig().with_bound(ErrorBoundMode.ABS, 1e-2)
    mesh = slab._mesh(8)
    sharded = jax.device_put(
        jnp.asarray(data), NamedSharding(mesh, P(slab.AXIS, None, None)))
    blob = slab.compress_sharded(sharded, cfg, n_devices=8)
    out_dev = slab.decompress_sharded(blob, n_devices=8, as_jax=True)
    assert isinstance(out_dev, jax.Array)
    assert len(out_dev.sharding.device_set) == 8
    out_np = slab.decompress_sharded(blob, n_devices=8)
    np.testing.assert_array_equal(np.asarray(out_dev).view(np.uint32),
                                  out_np.view(np.uint32))
    assert np.abs(out_np - data).max() <= 1e-2 * (1 + 1e-6)
