"""Classic SZ1.4 device engine (sz_tpu/tpu/classic_engine.py) parity:
streams and reconstructions must be byte/bit-identical to the host
kernels (which are themselves golden-tested against the reference
binary in test_golden_classic_nd.py)."""

import numpy as np
import pytest

from sz_tpu import api
from sz_tpu.config import ErrorBoundMode, SZConfig
from sz_tpu.core import classic_nd
from sz_tpu.format import tdps as tdps_mod

KW = dict(max_range_radius=32768, sample_distance=100,
          pred_threshold=np.float32(0.99))


def _field(shape, dtype, seed=0, noise=0.1):
    rng = np.random.default_rng(seed)
    axes = [np.linspace(0, 6, s) for s in shape]
    grids = np.meshgrid(*axes, indexing="ij")
    d = np.sin(grids[0] * 2)
    for g in grids[1:]:
        d = d * np.cos(g)
    return (d + noise * rng.standard_normal(shape)).astype(dtype)


@pytest.mark.parametrize("shape,dtype,rp", [
    ((20, 24, 18), np.float32, 1e-3),
    ((40, 52), np.float32, 1e-3),
    ((5, 9, 12, 10), np.float32, 1e-4),
    ((14, 16, 12), np.float64, 1e-5),
    ((3, 2, 2, 2), np.float64, 1e-4),
])
def test_stream_and_decode_parity(shape, dtype, rp):
    d = _field(shape, dtype)
    vr = float(d.max() - d.min())
    med = dtype(d.min() + vr / 2)
    t_h = classic_nd.compress_nd(d, rp, vr, med, **KW)
    t_j = classic_nd.compress_nd(d, rp, vr, med, engine="jax", **KW)
    assert tdps_mod.to_bytes(t_h, 8) == tdps_mod.to_bytes(t_j, 8)
    out_h = classic_nd.decompress_nd(t_h, shape, dtype)
    out_j = classic_nd.decompress_nd(t_h, shape, dtype, engine="jax")
    assert np.array_equal(out_h, out_j)


@pytest.mark.parametrize("shape", [(1, 5, 7), (5, 1, 7), (5, 7, 1),
                                   (2, 65), (6, 2, 2)])
def test_degenerate_shapes(shape):
    d = _field(shape, np.float32, noise=0.3)
    vr = float(d.max() - d.min())
    med = np.float32(d.min() + vr / 2)
    t_h = classic_nd.compress_nd(d, 1e-3, vr, med, **KW)
    t_j = classic_nd.compress_nd(d, 1e-3, vr, med, engine="jax", **KW)
    assert tdps_mod.to_bytes(t_h, 8) == tdps_mod.to_bytes(t_j, 8)


def test_escape_heavy_overflow_path():
    """More escapes than the inline ESC_K return forces the second
    device gather; random data at a tiny bound escapes everywhere."""
    rng = np.random.default_rng(1)
    shape = (30, 40, 20)
    d = rng.standard_normal(shape).astype(np.float32)
    vr = float(d.max() - d.min())
    med = np.float32(d.min() + vr / 2)
    t_h = classic_nd.compress_nd(d, 1e-9, vr, med, **KW)
    t_j = classic_nd.compress_nd(d, 1e-9, vr, med, engine="jax", **KW)
    assert tdps_mod.to_bytes(t_h, 8) == tdps_mod.to_bytes(t_j, 8)
    out_h = classic_nd.decompress_nd(t_h, shape, np.float32)
    out_j = classic_nd.decompress_nd(t_h, shape, np.float32, engine="jax")
    assert np.array_equal(out_h, out_j)


def test_api_end_to_end_classic_jax():
    """Full api.compress/decompress with regression off routes the
    classic codec through the device engine at engine='jax' and the
    whole .sz stream matches the host engine byte-for-byte."""
    d = _field((24, 20, 16), np.float32)
    cfg_h = SZConfig(engine="numpy", with_regression=False).with_bound(
        ErrorBoundMode.ABS, 1e-3)
    cfg_j = SZConfig(engine="jax", with_regression=False).with_bound(
        ErrorBoundMode.ABS, 1e-3)
    bh = api.compress(d, cfg_h)
    bj = api.compress(d, cfg_j)
    assert bh == bj
    out_h = api.decompress(bh, d.shape, np.float32, engine="numpy")
    out_j = api.decompress(bh, d.shape, np.float32, engine="jax")
    assert np.array_equal(out_h, out_j)
    dev = api.decompress(bh, d.shape, np.float32, engine="jax",
                         as_jax=True)
    assert np.array_equal(np.asarray(dev), out_h)


def test_classic_packed_types_decode():
    """The fixed-width packed type upload (classic_engine._decode_fn_packed)
    must reconstruct bit-identically to the raw-u16 path."""
    import os
    d = _field((20, 24, 18), np.float32)
    vr = float(d.max() - d.min())
    med = np.float32(d.min() + vr / 2)
    t = classic_nd.compress_nd(d, 1e-3, vr, med, **KW)
    oracle = classic_nd.decompress_nd(t, d.shape, np.float32)
    out = classic_nd.decompress_nd(t, d.shape, np.float32, engine="jax")
    np.testing.assert_array_equal(out.view(np.uint32),
                                  oracle.view(np.uint32))
    old = os.environ.get("SZ_TPU_PACKED_TYPES")
    os.environ["SZ_TPU_PACKED_TYPES"] = "0"
    try:
        raw = classic_nd.decompress_nd(t, d.shape, np.float32,
                                       engine="jax")
    finally:
        if old is None:
            os.environ.pop("SZ_TPU_PACKED_TYPES", None)
        else:
            os.environ["SZ_TPU_PACKED_TYPES"] = old
    np.testing.assert_array_equal(out.view(np.uint32),
                                  raw.view(np.uint32))


def test_classic_device_decode_fsm(device_decode_interpret):
    """With the device decode on, the classic decoder runs the Triton
    FSM kernel (interpret mode on CPU) — reconstruction bit-identical
    to the host decoder, for a smooth field (small tree) and a noisy
    1e-4 field (a tree of thousands of nodes)."""
    used = device_decode_interpret
    d = _field((44, 40, 36), np.float32, seed=9, noise=0.02)
    vr = float(d.max() - d.min())
    med = np.float32(d.min() + vr / 2)
    t = classic_nd.compress_nd(d, 1e-3, vr, med, **KW)
    out_h = classic_nd.decompress_nd(t, d.shape, np.float32)
    out_j = classic_nd.decompress_nd(t, d.shape, np.float32,
                                     engine="jax")
    assert np.array_equal(out_h, out_j)
    assert used == [True]  # the FSM path genuinely ran
    used.clear()
    d2 = _field((30, 28, 26), np.float32, seed=3, noise=0.4)
    vr2 = float(d2.max() - d2.min())
    t2 = classic_nd.compress_nd(d2, 1e-4, vr2,
                                np.float32(d2.min() + vr2 / 2), **KW)
    o2h = classic_nd.decompress_nd(t2, d2.shape, np.float32)
    o2j = classic_nd.decompress_nd(t2, d2.shape, np.float32,
                                   engine="jax")
    assert np.array_equal(o2h, o2j)
    assert used == [True]
