"""softf64 MSST19 wavefront parity (sz_tpu/tpu/msst19_soft.py).

The soft path recomputes the whole MSST19 chain in integer software-
f64 (guaranteed host parity on any backend).  Forced on via
SZ_TPU_MSST19_SOFT=1, its streams and decodes must be byte/bit-
identical to the host kernels on this (true-f64 CPU) test backend."""

import numpy as np
import pytest

from sz_tpu.core import pwr
from sz_tpu.format import tdps as tdps_mod

from tests.test_msst19_engine import KW, synth


@pytest.fixture
def soft_forced(monkeypatch):
    monkeypatch.setenv("SZ_TPU_MSST19_SOFT", "1")


@pytest.mark.parametrize("shape,seed,signed", [
    ((24, 19, 23), 3, False),
    ((40, 48, 56), 7, False),
    ((26, 22, 30), 11, True),      # signed: negative escapes in chain
    ((3, 3, 3), 13, False),
    ((33, 1, 17), 17, False),      # degenerate middle axis
    ((1, 40, 30), 19, False),      # single plane through the 3D path
    ((17, 7, 5), 23, False),
    ((48, 37), 29, False),         # 2D: the single-precision chain
    ((52, 44), 31, True),          # 2D signed
    ((2, 2), 37, False),
    ((1, 40), 41, False),
])
def test_soft_encode_decode_parity(soft_forced, shape, seed, signed):
    from sz_tpu.tpu import msst19_engine as me

    data = synth(shape, np.float32, seed=seed, signed=signed)
    data[data == 0] = np.float32(0.5)
    fmax = data.max()
    nz = data.reshape(-1)[np.abs(data).reshape(-1).argmin()]
    t_h = pwr.compress_msst19(data, 1e-3, fmax, nz, oracle=False,
                              **KW)
    t_d = me.compress(data, 1e-3, fmax, nz, **KW)
    assert getattr(t_d, "_device_exact", False)
    assert tdps_mod.to_bytes(t_h) == tdps_mod.to_bytes(t_d)
    out_h = pwr.decompress_pwrel(t_h, shape, np.float32)
    out_d = me.decompress(t_h, shape, np.float32)
    assert np.array_equal(out_h, np.asarray(out_d))


@pytest.mark.parametrize("ratio", [1e-2, 1e-4, 1e-5])
def test_soft_bounds_sweep(soft_forced, ratio):
    from sz_tpu.tpu import msst19_engine as me

    shape = (30, 26, 34)
    data = synth(shape, np.float32, seed=29)
    fmax = data.max()
    nz = np.abs(data[data != 0]).min()
    t_h = pwr.compress_msst19(data, ratio, fmax, nz, **KW)
    t_d = me.compress(data, ratio, fmax, nz, **KW)
    assert tdps_mod.to_bytes(t_h) == tdps_mod.to_bytes(t_d)
    assert np.array_equal(pwr.decompress_pwrel(t_h, shape, np.float32),
                          np.asarray(me.decompress(t_h, shape,
                                                   np.float32)))


def test_soft_skips_verify(soft_forced, monkeypatch):
    """_device_exact streams must bypass the decode-verify fallback in
    pwr.compress_msst19 (the whole point of guaranteed parity)."""
    from sz_tpu.tpu import msst19_engine as me

    shape = (12, 10, 11)
    data = synth(shape, np.float32, seed=31)
    fmax = data.max()
    nz = np.abs(data[data != 0]).min()
    dev_stream = me.compress(data, 1e-3, fmax, nz, **KW)
    assert getattr(dev_stream, "_device_exact", False)
    monkeypatch.setattr(me.jax, "default_backend", lambda: "gpu")
    monkeypatch.setattr(me, "compress", lambda *a, **k: dev_stream)
    monkeypatch.setattr(
        me, "verify_conformant",
        lambda *a: pytest.fail("verify ran for an exact stream"))
    got = pwr.compress_msst19(data, 1e-3, fmax, nz, engine="jax", **KW)
    assert tdps_mod.to_bytes(got) == tdps_mod.to_bytes(dev_stream)


def test_soft_tables_stair_matches_flat():
    """The stairstep counting search must equal the flat
    cache-table gather over the ENTIRE key range."""
    from sz_tpu.tpu import msst19_soft as ms

    jnp = ms.jnp
    tabs = ms.soft_tables(256, 1e-3, 3)
    assert tabs.stair_ok
    keys = np.arange(len(tabs.table_flat) + 64, dtype=np.int32) - 32
    okk = jnp.asarray(np.ones(len(keys), bool))
    st_stair = np.asarray(ms.stair_state_xla(
        jnp.asarray(keys), okk, jnp.asarray(tabs.bounds),
        tabs.lo_key, tabs.hi_key))
    idx = np.clip(keys, 0, len(tabs.table_flat) - 1)
    want = np.where((keys >= 0) & (keys < len(tabs.table_flat)),
                    tabs.table_flat[idx], 0).astype(np.int32)
    assert np.array_equal(st_stair, want)
