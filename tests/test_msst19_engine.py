"""PW_REL device engine parity (sz_tpu/tpu/msst19_engine.py).

The device MSST19 engine must emit byte-identical TDPS streams and
bit-identical reconstructions vs the host kernels (themselves golden
vs the reference binary in test_golden_classic_nd / the msst19 oracle).
The pre-log family has no dedicated device kernel: its log2/exp2
transform stays on the host (libm parity, SURVEY §7) while the classic
body rides the classic device engine — also byte-checked here.
"""

import numpy as np
import pytest

from sz_tpu import api
from sz_tpu.config import ErrorBoundMode, SZConfig
from sz_tpu.core import pwr
from sz_tpu.format import tdps as tdps_mod

KW = dict(max_range_radius=32768, sample_distance=100,
          pred_threshold=0.99, plus_bits=3)


def synth(shape, T, seed, signed=False):
    rng = np.random.default_rng(seed)
    axes = [np.linspace(0.1, 4 * np.pi, n) for n in shape]
    g = np.meshgrid(*axes, indexing="ij")
    f = np.exp(np.sin(g[0]) * (np.cos(g[-1]) if len(g) > 1 else 1.0))
    f = f * (1 + 0.05 * rng.standard_normal(shape))
    if signed:
        return (f - np.median(f)).astype(T)
    return np.abs(f).astype(T) + T(0.01)


@pytest.mark.parametrize("shape", [
    (48, 37), (24, 19, 23), (7, 5), (3, 3, 3), (1, 40), (2, 2),
    (33, 1, 17), (40, 48, 56)])
@pytest.mark.parametrize("T", [np.float32, np.float64])
def test_device_matches_host(shape, T):
    from sz_tpu.tpu import msst19_engine as me

    data = synth(shape, T, seed=len(shape))
    fmax = data.max()
    nz = np.abs(data[data != 0]).min()
    t_h = pwr.compress_msst19(data, 1e-3, fmax, nz, **KW)
    t_d = me.compress(data, 1e-3, fmax, nz, **KW)
    assert tdps_mod.to_bytes(t_h) == tdps_mod.to_bytes(t_d)
    out_h = pwr.decompress_pwrel(t_h, shape, T)
    out_d = me.decompress(t_h, shape, T)
    assert np.array_equal(out_h, out_d)


@pytest.mark.parametrize("ratio", [1e-2, 1e-4])
def test_device_matches_host_bounds(ratio):
    from sz_tpu.tpu import msst19_engine as me

    shape = (30, 26, 34)
    data = synth(shape, np.float32, seed=11)
    fmax = data.max()
    nz = np.abs(data[data != 0]).min()
    t_h = pwr.compress_msst19(data, ratio, fmax, nz, **KW)
    t_d = me.compress(data, ratio, fmax, nz, **KW)
    assert tdps_mod.to_bytes(t_h) == tdps_mod.to_bytes(t_d)
    assert np.array_equal(pwr.decompress_pwrel(t_h, shape, np.float32),
                          me.decompress(t_h, shape, np.float32))


@pytest.mark.parametrize("shape,T,signed", [
    ((26, 22, 30), np.float32, True),     # signed -> sign bitmap path
    ((26, 22, 30), np.float32, False),
    ((44, 38), np.float64, True),
    ((9, 6, 10, 8), np.float32, False),   # 4D folds to 3D
])
def test_api_end_to_end_msst19(shape, T, signed):
    data = synth(shape, T, seed=3, signed=signed)
    data[data == 0] = T(0.5)
    cfg_h = SZConfig(error_bound_mode=ErrorBoundMode.PW_REL,
                     pw_rel_bound_ratio=1e-3, engine="numpy")
    cfg_d = SZConfig(error_bound_mode=ErrorBoundMode.PW_REL,
                     pw_rel_bound_ratio=1e-3, engine="jax")
    blob_h = api.compress(data, cfg_h)
    blob_d = api.compress(data, cfg_d)
    assert blob_h == blob_d
    out_h = api.decompress(blob_h, shape, T, engine="numpy")
    out_d = api.decompress(blob_h, shape, T, engine="jax")
    assert np.array_equal(out_h, out_d)


def test_api_end_to_end_prelog():
    """accelerate off -> pre-log body rides the classic device engine."""
    shape = (26, 22, 30)
    data = synth(shape, np.float32, seed=5)
    cfg_h = SZConfig(error_bound_mode=ErrorBoundMode.PW_REL,
                     pw_rel_bound_ratio=1e-3, accelerate_pw_rel=False,
                     engine="numpy")
    cfg_d = SZConfig(error_bound_mode=ErrorBoundMode.PW_REL,
                     pw_rel_bound_ratio=1e-3, accelerate_pw_rel=False,
                     engine="jax")
    blob_h = api.compress(data, cfg_h)
    blob_d = api.compress(data, cfg_d)
    assert blob_h == blob_d
    assert np.array_equal(api.decompress(blob_h, shape, np.float32,
                                         engine="numpy"),
                          api.decompress(blob_h, shape, np.float32,
                                         engine="jax"))


def test_as_jax_device_out():
    shape = (24, 20, 28)
    data = synth(shape, np.float32, seed=9, signed=True)
    data[data == 0] = np.float32(0.5)
    cfg = SZConfig(error_bound_mode=ErrorBoundMode.PW_REL,
                   pw_rel_bound_ratio=1e-3)
    blob = api.compress(data, cfg)
    out_np = api.decompress(blob, shape, np.float32, engine="numpy")
    out_j = api.decompress(blob, shape, np.float32, engine="jax",
                           as_jax=True)
    assert np.array_equal(out_np, np.asarray(out_j))


def test_chunked_scan_parity(monkeypatch):
    """The plane-sweep fixpoint (SZ_TPU_MSST19_WF=0, the wavefront's
    fallback) must not change a byte vs the host kernels."""
    from sz_tpu.tpu import msst19_engine as me

    monkeypatch.setenv("SZ_TPU_MSST19_WF", "0")
    shape = (17, 7, 5)
    data = synth(shape, np.float32, seed=21)
    fmax = data.max()
    nz = np.abs(data[data != 0]).min()
    t_h = pwr.compress_msst19(data, 1e-3, fmax, nz, **KW)
    t_d = me.compress(data, 1e-3, fmax, nz, **KW)
    assert tdps_mod.to_bytes(t_h) == tdps_mod.to_bytes(t_d)
    assert np.array_equal(pwr.decompress_pwrel(t_h, shape, np.float32),
                          np.asarray(me.decompress(t_h, shape,
                                                   np.float32)))


def test_sharded_pwrel_device_container():
    """The sharded container compresses each slab with
    api.compress(slab, cfg), so engine="jax" slabs ride the MSST19
    device engine; the container must equal the host-engine container
    byte for byte."""
    from sz_tpu.parallel import slab

    shape = (16, 20, 24)
    data = synth(shape, np.float32, seed=31)
    data[data == 0] = np.float32(0.5)
    cfg_h = SZConfig(error_bound_mode=ErrorBoundMode.PW_REL,
                     pw_rel_bound_ratio=1e-3, engine="numpy")
    cfg_d = SZConfig(error_bound_mode=ErrorBoundMode.PW_REL,
                     pw_rel_bound_ratio=1e-3, engine="jax")
    blob_h = slab.compress_sharded(data, cfg_h, n_devices=4)
    blob_d = slab.compress_sharded(data, cfg_d, n_devices=4)
    assert blob_h == blob_d
    out = slab.decompress_sharded(blob_h)
    rel = np.abs(np.asarray(out) - data) / np.abs(data)
    assert rel.max() <= 1e-3 * (1 + 1e-5)


def test_stairstep_lookup_parity(monkeypatch):
    """The gather-free stairstep lookup (me._stair_pack /
    _stair_state / _pt_select, which replace the wavefront scan's
    per-step gathers) must not change a byte vs the
    plain take() lookups.  Force the gather path by disabling the
    pack and compare streams."""
    from sz_tpu.tpu import msst19_engine as me

    shape = (13, 11, 9)
    data = synth(shape, np.float32, seed=41)
    fmax = data.max()
    nz = np.abs(data[data != 0]).min()
    # default path (stairstep on this config)
    t_s = me.compress(data, 1e-3, fmax, nz, **KW)
    monkeypatch.setattr(me, "_stair_pack", lambda *a: None)
    t_g = me.compress(data, 1e-3, fmax, nz, **KW)
    assert tdps_mod.to_bytes(t_s) == tdps_mod.to_bytes(t_g)


def test_stair_pack_invariants():
    """_stair_pack must validate its own envelope: monotone stairstep
    boundaries that reconstruct the cache table exactly, plus the
    pt_exact flag guarding true-f64 backends against an inexact
    (hi, lo) precision-table split."""
    from sz_tpu.core import pwr as _pwr
    from sz_tpu.tpu import msst19_engine as me

    cache = _pwr._cache_table(256, 1e-3, 3)
    pack = me._stair_pack(256, 1e-3, 3)
    assert pack is not None
    bounds, lo_key, hi_key, pt_hi, pt_lo, pt_exact = pack
    assert (np.diff(bounds) >= 0).all()
    assert isinstance(pt_exact, bool)
    table = np.asarray(cache.table).reshape(-1)
    keys = np.arange(table.shape[0])
    recon = (keys[:, None] >= bounds[None, :]).sum(1)
    recon[(keys < lo_key) | (keys > hi_key)] = 0
    assert np.array_equal(recon, table)
    ptable = _pwr._precision_table(256, 1e-3, 3)
    if pt_exact:
        assert np.array_equal(pt_hi.astype(np.float64)
                              + pt_lo.astype(np.float64), ptable)


def test_verify_conformant_and_fallback(monkeypatch):
    """On emulated-f64 backends a diverged device stream is not
    self-correcting (multiplicative predictor), so pwr.compress_msst19
    verifies the device stream decodes within the point-wise bound and
    re-encodes on the host when it does not.  Simulate the divergence
    by handing back a stream for DIFFERENT data."""
    from sz_tpu.tpu import msst19_engine as me

    shape = (9, 8, 7)
    data = synth(shape, np.float32, seed=51)
    fmax = data.max()
    nz = np.abs(data[data != 0]).min()
    good = pwr.compress_msst19(data, 1e-3, fmax, nz, **KW)
    assert me.verify_conformant(good, data, 1e-3)
    other = synth(shape, np.float32, seed=52) * np.float32(3)
    bad = pwr.compress_msst19(other, 1e-3, other.max(),
                              np.abs(other).min(), **KW)
    assert not me.verify_conformant(bad, data, 1e-3)

    # wire-level: a non-conformant device stream must be replaced by
    # the host re-encode
    monkeypatch.setattr(me.jax, "default_backend", lambda: "gpu")
    monkeypatch.setattr(me, "compress",
                        lambda *a, **k: bad)
    got = pwr.compress_msst19(data, 1e-3, fmax, nz, engine="jax",
                              **KW)
    assert tdps_mod.to_bytes(got) == tdps_mod.to_bytes(good)


def test_verify_conformant_signed_field(monkeypatch):
    """A correct stream for a SIGNED field must verify: at verify time
    the sign bitmap / min_log_value are not yet on the TDPS, so the
    check decodes the raw chain and compares magnitudes (a restored
    decode would zero every negative escape and always fail —
    round-4 advisor finding).  The conformant device encode of a
    signed field must also be KEPT, not silently host re-encoded."""
    from sz_tpu.tpu import msst19_engine as me

    shape = (12, 10, 11)
    data = synth(shape, np.float32, seed=61, signed=True)
    data[data == 0] = np.float32(-0.5)
    assert (data < 0).any()
    work = data.copy()   # compress_msst19 contract: zeros replaced
    fmax = work.max()
    nz = work.reshape(-1)[np.abs(work).reshape(-1).argmin()]
    good = pwr.compress_msst19(work, 1e-3, fmax, nz, **KW)
    assert me.verify_conformant(good, work, 1e-3)

    # wire-level: a (conformant) device stream whose parity the
    # backend does not guarantee is verified and returned as-is — the
    # verify must not reject it.
    dev_stream = me.compress(work, 1e-3, fmax, nz, **KW)
    # simulate a non-guaranteed (float-wavefront) device stream: the
    # softf64 path marks streams _device_exact, which skips the verify
    dev_stream._device_exact = False
    verified = []
    real_verify = me.verify_conformant
    monkeypatch.setattr(me.jax, "default_backend", lambda: "gpu")
    monkeypatch.setattr(me, "compress", lambda *a, **k: dev_stream)
    monkeypatch.setattr(
        me, "verify_conformant",
        lambda *a: verified.append(real_verify(*a)) or verified[-1])
    got = pwr.compress_msst19(work, 1e-3, fmax, nz, engine="jax", **KW)
    assert verified == [True]
    assert tdps_mod.to_bytes(got) == tdps_mod.to_bytes(good)
