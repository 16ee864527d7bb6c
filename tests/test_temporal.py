"""Temporal mode parity vs reference-library goldens (gen_ts.c):
5 steps of a 4096-point float field, snapshotCmprStep=3
(steps 0,3 snapshots; 1,2,4 temporal)."""

import pathlib

import numpy as np
import pytest

from sz_tpu import SZConfig, ErrorBoundMode
from sz_tpu.temporal import TemporalCompressor
import sz_tpu.temporal as tmod

GOLDEN = pathlib.Path(__file__).parent / "golden"
STEPS = 5
N = 4096


def _have_goldens():
    return (GOLDEN / "ts_step0.sz").exists()


@pytest.mark.skipif(not _have_goldens(), reason="ts goldens missing")
def test_temporal_stream_bit_exact():
    tc = TemporalCompressor(snapshot_step=3)
    tc.register(1, "v", (N,), np.float32,
                SZConfig().with_bound(ErrorBoundMode.ABS, 1e-4))
    for s in range(STEPS):
        data = np.fromfile(GOLDEN / f"ts_step{s}.in", dtype="<f4")
        frame = tc.compress_step({1: data})
        golden = (GOLDEN / f"ts_step{s}.sz").read_bytes()
        # compare the frame structure + inner streams (normalize the
        # uninitialized params byte in classic snapshot payloads)
        assert _norm_frame(frame) == _norm_frame(golden), f"step {s}"


def _norm_frame(frame: bytes) -> bytes:
    """Frame: [step u32][nvars u16] {hdr 11B}{payload}; normalize byte 19
    of each decompressed payload (classic leaves it uninitialized)."""
    from sz_tpu.format import lossless as ll
    import struct

    pos = 6
    out = [frame[:6]]
    (nvars,) = struct.unpack_from("<H", frame, 4)
    for _ in range(nvars):
        hdr = frame[pos:pos + 11]
        (csize,) = struct.unpack_from("<Q", frame, pos + 3)
        payload = frame[pos + 11:pos + 11 + csize]
        inner = bytearray(ll.decompress(payload, expected_size=N * 8 + 64))
        if not (inner[3] & 0x80):
            inner[19] = 0
        out.append(hdr[:3])
        out.append(bytes(inner))
        pos += 11 + csize
    return b"".join(out)


@pytest.mark.skipif(not _have_goldens(), reason="ts goldens missing")
def test_temporal_decode_bit_exact():
    tc = TemporalCompressor(snapshot_step=3)
    tc.register(1, "v", (N,), np.float32,
                SZConfig().with_bound(ErrorBoundMode.ABS, 1e-4))
    for s in range(STEPS):
        golden = (GOLDEN / f"ts_step{s}.sz").read_bytes()
        out = tc.decompress_step(golden)[1]
        ref = np.fromfile(GOLDEN / f"ts_step{s}.out", dtype="<f4")
        np.testing.assert_array_equal(out.view(np.uint32),
                                      ref.view(np.uint32),
                                      err_msg=f"step {s}")


def test_temporal_roundtrip_bound():
    rng = np.random.default_rng(5)
    tc = TemporalCompressor(snapshot_step=2)
    td = TemporalCompressor(snapshot_step=2)
    for c in (tc, td):
        c.register(7, "x", (2048,), np.float32,
                   SZConfig().with_bound(ErrorBoundMode.ABS, 1e-3))
    base = np.cumsum(rng.standard_normal(2048)).astype(np.float32)
    for s in range(4):
        data = base + np.float32(0.01 * s)
        frame = tc.compress_step({7: data})
        out = td.decompress_step(frame)[7]
        assert np.abs(out - data).max() <= 1e-3 * (1 + 1e-6), f"step {s}"


def test_device_ts_step_parity():
    """compress_1d_ts_device must produce byte-identical TDPS streams
    and a bit-identical carried reconstruction vs the host kernel."""
    import jax.numpy as jnp
    from sz_tpu.format import tdps as tdps_mod

    rng = np.random.default_rng(4)
    n = 50000
    prev = np.sin(np.linspace(0, 30, n)).astype(np.float32)
    cur = (prev + 0.002 * rng.standard_normal(n)).astype(np.float32)
    # salt with jumps so some points escape
    cur[::997] += 1.5
    vr = float(cur.max() - cur.min())
    med = np.float32(cur.min() + vr / 2)
    kw = dict(max_range_radius=32768, sample_distance=100,
              pred_threshold=np.float32(0.99))
    t_h, rec_h = tmod.compress_1d_ts(cur, prev, 1e-3, vr, med, **kw)
    t_d, rec_d = tmod.compress_1d_ts_device(
        jnp.asarray(cur), jnp.asarray(prev), 1e-3, vr, med, **kw)
    assert tdps_mod.to_bytes(t_h, 8) == tdps_mod.to_bytes(t_d, 8)
    np.testing.assert_array_equal(np.asarray(rec_d).view(np.uint32),
                                  rec_h.view(np.uint32))


def test_temporal_compressor_device_frames_identical():
    """A TemporalCompressor fed device-resident snapshots must emit the
    exact frames of the numpy-input run, across snapshot + ts steps,
    with the history carried on device."""
    import jax.numpy as jnp

    rng = np.random.default_rng(9)
    shape = (40, 50)
    base = np.sin(np.linspace(0, 12, 2000)).reshape(shape)
    steps = [(base + 0.01 * k + 0.002 * rng.standard_normal(shape)
              ).astype(np.float32) for k in range(5)]
    cfg = SZConfig().with_bound(ErrorBoundMode.ABS, 1e-3)

    tc_h = TemporalCompressor(snapshot_step=3)
    tc_h.register(0, "v", shape, np.float32, cfg)
    tc_d = TemporalCompressor(snapshot_step=3)
    tc_d.register(0, "v", shape, np.float32, cfg)
    for s in steps:
        f_h = tc_h.compress_step({0: s})
        f_d = tc_d.compress_step({0: jnp.asarray(s)})
        assert f_d == f_h
        # round-trip stays within bound
        dec = TemporalCompressor(snapshot_step=3)
    # full decode of the host frames equals decode of device frames
    tc_dec = TemporalCompressor(snapshot_step=3)
    tc_dec.register(0, "v", shape, np.float32, cfg)
    tc_h2 = TemporalCompressor(snapshot_step=3)
    tc_h2.register(0, "v", shape, np.float32, cfg)
    for s in steps:
        out = tc_dec.decompress_step(tc_h2.compress_step({0: s}))
        assert np.abs(out[0] - s).max() <= 1e-3 * (1 + 1e-6)


def test_temporal_device_decode_bit_exact(device_decode_interpret):
    """decompress_step(as_jax=True): device FSM type decode + fused
    restore must be bit-identical to the host decoder, with the history
    carried on device across steps (incl. a snapshot step mid-chain)."""
    n = 1 << 16
    rng = np.random.default_rng(5)
    x = np.linspace(0, 20 * np.pi, n, dtype=np.float32)
    cfg = SZConfig().with_bound(ErrorBoundMode.ABS, 1e-4)

    tc = TemporalCompressor(snapshot_step=3)
    tc.register(1, "v", (n,), np.float32, cfg)
    blobs = []
    base = np.sin(x) + 0.05 * rng.standard_normal(n).astype(np.float32)
    for s in range(4):
        step = (base + np.float32(0.01) * s
                + np.float32(0.003) * np.sin(x * (s + 1))).astype(
            np.float32)
        blobs.append(tc.compress_step({1: step}))

    dec_h = TemporalCompressor(snapshot_step=3)
    dec_h.register(1, "v", (n,), np.float32, cfg)
    dec_d = TemporalCompressor(snapshot_step=3)
    dec_d.register(1, "v", (n,), np.float32, cfg)
    for s, blob in enumerate(blobs):
        out_h = dec_h.decompress_step(blob)[1]
        out_d = dec_d.decompress_step(blob, as_jax=True)[1]
        assert np.array_equal(np.asarray(out_h), np.asarray(out_d)), \
            f"step {s}"
        import jax
        assert isinstance(out_d, jax.Array)
