"""Compress-from-device parity: a jax.Array input must produce the
exact bytes of the host path, with no host materialization of the
lattice on the regression codec.

The device path skips the upload, runs the optimizer's sampling walks
as device gathers (engine._opt_gather_fn) and the dense-mean mask as a
device compact-gather (engine._mask_vals_fn), then reuses the host f64
histogram/selection tail (optimizer._finish) — so parity here covers
the full optimizer decision chain (intervals, dense_pos, use_mean,
sequential mean fold), not just the quantize stages.

Runs on the CPU backend (conftest pins the platform); chip_smoke.py
checks the same parity on the GPU.
"""

import pathlib

import numpy as np
import pytest

jnp = pytest.importorskip("jax.numpy")

import sz_tpu  # noqa: E402
from sz_tpu import ErrorBoundMode, SZConfig  # noqa: E402
from sz_tpu.core import regnd  # noqa: E402
from sz_tpu.tpu import engine  # noqa: E402

GOLDEN = pathlib.Path(__file__).parent / "golden"

KW = dict(max_range_radius=32768, sample_distance=100,
          pred_threshold=np.float32(0.99))


def _ref3d():
    """A seeded field at the reference's testfloat_8_8_128 shape."""
    rng = np.random.default_rng(128)
    n = 128 * 8 * 8
    return (np.sin(np.linspace(0, 6 * np.pi, n)) * 10
            + rng.standard_normal(n) * 0.01).astype(np.float32).reshape(
        128, 8, 8)


def _synth_mean():
    # exercises use_mean=True (dense cluster) + escapes
    return np.fromfile(GOLDEN / "synth_f32_64.dat",
                       dtype="<f4").reshape(64, 64, 64)


@pytest.mark.parametrize("case", ["ref3d", "mean3d", "f64"])
def test_engine_device_input_bytes(case):
    if case == "ref3d":
        data, prec = _ref3d(), 1e-4
    elif case == "mean3d":
        data, prec = _synth_mean(), 1e-3
    else:
        data = _ref3d().astype(np.float64)
        prec = 1e-6
    host = engine.compress(data, prec, **KW)
    dev = engine.compress(jnp.asarray(data), prec, **KW)
    assert dev.body == host.body
    oracle = regnd.compress(data, prec, **KW)
    assert dev.body == oracle.body


def test_engine_device_input_2d():
    rng = np.random.default_rng(3)
    data = (np.add.outer(np.sin(np.linspace(0, 9, 150)),
                         np.cos(np.linspace(0, 7, 97)))
            + 0.01 * rng.standard_normal((150, 97))).astype(np.float32)
    host = engine.compress(data, 1e-3, **KW)
    dev = engine.compress(jnp.asarray(data), 1e-3, **KW)
    assert dev.body == host.body


@pytest.mark.parametrize("mode,bound", [
    (ErrorBoundMode.ABS, 1e-4),
    (ErrorBoundMode.REL, 1e-4),
])
def test_api_device_input_stream(mode, bound):
    data = _ref3d()
    cfg = SZConfig(engine="jax").with_bound(mode, bound)
    blob_host = sz_tpu.compress(data, cfg)
    blob_dev = sz_tpu.compress(jnp.asarray(data), cfg)
    assert blob_dev == blob_host
    out = sz_tpu.decompress(blob_dev, data.shape, np.float32)
    assert np.isfinite(out).all()


def test_api_device_input_auto_engine():
    """engine='auto' + device input: on an accelerator it stays on
    device (forced jax); on a CPU-only backend it materializes into the
    faster native host path.  Either way the stream is byte-identical
    to the explicit jax-engine host-input call."""
    data = _synth_mean()
    cfg = SZConfig().with_bound(ErrorBoundMode.ABS, 1e-3)
    blob_host = sz_tpu.compress(data, SZConfig(engine="jax").with_bound(
        ErrorBoundMode.ABS, 1e-3))
    blob_dev = sz_tpu.compress(jnp.asarray(data), cfg)
    assert blob_dev == blob_host


def test_api_device_input_4d_fold():
    rng = np.random.default_rng(11)
    data = rng.standard_normal((4, 6, 32, 32)).astype(np.float32)
    cfg = SZConfig(engine="jax").with_bound(ErrorBoundMode.ABS, 1e-2)
    assert sz_tpu.compress(jnp.asarray(data), cfg) == \
        sz_tpu.compress(data, cfg)


def test_api_device_input_constant():
    data = np.full((40, 40, 40), 2.5, np.float32)
    cfg = SZConfig(engine="jax").with_bound(ErrorBoundMode.ABS, 1e-3)
    blob = sz_tpu.compress(jnp.asarray(data), cfg)
    assert blob == sz_tpu.compress(data, cfg)
    out = sz_tpu.decompress(blob, data.shape, np.float32)
    assert (out == 2.5).all()


def test_api_device_input_fallbacks():
    """Configs without a device path must round-trip via the numpy
    materialization, byte-identical to the host call."""
    data = np.abs(_ref3d()) + 1.0
    dev = jnp.asarray(data)
    # PW_REL has no device path
    cfg = SZConfig().with_bound(ErrorBoundMode.PW_REL, 1e-3)
    assert sz_tpu.compress(dev, cfg) == sz_tpu.compress(data, cfg)
    # classic codec (withRegression=NO)
    cfg = SZConfig(with_regression=False).with_bound(
        ErrorBoundMode.ABS, 1e-3)
    assert sz_tpu.compress(dev, cfg) == sz_tpu.compress(data, cfg)
    # 1D
    d1 = np.ascontiguousarray(data.reshape(-1)[:5000])
    cfg = SZConfig().with_bound(ErrorBoundMode.ABS, 1e-3)
    assert sz_tpu.compress(jnp.asarray(d1), cfg) == \
        sz_tpu.compress(d1, cfg)
    # int dtype
    di = (data * 100).astype(np.int32)
    assert sz_tpu.compress(jnp.asarray(di), cfg) == \
        sz_tpu.compress(di, cfg)


def test_device_input_f64_auto_materializes(monkeypatch):
    """engine='auto' + float64 device input materializes to the host
    codec on a CPU-only host (the fast path returns None), like f32;
    on a GPU it takes the device path, whose f64 bytes equal the host
    engine's (chip_smoke.py phase c)."""
    import jax
    from sz_tpu import api as api_mod

    cfg = SZConfig().with_bound(ErrorBoundMode.ABS, 1e-6)
    d64 = jnp.asarray(_ref3d().astype(np.float64))
    assert api_mod._try_compress_device(d64, cfg) is None
    seen = []
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    monkeypatch.setattr(api_mod, "_compress_fp",
                        lambda data, c, dt: seen.append(c.engine) or b"")
    assert api_mod._try_compress_device(d64, cfg) == b""
    assert seen == ["jax"]
    # explicit engine="jax" still honors the request for f64
    cfg_explicit = SZConfig(engine="jax").with_bound(
        ErrorBoundMode.ABS, 1e-6)
    monkeypatch.undo()  # back to the real (cpu) backend for execution
    blob = api_mod._try_compress_device(d64, cfg_explicit)
    assert blob is not None
