"""Combo bound modes, protectValueRange decode clamp, and 5D folding.

Combo modes (ABS/REL×PW_REL, defines.h:33-41): in SZ 2.1.12.4 every
errorBoundMode >= PW_REL reaches only the pre-log kernels, which ignore
the ABS/REL component (the min/max combo logic survives only in the
legacy segment/pwrgroup paths, CompressElement.c:155-179, unreachable
from the current dispatch) — so combos behave as plain PW_REL while
serializing the combo enum + both bound fields.  Verified against the
reference via config-file runs (the CLI -M rejects combo names).
"""

import pathlib
import re
import subprocess

import numpy as np
import pytest

import sz_tpu
from sz_tpu.config import SZConfig, ErrorBoundMode
from sz_tpu.format import lossless as ll

REF_BIN = pathlib.Path("/tmp/szref/build/bin/sz")
REF_CONF = pathlib.Path("/root/reference/example/sz.config")
need_ref = pytest.mark.skipif(not REF_BIN.exists(),
                              reason="reference binary not built")


def synth(shape, seed=5, offset=0.5):
    rng = np.random.default_rng(seed)
    axes = [np.linspace(0, 4 * np.pi, n) for n in shape]
    grids = np.meshgrid(*axes, indexing="ij")
    field = np.sin(grids[0])
    for g in grids[1:]:
        field = field * np.cos(g)
    return (field + offset
            + 0.05 * rng.standard_normal(shape)).astype(np.float32)


def _ref_conf_compress(data, tmp_path, **conf_keys):
    conf = REF_CONF.read_text()
    for k, v in conf_keys.items():
        conf = re.sub(rf"{k} = .*", f"{k} = {v}", conf)
    (tmp_path / "t.config").write_text(conf)
    dpath = tmp_path / "t.dat"
    data.tofile(dpath)
    dims = [str(d) for d in reversed(data.shape)]
    subprocess.run(
        [str(REF_BIN), "-z", "-f", "-c", str(tmp_path / "t.config"),
         "-i", str(dpath), f"-{data.ndim}", *dims],
        check=True, capture_output=True)
    return (tmp_path / "t.dat.sz").read_bytes()


def _ref_decompress(blob, shape, tmp_path):
    p = tmp_path / "d.sz"
    p.write_bytes(blob)
    dims = [str(d) for d in reversed(shape)]
    subprocess.run(
        [str(REF_BIN), "-x", "-f", "-s", str(p), f"-{len(shape)}", *dims],
        check=True, capture_output=True)
    return np.fromfile(tmp_path / "d.sz.out",
                       dtype=np.float32).reshape(shape)


def _norm15(inner: bytes) -> bytes:
    b = bytearray(inner)
    b[19] = 0  # params[15]: uninitialized in config-file runs
    return bytes(b)


@need_ref
@pytest.mark.parametrize("mode", [
    ErrorBoundMode.ABS_AND_PW_REL, ErrorBoundMode.ABS_OR_PW_REL,
    ErrorBoundMode.REL_AND_PW_REL, ErrorBoundMode.REL_OR_PW_REL])
def test_combo_modes_match_reference(mode, tmp_path):
    shape = (33, 20, 17)
    data = synth(shape)
    golden = _ref_conf_compress(
        data, tmp_path, errorBoundMode=mode.name, absErrBound="1E-3",
        relBoundRatio="1E-3", pw_relBoundRatio="1E-4")
    cfg = SZConfig(error_bound_mode=mode, abs_err_bound=1e-3,
                   rel_bound_ratio=1e-3, pw_rel_bound_ratio=1e-4,
                   segment_size=0)  # iniparser default with a conf file
    ours = sz_tpu.compress(data, cfg)
    assert _norm15(ll.decompress(golden)) == _norm15(ll.decompress(ours))
    ref_out = _ref_decompress(golden, shape, tmp_path)
    assert np.array_equal(sz_tpu.decompress(golden, shape, np.float32),
                          ref_out)
    assert np.array_equal(_ref_decompress(ours, shape, tmp_path),
                          sz_tpu.decompress(ours, shape, np.float32))


@need_ref
def test_protect_value_range_clamp(tmp_path):
    shape = (30, 18, 14)
    data = synth(shape, seed=2)
    golden = _ref_conf_compress(
        data, tmp_path, errorBoundMode="ABS", absErrBound="1E-2",
        protectValueRange="YES")
    ref_out = _ref_decompress(golden, shape, tmp_path)
    ours_dec = sz_tpu.decompress(golden, shape, np.float32)
    assert np.array_equal(ours_dec, ref_out), \
        "clamped decode diverges from reference"
    # the clamp must actually bite at this coarse bound
    fmax = data.max()
    assert ours_dec.max() <= fmax

    cfg = SZConfig(error_bound_mode=ErrorBoundMode.ABS,
                   abs_err_bound=1e-2, protect_value_range=True,
                   segment_size=0)
    ours = sz_tpu.compress(data, cfg)
    assert np.array_equal(_ref_decompress(ours, shape, tmp_path),
                          sz_tpu.decompress(ours, shape, np.float32))


def test_protect_clamp_roundtrip():
    data = synth((24, 16, 12), seed=7)
    cfg = SZConfig(error_bound_mode=ErrorBoundMode.ABS,
                   abs_err_bound=5e-2, protect_value_range=True)
    out = sz_tpu.decompress(sz_tpu.compress(data, cfg), data.shape,
                            np.float32)
    assert out.max() <= data.max() and out.min() >= data.min()


def test_5d_size1_dims_fold():
    data = synth((12, 10, 8))
    d5 = data.reshape(1, 12, 10, 1, 8)
    blob5 = sz_tpu.compress(d5, SZConfig().with_bound(
        ErrorBoundMode.ABS, 1e-3))
    blob3 = sz_tpu.compress(data, SZConfig().with_bound(
        ErrorBoundMode.ABS, 1e-3))
    assert blob5 == blob3
    out = sz_tpu.decompress(blob5, d5.shape, np.float32)
    assert out.shape == d5.shape
    assert np.abs(out - d5).max() <= 1e-3 * (1 + 1e-6)


def test_true_5d_rejected():
    data = np.zeros((3, 3, 3, 3, 3), np.float32)
    data[0, 0, 0, 0, 0] = 1.0
    with pytest.raises(ValueError):
        sz_tpu.compress(data, SZConfig().with_bound(
            ErrorBoundMode.ABS, 1e-5))


def test_decompress_dtype_mismatch_raises():
    """A float stream decoded as double (or vice versa) misparses the
    whole body 8 bytes off; decompress must sniff the stream's own type
    nibble and fail loudly instead."""
    import pytest
    data = np.linspace(0, 1, 4096, dtype=np.float32).reshape(16, 16, 16)
    cfg = SZConfig().with_bound(ErrorBoundMode.ABS, 1e-3)
    blob = sz_tpu.compress(data, cfg)
    with pytest.raises(TypeError, match="FLOAT"):
        sz_tpu.decompress(blob, data.shape, np.float64)
    blob64 = sz_tpu.compress(data.astype(np.float64), cfg)
    with pytest.raises(TypeError, match="DOUBLE"):
        sz_tpu.decompress(blob64, data.shape, np.float32)


def test_auto_engine_link_bound_policy(monkeypatch):
    """engine="auto" on a GPU host: large f32 fields take the device
    engine whatever side the data lives on (no link-bound exception),
    small ones stay on the host codec, and explicit requests are always
    honored."""
    from sz_tpu import api
    from sz_tpu.core import regnd
    from sz_tpu.tpu import engine as dev_engine

    big = api._AUTO_JAX_MIN_SIZE
    monkeypatch.setattr(dev_engine.jax, "default_backend", lambda: "gpu")
    assert api._regnd_engine("auto", big) is dev_engine
    assert api._regnd_engine("auto", big - 1) is regnd
    assert api._regnd_engine("jax", 8) is dev_engine
    assert api._regnd_engine("numpy", big) is regnd
    monkeypatch.setattr(dev_engine.jax, "default_backend", lambda: "cpu")
    assert api._regnd_engine("auto", big) is regnd
    assert api._regnd_engine("jax", big) is dev_engine
