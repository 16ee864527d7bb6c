"""Top-level compress/decompress drivers (analog of sz.c + sz_float.c entry).

Dispatch: dtype x dimensionality x bound mode -> codec kernel, plus the
whole-stream framing (header, skip/constant/verbatim fallbacks, lossless
wrap).  Mirrors SZ_compress_args / SZ_decompress_args behavior
(sz.c:294,486; sz_float.c:2811; sz_double.c:2531; szd_float.c:50).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from sz_tpu.config import (
    SZConfig, DEFAULT_CONFIG, ErrorBoundMode, DataType, SZMode,
    MIN_NUM_OF_ELEMENTS,
)
from sz_tpu.format import bytes_util as bu
from sz_tpu.format import lossless as ll
from sz_tpu.format import metadata as md
from sz_tpu.core import classic, classic_nd, intc, pwr, regnd
from sz_tpu.format import tdps as tdps_mod

_DTYPE_MAP = {
    np.dtype(np.float32): DataType.FLOAT,
    np.dtype(np.float64): DataType.DOUBLE,
}


def _filter_dims(shape) -> tuple:
    """filterDimension (sz.c:162-282): drop size-1 dims."""
    dims = [int(d) for d in shape if int(d) > 1]
    return tuple(dims) if dims else (1,)


def _resolve_precision(cfg: SZConfig, value_range: float, n: int,
                       dt: DataType = DataType.FLOAT):
    """Bound-mode resolution (sz_float.c:2852-2868, dataCompression.c:311).

    Returns (real_precision double, effective_mode_for_codec).
    """
    mode = cfg.error_bound_mode
    if mode == ErrorBoundMode.PSNR:
        # computeABSErrBoundFromPSNR (conf.c:54); predThreshold is stored as
        # float in the reference, so round it through float32 first
        pt = float(np.float32(cfg.pred_threshold))
        v1 = cfg.psnr + 10 * math.log10(1 - 2.0 / 3.0 * pt)
        rp = value_range * (10.0 ** (v1 / -20.0))
        return rp, ErrorBoundMode.ABS
    if mode == ErrorBoundMode.NORM:
        rp = math.sqrt(3.0 / n) * cfg.norm_err
        return rp, ErrorBoundMode.ABS
    if mode == ErrorBoundMode.ABS:
        return cfg.abs_err_bound, mode
    if mode == ErrorBoundMode.REL:
        return cfg.rel_bound_ratio * value_range, mode
    if mode in (ErrorBoundMode.ABS_AND_REL, ErrorBoundMode.ABS_OR_REL):
        # getRealPrecision_float uses min_f/max_f (float32 compare+result,
        # dataCompression.c:310-340); the double path stays in float64
        a, b = cfg.abs_err_bound, cfg.rel_bound_ratio * value_range
        if dt == DataType.FLOAT:
            a, b = float(np.float32(a)), float(np.float32(b))
        pick = min if mode == ErrorBoundMode.ABS_AND_REL else max
        return pick(a, b), mode
    if mode.is_pw_rel:
        # PW_REL and the ABS/REL×PW_REL combos: the modern pre-log
        # kernels never consult absErrBound/relBoundRatio (the combo
        # min/max logic lives only in the legacy segment/pwrgroup paths,
        # CompressElement.c:155-179, which the 2.1.12.4 dispatch no
        # longer reaches) — so every mode >= PW_REL behaves as plain
        # PW_REL (sz_float.c:2888)
        return 0.0, ErrorBoundMode.PW_REL
    raise ValueError(f"unsupported bound mode {mode}")


# use the device engine automatically above this element count ("auto");
# below it the numpy oracle's latency wins (no device round-trips)
_AUTO_JAX_MIN_SIZE = 1 << 18


def _regnd_engine(engine: str, n: int):
    """Pick the regression-codec implementation: numpy oracle or the
    device (JAX) engine — both produce identical bytes for f32 and f64
    (tests/test_tpu_engine on the CPU, chip_smoke.py on the GPU).  A
    failed device import under an explicit engine="jax" raises; it
    never turns into a silent host run."""
    if engine == "numpy":
        return regnd
    if engine == "jax" or (engine == "auto" and n >= _AUTO_JAX_MIN_SIZE):
        try:
            from sz_tpu.tpu import engine as tpu_engine
            # "auto" only picks the device engine when an accelerator
            # is attached: on CPU-only hosts the native host codec beats
            # XLA:CPU (which also runs fusion-disabled for bit parity)
            if engine == "jax" or tpu_engine.jax.default_backend() != "cpu":
                return tpu_engine
        except Exception:  # pragma: no cover - jax unavailable
            if engine == "jax":
                raise
    return regnd


def _is_jax_array(x) -> bool:
    if isinstance(x, np.ndarray):
        return False
    try:
        import jax
        return isinstance(x, jax.Array)
    except Exception:  # pragma: no cover - jax unavailable
        return False


def _try_compress_device(data, cfg: SZConfig):
    """Compress-from-device fast path: a jax.Array input (simulation
    output / checkpoint shard already in device memory) goes straight
    into the device regression engine with NO host round-trip of the
    lattice — the range scan, optimizer sampling gathers, quantize,
    histogram, escape gather and Huffman bit-pack all run on device;
    only compact vectors and the compressed stream cross the bus.
    Returns None when the requested codec has no device path (PW_REL,
    classic, RA, ints, tiny arrays, explicit engine="numpy"); the
    caller then materializes to numpy."""
    dims = _filter_dims(data.shape)
    n = int(np.prod(dims))
    dt = _DTYPE_MAP.get(np.dtype(data.dtype))
    if (dt is None or n <= MIN_NUM_OF_ELEMENTS
            or cfg.error_bound_mode.is_pw_rel or cfg.random_access
            or not cfg.with_regression or len(dims) not in (2, 3, 4)
            or cfg.engine == "numpy"):
        return None
    if cfg.engine == "auto":
        import jax
        if jax.default_backend() == "cpu":
            # a "device" array on a CPU-only host is a host buffer: the
            # native host codec beats fusion-disabled XLA:CPU, so let
            # the caller materialize (free) and take the numpy path
            return None
        cfg = dataclasses.replace(cfg, engine="jax")
    return _compress_fp(data.reshape(dims), cfg, dt)


def compress(data: np.ndarray, cfg: SZConfig = DEFAULT_CONFIG) -> bytes:
    """Compress an array into a reference-compatible SZ2 stream.

    `data` may be a device-resident jax.Array (compress-from-device):
    regression-codec configs then run end-to-end on the device without
    materializing the array on the host."""
    if _is_jax_array(data):
        blob = _try_compress_device(data, cfg)
        if blob is not None:
            return blob
    data = np.asarray(data)
    dims = _filter_dims(data.shape)
    n = int(np.prod(dims))
    if data.dtype in intc.SPECS:
        return _compress_int(data.reshape(dims), cfg)
    dt = _DTYPE_MAP.get(data.dtype)
    if dt is None:
        raise TypeError(f"unsupported dtype {data.dtype}")

    if n <= MIN_NUM_OF_ELEMENTS:
        # SZ_skip_compress_float (sz_float.c:37): raw bytes, no framing
        return data.tobytes()
    return _compress_fp(data.reshape(dims), cfg, dt)


def _compress_int(data: np.ndarray, cfg: SZConfig) -> bytes:
    """SZ_compress_args_int{8..64} analog (e.g. sz_int32.c:1193)."""
    spec = intc.SPECS[data.dtype]
    flat = data.reshape(-1)
    mn, vrange = intc.range_size_int(flat)
    mode = cfg.error_bound_mode
    if mode == ErrorBoundMode.PSNR:
        pt = float(np.float32(cfg.pred_threshold))
        rp = vrange * (10.0 ** ((cfg.psnr
                                 + 10 * math.log10(1 - 2.0 / 3.0 * pt))
                                / -20.0))
    else:
        rp, _ = _resolve_precision(cfg, float(vrange), data.size,
                                   DataType.FLOAT)
    hdr_cfg = dataclasses.replace(cfg, abs_err_bound=rp)
    params = md.serialize_params(hdr_cfg, spec.dt, 0.0, 0.0)
    if vrange == 0:
        # constant field -> allSameData stream (sz_uint16.c:1252)
        body = intc.same_int(data, params, int(cfg.sz_mode),
                             cfg.size_type)
    else:
        t = intc.compress_int(
            data, rp, max_range_radius=cfg.max_range_radius,
            sample_distance=cfg.sample_distance,
            pred_threshold=np.float32(cfg.pred_threshold),
            opt_quant_mode=1 if cfg.quantization_intervals == 0 else 0,
            fixed_intervals=cfg.quantization_intervals)
        body = intc.itdps_to_bytes(t, params, int(cfg.sz_mode),
                                   cfg.size_type)
        if len(body) > data.size * spec.esize:
            # StoreOriData fallback, pre-lossless (sz_uint16.c:561)
            body = intc.store_ori_int(data, params, cfg.size_type)
    if cfg.sz_mode == SZMode.BEST_SPEED:
        return body
    return ll.compress(body, cfg.lossless, cfg.lossless_level)


def _fp_stream_params(data: np.ndarray, cfg: SZConfig, dt: DataType):
    """Range scan + bound resolution + header-config rewrite for one
    float/double stream (sz_float.c:2838-2868).  Shared by the serial
    driver below and the slab-parallel pipeline (parallel/slab.py), whose
    per-slab streams must be byte-identical to the serial ones.

    Returns (fmin, fmax, value_range, rp, eff_mode, hdr_cfg, range_info).
    """
    T = np.float32 if dt == DataType.FLOAT else np.float64
    n = data.size
    flat = data.reshape(-1)
    # PW_REL accelerated path needs its own range scan that also collects
    # signs/nearZero (sz_float.c:2838-2843)
    is_pwrel = cfg.error_bound_mode.is_pw_rel
    accelerate = (cfg.accelerate_pw_rel
                  and not (cfg.pw_rel_bound_ratio < 0.000009999))
    range_info = None
    if is_pwrel and accelerate:
        range_info = pwr.range_size_msst19(data.astype(T, copy=False))
        fmin, value_range = range_info[0], range_info[1]
    else:
        # computeRangeSize (dataCompression.c:102/148): order-independent
        fmin = T(flat.min())
        value_range = T(T(flat.max()) - fmin)
    # the reference serializes max as min+range (sz_float.c:2847), which
    # can differ from the true max by one ulp — _fp_params_from_range
    # replicates the double rounding
    out = _fp_params_from_range(cfg, dt, fmin, value_range, n)
    return (*out[:6], range_info)


def _fp_params_from_range(cfg: SZConfig, dt: DataType, fmin, value_range,
                          n: int):
    """Bound resolution + header rewrite from an already-computed range
    (fmin/value_range in the stream dtype).  Shared by the data-scanning
    path above and the sharded device-input path (parallel/slab.py),
    whose per-slab ranges come from on-device reductions."""
    T = np.float32 if dt == DataType.FLOAT else np.float64
    fmax = T(fmin + value_range)
    rp, eff_mode = _resolve_precision(cfg, float(value_range), n, dt)
    hdr_cfg = cfg
    if cfg.error_bound_mode in (ErrorBoundMode.PSNR, ErrorBoundMode.NORM):
        # the reference rewrites errorBoundMode=ABS + absErrBound before
        # serializing params (sz_float.c:2853-2867)
        hdr_cfg = dataclasses.replace(
            cfg, error_bound_mode=ErrorBoundMode.ABS, abs_err_bound=rp)
    elif not cfg.error_bound_mode.is_pw_rel:
        hdr_cfg = dataclasses.replace(cfg, abs_err_bound=rp)
    return fmin, fmax, value_range, rp, eff_mode, hdr_cfg, None


def _compress_fp(data: np.ndarray, cfg: SZConfig, dt: DataType) -> bytes:
    T = np.float32 if dt == DataType.FLOAT else np.float64
    n = data.size
    flat = data.reshape(-1)
    (fmin, fmax, value_range, rp, eff_mode, hdr_cfg,
     range_info) = _fp_stream_params(data, cfg, dt)

    if value_range <= rp:
        return _constant_stream(hdr_cfg, dt, fmin, fmax, flat[0], n)

    if eff_mode == ErrorBoundMode.PW_REL:
        if data.ndim == 4:
            # 4D PW_REL folds to 3D (r4*r3, r2, r1) in the reference for
            # both pre-log (sz_float.c:2994-2997) and MSST19
            # (sz_float.c:2989-2992, sz_double.c:2690-2692)
            d = data.shape
            data = data.reshape(d[0] * d[1], d[2], d[3])
        accelerate = (cfg.accelerate_pw_rel
                      and not (cfg.pw_rel_bound_ratio < 0.000009999))
        if range_info is None:
            range_info = (fmin, fmax)
        t = pwr.compress_pwrel(
            data, cfg.pw_rel_bound_ratio, accelerate=accelerate,
            range_info=range_info, max_range_radius=cfg.max_range_radius,
            sample_distance=cfg.sample_distance,
            pred_threshold=np.float32(cfg.pred_threshold),
            plus_bits=cfg.plus_bits,
            opt_quant_mode=1 if cfg.quantization_intervals == 0 else 0,
            fixed_intervals=cfg.quantization_intervals,
            engine=cfg.engine)
        t.segment_size = cfg.segment_size
        header = md.make_header(hdr_cfg, dt, fmin, fmax, pw_rel=True,
                                msst19=bool(t.msst19))
        body = header + bu.size_be(n, cfg.size_type) \
            + tdps_mod.to_bytes(t, cfg.size_type)
        esize = np.dtype(T).itemsize
        mlen = md.meta_length(dt)
        if len(body) >= n * esize + 3 + mlen + cfg.size_type + 1:
            body = _store_ori(hdr_cfg, dt, fmin, fmax, flat, n)
        if cfg.sz_mode == SZMode.BEST_SPEED:
            return body
        return ll.compress(body, cfg.lossless, cfg.lossless_level)

    dims = data.shape
    ndim = len(dims)
    if (cfg.random_access and dt == DataType.FLOAT and ndim in (1, 2, 3)):
        # HAVE_RANDOMACCESS path (sz_float.c:2913,2949,2985): float-only
        # upstream; 4D ignores the flag (sz_float.c:3010) and doubles
        # have no RA kernels (sz_double.c) — both fall through below.
        from sz_tpu.core import rablock
        res = rablock.compress_ra(data, rp, cfg)
        header = md.make_header(hdr_cfg, dt, fmin, fmax, regression=True,
                                random_access=True)
        body = header + bu.size_be(n, cfg.size_type) + res.body
        from sz_tpu.utils import stats as _stats
        if cfg.sz_mode == SZMode.BEST_SPEED:
            _stats.record(original_size=data.nbytes,
                          compressed_size=len(body))
            return body
        out = ll.compress(body, cfg.lossless, cfg.lossless_level)
        _stats.record(original_size=data.nbytes, compressed_size=len(out))
        return out

    if ndim == 4 and cfg.with_regression:
        # the regression path folds 4D to 3D: (r4*r3, r2, r1)
        # (sz_float.c:3010); the classic path has a true 4D kernel
        data = data.reshape(dims[0] * dims[1], dims[2], dims[3])
        ndim = 3

    if ndim in (2, 3) and cfg.with_regression and not cfg.random_access:
        res = _regnd_engine(cfg.engine, data.size).compress(
            data, rp, max_range_radius=cfg.max_range_radius,
            sample_distance=cfg.sample_distance,
            pred_threshold=np.float32(cfg.pred_threshold),
            opt_quant_mode=1 if cfg.quantization_intervals == 0 else 0,
            fixed_intervals=cfg.quantization_intervals,
            size_type=cfg.size_type)
        return _frame_regression_stream(cfg, hdr_cfg, dt, fmin, fmax,
                                        flat, n, res)
    elif ndim == 1:
        median = T(fmin + value_range / T(2))
        t = classic.compress_1d(
            data, rp, value_range, median,
            max_range_radius=cfg.max_range_radius,
            sample_distance=cfg.sample_distance,
            pred_threshold=np.float32(cfg.pred_threshold),
            opt_quant_mode=1 if cfg.quantization_intervals == 0 else 0,
            fixed_intervals=cfg.quantization_intervals)
        header = md.make_header(hdr_cfg, dt, fmin, fmax)
        body = (header + bu.size_be(n, cfg.size_type)
                + tdps_mod.to_bytes(t, cfg.size_type))
    elif ndim in (2, 3, 4):
        # classic SZ1.4 path (withRegression=NO, conf.c:256)
        median = T(fmin + value_range / T(2))
        t = classic_nd.compress_nd(
            data, rp, value_range, median,
            max_range_radius=cfg.max_range_radius,
            sample_distance=cfg.sample_distance,
            pred_threshold=np.float32(cfg.pred_threshold),
            opt_quant_mode=1 if cfg.quantization_intervals == 0 else 0,
            fixed_intervals=cfg.quantization_intervals,
            engine=cfg.engine)
        header = md.make_header(hdr_cfg, dt, fmin, fmax)
        body = (header + bu.size_be(n, cfg.size_type)
                + tdps_mod.to_bytes(t, cfg.size_type))
    else:
        # the reference accepts 5D shapes only when filterDimension
        # (applied above) drops size-1 dims to <=4; genuine 5D errors
        # (sz_float.c:3016 "doesn't support 5 dimensions for now")
        raise ValueError(f"{ndim} dimensions unsupported (the reference "
                         "supports at most 4 after dropping size-1 dims)")

    # StoreOriData fallback (sz_float.c:526): verbatim big-endian values
    esize = np.dtype(T).itemsize
    mlen = md.meta_length(dt)
    if len(body) >= n * esize + 3 + mlen + cfg.size_type + 1:
        body = _store_ori(hdr_cfg, dt, fmin, fmax, flat, n)

    from sz_tpu.utils import stats as _stats
    if cfg.sz_mode == SZMode.BEST_SPEED:
        _stats.record(original_size=data.nbytes, compressed_size=len(body))
        return body
    out = ll.compress(body, cfg.lossless, cfg.lossless_level)
    _stats.record(original_size=data.nbytes, compressed_size=len(out))
    return out


def _frame_regression_stream(cfg, hdr_cfg, dt, fmin, fmax, flat, n,
                             res) -> bytes:
    """Whole-stream framing around a regression-codec body (header +
    element count + body, StoreOriData fallback, lossless wrap, stats) —
    the tail of SZ_compress_args_float (sz_float.c:2978-3039).  Shared by
    the serial driver and parallel/slab.py so per-slab streams are
    byte-identical to serial ones."""
    T = np.float32 if dt == DataType.FLOAT else np.float64
    header = md.make_header(hdr_cfg, dt, fmin, fmax, regression=True,
                            random_access=cfg.random_access)
    body = header + bu.size_be(n, cfg.size_type) + res.body
    esize = np.dtype(T).itemsize
    mlen = md.meta_length(dt)
    if len(body) >= n * esize + 3 + mlen + cfg.size_type + 1:
        body = _store_ori(hdr_cfg, dt, fmin, fmax, flat, n)
    from sz_tpu.utils import stats as _stats
    if cfg.sz_mode == SZMode.BEST_SPEED:
        _stats.record(original_size=n * esize, compressed_size=len(body))
        return body
    out = ll.compress(body, cfg.lossless, cfg.lossless_level)
    _stats.record(original_size=n * esize, compressed_size=len(out))
    return out


def _constant_stream(cfg, dt, fmin, fmax, value, n) -> bytes:
    """SZ_compress_args_float_withinRange (sz_float.c:2728): header with the
    'same' flag + one big-endian value.  Never lossless-wrapped (the size
    check in SZ_decompress_args_float:62 relies on the exact length)."""
    header = md.make_header(cfg, dt, fmin, fmax, same=True)
    val = bu.f32_be(value) if dt == DataType.FLOAT else bu.f64_be(value)
    return header + bu.size_be(n, cfg.size_type) + val


def _store_ori(cfg, dt, fmin, fmax, flat, n) -> bytes:
    header = md.make_header(cfg, dt, fmin, fmax, lossless=True)
    be = np.asarray(flat).astype(
        ">f4" if dt == DataType.FLOAT else ">f8").tobytes()
    return header + bu.size_be(n, cfg.size_type) + be


def _protect_clamp(out, hdr, T):
    """protectValueRange decode clamp (szd_float.c:161-176): values
    outside [fmin, fmax] snap to the bound; NaNs pass through.  Applied
    to every SZ_decompress path except random-access (whose entry point,
    szd_float.c:7597, has no clamp)."""
    if not hdr.protect_range:
        return out
    mn, mx = T(hdr.params.fmin), T(hdr.params.fmax)
    if isinstance(out, np.ndarray):
        xp = np
    else:  # pragma: no cover - jax array (as_jax=True)
        import jax.numpy as xp
    return xp.where(out < mn, mn, xp.where(out > mx, mx, out))


def decompress(blob: bytes, shape, dtype=np.float32,
               engine: str = "auto", as_jax: bool = False) -> np.ndarray:
    """Decompress a reference-format SZ2 stream.

    as_jax=True (jax engine, regression streams) keeps the result on the
    device — decompress-to-device for on-accelerator pipelines."""
    dims = _filter_dims(shape)
    n = int(np.prod(dims))
    if np.dtype(dtype) in intc.SPECS:
        spec = intc.SPECS[np.dtype(dtype)]
        inner = ll.decompress(
            blob, expected_size=n * spec.esize * 2 + 128)
        flag = inner[3]
        st = 8 if flag & 0x40 else 4
        off = 4 + md.meta_length(DataType.FLOAT) + st
        if flag & 0x10:  # StoreOriData verbatim (sz_uint16.c:320)
            be = np.dtype(dtype).newbyteorder(">")
            return np.frombuffer(inner, dtype=be, count=n,
                                 offset=off).astype(dtype).reshape(shape)
        if flag & 0x01:  # allSameData (TightDataPointStorageI.c:356)
            be = np.dtype(dtype).newbyteorder(">")
            v = np.frombuffer(inner, dtype=be, count=1, offset=off)[0]
            return np.full(shape, v, dtype=dtype)
        t = intc.itdps_from_bytes(inner, md.meta_length(DataType.FLOAT))
        return intc.decompress_int(t, dims, dtype).reshape(shape)
    dt = _DTYPE_MAP[np.dtype(dtype)]
    esize = np.dtype(dtype).itemsize
    if n <= MIN_NUM_OF_ELEMENTS:
        return np.frombuffer(blob, dtype=dtype, count=n).reshape(shape)

    mlen = md.meta_length(dt)
    if len(blob) not in (8 + 4 + mlen, 8 + 8 + mlen):
        inner = ll.decompress(blob, expected_size=n * esize + 4 + mlen + 8)
    else:
        inner = blob
    # every stream self-describes its element type in the params block
    # (same nibble get_metadata reads); a float/double mismatch would
    # misparse the whole body 8 bytes off — fail loudly instead (the
    # reference CLI derives the type from its -f/-d flag and misparses)
    sdt = DataType(inner[4 + 5] & 0x0F)
    if sdt in (DataType.FLOAT, DataType.DOUBLE) and sdt != dt:
        raise TypeError(
            f"stream holds {sdt.name} data but dtype="
            f"{np.dtype(dtype).name} was requested")
    hdr = md.parse_header(inner, dt)
    off = hdr.body_offset
    ds_len = bu.read_size_be(inner, off, hdr.size_type)
    off += hdr.size_type

    T = np.float32 if dt == DataType.FLOAT else np.float64
    be_t = ">f4" if dt == DataType.FLOAT else ">f8"
    if hdr.lossless:
        out = np.frombuffer(inner, dtype=be_t, count=n, offset=off)
        return _protect_clamp(out.astype(dtype), hdr, T).reshape(shape)
    if hdr.same:
        v = bu.read_f32_be(inner, off) if dt == DataType.FLOAT \
            else bu.read_f64_be(inner, off)
        return _protect_clamp(np.full(n, v, dtype=dtype), hdr,
                              T).reshape(shape)
    if hdr.regression and hdr.random_access:
        # the reference RA entry has no protectValueRange clamp
        from sz_tpu.core import rablock
        return rablock.decompress_ra(inner[off:], dims, dtype,
                                     size_type=hdr.size_type
                                     ).reshape(shape)
    if hdr.regression:
        body = inner[off:]
        eng = _regnd_engine(engine, n)
        kw = {"as_jax": True} if (as_jax and eng is not regnd) else {}
        if len(dims) == 4:
            dims3 = (dims[0] * dims[1], dims[2], dims[3])
            out = eng.decompress(body, dims3, dtype,
                                 size_type=hdr.size_type, **kw)
        elif len(dims) in (2, 3):
            out = eng.decompress(body, dims, dtype,
                                 size_type=hdr.size_type, **kw)
        else:
            # 1-D data inside a regression-flagged stream is still classic
            t = tdps_mod.from_bytes(body, dt, is_pwr=hdr.pw_rel,
                                    msst19=hdr.pw_rel and hdr.msst19,
                                    size_type=hdr.size_type)
            out = classic.decompress_1d(t, n, dtype)
        return _protect_clamp(out, hdr, T).reshape(shape)
    # classic (SZ1.4) stream
    t = tdps_mod.from_bytes(inner[off:], dt, is_pwr=hdr.pw_rel,
                            msst19=hdr.pw_rel and hdr.msst19,
                            size_type=hdr.size_type)
    if hdr.pw_rel:
        t.msst19 = hdr.msst19
        if len(dims) == 4:
            # 4D PW_REL decodes through the 3D kernels on folded dims
            # (getSnapshotData_float_4D, szd_float.c:2836-2838)
            dims = (dims[0] * dims[1], dims[2], dims[3])
        out = pwr.decompress_pwrel(t, dims, dtype, engine=engine,
                                   as_jax=as_jax)
    elif len(dims) == 1:
        out = classic.decompress_1d(t, n, dtype)
    elif len(dims) in (2, 3, 4):
        out = classic_nd.decompress_nd(t, dims, dtype, engine=engine,
                                       as_jax=as_jax)
    else:
        raise NotImplementedError(f"classic {len(dims)}D decode")
    return _protect_clamp(out, hdr, T).reshape(shape)


def compress_region(data: np.ndarray, start, end,
                    cfg: SZConfig = DEFAULT_CONFIG, *,
                    mode: ErrorBoundMode = None, abs_bound: float = None,
                    rel_bound: float = None) -> bytes:
    """Compress a sub-region [start, end) of a larger array —
    SZ_compress_args3 (sz.c:403) / SZ_compress_args_float_subblock
    (sz_float.c:3046).  `end` is exclusive here (the reference takes
    inclusive corners).  The result is a classic-format stream of the
    region's dimensions, decodable with decompress(blob, region_shape).

    Like the reference entry point, the bound comes from the explicit
    mode/abs_bound/rel_bound arguments (defaulting to cfg's) while the
    serialized 21-byte params block reflects cfg UNMODIFIED —
    SZ_compress_args3 never writes its bound into confparams_cpr, so
    the header's bound fields can disagree with the effective bound
    (upstream quirk, kept for byte parity; the decoder reads the real
    precision from the stream body).

    Other reference quirks kept: PW_REL unsupported (sz_float.c:3104
    prints and produces nothing — we raise instead); double quantizer
    arithmetic with no machine-epsilon recheck."""
    data = np.asarray(data)
    dt = _DTYPE_MAP.get(data.dtype)
    if dt is None:
        raise TypeError(f"subblock compression: {data.dtype}")
    T = np.float32 if dt == DataType.FLOAT else np.float64
    start = tuple(int(s) for s in start)
    end = tuple(int(e) for e in end)
    region = np.ascontiguousarray(
        data[tuple(slice(s, e) for s, e in zip(start, end))], dtype=T)
    ndim = region.ndim
    if ndim > 4:
        raise NotImplementedError("subblock supports up to 4D")
    n = region.size
    flat = region.reshape(-1)
    # computeRangeSize_float_subblock (dataCompression.c:196)
    fmin = T(flat.min())
    value_range = T(T(flat.max()) - fmin)
    fmax = T(fmin + value_range)
    bound_cfg = cfg
    if mode is not None:
        bound_cfg = dataclasses.replace(
            cfg, error_bound_mode=mode,
            abs_err_bound=cfg.abs_err_bound if abs_bound is None
            else abs_bound,
            rel_bound_ratio=cfg.rel_bound_ratio if rel_bound is None
            else rel_bound)
    rp, eff_mode = _resolve_precision(bound_cfg, float(value_range), n,
                                      dt)
    if eff_mode == ErrorBoundMode.PW_REL:
        raise NotImplementedError(
            "subblock does not support point-wise relative bounds "
            "(sz_float.c:3104)")
    if value_range <= rp:
        # upstream leaves this TODO (sz_float.c:3095) and produces
        # nothing; emit the constant stream instead
        return _constant_stream(cfg, dt, fmin, fmax, flat[0], n)
    median = T(fmin + value_range / T(2))
    common = dict(max_range_radius=cfg.max_range_radius,
                  sample_distance=cfg.sample_distance,
                  pred_threshold=np.float32(cfg.pred_threshold),
                  opt_quant_mode=1 if cfg.quantization_intervals == 0
                  else 0,
                  fixed_intervals=cfg.quantization_intervals)
    if ndim == 1:
        t = classic.compress_1d(region, rp, value_range, median,
                                subblock=True, **common)
    else:
        t = classic_nd.compress_nd(region, rp, value_range, median,
                                   subblock_origin=start, **common)
    # SZ_compress_args3 never runs computeRangeSize into confparams, so
    # the header's fmin/fmax serialize as zeros (upstream quirk)
    header = md.make_header(cfg, dt, T(0), T(0))
    body = (header + bu.size_be(n, cfg.size_type)
            + tdps_mod.to_bytes(t, cfg.size_type))
    if cfg.sz_mode == SZMode.BEST_SPEED:
        return body
    return ll.compress(body, cfg.lossless, cfg.lossless_level)


def decompress_region(blob: bytes, shape, start, end,
                      dtype=np.float32) -> np.ndarray:
    """Decode a sub-region [start, end) of a random-access stream
    without touching unrelated blocks (SZ_decompress_args_randomaccess,
    szd_float.c:7597).  Raises for non-random-access streams, exactly
    like the reference (szd_float.c:7681)."""
    dims = _filter_dims(shape)
    n = int(np.prod(dims))
    dt = _DTYPE_MAP[np.dtype(dtype)]
    esize = np.dtype(dtype).itemsize
    mlen = md.meta_length(dt)
    if len(blob) not in (8 + 4 + mlen, 8 + 8 + mlen):
        inner = ll.decompress(blob, expected_size=n * esize + 4 + mlen + 8)
    else:
        inner = blob
    hdr = md.parse_header(inner, dt)
    if not (hdr.regression and hdr.random_access):
        raise ValueError(
            "region decode requires a random-access stream "
            "(compress with SZConfig(random_access=True))")
    off = hdr.body_offset + hdr.size_type
    from sz_tpu.core import rablock
    return rablock.decompress_ra(inner[off:], dims, dtype, start=start,
                                 end=end, size_type=hdr.size_type)


def get_metadata(blob: bytes) -> dict:
    """SZ_getMetadata analog (sz.c:683): introspect a stream header."""
    inner = ll.decompress(blob)
    # data type nibble lives in the params block at offset 4+5
    dt = DataType(inner[4 + 5] & 0x0F)
    hdr = md.parse_header(inner, dt)
    off = hdr.body_offset
    ds_len = bu.read_size_be(inner, off, hdr.size_type)
    return {
        "version": hdr.version,
        "data_type": dt,
        "is_constant": hdr.same,
        "is_lossless": hdr.lossless,
        "regression": hdr.regression,
        "size_type": hdr.size_type,
        "num_elements": ds_len,
        "error_bound_mode": hdr.params.error_bound_mode,
        "bound1": float(hdr.params.bound1),
        "bound2": float(hdr.params.bound2),
        "max_quant_intervals": hdr.params.max_quant_intervals,
        "fmin": hdr.params.fmin,
        "fmax": hdr.params.fmax,
    }
