"""Point-wise-relative (PW_REL) error-bound codecs.

Two pipelines, mirroring the reference:

1. **MSST19 accelerated** (default when pw ratio >= 1e-5 and
   accelerate_pw_rel_compression): multiplicative quantization directly
   on the signed data — states index a geometric precision table
   (1+e)^(inv*(i-radius)) and are found by a bit-sliced lookup on the
   prediction ratio (MultiLevelCacheTableWideInterval.c), with
   multiplicative Lorenzo predictors.
   Encode: SZ_compress_float_{1,2,3}D_MDQ_MSST19 (sz_float.c:1824,...).
   Decode: decompressDataSeries_float_{1,2,3}D_MSST19 (szd_float.c:1702,
   1808, 2129) + sign/zero restore (szd_float_pwr.c:1425).

2. **Pre-log** (fallback): log2 transform + sign bitmap, then the plain
   classic MDQ codec on the transformed field
   (SZ_compress_args_float_NoCkRngeNoGzip_{1,2,3}D_pwr_pre_log,
   sz_float_pwr.c:1792/1853/1915); decode restores 2^x with signs, zeros
   below minLogValue (szd_float_pwr.c:1331+).

Both serialize through the classic TDPS container with the PW_REL extras
(radExpo/segment/pwrBytes/minLogValue, and plus_bits/max_bits for
MSST19).
"""

from __future__ import annotations

import numpy as np

from sz_tpu.config import DataType
from sz_tpu.core import classic, classic_nd
from sz_tpu.format import huffman
from sz_tpu.format import lossless as ll
from sz_tpu.format.tdps import TDPS
from sz_tpu.utils import trace as _tr


# ---------------------------------------------------------------------------
# Range/sign scan (computeRangeSize_float_MSST19, dataCompression.c:121)
# ---------------------------------------------------------------------------

def range_size_msst19(data: np.ndarray):
    """(min, value_range, median, signs u8[n], positive, nearZero).

    Literal semantics: signs/positive consider only i>=1 (the reference
    loop starts at 1), nearZero starts at data[0] and updates on strictly
    smaller nonzero magnitudes."""
    T = data.dtype.type
    flat = data.reshape(-1)
    try:
        from sz_tpu.native import range_scan
        fmin, fmax, near, signs, positive = range_scan(flat)
    except ImportError:  # pragma: no cover - native unavailable
        n = flat.size
        signs = np.zeros(n, dtype=np.uint8)
        signs[1:] = flat[1:] < 0
        positive = not bool(signs[1:].any())
        near = flat[0]
        rest = flat[1:]
        # strictly-smaller-magnitude updates, first occurrence wins; if
        # data[0]==0 the |x|<|0| test never fires and nearZero stays 0
        am = np.where(rest != 0, np.abs(rest), np.inf)
        if am.size:
            k = int(np.argmin(am))  # first occurrence of the minimum
            if am[k] < abs(near):
                near = rest[k]
        fmin = T(flat.min())
        fmax = T(flat.max())
    vrange = T(fmax - fmin)
    median = T(fmin + vrange / T(2))
    return fmin, vrange, median, signs, positive, T(near)


# ---------------------------------------------------------------------------
# MSST19 cache table (MultiLevelCacheTableWideInterval.c)
# ---------------------------------------------------------------------------

def _expo_index(value: float) -> int:
    return int(np.float64(value).view(np.uint64)) >> 52


def _required_bits(precision: float) -> int:
    return -((int(np.float64(precision).view(np.uint64)) >> 52) - 1023)


def _rebuild_double(expo: int, manti: int, bits: int) -> float:
    v = (expo << 52) + (manti << (52 - bits))
    return float(np.uint64(v & 0xFFFFFFFFFFFFFFFF).view(np.float64))


class CacheTable:
    """TopLevelTableWideInterval replica: state lookup keyed on the
    (exponent, truncated-mantissa) bits of the prediction ratio."""

    def __init__(self, precision_table: np.ndarray, precision: float,
                 plus_bits: int):
        count = len(precision_table)
        bits = _required_bits(precision) + plus_bits
        self.bits = bits
        bottom = precision_table[1] / (1 + precision)
        top = precision_table[count - 1] / (1 - precision)
        self.base_index = _expo_index(bottom)
        self.top_index = _expo_index(top)
        nsub = self.top_index - self.base_index + 1
        size = 1 << bits
        try:
            from sz_tpu.native import msst19_build_table
            self.table = msst19_build_table(
                precision_table.astype(np.float64), precision, bits,
                self.base_index, nsub)
            return
        except ImportError:  # pragma: no cover - native unavailable
            pass
        table = np.zeros((nsub, size), dtype=np.uint16)
        index = 0
        flag = False
        pt = precision_table.astype(np.float64)
        lo = pt / (1 + precision)
        hi = pt / (1 - precision)
        for i in range(nsub):
            expo = i + self.base_index
            for j in range(size):
                bot_s = _rebuild_double(expo, j, bits)
                top_s = _rebuild_double(expo, j + 1, bits)
                if top_s < hi[index] and bot_s > lo[index]:
                    table[i, j] = index
                    flag = True
                else:
                    if flag and index < count - 1:
                        index += 1
                        table[i, j] = index
                    else:
                        table[i, j] = 0
        self.table = table

    def lookup(self, ratio: float) -> int:
        """State for one prediction ratio (as the C kernel inlines it:
        bits of the double, exponent + truncated mantissa)."""
        bits64 = int(np.float64(ratio).view(np.uint64))
        expo = ((bits64 & 0x7FFFFFFFFFFFFFFF) >> 52) - self.base_index
        if 0 <= expo <= self.top_index - self.base_index:
            manti = (bits64 & 0x000FFFFFFFFFFFFF) >> (52 - self.bits)
            return int(self.table[expo, manti])
        return 0

    def lookup_vec(self, ratios: np.ndarray) -> np.ndarray:
        """Vectorized lookup (NaN/inf/out-of-range ratios -> state 0)."""
        bits = np.ascontiguousarray(ratios, np.float64).view(np.uint64)
        expo = ((bits & np.uint64(0x7FFFFFFFFFFFFFFF))
                >> np.uint64(52)).astype(np.int64) - self.base_index
        manti = ((bits & np.uint64(0x000FFFFFFFFFFFFF))
                 >> np.uint64(52 - self.bits)).astype(np.int64)
        inr = (expo >= 0) & (expo <= self.top_index - self.base_index)
        state = self.table[np.clip(expo, 0,
                                   self.table.shape[0] - 1), manti]
        return np.where(inr, state, 0).astype(np.int32)


import functools


@functools.lru_cache(maxsize=8)
def _cache_table(intervals: int, ratio: float,
                 plus_bits: int) -> CacheTable:
    """CacheTable construction is a Python double loop over
    2^bits x n_subranges entries (~seconds at 32768 intervals); the
    table depends only on (intervals, ratio, plus_bits), so memoize."""
    return CacheTable(_precision_table(intervals, ratio, plus_bits),
                      ratio, plus_bits)


def _precision_table(intervals: int, ratio: float,
                     plus_bits: int) -> np.ndarray:
    """precisionTable[i] = pow(1+ratio, inv*(i-radius)).  Uses libm pow
    per element (math.pow), not np.power: the two differ in the last
    ulp and the f64 MSST19 decoder multiplies by these entries directly
    (decompressDataSeries_double_3D_MSST19), so table parity must be
    bit-exact against the reference's libm."""
    import math

    radius = intervals // 2
    inv = 2.0 - 2.0 ** (-plus_bits)
    base = 1.0 + ratio
    return np.array([math.pow(base, inv * (i - radius))
                     for i in range(intervals)], dtype=np.float64)


# ---------------------------------------------------------------------------
# MSST19 interval optimizers (sz_float.c opt_MSST19 variants)
# ---------------------------------------------------------------------------

def _radius_index(v: float, max_range_radius: int) -> int:
    """C: (uint64_t) cast of the double — inf/NaN/negative-overflow all
    come out of cvttsd2si as INT64_MIN, i.e. a huge uint64, and get
    clamped to maxRangeRadius-1."""
    if not np.isfinite(v) or v >= max_range_radius or v < 0:
        return max_range_radius - 1
    return min(int(v), max_range_radius - 1)


def _finish_intervals(hist, total, max_range_radius, pred_threshold):
    from sz_tpu.core.optimizer import round_up_to_power_of_2

    target = int(total * pred_threshold)
    csum = np.cumsum(hist)
    over = np.flatnonzero(csum > target)
    i = int(over[0]) if len(over) else max_range_radius - 1
    return max(round_up_to_power_of_2(2 * (i + 1)), 32)


def _walk_positions(shape, sample_distance: int) -> list:
    """The MSST19 optimizers' sampling-walk positions (pure control
    flow of the loops below, which is data-independent when no sampled
    value is zero — guaranteed after the driver's zero replacement)."""
    n = 1
    for r in shape:
        n *= r
    out = []
    if len(shape) == 1:
        pos = 2
        while pos < n:
            out.append(pos)
            pos += sample_distance
    elif len(shape) == 2:
        r1, r2 = shape
        offset_count = sample_distance - 1
        pos = r2 + offset_count
        n1 = 1
        while pos < n:
            out.append(pos)
            offset_count += sample_distance
            if offset_count >= r2:
                n1 += 1
                oc2 = n1 % sample_distance
                pos += (r2 + sample_distance - offset_count) \
                    + (sample_distance - oc2)
                offset_count = sample_distance - oc2
                if offset_count == 0:
                    offset_count += 1
            else:
                pos += sample_distance
    else:
        r1, r2, r3 = shape
        r23 = r2 * r3
        offset_count = sample_distance - 2
        pos = r23 + r3 + offset_count
        n1 = n2 = 1
        while pos < n:
            out.append(pos)
            offset_count += sample_distance
            if offset_count >= r3:
                n2 += 1
                if n2 == r2:
                    n1 += 1
                    n2 = 1
                    pos += r3
                oc2 = (n1 + n2) % sample_distance
                pos += (r3 + sample_distance - offset_count) \
                    + (sample_distance - oc2)
                offset_count = sample_distance - oc2
                if offset_count == 0:
                    offset_count += 1
            else:
                pos += sample_distance
    return out


def _radius_index_vec(v: np.ndarray, mrr: int) -> np.ndarray:
    """Vectorized _radius_index (the C (uint64_t) cast semantics)."""
    with np.errstate(all="ignore"):
        bad = ~np.isfinite(v) | (v >= mrr) | (v < 0)
        idx = np.trunc(np.where(bad, 0, v)).astype(np.int64)
    return np.where(bad, mrr - 1, np.minimum(idx, mrr - 1))


def _optimize_intervals_msst19_fast(data, ratio, max_range_radius,
                                    sample_distance, pred_threshold):
    """Vectorized optimizer; returns None (fall back to the serial
    walk) if any sampled value is zero — there the reference's walk
    becomes data-dependent."""
    pos = np.asarray(_walk_positions(data.shape, sample_distance),
                     np.int64)
    if pos.size == 0:
        return _finish_intervals(np.zeros(max_range_radius, np.int64),
                                 0, max_range_radius, pred_threshold)
    divider = np.float64(np.float32(np.log2(1 + ratio) * 2))
    mrr = max_range_radius
    f = data.reshape(-1)
    cur = f[pos]
    if bool((cur == 0).any()):
        return None
    with np.errstate(all="ignore"):
        if data.ndim == 1:
            cur64 = cur.astype(np.float64)
            pred = f[pos - 1].astype(np.float64)
            perr = np.abs(cur64 / pred)
            v = np.abs(np.log2(perr) / divider + 0.5)
        elif data.ndim == 2:
            r2 = data.shape[1]
            pred = f[pos - 1] + f[pos - r2] - f[pos - r2 - 1]
            perr = np.abs(pred.astype(np.float64)
                          / cur.astype(np.float64)).astype(np.float32)
            v = np.abs(np.log2(perr.astype(np.float64)) / divider + 0.5)
        else:
            r2, r3 = data.shape[1:]
            r23 = r2 * r3
            p = f[pos - 1] + f[pos - r3]
            p = (p + f[pos - r23]).astype(np.float32)
            p = (p - f[pos - 1 - r23]).astype(np.float32)
            p = (p - f[pos - r3 - 1]).astype(np.float32)
            p = (p - f[pos - r3 - r23]).astype(np.float32)
            p = (p + f[pos - r3 - r23 - 1]).astype(np.float32)
            perr = np.abs(cur.astype(np.float64)
                          / p.astype(np.float64)).astype(np.float32)
            v = np.abs(np.log2(perr.astype(np.float64)) / divider + 0.5)
    hist = np.bincount(_radius_index_vec(v, mrr), minlength=mrr)
    return _finish_intervals(hist, len(pos), mrr, pred_threshold)


def _optimize_intervals_msst19(data: np.ndarray, ratio: float,
                               max_range_radius: int, sample_distance: int,
                               pred_threshold: float) -> int:
    fast = _optimize_intervals_msst19_fast(
        data, ratio, max_range_radius, sample_distance, pred_threshold)
    if fast is not None:
        return fast
    flat = data.reshape(-1).astype(np.float64)
    divider = np.float64(np.float32(np.log2(1 + ratio) * 2))
    hist = np.zeros(max_range_radius, dtype=np.int64)
    total = 0
    n = flat.size
    with np.errstate(all="ignore"):
        if data.ndim == 1:
            pos = 2
            while pos < n:
                cur = flat[pos]
                if cur == 0:
                    pos += sample_distance
                    continue
                total += 1
                pred = flat[pos - 1]
                perr = abs(cur / pred)
                ridx = _radius_index(
                    abs(np.log2(perr) / divider + 0.5), max_range_radius)
                hist[ridx] += 1
                pos += sample_distance
        elif data.ndim == 2:
            r1, r2 = data.shape
            f32 = data.reshape(-1)
            offset_count = sample_distance - 1
            pos = r2 + offset_count
            n1 = 1
            while pos < n:
                cur = f32[pos]
                if cur == 0:
                    pos += sample_distance
                    continue
                total += 1
                pred = f32[pos - 1] + f32[pos - r2] - f32[pos - r2 - 1]
                perr = np.float32(abs(np.float64(pred) / np.float64(cur)))
                ridx = _radius_index(
                    abs(np.log2(np.float64(perr)) / divider + 0.5),
                    max_range_radius)
                hist[ridx] += 1
                offset_count += sample_distance
                if offset_count >= r2:
                    n1 += 1
                    oc2 = n1 % sample_distance
                    pos += (r2 + sample_distance - offset_count) \
                        + (sample_distance - oc2)
                    offset_count = sample_distance - oc2
                    if offset_count == 0:
                        offset_count += 1
                else:
                    pos += sample_distance
        else:
            r1, r2, r3 = data.shape
            r23 = r2 * r3
            f32 = data.reshape(-1)
            offset_count = sample_distance - 2
            pos = r23 + r3 + offset_count
            n1 = n2 = 1
            while pos < n:
                cur = f32[pos]
                if cur == 0:
                    pos += sample_distance
                    continue
                total += 1
                p = f32[pos - 1] + f32[pos - r3]
                p = np.float32(p + f32[pos - r23])
                p = np.float32(p - f32[pos - 1 - r23])
                p = np.float32(p - f32[pos - r3 - 1])
                p = np.float32(p - f32[pos - r3 - r23])
                p = np.float32(p + f32[pos - r3 - r23 - 1])
                perr = np.float32(abs(np.float64(cur) / np.float64(p)))
                ridx = _radius_index(
                    abs(np.log2(np.float64(perr)) / divider + 0.5),
                    max_range_radius)
                hist[ridx] += 1
                offset_count += sample_distance
                if offset_count >= r3:
                    n2 += 1
                    if n2 == r2:
                        n1 += 1
                        n2 = 1
                        pos += r3
                    oc2 = (n1 + n2) % sample_distance
                    pos += (r3 + sample_distance - offset_count) \
                        + (sample_distance - oc2)
                    offset_count = sample_distance - oc2
                    if offset_count == 0:
                        offset_count += 1
                else:
                    pos += sample_distance
    return _finish_intervals(hist, total, max_range_radius, pred_threshold)


# ---------------------------------------------------------------------------
# MSST19 encode
# ---------------------------------------------------------------------------

def compress_msst19(data: np.ndarray, pw_ratio: float, fmax, near_zero, *,
                    max_range_radius: int, sample_distance: int,
                    pred_threshold: float, plus_bits: int = 3,
                    opt_quant_mode: int = 1,
                    fixed_intervals: int = 0, oracle: bool = False,
                    engine: str = "numpy") -> TDPS:
    """SZ_compress_float_{1,2,3}D_MDQ_MSST19 + pre_log_MSST19 driver
    pieces (zero replacement is done by the caller's copy).  `data` must
    already have zeros replaced with nearZero*multiplier."""
    if not oracle and data.ndim in (2, 3):
        try:
            from sz_tpu.tpu import msst19_engine as me
        except Exception:  # pragma: no cover - jax unavailable
            me = None
            if engine == "jax":
                raise
        if me is not None and me.device_ok(engine, data.dtype,
                                           data.ndim, data.size):
            t_dev = me.compress(
                data, pw_ratio, fmax, near_zero,
                max_range_radius=max_range_radius,
                sample_distance=sample_distance,
                pred_threshold=pred_threshold, plus_bits=plus_bits,
                opt_quant_mode=opt_quant_mode,
                fixed_intervals=fixed_intervals, engine=engine)
            # A FLOAT wavefront chain that diverged from the host's f64
            # chain is NOT self-correcting on decode — the A*B/D
            # predictor can amplify a 1-ulp seed without bound.  Streams
            # whose parity is guaranteed (TDPS._device_exact: the CPU
            # backend, CI-gated, and the softf64 wavefront) skip the
            # check; anything else is decode-verified on the host and
            # re-encoded there on failure — returned streams are always
            # conformant.
            if (getattr(t_dev, "_device_exact", False)
                    or me.verify_conformant(t_dev, data, pw_ratio)):
                return t_dev
            _tr.count("host_fallback.msst19")
    T = np.float32 if data.dtype == np.float32 else np.float64
    dt = DataType.FLOAT if T is np.float32 else DataType.DOUBLE
    data = np.ascontiguousarray(data, dtype=T)
    flat = data.reshape(-1)
    n = data.size
    ratio = float(pw_ratio)

    if opt_quant_mode == 1:
        intervals = _optimize_intervals_msst19(
            data, ratio, max_range_radius, sample_distance, pred_threshold)
    else:
        intervals = fixed_intervals
    radius = intervals // 2

    ptable = _precision_table(intervals, ratio, plus_bits)
    cache = _cache_table(int(intervals), float(ratio), int(plus_bits))

    # median_log = sqrt(fabs(nearZero*max)) (sz_float_pwr.c:1988)
    median = T(np.sqrt(np.float64(abs(T(near_zero * fmax)))))

    # reqLength: the float 1D/3D kernels use computeReqLength_float_MSST19
    # (= 9 - expo, sz_float.c:58) but the float 2D kernel calls the
    # *double* variant (= 12 - expo) — a reference quirk we replicate
    if T is np.float32 and data.ndim != 2:
        req_expo = classic.get_exponent(np.float32(ratio), np.float32)
        req_length = 9 - req_expo
    else:
        req_expo = classic.get_exponent(np.float64(ratio), np.float64)
        req_length = 12 - req_expo

    enc = classic.ExactEncoder(req_length, T(0), T, raw=True)
    types = np.zeros(n, dtype=np.int32)

    def escape(idx, cur):
        types[idx] = 0
        return enc.add(cur)

    def quant(idx, cur, pred):
        with np.errstate(divide="ignore", invalid="ignore"):
            # pred can be 0 like the C (division yields inf/nan, which
            # the cache lookup maps to the escape state)
            ratio_pd = np.float64(T(cur / pred))
        state = cache.lookup(float(ratio_pd))
        if state:
            types[idx] = state
            return T(np.float64(abs(pred)) * ptable[state])
        return escape(idx, cur)

    native_t = None
    if not oracle and n >= 2:
        try:
            from sz_tpu.native import msst19_encode
            native_t = msst19_encode(data, cache.table, cache.base_index,
                                     cache.top_index, cache.bits,
                                     ptable, req_length)
        except ImportError:  # pragma: no cover - native unavailable
            native_t = None
    if native_t is not None:
        types, lead, mid_b, resi, _cnt = native_t
        enc._lead_arrays = [lead]
        enc.mid_bytes = bytearray(mid_b)
        enc._resi_arrays = [resi] if resi.size else []
    elif data.ndim in (2, 3) and not oracle:
        types = _encode_msst19_fast(data, cache, ptable, intervals,
                                    enc, T)
    elif data.ndim == 1:
        rec0 = escape(0, flat[0])
        pred = escape(1, flat[1])
        for i in range(2, n):
            # 1D MSST19: pred stays previous value; state multiplies pred
            cur = flat[i]
            with np.errstate(divide="ignore", invalid="ignore"):
                ratio_pd = np.float64(T(cur / pred))
            state = cache.lookup(float(ratio_pd))
            if state:
                types[i] = state
                pred = T(np.float64(pred) * ptable[state])
            else:
                pred = escape(i, cur)
    elif data.ndim == 2:
        r1, r2 = data.shape
        P1 = np.zeros(r2, dtype=T)
        P0 = np.zeros(r2, dtype=T)
        P1[0] = escape(0, flat[0])
        P1[1] = quant(1, flat[1], P1[0])
        for j in range(2, r2):
            pred = T(T(P1[j - 1] * P1[j - 1]) / P1[j - 2])
            P1[j] = quant(j, flat[j], pred)
        for i in range(1, r1):
            base = i * r2
            P0[0] = quant(base, flat[base], P1[0])
            for j in range(1, r2):
                pred = T(T(P0[j - 1] * P1[j]) / P1[j - 1])
                P0[j] = quant(base + j, flat[base + j], pred)
            P1, P0 = P0, P1
    else:
        r1, r2, r3 = data.shape
        r23 = r2 * r3
        P1 = np.zeros(r23, dtype=T)
        P0 = np.zeros(r23, dtype=T)
        # the 3D kernel computes its predictors through double `temp`
        # variables (sz_float.c MSST19 3D: `double temp, temp2`), so the
        # whole product chain is double with one final float rounding
        D = np.float64
        P1[0] = escape(0, flat[0])
        P1[1] = quant(1, flat[1], P1[0])
        for j in range(2, r3):
            pred = T(D(P1[j - 1]) * D(P1[j - 1]) / D(P1[j - 2]))
            P1[j] = quant(j, flat[j], pred)
        for i in range(1, r2):
            idx = i * r3
            P1[idx] = quant(idx, flat[idx], P1[idx - r3])
            for j in range(1, r3):
                ix = idx + j
                pred = T(D(P1[ix - 1]) * D(P1[ix - r3])
                         / D(P1[ix - r3 - 1]))
                P1[ix] = quant(ix, flat[ix], pred)
        for k in range(1, r1):
            index = k * r23
            P0[0] = quant(index, flat[index], P1[0])
            for j in range(1, r3):
                index += 1
                pred = T(D(P0[j - 1]) * D(P1[j]) / D(P1[j - 1]))
                P0[j] = quant(index, flat[index], pred)
            for i in range(1, r2):
                index = k * r23 + i * r3
                i2 = i * r3
                pred = T(D(P0[i2 - r3]) * D(P1[i2]) / D(P1[i2 - r3]))
                P0[i2] = quant(index, flat[index], pred)
                for j in range(1, r3):
                    index += 1
                    i2 = i * r3 + j
                    num = D(P0[i2 - 1]) * D(P0[i2 - r3]) * D(P1[i2]) \
                        * D(P1[i2 - r3 - 1])
                    den = D(P0[i2 - r3 - 1]) * D(P1[i2 - r3]) \
                        * D(P1[i2 - 1])
                    pred = T(num / den)
                    P0[i2] = quant(index, flat[index], pred)
            P1, P0 = P0, P1

    type_array, max_bits = huffman.encode_with_tree_max_bits(
        types, 2 * intervals)
    return TDPS(
        data_type=dt, ds_length=n, intervals=intervals,
        median_value=float(median), req_length=req_length,
        real_precision=ratio, type_array=type_array,
        lead_num=enc.lead_packed(), exact_mid_bytes=bytes(enc.mid_bytes),
        residual_mid_bits=enc.resi_packed(),
        exact_data_num=enc.exact_count(),
        max_quant_intervals=max_range_radius * 2,
        is_pwr=True, msst19=True, plus_bits=plus_bits, max_bits=max_bits)


# ---------------------------------------------------------------------------
# Vectorized MSST19: anti-diagonal wavefront.  Cells with i+j+k == d
# depend only on cells with smaller index sums, so each diagonal is one
# exact vectorized step (identical IEEE elementwise arithmetic to the
# per-point oracle loops above) -- no fixpoint iteration needed.  2D
# inputs run as a single-layer (1, r1, r2) volume: the 3D layer-0 rules
# are exactly the 2D kernel's rules; `dbl` keeps the float-vs-double
# temp-chain distinction (2D float kernel chains in float, 3D float
# kernel in double temps, sz_float.c MSST19).
# ---------------------------------------------------------------------------

def _diag_indices(d, r1, r2, r3):
    """(i, j, k) index vectors of all cells with i + j + k == d."""
    i_lo = max(0, d - (r2 - 1) - (r3 - 1))
    i_hi = min(r1 - 1, d)
    ivals = np.arange(i_lo, i_hi + 1)
    IT = np.int32 if r1 * r2 * r3 < 2**31 else np.int64
    e = d - ivals
    j_lo = np.maximum(0, e - (r3 - 1)).astype(IT)
    j_hi = np.minimum(r2 - 1, e)
    lens = j_hi - j_lo + 1
    total = int(lens.sum())
    starts = np.zeros(len(ivals), IT)
    np.cumsum(lens[:-1], out=starts[1:])
    seg = np.repeat(np.arange(len(ivals), dtype=IT), lens)
    js = j_lo[seg] + (np.arange(total, dtype=IT) - starts[seg])
    is_ = ivals.astype(IT)[seg]
    return is_, js, IT(d) - is_ - js


def _msst19_diag_pred(R, fi, is_, js, ks, r3, r23, T, dbl):
    """Positional multiplicative predictor for the cells of one
    diagonal.  Layer 0 (i==0): (0,0,1) left, row0 k>=2: A*A/A2,
    col0: up, interior: A*B/D.  Layers i>=1: (0,0) below (C), row0:
    A*C/F, col0: B*C/E, interior: A*B*C*G/(D*E*F).  Out-of-bounds
    gathers wrap harmlessly -- every lane's selected formula only
    reads already-final neighbors (index sums d-1..d-3)."""
    D64 = np.float64
    # R is guard-padded by the caller: index 0 of the lattice lives at
    # R[_GUARD(r3, r23)], so fi - off never goes out of range and the
    # masked-out lanes read harmless zeros from the guard region.
    A = R[fi - 1]
    B = R[fi - r3]
    Dg = R[fi - r3 - 1]
    A2 = R[fi - 2]
    C = R[fi - r23]
    E = R[fi - r23 - r3]
    F = R[fi - r23 - 1]
    G = R[fi - r23 - r3 - 1]
    i0 = is_ == 0
    j0 = js == 0
    k0 = ks == 0
    k1 = ks == 1
    if dbl:
        lin = (D64(1) * A * A / A2).astype(T)
        p2 = (D64(1) * A * B / Dg).astype(T)
    else:
        lin = ((A * A).astype(T) / A2).astype(T)
        p2 = ((A * B).astype(T) / Dg).astype(T)
    pred0 = np.where(j0 & k1, A,
             np.where(j0, lin,
              np.where(k0, B, p2)))
    predk = np.where(j0 & k0, C,
             np.where(j0, (D64(1) * A * C / F).astype(T),
              np.where(k0, (D64(1) * B * C / E).astype(T),
               ((D64(1) * A * B * C * G)
                / (D64(1) * Dg * E * F)).astype(T))))
    return np.where(i0, pred0, predk)


def _encode_msst19_fast(data, cache, ptable, intervals, enc, T):
    """Vectorized 2D/3D MSST19 encode -> raster type array; escapes are
    replayed through the raw ExactEncoder at the end (raster order)."""
    from sz_tpu.core.classic_nd import _esc_recon_vec

    dbl = data.ndim == 3
    vol = data if data.ndim == 3 else data[None]
    r1, r2, r3 = vol.shape
    r23 = r2 * r3
    flat = vol.reshape(-1)
    guard = r23 + r3 + 2
    R = np.zeros(guard + flat.size, T)
    types = np.zeros(flat.size, np.int32)
    with np.errstate(all="ignore"):
        for d in range(r1 + r2 + r3 - 2):
            is_, js, ks = _diag_indices(d, r1, r2, r3)
            fi = is_ * r23 + js * r3 + ks
            fg = fi + guard
            pred = _msst19_diag_pred(R, fg, is_, js, ks, r3, r23, T, dbl)
            cur = flat[fi]
            ratio = (cur / pred).astype(T).astype(np.float64)
            state = cache.lookup_vec(ratio)
            if d == 0:
                state[...] = 0  # forced first escape
            rec = (np.abs(pred.astype(np.float64))
                   * ptable[state]).astype(T)
            el = state == 0
            # escape reconstructions computed lazily on the (few)
            # escape lanes — _esc_recon_vec is positionally independent
            if el.any():
                rec[el] = _esc_recon_vec(cur[el], enc, T)
            R[fg] = rec
            types[fi] = state
    enc.add_batch(flat[np.flatnonzero(types == 0)])
    return types


def _decode_msst19_fast(types, shape, T, ptable, dec):
    """Vectorized 2D/3D MSST19 decode (anti-diagonal wavefront)."""
    t_flat = np.asarray(types, np.int32).reshape(-1)
    esc_idx = np.flatnonzero(t_flat == 0)
    known = np.zeros(t_flat.size, T)
    known[esc_idx] = dec.next_batch(len(esc_idx))
    km = t_flat == 0
    dbl = len(shape) == 3
    r1, r2, r3 = shape if len(shape) == 3 else (1,) + tuple(shape)
    r23 = r2 * r3
    guard = r23 + r3 + 2
    R = np.zeros(guard + t_flat.size, T)
    with np.errstate(all="ignore"):
        for d in range(r1 + r2 + r3 - 2):
            is_, js, ks = _diag_indices(d, r1, r2, r3)
            fi = is_ * r23 + js * r3 + ks
            fg = fi + guard
            pred = _msst19_diag_pred(R, fg, is_, js, ks, r3, r23, T, dbl)
            t_d = t_flat[fi]
            val = (np.abs(pred.astype(np.float64))
                   * ptable[t_d]).astype(T)
            el = t_d == 0
            if el.any():
                val[el] = known[fi[el]]
            R[fg] = val
    return R[guard:]


def decompress_msst19(tdps: TDPS, shape, dtype, *,
                      oracle: bool = False) -> np.ndarray:
    """decompressDataSeries_float_{1,2,3}D_MSST19."""
    T = np.float32 if np.dtype(dtype) == np.float32 else np.float64
    n = int(np.prod(shape))
    types = huffman.decode_with_tree(tdps.type_array, n)
    dec = classic.ExactDecoder(tdps, T, raw=True)
    ptable = _precision_table(tdps.intervals, tdps.real_precision,
                              tdps.plus_bits)
    if not oracle:
        try:
            from sz_tpu import native
            from sz_tpu.format import bytes_util as bu
            lead = bu.unpack_bits_2(tdps.lead_num, tdps.exact_data_num)
            return native.msst19_decode(
                types, tuple(shape), ptable, tdps.req_length, lead,
                tdps.exact_mid_bytes, tdps.residual_mid_bits,
                T).reshape(shape)
        except ImportError:  # pragma: no cover - native unavailable
            pass
    if len(shape) in (2, 3) and not oracle:
        return _decode_msst19_fast(types, tuple(shape), T, ptable,
                                   dec).reshape(shape)
    out = np.zeros(n, dtype=T)

    def rec(idx, pred):
        t = int(types[idx])
        if t == 0:
            v = dec.next()
        else:
            v = T(np.float64(abs(pred)) * ptable[t])
        out[idx] = v
        return v

    if len(shape) == 1:
        prev = rec(0, T(0))
        for i in range(1, n):
            prev = rec(i, prev)
    elif len(shape) == 2:
        r1, r2 = shape
        rec(0, T(0))
        rec(1, out[0])
        for j in range(2, r2):
            rec(j, T(T(out[j - 1] * out[j - 1]) / out[j - 2]))
        for i in range(1, r1):
            base = i * r2
            rec(base, out[base - r2])
            for j in range(1, r2):
                ix = base + j
                rec(ix, T(T(out[ix - 1] * out[ix - r2]) / out[ix - r2 - 1]))
    else:
        r1, r2, r3 = shape
        r23 = r2 * r3
        D = np.float64
        rec(0, T(0))
        rec(1, out[0])
        for j in range(2, r3):
            rec(j, T(D(out[j - 1]) * D(out[j - 1]) / D(out[j - 2])))
        for i in range(1, r2):
            ix = i * r3
            rec(ix, out[ix - r3])
            for j in range(1, r3):
                ixj = ix + j
                rec(ixj, T(D(out[ixj - 1]) * D(out[ixj - r3])
                           / D(out[ixj - r3 - 1])))
        for k in range(1, r1):
            index = k * r23
            rec(index, out[index - r23])
            for j in range(1, r3):
                ix = index + j
                rec(ix, T(D(out[ix - 1]) * D(out[ix - r23])
                          / D(out[ix - r23 - 1])))
            for i in range(1, r2):
                ix = index + i * r3
                rec(ix, T(D(out[ix - r3]) * D(out[ix - r23])
                          / D(out[ix - r23 - r3])))
                for j in range(1, r3):
                    ixj = ix + j
                    num = D(out[ixj - 1]) * D(out[ixj - r3]) \
                        * D(out[ixj - r23]) * D(out[ixj - r23 - r3 - 1])
                    den = D(out[ixj - r3 - 1]) * D(out[ixj - r23 - r3]) \
                        * D(out[ixj - r23 - 1])
                    rec(ixj, T(num / den))
    return out.reshape(shape)


# ---------------------------------------------------------------------------
# Plain pre-log pipeline (sz_float_pwr.c:1792/1853/1915)
# ---------------------------------------------------------------------------

def compress_prelog(data: np.ndarray, pw_ratio: float, fmin, fmax, *,
                    max_range_radius: int, sample_distance: int,
                    pred_threshold: float, opt_quant_mode: int = 1,
                    fixed_intervals: int = 0,
                    engine: str = "numpy") -> TDPS:
    T = np.float32 if data.dtype == np.float32 else np.float64
    flat = np.ascontiguousarray(data, dtype=T).reshape(-1)
    signs = (flat < 0).astype(np.uint8)
    positive = not bool(signs.any())

    import math

    from sz_tpu import native

    # max_abs_log seed from min/max (sz_float_pwr.c:1799-1802)
    if fmin == 0:
        max_abs = abs(math.log2(abs(float(fmax))))
    elif fmax == 0:
        max_abs = abs(math.log2(abs(float(fmin))))
    else:
        max_abs = max(abs(math.log2(abs(float(fmin)))),
                      abs(math.log2(abs(float(fmax)))))
    max_abs = T(max_abs)
    min_log = max_abs

    log_data = np.abs(flat)
    pos_mask = log_data > 0
    # libm log2 per element (native.v_log2): numpy's SIMD log2 differs
    # in the last ulp, which double streams serialize directly
    log_data[pos_mask] = native.v_log2(log_data[pos_mask]).astype(T)
    if pos_mask.any():
        max_abs = max(max_abs, log_data[pos_mask].max())
        min_log = min(min_log, log_data[pos_mask].min())

    # range over the log field BEFORE zero flushing
    lmin = T(log_data.min())
    lrange = T(T(log_data.max()) - lmin)
    lmedian = T(lmin + lrange / T(2))

    if abs(np.float64(min_log)) > max_abs:
        max_abs = T(abs(np.float64(min_log)))
    # float kernels subtract maxAbsLog*1.2e-7 (sz_float_pwr.c:1927);
    # the double kernels use 2.23e-16 (sz_double_pwr.c:1939)
    eps = 1.2e-7 if T is np.float32 else 2.23e-16
    rp = float(math.log2(1.0 + pw_ratio) - np.float64(max_abs) * eps)
    log_data[flat == 0] = T(np.float64(min_log) - 2.0001 * rp)

    shaped = log_data.reshape(data.shape)
    if data.ndim == 1:
        tdps = classic.compress_1d(
            shaped, rp, lrange, lmedian, max_range_radius=max_range_radius,
            sample_distance=sample_distance, pred_threshold=pred_threshold,
            opt_quant_mode=opt_quant_mode, fixed_intervals=fixed_intervals)
    else:
        # log2 happens on the HOST (libm-exact v_log2 above); the
        # transformed field then rides the classic DEVICE engine when
        # engine allows — the pre-log "device path" with exact parity
        tdps = classic_nd.compress_nd(
            shaped, rp, lrange, lmedian, max_range_radius=max_range_radius,
            sample_distance=sample_distance, pred_threshold=pred_threshold,
            opt_quant_mode=opt_quant_mode, fixed_intervals=fixed_intervals,
            engine=engine)
    tdps.is_pwr = True
    tdps.min_log_value = float(T(np.float64(min_log) - 1.0001 * rp))
    if not positive:
        from sz_tpu.config import Lossless
        tdps.pwr_err_bound_bytes = ll.compress(signs.tobytes(),
                                               Lossless.ZSTD, 3)
    return tdps


# ---------------------------------------------------------------------------
# Top-level PW_REL drivers
# ---------------------------------------------------------------------------

def compress_pwrel(data: np.ndarray, pw_ratio: float, *, accelerate: bool,
                   range_info, max_range_radius: int, sample_distance: int,
                   pred_threshold: float, plus_bits: int = 3,
                   opt_quant_mode: int = 1,
                   fixed_intervals: int = 0,
                   engine: str = "numpy") -> TDPS:
    """range_info: (fmin, fmax) for pre-log, or the full
    range_size_msst19 tuple for the accelerated path."""
    T = np.float32 if data.dtype == np.float32 else np.float64
    if accelerate:
        fmin, vrange, median, signs, positive, near_zero = range_info
        fmax = T(fmin + vrange)
        # zero replacement (sz_float_pwr.c:1981-1985); multiplier is a
        # float variable assigned from double pow()
        multiplier = T(np.power(1.0 + pw_ratio, -3.0001))
        work = np.array(data, dtype=T, copy=True)
        work.reshape(-1)[work.reshape(-1) == 0] = T(near_zero * multiplier)
        tdps = compress_msst19(
            work, pw_ratio, fmax, near_zero,
            max_range_radius=max_range_radius,
            sample_distance=sample_distance, pred_threshold=pred_threshold,
            plus_bits=plus_bits, opt_quant_mode=opt_quant_mode,
            fixed_intervals=fixed_intervals, engine=engine)
        tdps.min_log_value = float(T(
            np.float64(near_zero) / ((1 + pw_ratio) * (1 + pw_ratio))))
        if not positive:
            from sz_tpu.config import Lossless
            tdps.pwr_err_bound_bytes = ll.compress(signs.tobytes(),
                                                   Lossless.ZSTD, 3)
        return tdps
    fmin, fmax = range_info[0], range_info[1]
    return compress_prelog(
        data, pw_ratio, fmin, fmax, max_range_radius=max_range_radius,
        sample_distance=sample_distance, pred_threshold=pred_threshold,
        opt_quant_mode=opt_quant_mode, fixed_intervals=fixed_intervals,
        engine=engine)


def decompress_pwrel(tdps: TDPS, shape, dtype, engine: str = "numpy",
                     as_jax: bool = False):
    """szd_float_pwr.c pre_log decoders (plain :1331+, MSST19 :1425+).

    engine="jax"/"auto" routes MSST19 streams to the device engine
    (sign/zero restore included on device; as_jax keeps the result in
    HBM).  Pre-log streams decode their classic body with the device
    engine but the exp2 restore stays on the host (libm parity)."""
    T = np.float32 if np.dtype(dtype) == np.float32 else np.float64
    n = int(np.prod(shape))
    thr = T(tdps.min_log_value)
    ubits = np.uint32 if T is np.float32 else np.uint64
    signbit = ubits(1) << ubits(8 * np.dtype(T).itemsize - 1)

    if tdps.msst19:
        if len(shape) in (2, 3):
            try:
                from sz_tpu.tpu import msst19_engine as me
            except Exception:  # pragma: no cover - jax unavailable
                me = None
                if engine == "jax":
                    raise
            if me is not None and me.device_ok(engine, T, len(shape), n):
                return me.decompress(tdps, shape, dtype, as_jax=as_jax)
        out = decompress_msst19(tdps, shape, dtype).reshape(-1)
        if len(tdps.pwr_err_bound_bytes):
            signs = np.frombuffer(
                ll.decompress(tdps.pwr_err_bound_bytes, expected_size=n),
                dtype=np.uint8, count=n)
            zero = (out < thr) & (out >= 0)
            out[zero] = 0
            u = out.view(ubits)
            u[signs.astype(bool) & ~zero] |= signbit
        else:
            out[out < thr] = 0
        return out.reshape(shape)

    if len(shape) == 1:
        out = classic.decompress_1d(tdps, n, dtype)
    else:
        out = np.asarray(classic_nd.decompress_nd(
            tdps, shape, dtype, engine=engine)).reshape(-1)
    from sz_tpu import native

    out = np.asarray(out).reshape(-1)
    zero = out < thr
    vals = native.v_exp2(out).astype(T)
    res = np.where(zero, T(0), vals)
    if len(tdps.pwr_err_bound_bytes):
        signs = np.frombuffer(
            ll.decompress(tdps.pwr_err_bound_bytes, expected_size=n),
            dtype=np.uint8, count=n)
        res = np.where(signs.astype(bool), -res, res)
    return res.reshape(shape)
