"""Classic SZ1.4 MDQ codec for 2D/3D grids (float + double).

Host-reference (oracle) implementation of:
  SZ_compress_float_2D_MDQ   (sz_float.c:610)   / decompress (szd_float.c:284)
  SZ_compress_float_3D_MDQ   (sz_float.c:946)   / decompress (szd_float.c:600)
  SZ_compress_double_2D_MDQ  (sz_double.c:494)  / decompress
  SZ_compress_double_3D_MDQ  (sz_double.c:784)

Used directly when regression is disabled (withRegression=NO) and as the
core of the PW_REL pre-log path (sz_float_pwr.c:1853/1915).

Predictor layout (encode predicts from *reconstructed* values, rolling
row/layer buffers P0/P1):
  2D: [0,0] escape; [0,1] pred=P[0]; row0 j>=2: 2*P[j-1]-P[j-2];
      [i,0]: P1[0]; interior: P0[j-1]+P1[j]-P1[j-1] (2D Lorenzo).
  3D: layer0 = the 2D scheme; [k,0,0]: P1[0] (below);
      layer rows j=0, k>=1: P0[k-1]+P1... (2D Lorenzo in the i-k plane);
      interior: 7-point 3D Lorenzo.

Arithmetic notes (float kernels): realPrecision and recip are float;
`itvNum = fabs(diff)*recip + 1` evaluates in double and is assigned to a
float variable (round), and the reconstruction arithmetic is float.
Double kernels stay in double throughout.
"""

from __future__ import annotations

import numpy as np

from sz_tpu.config import DataType
from sz_tpu.core import classic
from sz_tpu.core import optimizer as opt
from sz_tpu.format import huffman
from sz_tpu.format.tdps import TDPS


def _optimize_intervals_nd(data: np.ndarray, real_precision: float,
                           max_range_radius: int, sample_distance: int,
                           pred_threshold: float) -> int:
    """optimize_intervals_float_{2D,3D}_opt (sz_float.c:5015/4644):
    same sampling walks as the freq_dense variants, histogram only."""
    from sz_tpu.core import optimizer as opt

    flat = data.reshape(-1)
    rp = float(real_precision)
    if data.ndim == 4:
        # optimize_intervals_float_4D (sz_float.c:298): modular grid;
        # note the reference's predictor mixes index-r3 into the 7-point
        # stencil (instead of index-r4) — replicated literally
        r1, r2, r3, r4 = data.shape
        r234, r34 = r2 * r3 * r4, r3 * r4
        i, j, k, l = np.meshgrid(np.arange(1, r1), np.arange(1, r2),
                                 np.arange(1, r3), np.arange(1, r4),
                                 indexing="ij")
        sel = ((i + j + k + l) % sample_distance) == 0
        idx = (i[sel] * r234 + j[sel] * r34 + k[sel] * r4 + l[sel])
        d = flat
        pred = d[idx - 1] + d[idx - r3]
        pred = pred + d[idx - r34]
        pred = pred - d[idx - 1 - r34]
        pred = pred - d[idx - r4 - 1]
        pred = pred - d[idx - r4 - r34]
        pred = pred + d[idx - r4 - r34 - 1]
        pred_err = np.abs((pred - d[idx]).astype(np.float64))
        total = (r1 - 1) * (r2 - 1) * (r3 - 1) * (r4 - 1) \
            // sample_distance
        radius_index = ((pred_err / rp + 1.0) / 2.0).astype(np.int64)
        np.minimum(radius_index, max_range_radius - 1, out=radius_index)
        # C casts the quotient through (uint64_t): negatives wrap huge
        radius_index[radius_index < 0] = max_range_radius - 1
        hist = np.bincount(radius_index, minlength=max_range_radius)
        target = int(total * pred_threshold)
        csum = np.cumsum(hist)
        over = np.flatnonzero(csum > target)
        i0 = int(over[0]) if len(over) else max_range_radius - 1
        return max(opt.round_up_to_power_of_2(2 * (i0 + 1)), 32)
    if data.ndim == 2:
        r1, r2 = data.shape
        sidx = opt._sample_walk_indices_2d(r1, r2, sample_distance)
        pred = flat[sidx - 1] + flat[sidx - r2] - flat[sidx - r2 - 1]
    else:
        r1, r2, r3 = data.shape
        r23 = r2 * r3
        sidx = opt._sample_walk_indices_3d(r1, r2, r3, sample_distance)
        d = flat
        pred = d[sidx - 1] + d[sidx - r3]
        pred = pred + d[sidx - r23]
        pred = pred - d[sidx - 1 - r23]
        pred = pred - d[sidx - r3 - 1]
        pred = pred - d[sidx - r3 - r23]
        pred = pred + d[sidx - r3 - r23 - 1]
    pred_err = np.abs((pred - flat[sidx]).astype(np.float64))
    radius_index = ((pred_err / rp + 1.0) / 2.0).astype(np.int64)
    np.minimum(radius_index, max_range_radius - 1, out=radius_index)
    # C casts the quotient through (uint64_t): negatives (possible
    # when a tiny PW_REL ratio makes realPrecision negative) wrap to
    # huge values and clamp to the last bin
    radius_index[radius_index < 0] = max_range_radius - 1
    intervals = np.bincount(radius_index, minlength=max_range_radius)
    target = int(len(sidx) * pred_threshold)
    csum = np.cumsum(intervals)
    over = np.flatnonzero(csum > target)
    i = int(over[0]) if len(over) else max_range_radius - 1
    pow2 = opt.round_up_to_power_of_2(2 * (i + 1))
    return max(pow2, 32)


_DEVICE_MIN_SIZE = 1 << 18


def _device_engine(engine: str, ndim: int, n: int):
    """Pick the device engine (sz_tpu/tpu/classic_engine.py) or None
    for the host kernels.  Same policy as api._regnd_engine: "auto"
    requires an attached accelerator and a large-enough array; a failed
    device import under explicit engine="jax" raises."""
    if engine not in ("jax", "auto") or ndim not in (2, 3, 4):
        return None
    if engine == "auto" and n < _DEVICE_MIN_SIZE:
        return None
    try:
        from sz_tpu.tpu import classic_engine as ce
    except Exception:  # pragma: no cover - jax unavailable
        if engine == "jax":
            raise
        return None
    if engine == "auto" and ce.jax.default_backend() == "cpu":
        return None
    return ce


def _optimize_intervals_subblock(data, origin, rp, max_range_radius,
                                 sample_distance, pred_threshold):
    """Subblock interval optimizers (sz_float.c:3278,3330,3382): the
    modular sampling uses GLOBAL coordinates (local + origin), and the
    4D variant predicts with the 3D Lorenzo over the last three dims."""
    rank = data.ndim
    shape = data.shape
    grids = np.meshgrid(*[np.arange(1, r) for r in shape], indexing="ij")
    gsum = sum(g + int(o) for g, o in zip(grids, origin))
    sel = (gsum % sample_distance) == 0
    loc = [g[sel] for g in grids]
    d = data
    if rank == 2:
        i, j = loc
        pred = d[i, j - 1] + d[i - 1, j] - d[i - 1, j - 1]
        cur = d[i, j]
    elif rank == 3:
        i, j, k = loc
        pred = d[i, j, k - 1] + d[i, j - 1, k]
        pred = pred + d[i - 1, j, k]
        pred = pred - d[i, j - 1, k - 1]
        pred = pred - d[i - 1, j, k - 1]
        pred = pred - d[i - 1, j - 1, k]
        pred = pred + d[i - 1, j - 1, k - 1]
        cur = d[i, j, k]
    else:  # 4D: 3D Lorenzo over dims (1,2,3) — sz_float.c:3410
        i, j, k, l = loc
        pred = d[i, j, k, l - 1] + d[i, j, k - 1, l]
        pred = pred + d[i, j - 1, k, l]
        pred = pred - d[i, j, k - 1, l - 1]
        pred = pred - d[i, j - 1, k, l - 1]
        pred = pred - d[i, j - 1, k - 1, l]
        pred = pred + d[i, j - 1, k - 1, l - 1]
        cur = d[i, j, k, l]
    pred_err = np.abs((pred - cur).astype(np.float64))
    radius_index = ((pred_err / rp + 1.0) / 2.0).astype(np.int64)
    np.minimum(radius_index, max_range_radius - 1, out=radius_index)
    # C casts the quotient through (uint64_t): negatives (possible
    # when a tiny PW_REL ratio makes realPrecision negative) wrap to
    # huge values and clamp to the last bin
    radius_index[radius_index < 0] = max_range_radius - 1
    hist = np.bincount(radius_index, minlength=max_range_radius)
    total = data.size // sample_distance
    target = int(total * pred_threshold)
    csum = np.cumsum(hist)
    over = np.flatnonzero(csum > target)
    i0 = int(over[0]) if len(over) else max_range_radius - 1
    return max(opt.round_up_to_power_of_2(2 * (i0 + 1)), 32)


# ---------------------------------------------------------------------------
# Vectorized classic encoder/decoder (numpy fixpoint over the lattice
# with the classic kernels' POSITIONAL predictors; same convergence
# argument as the regnd fixpoint — the dependency DAG is acyclic raster
# order and numpy rounds per-op like the serial C).  The per-point
# loops below remain as the oracle (oracle=True).
# ---------------------------------------------------------------------------

def _plane_pred_np(P, prev, T):
    """Positional classic predictor for one (r2, r3) plane.

    prev=None: the layer-0 scheme (== the 2D kernel): (0,0) escape,
    (0,1) prev-value, row 0 j>=2 linear 2a-b, (i>=1,0) up, else 2D
    Lorenzo.  prev given: the layer-k>=1 scheme: (0,0) below,
    (0,j>=1)/(i>=1,0) 2D Lorenzo in the mixed plane, else 7-point.
    Operand order matches the serial C expressions."""
    r2, r3 = P.shape
    Pp = np.zeros((r2 + 1, r3 + 1), dtype=T)
    Pp[1:, 1:] = P
    A = Pp[1:, :-1]    # (i, j-1)
    B = Pp[:-1, 1:]    # (i-1, j)
    D = Pp[:-1, :-1]   # (i-1, j-1)
    i0 = np.zeros((r2, 1), bool)
    i0[0] = True
    j0 = np.zeros((1, r3), bool)
    j0[:, 0] = True
    if prev is None:
        A2 = np.zeros((r2, r3), dtype=T)
        A2[:, 2:] = P[:, :-2]
        lin = T(2) * A - A2
        j1 = np.zeros((1, r3), bool)
        if r3 > 1:
            j1[:, 1] = True
        return np.where(i0 & j1, A,
                np.where(i0, lin,
                 np.where(j0, B, A + B - D)))
    Qp = np.zeros((r2 + 1, r3 + 1), dtype=T)
    Qp[1:, 1:] = prev
    C_ = Qp[1:, 1:]    # (k-1, i, j)
    E = Qp[:-1, 1:]    # (k-1, i-1, j)
    F = Qp[1:, :-1]    # (k-1, i, j-1)
    G = Qp[:-1, :-1]   # (k-1, i-1, j-1)
    p3 = A + B         # interior op order (sz_float.c:1086-1090)
    p3 = p3 + C_
    p3 = p3 - D
    p3 = p3 - E
    p3 = p3 - F
    p3 = p3 + G
    return np.where(i0 & j0, C_,
            np.where(i0, A + C_ - F,
             np.where(j0, B + C_ - E, p3)))


def _esc_recon_vec(data, enc, T):
    """Vectorized ExactEncoder reconstruction (binary truncation after
    the median offset; raw MSST19 encoders skip the offset) — the
    lead-byte dedup only affects stream bytes, not the value."""
    norm = data.astype(T) if enc.raw else (data - enc.median).astype(T)
    if T is np.float32:
        bits = norm.view(np.uint32) & np.uint32(enc._mask & 0xFFFFFFFF)
        rec = bits.view(np.float32)
    else:
        bits = norm.view(np.uint64) \
            & np.uint64(enc._mask & 0xFFFFFFFFFFFFFFFF)
        rec = bits.view(np.float64)
    if enc.raw:
        return rec.astype(T)
    return (rec + enc.median).astype(T)


def _encode_fast_nd(data, T, RT, IT, rp, recip, intervals, radius, enc):
    """Vectorized classic encode: plane scan over the slowest axis with
    a per-plane fixpoint (initial guess = the data plane), sharing the
    positional predictors with the decoder.  The 2a-b linear predictor
    on the first row amplifies perturbations, so that one row is solved
    serially and pinned.  Returns the raster-order type array; escapes
    are replayed through the ExactEncoder for the byte streams.  4D
    runs as independent 3D slices (sz_float.c:1479)."""
    shape = data.shape
    ndim = data.ndim
    esc_recon = _esc_recon_vec(data, enc, T)
    rp64 = np.float64(rp)
    recip64 = np.float64(recip)

    def quant_scalar(cur, pred):
        diff = T(cur - pred)
        itv = IT(np.float64(abs(np.float64(diff))) * recip64 + 1.0)
        if itv < intervals:
            if diff < 0:
                itv = -itv
            t = int(itv / IT(2)) + radius
            rec = T(pred + RT(2 * (t - radius)) * rp)
            if not np.float64(abs(np.float64(T(cur - rec)))) > rp64:
                return t, rec
        return 0, None

    def quant_plane(d, pred, er, forced_esc):
        diff = d - pred
        itv = (np.abs(diff.astype(np.float64)) * recip64
               + 1.0).astype(IT)
        within = itv < intervals
        itv = np.where(diff < 0, -itv, itv)
        t = (itv / IT(2)).astype(np.int32) + np.int32(radius)
        rec = (pred + (2 * (t - radius)).astype(RT) * rp).astype(T)
        ok = within & ~(np.abs((d - rec).astype(T)
                               .astype(np.float64)) > rp64) & ~forced_esc
        return np.where(ok, t, 0), np.where(ok, rec, er)

    def solve_row0(row_data, row_er, out_t, out_rec):
        r = len(row_data)
        out_t[0] = 0
        out_rec[0] = row_er[0]
        if r > 1:
            t, rec = quant_scalar(row_data[1], out_rec[0])
            out_t[1] = t
            out_rec[1] = rec if t else row_er[1]
        for j in range(2, r):
            pred = T(T(2) * out_rec[j - 1] - out_rec[j - 2])
            t, rec = quant_scalar(row_data[j], pred)
            out_t[j] = t
            out_rec[j] = rec if t else row_er[j]

    def encode_volume(vol, vol_er, out_t):
        """One 3D volume (or a 2D grid as a single layer-0 plane)."""
        vshape = vol.shape
        if len(vshape) == 2:
            planes = [(vol, vol_er, out_t)]
            r2, r3 = vshape
        else:
            planes = [(vol[k], vol_er[k], out_t[k])
                      for k in range(vshape[0])]
            r2, r3 = vshape[1:]
        prev = None
        for k, (d, er, tk) in enumerate(planes):
            pin = np.zeros((r2, r3), bool)
            t_pin = np.zeros((r2, r3), np.int32)
            rec_pin = np.zeros((r2, r3), T)
            if prev is None:
                pin[0, :] = True
                solve_row0(d[0], er[0], t_pin[0], rec_pin[0])
            forced = np.zeros((r2, r3), bool)  # first elem is in pin
            P = d
            for _ in range(r2 + r3 + 4):
                pred = _plane_pred_np(P, prev, T)
                t, rec = quant_plane(d, pred, er, forced)
                t = np.where(pin, t_pin, t)
                rec = np.where(pin, rec_pin, rec)
                if np.array_equal(rec, P):
                    break
                P = rec
            pred = _plane_pred_np(P, prev, T)
            t, rec = quant_plane(d, pred, er, forced)
            tk[...] = np.where(pin, t_pin, t)
            prev = np.where(pin, rec_pin, rec)

    types = np.zeros(shape, np.int32)
    with np.errstate(all="ignore"):
        if ndim == 4:
            for s in range(shape[0]):
                encode_volume(data[s], esc_recon[s], types[s])
        else:
            encode_volume(data, esc_recon, types)
    types = types.reshape(-1)
    flat = data.reshape(-1)
    enc.add_batch(flat[np.flatnonzero(types == 0)])
    return types


def _decode_fast_nd(types, unpred, shape, T, RT, rp, radius, dec):
    """Vectorized classic decode (plane scan, shared predictors)."""
    n = int(np.prod(shape))
    t_lat = np.asarray(types, np.int32).reshape(shape)
    esc = t_lat == 0
    known = np.zeros(shape, T)
    esc_idx = np.flatnonzero(esc.reshape(-1))
    vals = dec.next_batch(len(esc_idx))
    known.reshape(-1)[esc_idx] = vals
    q = (2 * (t_lat - radius)).astype(RT) * rp

    def solve_plane(prev, km, kv, qx):
        r2, r3 = km.shape
        P = np.where(km, kv, np.zeros((r2, r3), T))
        for _ in range(r2 + r3 + 4):
            pred = _plane_pred_np(P, prev, T)
            P_new = np.where(km, kv, (pred + qx).astype(T))
            if np.array_equal(P_new, P):
                break
            P = P_new
        return P

    with np.errstate(all="ignore"):
        if len(shape) == 2:
            return solve_plane(None, esc, known, q).reshape(shape)
        if len(shape) == 4:
            out = np.zeros(shape, T)
            for s in range(shape[0]):
                prev = None
                for k in range(shape[1]):
                    out[s, k] = solve_plane(prev, esc[s, k],
                                            known[s, k], q[s, k])
                    prev = out[s, k]
            return out
        out = np.zeros(shape, T)
        prev = None
        for k in range(shape[0]):
            out[k] = solve_plane(prev, esc[k], known[k], q[k])
            prev = out[k]
        return out


def compress_nd(data: np.ndarray, real_precision: float, value_range,
                median, *, max_range_radius: int, sample_distance: int,
                pred_threshold: float, opt_quant_mode: int = 1,
                fixed_intervals: int = 0, subblock_origin=None,
                oracle: bool = False, engine: str = "numpy") -> TDPS:
    """Classic 2D/3D/4D MDQ encode -> TDPS.

    subblock_origin: when set (SZ_compress_args3 path), the kernel is
    the `*_MDQ_subblock` variant (sz_float.c:3566,3777,4118): double
    quantizer arithmetic with true division by realPrecision, NO
    machine-epsilon recheck, and the subblock interval optimizer whose
    modular sampling is offset by the region's global origin."""
    T = np.float32 if data.dtype == np.float32 else np.float64
    dt = DataType.FLOAT if T is np.float32 else DataType.DOUBLE
    data = np.ascontiguousarray(data, dtype=T)
    n = data.size
    subblock = subblock_origin is not None

    if not subblock and not oracle:
        ce = _device_engine(engine, data.ndim, n)
        if ce is not None:
            return ce.compress(
                data, real_precision, value_range, median,
                max_range_radius=max_range_radius,
                sample_distance=sample_distance,
                pred_threshold=pred_threshold,
                opt_quant_mode=opt_quant_mode,
                fixed_intervals=fixed_intervals)

    # the float 2D/3D kernels receive realPrecision narrowed to float;
    # the float 4D kernel (and all double kernels) keep it double
    RT = np.float64 if (T is np.float64 or data.ndim == 4
                        or subblock) else T
    rp = RT(real_precision)
    recip = RT(RT(1) / rp)

    if opt_quant_mode == 1:
        if subblock:
            intervals = _optimize_intervals_subblock(
                data, subblock_origin, float(real_precision),
                max_range_radius, sample_distance, pred_threshold)
        else:
            intervals = _optimize_intervals_nd(
                data, float(real_precision), max_range_radius,
                sample_distance, pred_threshold)
    else:
        intervals = fixed_intervals
    radius = intervals // 2

    median = T(median)
    rad_expo = classic.get_exponent(T(value_range) / T(2), T)
    req_length, median_zeroed = classic.compute_req_length(
        float(rp), rad_expo, T)
    if median_zeroed:
        median = T(0)

    enc = classic.ExactEncoder(req_length, median, T)
    types = np.zeros(n, dtype=np.int32)
    flat = data.reshape(-1)

    # the float 2D/3D kernels round itvNum into a float variable, but the
    # float 4D kernel declares `double itvNum` (sz_float.c:1496) — the
    # double kernels use double everywhere
    IT = np.float64 if (T is np.float64 or data.ndim == 4
                        or subblock) else T

    if subblock:
        rp64 = np.float64(rp)

        def quant(idx, cur, pred):
            """Subblock step: double division, no epsilon recheck
            (sz_float.c:3862-3871)."""
            diff = T(cur - pred)
            itv = np.float64(abs(np.float64(diff))) / rp64 + 1.0
            if itv < intervals:
                if diff < 0:
                    itv = -itv
                t = int(itv / 2.0) + radius
                rec = T(pred + np.float64(2 * (t - radius)) * rp64)
                types[idx] = t
                return rec
            types[idx] = 0
            return enc.add(cur)
    else:
        def quant(idx, cur, pred):
            """One predict+quantize step; returns the reconstruction."""
            diff = T(cur - pred)
            itv = IT(np.float64(abs(np.float64(diff))) * np.float64(recip)
                     + 1.0)
            if itv < intervals:
                if diff < 0:
                    itv = -itv
                t = int(itv / IT(2)) + radius
                rec = T(pred + RT(2 * (t - radius)) * rp)
                if np.float64(abs(np.float64(T(cur - rec)))) > rp:
                    types[idx] = 0
                    return enc.add(cur)
                types[idx] = t
                return rec
            types[idx] = 0
            return enc.add(cur)

    native_sb = None
    if subblock and not oracle and min(data.shape[-1:]) >= 2:
        # subblock quantizer lives in the wavefront kernel only; small
        # regions stay on the Python loops below
        try:
            from sz_tpu import native as _nat
            if data.size >= _nat._CLASSIC_WF_MIN:
                native_sb = _nat.classicnd_encode(
                    data, float(rp), float(recip), T(rp), T(recip),
                    int(intervals), radius, RT is np.float64,
                    req_length, median, subblock=True)
        except ImportError:  # pragma: no cover
            native_sb = None
    if native_sb is not None:
        types, lead, mid_b, resi, _cnt = native_sb
        enc._lead_arrays = [lead]
        enc.mid_bytes = bytearray(mid_b)
        enc._resi_arrays = [resi] if resi.size else []
    elif not subblock and not oracle:
        native_t = None
        if min(data.shape[-1:]) >= 2:
            try:
                from sz_tpu.native import classicnd_encode
                dbl = RT is np.float64
                native_t = classicnd_encode(
                    data, float(rp), float(recip), T(rp), T(recip),
                    int(intervals), radius, dbl, req_length, median)
            except ImportError:  # pragma: no cover
                native_t = None
        if native_t is not None:
            types, lead, mid_b, resi, _cnt = native_t
            enc._lead_arrays = [lead]
            enc.mid_bytes = bytearray(mid_b)
            enc._resi_arrays = [resi] if resi.size else []
        else:
            types = _encode_fast_nd(data, T, RT, IT, rp, recip,
                                    intervals, radius, enc)
    elif data.ndim == 4:
        # SZ_compress_float_4D_MDQ (sz_float.c:1479): the 3D scheme run
        # independently per outermost slice (each slice restarts with an
        # escaped first value)
        q1, r1, r2, r3 = data.shape
        for l in range(q1):
            _encode_3d_block(data[l], l * r1 * r2 * r3, flat, types,
                             quant, enc, T)
    elif data.ndim == 2:
        r1, r2 = data.shape
        P1 = np.zeros(r2, dtype=T)
        P0 = np.zeros(r2, dtype=T)
        types[0] = 0
        P1[0] = enc.add(flat[0])
        P1[1] = quant(1, flat[1], P1[0])
        for j in range(2, r2):
            pred = T(T(2) * P1[j - 1] - P1[j - 2])
            P1[j] = quant(j, flat[j], pred)
        for i in range(1, r1):
            base = i * r2
            P0[0] = quant(base, flat[base], P1[0])
            for j in range(1, r2):
                pred = T(P0[j - 1] + P1[j] - P1[j - 1])
                P0[j] = quant(base + j, flat[base + j], pred)
            P1, P0 = P0, P1
    else:
        _encode_3d_block(data, 0, flat, types, quant, enc, T)

    type_array = huffman.encode_with_tree(types, 2 * intervals)
    return TDPS(
        data_type=dt, ds_length=n, intervals=intervals,
        median_value=float(median), req_length=req_length,
        real_precision=float(rp), type_array=type_array,
        lead_num=enc.lead_packed(), exact_mid_bytes=bytes(enc.mid_bytes),
        residual_mid_bits=enc.resi_packed(),
        exact_data_num=enc.exact_count(),
        max_quant_intervals=max_range_radius * 2)


def _encode_3d_block(data3, base, flat, types, quant, enc, T):
    """The 3D MDQ sweep over one contiguous sub-volume starting at flat
    offset `base` (shared by the 3D kernel and each 4D slice)."""
    r1, r2, r3 = data3.shape
    r23 = r2 * r3
    P1 = np.zeros(r23, dtype=T)
    P0 = np.zeros(r23, dtype=T)
    types[base] = 0
    P1[0] = enc.add(flat[base])
    P1[1] = quant(base + 1, flat[base + 1], P1[0])
    for j in range(2, r3):
        pred = T(T(2) * P1[j - 1] - P1[j - 2])
        P1[j] = quant(base + j, flat[base + j], pred)
    for i in range(1, r2):
        idx = i * r3
        P1[idx] = quant(base + idx, flat[base + idx], P1[idx - r3])
        for j in range(1, r3):
            ix = idx + j
            pred = T(P1[ix - 1] + P1[ix - r3] - P1[ix - r3 - 1])
            P1[ix] = quant(base + ix, flat[base + ix], pred)
    for k in range(1, r1):
        index = k * r23
        P0[0] = quant(base + index, flat[base + index], P1[0])
        for j in range(1, r3):
            index += 1
            pred = T(P0[j - 1] + P1[j] - P1[j - 1])
            P0[j] = quant(base + index, flat[base + index], pred)
        for i in range(1, r2):
            index = k * r23 + i * r3
            i2 = i * r3
            pred = T(P0[i2 - r3] + P1[i2] - P1[i2 - r3])
            P0[i2] = quant(base + index, flat[base + index], pred)
            for j in range(1, r3):
                index += 1
                i2 = i * r3 + j
                pred = P0[i2 - 1] + P0[i2 - r3]
                pred = T(pred + P1[i2])
                pred = T(pred - P0[i2 - r3 - 1])
                pred = T(pred - P1[i2 - r3])
                pred = T(pred - P1[i2 - 1])
                pred = T(pred + P1[i2 - r3 - 1])
                P0[i2] = quant(base + index, flat[base + index], pred)
        P1, P0 = P0, P1


def decompress_nd(tdps: TDPS, shape, dtype,
                  oracle: bool = False, engine: str = "numpy",
                  as_jax: bool = False) -> np.ndarray:
    """Classic 2D/3D MDQ decode (szd_float.c:284/600 and double analogs)."""
    T = np.float32 if np.dtype(dtype) == np.float32 else np.float64
    n = int(np.prod(shape))

    if not oracle:
        ce = _device_engine(engine, len(shape), n)
        if ce is not None:
            return ce.decompress(tdps, shape, dtype, as_jax=as_jax)
    types = huffman.decode_with_tree(tdps.type_array, n)
    dec = classic.ExactDecoder(tdps, T)
    out = np.zeros(n, dtype=T)
    radius = tdps.intervals // 2
    RT = np.float64 if (T is np.float64 or len(shape) == 4) else T
    rp = RT(tdps.real_precision)

    if not oracle:
        shp = tuple(int(s) for s in shape)
        if shp[-1] >= 2:
            try:
                from sz_tpu.native import classicnd_decode
                from sz_tpu.format import bytes_util as bu
                lead = bu.unpack_bits_2(tdps.lead_num,
                                        tdps.exact_data_num)
                return classicnd_decode(
                    types, shp, float(rp), T(rp), radius,
                    RT is np.float64, tdps.req_length,
                    T(tdps.median_value), lead, tdps.exact_mid_bytes,
                    tdps.residual_mid_bits, T).reshape(shape)
            except ImportError:  # pragma: no cover
                pass
        return _decode_fast_nd(types, None, shp,
                               T, RT, rp, radius, dec).reshape(shape)

    def rec(idx, pred):
        t = int(types[idx])
        if t == 0:
            v = dec.next()
        else:
            v = T(pred + RT(2 * (t - radius)) * rp)
        out[idx] = v
        return v

    if len(shape) == 2:
        r1, r2 = shape
        rec(0, T(0))
        if r2 > 1:
            rec(1, out[0])
        for j in range(2, r2):
            rec(j, T(T(2) * out[j - 1] - out[j - 2]))
        for i in range(1, r1):
            base = i * r2
            rec(base, out[base - r2])
            for j in range(1, r2):
                ix = base + j
                rec(ix, T(out[ix - 1] + out[ix - r2] - out[ix - r2 - 1]))
    elif len(shape) == 3:
        _decode_3d_block(shape, 0, out, rec, T)
    else:
        q1 = shape[0]
        sub = tuple(shape[1:])
        stride = int(np.prod(sub))
        for l in range(q1):
            _decode_3d_block(sub, l * stride, out, rec, T)
    return out.reshape(shape)


def _decode_3d_block(dims3, base, out, rec, T):
    r1, r2, r3 = dims3
    r23 = r2 * r3
    rec(base, T(0))
    if r3 > 1:
        rec(base + 1, out[base])
    for j in range(2, r3):
        rec(base + j, T(T(2) * out[base + j - 1] - out[base + j - 2]))
    for i in range(1, r2):
        idx = base + i * r3
        rec(idx, out[idx - r3])
        for j in range(1, r3):
            ix = idx + j
            rec(ix, T(out[ix - 1] + out[ix - r3] - out[ix - r3 - 1]))
    for k in range(1, r1):
        index = base + k * r23
        rec(index, out[index - r23])
        for j in range(1, r3):
            ix = index + j
            rec(ix, T(out[ix - 1] + out[ix - r23] - out[ix - r23 - 1]))
        for i in range(1, r2):
            ix = index + i * r3
            rec(ix, T(out[ix - r3] + out[ix - r23] - out[ix - r23 - r3]))
            for j in range(1, r3):
                ixj = ix + j
                pred = out[ixj - 1] + out[ixj - r3]
                pred = T(pred + out[ixj - r23])
                pred = T(pred - out[ixj - r3 - 1])
                pred = T(pred - out[ixj - r23 - r3])
                pred = T(pred - out[ixj - r23 - 1])
                pred = T(pred + out[ixj - r23 - r3 - 1])
                rec(ixj, pred)
