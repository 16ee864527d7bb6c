"""Device engine for the classic SZ1.4 MDQ codec — identical bytes.

Device analog of sz_tpu/core/classic_nd.py (the oracle for
SZ_compress_float_{2,3,4}D_MDQ, sz_float.c:610/946/1479, and the double
kernels): the serial Lorenzo recurrence is solved by the same plane-scan
fixpoint the regression engine uses (sz_tpu/tpu/engine.py), with the
classic kernels' POSITIONAL predictors:

- plane scan over the slowest axis (lax.scan); per plane, fixpoint
  iteration of the predict->quantize map with the data plane as the
  initial guess (lax.while_loop until the reconstruction is bit-stable);
- layer 0 uses the 2D-kernel scheme and its first row (escape, prev,
  2a-b linear) is solved by a short batched lax.scan and pinned — the
  linear predictor amplifies perturbations, so it is excluded from the
  fixpoint (same treatment as the numpy formulation it mirrors);
- 4D runs as independent 3D volumes (sz_float.c:1479): one scan over
  all q1*r1 planes with the layer-0 scheme re-armed at each volume
  boundary;
- escapes reconstruct elementwise on device (median-offset bit
  truncation, compressSingleFloatValue) — no serial dependence;
- epilogue (stream types, 65536-bin histogram, escape values, optional
  Huffman bit-pack) reuses the regression engine's device formulations.

Arithmetic parity: every jnp op rounds separately (engine._strict_jit
disables XLA:CPU's mul+add contraction; XLA:GPU does not contract).
The float kernels' double intermediates (`fabs(diff)*recip + 1` in C
promotes to double) run in IEEE f64 on the CPU and the GPU alike.
"""

from __future__ import annotations

import functools

import numpy as np

from sz_tpu.config import DataType
from sz_tpu.core import classic
from sz_tpu.core import classic_nd
from sz_tpu.format import bytes_util as bu
from sz_tpu.format import huffman
from sz_tpu.format.tdps import TDPS
from sz_tpu.tpu import engine as eng
from sz_tpu.utils import trace as _tr

jax = eng.jax
jnp = eng.jnp

ESC_K = eng.ESC_K


def _vshape(shape: tuple) -> tuple:
    """Normalize 2D/3D/4D to (nvol, nplanes, r2, r3): 2D is one layer-0
    plane; 3D is one volume; 4D is q1 independent volumes."""
    if len(shape) == 2:
        return (1, 1) + tuple(shape)
    if len(shape) == 3:
        return (1,) + tuple(shape)
    return tuple(shape)


def _esc_recon_dev(data, req_length, median):
    """Device escape reconstruction: median-offset binary truncation
    (dataCompression.c:454 / classic_nd._esc_recon_vec)."""
    T = data.dtype
    if T == jnp.float32:
        ubits, width = jnp.uint32, 32
    else:
        ubits, width = jnp.uint64, 64
    ign = jnp.maximum(width - req_length, 0).astype(ubits)
    mask = ~((ubits(1) << ign) - ubits(1))
    norm = data - jnp.asarray(median, T)
    bits = jax.lax.bitcast_convert_type(norm, ubits) & mask
    return jax.lax.bitcast_convert_type(bits, T) + jnp.asarray(median, T)


def _esc_vals_raster(t_flat, data_flat, k):
    """First k escape values in raster order, zero-padded (cumsum +
    index scatter — engine._escape_values without the block reorder)."""
    n = t_flat.shape[0]
    is_esc = t_flat == 0
    rank = jnp.cumsum(is_esc.astype(jnp.int32)) - 1
    idx = jnp.where(is_esc, jnp.minimum(rank, k), k)
    esc_idx = jnp.full((k + 1,), n, jnp.int32).at[idx].set(
        jnp.arange(n, dtype=jnp.int32), mode="drop")[:k]
    return jnp.take(data_flat, esc_idx, mode="fill", fill_value=0.0)


@functools.lru_cache(maxsize=32)
def _encode_fn(vshape: tuple, dtype_str: str, dbl: bool,
               backend: str = "cpu"):
    """data -> (uint16 raster type stream, 65536-bin histogram, padded
    escape values).  `dbl` selects the double quantizer/reconstruction
    types (float64 data, or the float-4D kernel's double itvNum)."""
    nvol, npl, r2, r3 = vshape
    plane_iter = r2 + r3 + 4
    row0 = (jnp.arange(r2) == 0)[:, None]
    col0 = (jnp.arange(r3) == 0)[None, :]

    def f(data, rp_t, rp64, recip64, intervals, radius, req_length,
          median):
        T = data.dtype
        IT = jnp.float64 if dbl else T
        data = data.reshape(vshape)
        er = _esc_recon_dev(data, req_length, median)
        intervals_f = intervals.astype(IT)

        def quant(d, pred, erx):
            """classic_nd.compress_nd's quant/quant_plane: the C itvNum
            chain promotes to double (fabs returns double) and assigns
            to IT; reconstruction is RT; epsilon recheck in double."""
            diff = d - pred
            itv = (jnp.abs(diff.astype(jnp.float64)) * recip64
                   + 1.0).astype(IT)
            within = itv < intervals_f
            itv = jnp.where(diff < 0, -itv, itv)
            t = (itv / jnp.asarray(2, IT)).astype(jnp.int32) + radius
            if dbl:
                rec = (pred.astype(jnp.float64)
                       + (2 * (t - radius)).astype(jnp.float64)
                       * rp64).astype(T)
            else:
                rec = pred + (2 * (t - radius)).astype(T) * rp_t
            ok = within & ~(jnp.abs(d - rec).astype(jnp.float64) > rp64)
            return jnp.where(ok, t, 0), jnp.where(ok, rec, erx)

        # --- layer-0 first rows, one batched scan over all volumes ---
        # (sz_float.c:946 row 0: escape, prev-value, then 2a-b linear;
        # solved serially and pinned — the linear predictor amplifies
        # perturbations, so the fixpoint excludes it)
        row_d = data[:, 0, 0, :]    # (nvol, r3)
        row_er = er[:, 0, 0, :]

        def row_step(carry, xs):
            pm1, pm2, j = carry
            cur, erx = xs
            pred = jnp.where(j == 1, pm1,
                             jnp.asarray(2, T) * pm1 - pm2)
            t, rec = quant(cur, pred, erx)
            t = jnp.where(j == 0, 0, t)
            rec = jnp.where(t == 0, erx, rec)
            return (rec, pm1, j + 1), (t, rec)

        z = jnp.zeros((nvol,), T)
        _, (tT, recT) = jax.lax.scan(
            row_step, (z, z, jnp.asarray(0, jnp.int32)),
            (row_d.T, row_er.T))
        pin_t = jnp.zeros((nvol * npl, r3), jnp.int32).at[::npl].set(tT.T)
        pin_rec = jnp.zeros((nvol * npl, r3), T).at[::npl].set(recT.T)

        # --- plane scan: fixpoint per plane, layer-0 scheme re-armed at
        # volume boundaries ---
        first_flags = (jnp.arange(nvol * npl, dtype=jnp.int32)
                       % npl) == 0

        def pred_plane(P, prev, first):
            Pp = jnp.pad(P, ((1, 0), (1, 0)))
            A = Pp[1:, :-1]
            B = Pp[:-1, 1:]
            Dd = Pp[:-1, :-1]
            # layer 0 (row 0 is pinned; only the col-0/interior forms
            # feed unpinned lanes)
            p0 = jnp.where(col0, B, A + B - Dd)
            Qp = jnp.pad(prev, ((1, 0), (1, 0)))
            C = Qp[1:, 1:]
            E = Qp[:-1, 1:]
            F = Qp[1:, :-1]
            G = Qp[:-1, :-1]
            p3 = A + B
            p3 = p3 + C
            p3 = p3 - Dd
            p3 = p3 - E
            p3 = p3 - F
            p3 = p3 + G
            pk = jnp.where(row0 & col0, C,
                           jnp.where(row0, A + C - F,
                                     jnp.where(col0, B + C - E, p3)))
            return jnp.where(first, p0, pk)

        def plane(prev, xs):
            d, erx, first, pt, pr = xs
            pinm = first & row0

            def pstep(P):
                t, rec = quant(d, pred_plane(P, prev, first), erx)
                t = jnp.where(pinm, pt[None, :], t)
                rec = jnp.where(pinm, pr[None, :], rec)
                return t, rec

            def pbody(c):
                P, it, _ = c
                _, P_new = pstep(P)
                return P_new, it + 1, eng._same_bits(P_new, P)

            def pcond(c):
                _, it, done = c
                return (~done) & (it < plane_iter)

            P, it, _ = jax.lax.while_loop(
                pcond, pbody, (d, jnp.asarray(0), jnp.asarray(False)))
            tp, P = pstep(P)
            return P, (tp, it)

        planes = data.reshape(nvol * npl, r2, r3)
        erp = er.reshape(nvol * npl, r2, r3)
        _, (t, its) = jax.lax.scan(
            plane, jnp.zeros((r2, r3), T),
            (planes, erp, first_flags, pin_t, pin_rec))

        t_flat = t.reshape(-1)
        t_stream = t_flat.astype(jnp.uint16)
        hist = eng.histogram(t_flat)
        esc_vals = _esc_vals_raster(t_flat, data.reshape(-1), ESC_K)
        return t_stream, hist, esc_vals, jnp.max(its)

    return eng._strict_jit(f, backend)


@functools.lru_cache(maxsize=32)
def _escapes_fn(n: int, k: int, backend: str = "cpu"):
    def f(t_stream, data_flat):
        return _esc_vals_raster(t_stream.astype(jnp.int32), data_flat, k)

    return eng._strict_jit(f, backend)


@functools.lru_cache(maxsize=32)
def _decode_fn(vshape: tuple, dtype_str: str, dbl: bool,
               backend: str = "cpu"):
    """(uint16 type stream, padded escape values) -> reconstruction.
    Mirrors classic_nd._decode_fast_nd: plane-scan fixpoint from zeros
    with the shared positional predictors."""
    nvol, npl, r2, r3 = vshape
    n = nvol * npl * r2 * r3
    plane_iter = r2 + r3 + 4
    row0 = (jnp.arange(r2) == 0)[:, None]
    col0 = (jnp.arange(r3) == 0)[None, :]
    T = jnp.dtype(dtype_str)

    def f(t_stream, unpred_pad, rp_t, rp64, radius):
        t_flat = t_stream.astype(jnp.int32)
        is_esc = t_flat == 0
        rank = jnp.cumsum(is_esc.astype(jnp.int32)) - 1
        kv_flat = jnp.take(unpred_pad,
                           jnp.clip(rank, 0, unpred_pad.shape[0] - 1))
        known = jnp.where(is_esc, kv_flat, jnp.asarray(0, T))
        if dbl:
            q = ((2 * (t_flat - radius)).astype(jnp.float64) * rp64)
        else:
            q = (2 * (t_flat - radius)).astype(T) * rp_t

        km = is_esc.reshape(nvol * npl, r2, r3)
        kv = known.reshape(nvol * npl, r2, r3)
        qx = q.reshape(nvol * npl, r2, r3)
        first_flags = (jnp.arange(nvol * npl, dtype=jnp.int32)
                       % npl) == 0

        def pred_plane(P, prev, first):
            Pp = jnp.pad(P, ((1, 0), (1, 0)))
            A = Pp[1:, :-1]
            B = Pp[:-1, 1:]
            Dd = Pp[:-1, :-1]
            A2 = jnp.pad(P, ((0, 0), (2, 0)))[:, :-2]
            lin = jnp.asarray(2, T) * A - A2
            col1 = (jnp.arange(r3) == 1)[None, :]
            p0 = jnp.where(row0 & col1, A,
                           jnp.where(row0, lin,
                                     jnp.where(col0, B, A + B - Dd)))
            Qp = jnp.pad(prev, ((1, 0), (1, 0)))
            C = Qp[1:, 1:]
            E = Qp[:-1, 1:]
            F = Qp[1:, :-1]
            G = Qp[:-1, :-1]
            p3 = A + B
            p3 = p3 + C
            p3 = p3 - Dd
            p3 = p3 - E
            p3 = p3 - F
            p3 = p3 + G
            pk = jnp.where(row0 & col0, C,
                           jnp.where(row0, A + C - F,
                                     jnp.where(col0, B + C - E, p3)))
            return jnp.where(first, p0, pk)

        def plane(prev, xs):
            kmx, kvx, qxx, first = xs

            def val(P):
                p = pred_plane(P, prev, first)
                if dbl:
                    v = (p.astype(jnp.float64) + qxx).astype(T)
                else:
                    v = (p + qxx).astype(T)
                return jnp.where(kmx, kvx, v)

            def pbody(c):
                P, it, _ = c
                P_new = val(P)
                return P_new, it + 1, eng._same_bits(P_new, P)

            def pcond(c):
                _, it, done = c
                return (~done) & (it < plane_iter)

            P0 = jnp.where(kmx, kvx, jnp.zeros((r2, r3), T))
            P, it, _ = jax.lax.while_loop(
                pcond, pbody, (P0, jnp.asarray(0), jnp.asarray(False)))
            return P, (P, it)

        _, (R, its) = jax.lax.scan(
            plane, jnp.zeros((r2, r3), T),
            (km, kv, qx, first_flags))
        return R.reshape(n), jnp.max(its)

    return eng._strict_jit(f, backend)


# ---------------------------------------------------------------------------
# Drivers (host side): mirror classic_nd.compress_nd / decompress_nd
# ---------------------------------------------------------------------------

def compress(data: np.ndarray, real_precision: float, value_range,
             median, *, max_range_radius: int, sample_distance: int,
             pred_threshold: float, opt_quant_mode: int = 1,
             fixed_intervals: int = 0) -> TDPS:
    """Device analog of classic_nd.compress_nd — identical byte output
    (gated by tests/test_classic_engine.py)."""
    T = np.float32 if data.dtype == np.float32 else np.float64
    dt = DataType.FLOAT if T is np.float32 else DataType.DOUBLE
    data = np.ascontiguousarray(data, dtype=T)
    n = data.size
    shape = tuple(int(r) for r in data.shape)
    dstr = np.dtype(T).str.lstrip("<>=")
    be = jax.default_backend()

    dbl = T is np.float64 or data.ndim == 4
    RT = np.float64 if dbl else T
    rp = RT(real_precision)
    recip = RT(RT(1) / rp)

    if opt_quant_mode == 1:
        with _tr.trace("optimizer"):
            intervals = classic_nd._optimize_intervals_nd(
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

    with _tr.trace("upload"):
        dev = jax.device_put(data)
        dev.block_until_ready()
    with _tr.trace("quantize"):
        t_stream_d, hist_d, esc_d, _iters = _encode_fn(
            _vshape(shape), dstr, dbl, be)(
            dev, T(rp), np.float64(rp), np.float64(recip),
            jnp.asarray(intervals, jnp.int32),
            jnp.asarray(radius, jnp.int32),
            jnp.asarray(req_length, jnp.int32), T(median))
        hist = np.asarray(hist_d)

    n_esc = int(hist[0])
    with _tr.trace("escapes"):
        if n_esc <= ESC_K:
            esc_vals = np.asarray(esc_d)[:n_esc]
        else:
            k = eng._pad_pow2(n_esc)
            esc_vals = np.asarray(_escapes_fn(n, k, be)(
                t_stream_d, dev.reshape(-1)))[:n_esc]
    enc = classic.ExactEncoder(req_length, median, T)
    enc.add_batch(esc_vals.astype(T))

    state_num = 2 * intervals
    freq = np.zeros(2 * state_num, np.int64)
    m = min(65536, 2 * state_num)
    freq[:m] = hist[:m]
    with _tr.trace("huffman_tree"):
        tables = huffman.build_tables(None, state_num, freq=freq)
    max_len = int(tables.code_len.max()) if tables.code_len.size else 0
    total_bits = int((freq[:len(tables.code_len)]
                      * tables.code_len.astype(np.int64)).sum())

    dev_pack = eng.device_bitpack_policy()
    if dev_pack and 0 < max_len <= 32 and total_bits > 0:
        nbytes = (total_bits + 7) // 8
        with _tr.trace("bitpack_device"):
            packed = eng.pack_stream_device(t_stream_d, tables,
                                            n, nbytes, be)
        body = packed[:nbytes].tobytes()
    else:
        with _tr.trace("types_download"):
            types = np.asarray(t_stream_d)
        body = huffman.encode(tables, types)

    type_array = (bu.u32_be(tables.node_count) + bu.u32_be(state_num // 2)
                  + tables.tree_bytes + body)
    return TDPS(
        data_type=dt, ds_length=n, intervals=intervals,
        median_value=float(median), req_length=req_length,
        real_precision=float(rp), type_array=type_array,
        lead_num=enc.lead_packed(), exact_mid_bytes=bytes(enc.mid_bytes),
        residual_mid_bits=enc.resi_packed(),
        exact_data_num=enc.exact_count(),
        max_quant_intervals=max_range_radius * 2)


@functools.lru_cache(maxsize=32)
def _decode_fn_packed(vshape: tuple, dtype_str: str, dbl: bool, w: int,
                      backend: str = "cpu"):
    """_decode_fn over a fixed-width bit-packed type stream (the same
    ~w/16 decode-upload cut as the regression engine's
    _delattice_packed_fn)."""
    base = _decode_fn(vshape, dtype_str, dbl, "raw")
    n = int(np.prod(vshape))

    def f(packed, unpred_pad, rp_t, rp64, radius):
        return base(eng.unpack_w_bits(packed, n, w), unpred_pad, rp_t,
                    rp64, radius)

    return eng._strict_jit(f, backend)


def decompress(tdps: TDPS, shape, dtype, as_jax: bool = False):
    """Device analog of classic_nd.decompress_nd — bit-identical output.
    as_jax=True keeps the reconstruction on device."""
    T = np.float32 if np.dtype(dtype) == np.float32 else np.float64
    n = int(np.prod(shape))
    shape = tuple(int(s) for s in shape)
    dstr = np.dtype(T).str.lstrip("<>=")
    be = jax.default_backend()
    # device-side FSM Huffman decode (same policy as the regression
    # codec): zero host FSM pass; a sync failure falls back to the
    # host decoder below
    use_dd = eng.device_decode_policy(be)
    t_dev = None
    if use_dd:
        from sz_tpu.format import bytes_util as _bu
        node_count = _bu.read_u32_be(tdps.type_array, 0)
        tsize = huffman.tree_bytes_size(node_count)
        tree = huffman.deserialize_tree(
            tdps.type_array[8:8 + tsize], node_count)
        with _tr.trace("huffman_device"):
            t_dev = eng._device_decode_stream(
                (*tree, node_count), tdps.type_array[8 + tsize:], n)
    if t_dev is None:
        with _tr.trace("huffman_decode"):
            types = huffman.decode_with_tree(tdps.type_array, n)
        t_np = np.asarray(types, np.int32)
        n_esc = int((t_np == 0).sum())
    else:
        t_np = None
        n_esc = int(jnp.sum(jnp.equal(t_dev, 0),
                            promote_integers=False))
    dec = classic.ExactDecoder(tdps, T)
    radius = tdps.intervals // 2
    dbl = T is np.float64 or len(shape) == 4
    RT = np.float64 if dbl else T
    rp = RT(tdps.real_precision)

    k = eng._pad_pow2(max(n_esc, 1))
    unpred_pad = np.zeros(k, dtype=T)
    unpred_pad[:n_esc] = dec.next_batch(n_esc)

    w = (0 if t_np is None else
         int(max(int(t_np.max(initial=0)), 1)).bit_length())
    with _tr.trace("decode_fixpoint"):
        if t_dev is not None:
            out, _iters = _decode_fn(_vshape(shape), dstr, dbl, be)(
                t_dev.astype(jnp.uint16),
                jax.device_put(unpred_pad),
                T(rp), np.float64(rp), jnp.asarray(radius, jnp.int32))
        elif 0 < w < 16 and eng.packed_types_enabled():
            from sz_tpu import native as _nat
            packed = _nat.pack_wide_bits_u32(t_np, w)
            out, _iters = _decode_fn_packed(_vshape(shape), dstr, dbl,
                                            w, be)(
                jax.device_put(packed), jax.device_put(unpred_pad),
                T(rp), np.float64(rp), jnp.asarray(radius, jnp.int32))
        else:
            out, _iters = _decode_fn(_vshape(shape), dstr, dbl, be)(
                jax.device_put(t_np.astype(np.uint16)),
                jax.device_put(unpred_pad),
                T(rp), np.float64(rp), jnp.asarray(radius, jnp.int32))
    if as_jax:
        return out.reshape(shape)
    with _tr.trace("download"):
        return np.asarray(out).reshape(shape)
