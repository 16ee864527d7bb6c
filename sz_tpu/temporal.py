"""Temporal (time-series) compression — multi-variable, multi-step.

Mirrors the reference's temporal mode (szMode=SZ_TEMPORAL_COMPRESSION,
compile flag HAVE_TIMECMPR): a registry of variables
(SZ_registerVar/SZ_VarSet, sz.c:975 / VarSet.c), per-variable history of
the previous step's *decompressed* data (multisteps->hist_data), a
per-step choice between snapshot compression (the spatial codec) and
temporal compression (predict every point from the same index in the
previous step, SZ_compress_float_1D_MDQ_ts, sz_float_ts.c:69), and a
multi-variable frame per step (SZ_compress_ts, sz.c:1071-1141):

    [currentStep u32 BE][var_count u16 LE]
    per var: [var_id u8][compressType u8][dataType u8]
             [compressedSize u64 LE][payload = full SZ stream]

The temporal predictor has no intra-step dependence — it is purely
elementwise against the previous reconstruction, i.e. embarrassingly
parallel (on the device this is a fused elementwise kernel; a run of steps is a
`lax.scan` carrying the reconstruction).  The host oracle below defines
the exact arithmetic contract.
"""

from __future__ import annotations

import dataclasses
import functools as _functools
import struct

import numpy as np

from sz_tpu import api
from sz_tpu.config import (SZConfig, ErrorBoundMode, DataType, SZMode,
                           CompressionType)
from sz_tpu.core import classic
from sz_tpu.format import bytes_util as bu
from sz_tpu.format import huffman
from sz_tpu.format import lossless as ll
from sz_tpu.format import metadata as md
from sz_tpu.format import tdps as tdps_mod
from sz_tpu.format.tdps import TDPS

_DT_NP = {DataType.FLOAT: np.float32, DataType.DOUBLE: np.float64}


# ---------------------------------------------------------------------------
# Temporal 1D kernel (sz_float_ts.c:69-208 / sz_double_ts.c)
# ---------------------------------------------------------------------------

def _ts_sample_idx(n: int, sample_distance: int) -> np.ndarray:
    """Sampling indices of the ts optimizer walk (sz_float_ts.c:28)."""
    idx = np.arange(2, n)
    return idx[idx % sample_distance == 0]


def _optimize_1d_ts_tail(cur_s, prev_s, n, real_precision,
                         max_range_radius, sample_distance,
                         pred_threshold) -> int:
    """Histogram/selection tail over the sampled values — shared by the
    host path and the device-input path (whose samples arrive as
    compact device gathers)."""
    from sz_tpu.core.optimizer import round_up_to_power_of_2

    rp = float(real_precision)
    pred_err = np.abs((prev_s - cur_s).astype(np.float64)) \
        .astype(cur_s.dtype)
    radius_index = ((pred_err.astype(np.float64) / rp + 1.0) / 2.0) \
        .astype(np.int64)
    np.minimum(radius_index, max_range_radius - 1, out=radius_index)
    hist = np.bincount(radius_index, minlength=max_range_radius)
    total = n // sample_distance
    target = int(total * pred_threshold)
    csum = np.cumsum(hist)
    over = np.flatnonzero(csum > target)
    i = int(over[0]) if len(over) else max_range_radius - 1
    return max(round_up_to_power_of_2(2 * (i + 1)), 32)


def optimize_intervals_1d_ts(flat, prev, real_precision, max_range_radius,
                             sample_distance, pred_threshold) -> int:
    """optimize_intervals_float_1D_ts (sz_float_ts.c:28)."""
    idx = _ts_sample_idx(len(flat), sample_distance)
    return _optimize_1d_ts_tail(flat[idx], prev[idx], len(flat),
                                real_precision, max_range_radius,
                                sample_distance, pred_threshold)


def _ts_step_jax(flat, prev, rp, intervals, radius, req_length, median):
    """Device form of the temporal kernel: the previous-step predictor has
    no intra-step dependence, so quantization, the epsilon recheck and
    even the escape bit-truncation are one fused elementwise pass
    (float32; float64 runs the host loop).  Returns (types, recon, esc_mask) as
    numpy arrays; the small ordered escape-byte chain stays on host."""
    from sz_tpu.tpu import engine as _eng  # enables jax x64 + cache
    jax = _eng.jax
    jnp = _eng.jnp

    def step(cur, prv):
        T = cur.dtype
        check_radius = (intervals - 1) * rp  # double
        interval2 = 2 * rp
        d = cur - prv
        pae = jnp.abs(d)
        cand = pae.astype(jnp.float64) <= check_radius
        state = ((pae.astype(jnp.float64) / rp + 1) / 2).astype(jnp.int32)
        up = (prv.astype(jnp.float64) + state * interval2).astype(T)
        dn = (prv.astype(jnp.float64) - state * interval2).astype(T)
        ge = cur >= prv
        t = jnp.where(ge, radius + state, radius - state)
        rec = jnp.where(ge, up, dn)
        bad = jnp.abs(cur - rec).astype(jnp.float64) > rp
        esc = (~cand) | bad
        # escape reconstruction: median-offset bit truncation
        # (compressSingleFloatValue, dataCompression.c:454)
        ign = 32 - req_length
        mask = jnp.uint32(0xFFFFFFFF) << jnp.uint32(max(ign, 0))
        norm = cur - jnp.asarray(median, T)
        bits = jax.lax.bitcast_convert_type(norm, jnp.uint32) & mask
        trunc = jax.lax.bitcast_convert_type(bits, jnp.float32)             + jnp.asarray(median, T)
        t = jnp.where(esc, 0, t)
        rec = jnp.where(esc, trunc, rec)
        return t, rec, esc

    step = _eng._strict_jit(step, jax.default_backend())
    t, rec, esc = step(jnp.asarray(flat), jnp.asarray(prev))
    return np.asarray(t), np.asarray(rec), np.asarray(esc)


def compress_1d_ts(data: np.ndarray, prev: np.ndarray,
                   real_precision: float, value_range, median, *,
                   max_range_radius: int, sample_distance: int,
                   pred_threshold: float, opt_quant_mode: int = 1,
                   fixed_intervals: int = 0, engine: str = "auto"):
    """Returns (TDPS, reconstruction)."""
    T = np.float32 if data.dtype == np.float32 else np.float64
    dt = DataType.FLOAT if T is np.float32 else DataType.DOUBLE
    flat = np.ascontiguousarray(data, dtype=T).reshape(-1)
    prev = np.ascontiguousarray(prev, dtype=T).reshape(-1)
    n = len(flat)
    rp = float(real_precision)

    if opt_quant_mode == 1:
        intervals = optimize_intervals_1d_ts(
            flat, prev, rp, max_range_radius, sample_distance,
            pred_threshold)
    else:
        intervals = fixed_intervals
    radius = intervals // 2

    median = T(median)
    rad_expo = classic.get_exponent(T(value_range) / T(2), T)
    req_length, median_zeroed = classic.compute_req_length(rp, rad_expo, T)
    if median_zeroed:
        median = T(0)

    enc = classic.ExactEncoder(req_length, median, T)
    types = np.zeros(n, dtype=np.int32)
    recon = np.zeros(n, dtype=T)

    use_jax = T is np.float32 and n >= 4096 and engine != "numpy"
    if use_jax and engine != "jax":
        # only take the device path when the device engine is already
        # in use (module loaded) on an accelerator: the host path beats
        # XLA:CPU, and probing the backend would needlessly import jax
        import sys
        _eng = sys.modules.get("sz_tpu.tpu.engine")
        try:
            use_jax = (_eng is not None
                       and _eng.jax.default_backend() != "cpu")
        except Exception:  # pragma: no cover
            use_jax = False
    if use_jax:
        try:
            t_j, rec_j, esc_j = _ts_step_jax(
                flat, prev, rp, intervals, radius, req_length, median)
        except Exception:
            use_jax = False
    if use_jax:
        types[:] = t_j
        types[:2] = 0
        recon[:] = rec_j
        esc_j = np.array(esc_j, copy=True)
        esc_j[:2] = True
        # ordered escape-byte chain (lead-num deltas), batched native
        eidx = np.flatnonzero(esc_j)
        recon[eidx] = enc.add_batch(flat[eidx])
        type_array = huffman.encode_with_tree(types, 2 * intervals)
        t = TDPS(
            data_type=dt, ds_length=n, intervals=intervals,
            median_value=float(median), req_length=req_length,
            real_precision=rp, type_array=type_array,
            lead_num=enc.lead_packed(),
            exact_mid_bytes=bytes(enc.mid_bytes),
            residual_mid_bits=enc.resi_packed(),
            exact_data_num=enc.exact_count(),
            max_quant_intervals=max_range_radius * 2)
        return t, recon

    recon[0] = enc.add(flat[0])
    recon[1] = enc.add(flat[1])
    check_radius = (intervals - 1) * rp  # double
    interval2 = 2 * rp  # double

    # the previous-step predictor is elementwise (no intra-step
    # recurrence, sz_float_ts.c:139-183) — fully vectorized; only the
    # escape byte streams replay serially
    cur = flat[2:]
    pr = prev[2:]
    pae = np.abs((cur - pr).astype(T))
    within = pae.astype(np.float64) <= check_radius
    state = ((pae.astype(np.float64) / rp + 1) / 2).astype(np.int64)
    ge = cur >= pr
    t_v = np.where(ge, radius + state, radius - state).astype(np.int32)
    rec = (pr.astype(np.float64)
           + np.where(ge, state, -state) * interval2).astype(T)
    ok = within & ~(np.abs((cur - rec).astype(T)
                           .astype(np.float64)) > rp)
    from sz_tpu.core.classic_nd import _esc_recon_vec
    esc_rec = _esc_recon_vec(cur, enc, T)
    types[2:] = np.where(ok, t_v, 0)
    recon[2:] = np.where(ok, rec, esc_rec)
    enc.add_batch(cur[np.flatnonzero(~ok)])

    type_array = huffman.encode_with_tree(types, 2 * intervals)
    t = TDPS(
        data_type=dt, ds_length=n, intervals=intervals,
        median_value=float(median), req_length=req_length,
        real_precision=rp, type_array=type_array,
        lead_num=enc.lead_packed(), exact_mid_bytes=bytes(enc.mid_bytes),
        residual_mid_bits=enc.resi_packed(),
        exact_data_num=enc.exact_count(),
        max_quant_intervals=max_range_radius * 2)
    return t, recon


@_functools.lru_cache(maxsize=32)
def _ts_device_step_fn(n: int, k: int):
    """Cached jitted device temporal step + fused epilogue:
    (flat, prev, scalars) -> (types u16, recon, 65536-bin histogram,
    padded escape values, padded escape indices).  Same arithmetic as
    _ts_step_jax with the first two points forced to escapes on device
    (sz_float_ts.c:101-108 handles them via the exact encoder)."""
    from sz_tpu.tpu import engine as _eng
    jax = _eng.jax
    jnp = _eng.jnp

    def f(cur, prv, rp64, intervals, radius, req_length, median):
        T = cur.dtype
        check_radius = (intervals - 1).astype(jnp.float64) * rp64
        interval2 = 2 * rp64
        d = cur - prv
        pae = jnp.abs(d)
        cand = pae.astype(jnp.float64) <= check_radius
        state = ((pae.astype(jnp.float64) / rp64 + 1) / 2
                 ).astype(jnp.int32)
        up = (prv.astype(jnp.float64) + state * interval2).astype(T)
        dn = (prv.astype(jnp.float64) - state * interval2).astype(T)
        ge = cur >= prv
        t = jnp.where(ge, radius + state, radius - state)
        rec = jnp.where(ge, up, dn)
        bad = jnp.abs(cur - rec).astype(jnp.float64) > rp64
        esc = (~cand) | bad | (jnp.arange(n) < 2)
        t = jnp.where(esc, 0, t)
        # escape recon placeholder (overwritten by the host exact-chain
        # scatter in compress_1d_ts_device — kept here so recon is
        # well-defined even before the fix-up)
        ign = jnp.maximum(32 - req_length, 0).astype(jnp.uint32)
        mask = jnp.uint32(0xFFFFFFFF) << ign
        norm = cur - median
        bits = jax.lax.bitcast_convert_type(norm, jnp.uint32) & mask
        trunc = jax.lax.bitcast_convert_type(bits, jnp.float32) + median
        rec = jnp.where(esc, trunc, rec)
        hist = _eng.histogram(t)
        # compact escape values + indices (cumsum + index scatter)
        rankc = jnp.cumsum(esc.astype(jnp.int32)) - 1
        idx = jnp.where(esc, jnp.minimum(rankc, k), k)
        sel = jnp.full((k + 1,), n, jnp.int32).at[idx].set(
            jnp.arange(n, dtype=jnp.int32), mode="drop")[:k]
        vals = jnp.take(cur, sel, mode="fill", fill_value=0.0)
        return t.astype(jnp.uint16), rec, hist, vals, sel

    return _eng._strict_jit(f, jax.default_backend())


def compress_1d_ts_device(flat_dev, prev_dev, real_precision, value_range,
                          median, *, max_range_radius: int,
                          sample_distance: int, pred_threshold,
                          opt_quant_mode: int = 1,
                          fixed_intervals: int = 0):
    """Device-resident temporal step (float32): snapshots produced on
    the device compress against the carried on-device history with no host
    round-trip of the lattice — only compact vectors (optimizer
    samples, escape values, histogram) and the entropy-coded stream
    cross the bus.  Returns (TDPS, recon as a device array); streams
    and recon are byte/bit-identical to compress_1d_ts.
    """
    from sz_tpu.tpu import engine as _eng
    jax = _eng.jax
    jnp = _eng.jnp
    T = np.float32
    dt = DataType.FLOAT
    flat_dev = jnp.asarray(flat_dev, jnp.float32).reshape(-1)
    prev_dev = jnp.asarray(prev_dev, jnp.float32).reshape(-1)
    n = int(flat_dev.size)
    rp = float(real_precision)

    if opt_quant_mode == 1:
        sidx = _ts_sample_idx(n, sample_distance).astype(
            np.int32 if n < (1 << 31) else np.int64)
        cur_s, prev_s = jax.jit(
            lambda c, p, i: (jnp.take(c, i), jnp.take(p, i)))(
            flat_dev, prev_dev, jax.device_put(sidx))
        intervals = _optimize_1d_ts_tail(
            np.asarray(cur_s), np.asarray(prev_s), n, rp,
            max_range_radius, sample_distance, pred_threshold)
    else:
        intervals = fixed_intervals
    radius = intervals // 2

    median = T(median)
    rad_expo = classic.get_exponent(T(value_range) / T(2), T)
    req_length, median_zeroed = classic.compute_req_length(rp, rad_expo, T)
    if median_zeroed:
        median = T(0)
    enc = classic.ExactEncoder(req_length, median, T)

    from sz_tpu.tpu.engine import _pad_pow2
    k = 4096
    while True:
        t_d, rec_d, hist_d, vals_d, sel_d = _ts_device_step_fn(n, k)(
            flat_dev, prev_dev, np.float64(rp),
            jnp.asarray(intervals, jnp.int32),
            jnp.asarray(radius, jnp.int32),
            jnp.asarray(req_length, jnp.int32), T(median))
        hist = np.asarray(hist_d)
        n_esc = int(hist[0])
        if n_esc <= k:
            break
        k = _pad_pow2(n_esc)
    esc_vals = np.asarray(vals_d)[:n_esc]

    # ordered escape byte chain on the host (exact C fold); its recon
    # values scatter back so the carried history is bit-exact even if
    # the device truncation ever disagreed
    recon_esc = enc.add_batch(esc_vals) if n_esc else np.zeros(0, T)
    pad = np.zeros(k, T)
    pad[:n_esc] = recon_esc
    rec_d = jax.jit(
        lambda r, s, v: r.at[s].set(v, mode="drop"))(
        rec_d, sel_d, jax.device_put(pad))

    state_num = 2 * intervals
    freq = np.zeros(2 * state_num, np.int64)
    m = min(65536, 2 * state_num)
    freq[:m] = hist[:m]
    tables = huffman.build_tables(None, state_num, freq=freq)
    max_len = int(tables.code_len.max()) if tables.code_len.size else 0
    total_bits = int((freq[:len(tables.code_len)]
                      * tables.code_len.astype(np.int64)).sum())
    if 0 < max_len <= 32 and total_bits > 0:
        nbytes = (total_bits + 7) // 8
        be = _eng.jax.default_backend()
        body = _eng.pack_stream_device(t_d, tables, n, nbytes,
                                       be)[:nbytes].tobytes()
    else:  # pragma: no cover - pathological trees
        body = huffman.encode(tables, np.asarray(t_d).astype(np.int32))
    type_array = (bu.u32_be(tables.node_count)
                  + bu.u32_be(state_num // 2) + tables.tree_bytes + body)

    t = TDPS(
        data_type=dt, ds_length=n, intervals=intervals,
        median_value=float(median), req_length=req_length,
        real_precision=rp, type_array=type_array,
        lead_num=enc.lead_packed(), exact_mid_bytes=bytes(enc.mid_bytes),
        residual_mid_bits=enc.resi_packed(),
        exact_data_num=enc.exact_count(),
        max_quant_intervals=max_range_radius * 2)
    return t, rec_d


def decompress_1d_ts(tdps: TDPS, prev: np.ndarray, n: int,
                     dtype) -> np.ndarray:
    """decompressDataSeries_float_1D_ts (szd_float_ts.c:19)."""
    T = np.float32 if np.dtype(dtype) == np.float32 else np.float64
    types = huffman.decode_with_tree(tdps.type_array, n)
    dec = classic.ExactDecoder(tdps, T)
    radius = tdps.intervals // 2
    interval2 = tdps.real_precision * 2  # double
    t_arr = np.asarray(types, np.int64)
    out = (np.asarray(prev, T).astype(np.float64)
           + (t_arr - radius) * interval2).astype(T)
    esc = np.flatnonzero(t_arr == 0)
    out[esc] = dec.next_batch(len(esc))
    return out


@_functools.lru_cache(maxsize=8)
def _ts_decode_fn(n: int, k: int, dstr: str):
    from sz_tpu.tpu import engine as _eng
    jax, jnp = _eng.jax, _eng.jnp
    T = jnp.dtype(dstr)

    def f(t_arr, prev, radius, interval2, unpred_pad):
        t32 = t_arr.astype(jnp.int32)
        out = (prev.astype(jnp.float64)
               + (t32 - radius).astype(jnp.float64) * interval2
               ).astype(T)
        is_esc = t32 == 0
        cum = jnp.cumsum(is_esc.astype(jnp.int32))
        esc_idx = jnp.searchsorted(
            cum, jnp.arange(1, k + 1, dtype=jnp.int32), side="left")
        return out.at[esc_idx].set(unpred_pad, mode="drop")

    return _eng._strict_jit(f, jax.default_backend())


def decompress_1d_ts_device(tdps: TDPS, prev, n: int, dtype):
    """Device analog of decompress_1d_ts: the type stream decodes with
    the on-chip FSM kernel (zero host Huffman pass — only the raw coded
    bytes cross the bus), the elementwise temporal restore
    (szd_float_ts.c:19 arithmetic, f64 contract) and the escape scatter
    run on device, and the returned reconstruction stays device-resident
    (the next step's history).  Returns None when the stream is outside
    the FSM envelope (caller falls back to the host path)."""
    from sz_tpu.format import bytes_util as _bu
    from sz_tpu.tpu import engine as _eng
    jax, jnp = _eng.jax, _eng.jnp

    T = np.float32 if np.dtype(dtype) == np.float32 else np.float64
    node_count = _bu.read_u32_be(tdps.type_array, 0)
    tsize = huffman.tree_bytes_size(node_count)
    tree = huffman.deserialize_tree(tdps.type_array[8:8 + tsize],
                                    node_count)
    t_dev = _eng._device_decode_stream(
        (*tree, node_count), tdps.type_array[8 + tsize:], n)
    if t_dev is None:
        return None
    n_esc = int(jnp.sum(jnp.equal(t_dev[:n], 0),
                        promote_integers=False))
    dec = classic.ExactDecoder(tdps, T)
    k = _eng._pad_pow2(max(n_esc, 1))
    unpred_pad = np.zeros(k, dtype=T)
    unpred_pad[:n_esc] = dec.next_batch(n_esc)
    dstr = np.dtype(T).str.lstrip("<>=")
    prev_d = prev if api._is_jax_array(prev) else jax.device_put(
        np.asarray(prev, T))
    return _ts_decode_fn(n, k, dstr)(
        t_dev[:n], prev_d.reshape(-1),
        jnp.asarray(tdps.intervals // 2, jnp.int32),
        jnp.asarray(tdps.real_precision * 2, jnp.float64),
        jax.device_put(unpred_pad))


# ---------------------------------------------------------------------------
# Variable registry + per-step framing
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Variable:
    """SZ_Variable analog (VarSet.c)."""

    var_id: int
    name: str
    shape: tuple
    dtype: object
    cfg: SZConfig
    hist: np.ndarray = None  # previous step's reconstruction
    last_snapshot_step: int = 0
    compress_type: int = 0


class TemporalCompressor:
    """SZ_registerVar + SZ_compress_ts/SZ_decompress_ts analog.

    The same class drives both directions; decompression needs the same
    registration order/ids (as in the reference, where the decompressor
    re-registers the variables)."""

    def __init__(self, snapshot_step: int = 5):
        self.snapshot_step = snapshot_step
        self.vars: dict[int, Variable] = {}
        self.order: list[int] = []
        self.current_step = 0

    def register(self, var_id: int, name: str, shape, dtype,
                 cfg: SZConfig = None) -> None:
        cfg = cfg or SZConfig().with_bound(ErrorBoundMode.ABS, 1e-4)
        cfg = dataclasses.replace(cfg, sz_mode=SZMode.TEMPORAL_COMPRESSION,
                                  snapshot_cmpr_step=self.snapshot_step)
        self.vars[var_id] = Variable(var_id, name, tuple(shape),
                                     np.dtype(dtype), cfg)
        self.order.append(var_id)

    # -- compression ------------------------------------------------------

    def _step_payload(self, v: Variable, data, cmpr_type:
                      CompressionType) -> bytes:
        cfg = v.cfg
        T = _DT_NP[DataType.FLOAT if v.dtype == np.float32
                   else DataType.DOUBLE]
        dt = DataType.FLOAT if T is np.float32 else DataType.DOUBLE
        # device-resident temporal: jax.Array snapshots (f32) compress
        # against an on-device history with no lattice round-trip
        is_dev = api._is_jax_array(data) and T is np.float32
        flat = data.reshape(-1).astype(T, copy=False) \
            if not is_dev else data.reshape(-1)
        n = int(flat.size)
        fmin = T(flat.min())
        value_range = T(T(flat.max()) - fmin)
        fmax = T(fmin + value_range)
        rp, _ = api._resolve_precision(cfg, float(value_range), n, dt)
        hdr_cfg = dataclasses.replace(cfg, abs_err_bound=rp)
        median = T(fmin + value_range / T(2))

        use_ts = (cmpr_type == CompressionType.FORCE_TEMPORAL
                  or (cmpr_type == CompressionType.PERIO_TEMPORAL
                      and self.current_step % self.snapshot_step != 0))
        if use_ts and v.hist is not None:
            kw = dict(max_range_radius=cfg.max_range_radius,
                      sample_distance=cfg.sample_distance,
                      pred_threshold=np.float32(cfg.pred_threshold),
                      opt_quant_mode=cfg.opt_quant_mode,
                      fixed_intervals=cfg.quantization_intervals)
            if is_dev:
                t, recon = compress_1d_ts_device(
                    flat, v.hist, rp, value_range, median, **kw)
            else:
                t, recon = compress_1d_ts(
                    flat, np.asarray(v.hist), rp, value_range, median,
                    **kw)
            v.compress_type = 1
            v.hist = recon
            header = md.make_header(hdr_cfg, dt, fmin, fmax)
            body = (header + bu.size_be(n, cfg.size_type)
                    + tdps_mod.to_bytes(t, cfg.size_type))
            payload = ll.compress(body, cfg.lossless, cfg.lossless_level)
        else:
            # snapshot step: the spatial classic codec; history = its
            # own reconstruction (decode of the just-built stream)
            snap_cfg = dataclasses.replace(cfg, with_regression=False)
            payload = api.compress(data.reshape(v.shape), snap_cfg)
            v.compress_type = 0
            v.last_snapshot_step = self.current_step
            if is_dev:
                # keep the history on device for the next ts step
                v.hist = api.decompress(payload, v.shape, v.dtype,
                                        engine="jax",
                                        as_jax=True).reshape(-1)
            else:
                v.hist = api.decompress(payload, v.shape,
                                        v.dtype).reshape(-1)
        return payload

    def compress_step(self, arrays: dict, cmpr_type: CompressionType =
                      CompressionType.PERIO_TEMPORAL) -> bytes:
        """arrays: {var_id: ndarray}.  Returns the step frame."""
        frames = []
        for vid in self.order:
            v = self.vars[vid]
            data = arrays[vid]
            if not api._is_jax_array(data):
                data = np.asarray(data)
            payload = self._step_payload(v, data, cmpr_type)
            frames.append((v, payload))
        out = bytearray()
        out += bu.u32_be(self.current_step)
        out += struct.pack("<H", len(frames))
        for v, payload in frames:
            out += bytes([v.var_id & 0xFF, v.compress_type & 0xFF,
                          (DataType.FLOAT if v.dtype == np.float32
                           else DataType.DOUBLE) & 0xFF])
            out += struct.pack("<Q", len(payload))
            out += payload
        self.current_step += 1
        return bytes(out)

    # -- decompression ----------------------------------------------------

    def decompress_step(self, blob: bytes, as_jax: bool = False) -> dict:
        """Returns {var_id: ndarray}; updates per-var history.

        as_jax=True (or an accelerator backend with the device-decode
        policy on) decodes f32 temporal steps on device: the type
        stream runs through the on-chip FSM kernel, the restore and
        escape scatter are fused device ops, and the history stays in
        HBM across steps; as_jax additionally returns the device
        arrays (the natural mode when the steps feed an on-device
        pipeline)."""
        pos = 0
        step = bu.read_u32_be(blob, pos)
        pos += 4
        (nvars,) = struct.unpack_from("<H", blob, pos)
        pos += 2
        out = {}
        for _ in range(nvars):
            var_id = blob[pos]
            ctype = blob[pos + 1]
            pos += 3  # id, compressType, dataType
            (csize,) = struct.unpack_from("<Q", blob, pos)
            pos += 8
            payload = blob[pos:pos + csize]
            pos += csize
            v = self.vars.get(var_id)
            if v is None:
                continue
            n = int(np.prod(v.shape))
            use_dev = False
            if v.dtype == np.float32:
                from sz_tpu.tpu import engine as _eng
                import jax as _jax
                be = _jax.default_backend()
                use_dev = as_jax or _eng.device_decode_policy(be)
            if ctype == 0:
                data = api.decompress(payload, v.shape, v.dtype,
                                      engine="jax" if use_dev
                                      else "auto", as_jax=use_dev)
                if use_dev and not api._is_jax_array(data):
                    # 1D snapshots decode on the host (classic 1D has
                    # no device kernel — serial chain); keep the
                    # history chain device-resident regardless
                    import jax as _jax
                    data = _jax.device_put(data)
            else:
                T = _DT_NP[DataType.FLOAT if v.dtype == np.float32
                           else DataType.DOUBLE]
                inner = ll.decompress(
                    payload, expected_size=n * T().itemsize * 2 + 64)
                dt = (DataType.FLOAT if v.dtype == np.float32
                      else DataType.DOUBLE)
                hdr = md.parse_header(inner, dt)
                off = hdr.body_offset + hdr.size_type
                t = tdps_mod.from_bytes(inner[off:], dt, is_pwr=False,
                                        msst19=False,
                                        size_type=hdr.size_type)
                data = None
                if use_dev:
                    data = decompress_1d_ts_device(t, v.hist, n,
                                                   v.dtype)
                    if data is not None:
                        data = data.reshape(v.shape)
                if data is None:
                    data = decompress_1d_ts(t, np.asarray(v.hist), n,
                                            v.dtype).reshape(v.shape)
            if api._is_jax_array(data):
                v.hist = data.reshape(-1)
                out[var_id] = data if as_jax else np.asarray(data)
            else:
                v.hist = np.asarray(data).reshape(-1).copy()
                out[var_id] = data
        self.current_step = step + 1
        return out
