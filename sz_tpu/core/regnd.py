"""SZ2.1 blocked-regression codec, generic over rank (2D/3D) and dtype.

Host-reference implementation defining the exact numerical contract of
the reference kernels:
  float 3D: SZ_compress_float_3D_MDQ_nonblocked_with_blocked_regression
            (sz_float.c:6527) / decoder (szd_float.c:3483)
  float 2D: sz_float.c:5516 (block_size=16, 3 coeffs, use_mean forced 0,
            noise=0.81*eb, and the sampling quirk a*(i-1) at
            sz_float.c:6023)
  double:   sz_double.c:5904 / :4900 — same structure in float64 with
            8-byte precision/mean/unpredictable fields

The device engine (sz_tpu/tpu/engine.py) reproduces these semantics with
vectorized wavefront kernels; this module is the oracle it is tested
against, and the fallback when JAX is unavailable.
"""

from __future__ import annotations

import dataclasses
import struct

import numpy as np

from sz_tpu.core import blocks as B
from sz_tpu.core import optimizer as opt
from sz_tpu.format import bytes_util as bu
from sz_tpu.format import huffman

COEFF_CAPACITY = 65536
COEFF_RADIUS = COEFF_CAPACITY // 2


@dataclasses.dataclass
class EncodeResult:
    body: bytes
    quantization_intervals: int
    use_mean: bool
    reg_count: int
    total_unpred: int


@dataclasses.dataclass(frozen=True)
class _Spec:
    """Rank/dtype-dependent constants."""

    rank: int
    T: type  # numpy scalar type
    block_size: int
    ncoeff: int
    noise_factor: float
    rel_param_err_expr: float  # 0.025 (3D) | 0.15/3 (2D), as C double
    esize: int  # element byte size

    @property
    def fmt_le(self):
        return "<f4" if self.T is np.float32 else "<f8"


def _spec(rank: int, dtype) -> _Spec:
    T = np.float32 if np.dtype(dtype) == np.float32 else np.float64
    esize = 4 if T is np.float32 else 8
    if rank == 3:
        return _Spec(3, T, 6, 4, 1.22, 0.025, esize)
    elif rank == 2:
        return _Spec(2, T, 16, 3, 0.81, 0.15 / 3, esize)
    raise ValueError(f"rank {rank} unsupported by regression codec")


def _val_be(spec: _Spec, v) -> bytes:
    return bu.f32_be(v) if spec.T is np.float32 else bu.f64_be(v)


def _val_le(spec: _Spec, v) -> bytes:
    return bu.f32_le(v) if spec.T is np.float32 else bu.f64_le(v)


# ---------------------------------------------------------------------------
# Regression coefficients
# ---------------------------------------------------------------------------

def _regions(db: B.DimBlocks):
    return [(0, db.split, db.early), (db.split, db.num, db.late)]


def _iter_regions(dbs):
    """Yield (ranges, lens) for the cartesian product of early/late regions."""
    import itertools

    for combo in itertools.product(*[_regions(db) for db in dbs]):
        ranges = [(c[0], c[1]) for c in combo]
        lens = [c[2] for c in combo]
        if all(r0 < r1 for r0, r1 in ranges):
            yield ranges, lens


def _gather_blocks(data, dbs, ranges, lens):
    """All blocks of one uniform region as [*nblocks, *blocklens]."""
    starts = [db.start(r0) for db, (r0, r1) in zip(dbs, ranges)]
    nb = [r1 - r0 for r0, r1 in ranges]
    ix = tuple(slice(s, s + n * ln) for s, n, ln in zip(starts, nb, lens))
    sub = data[ix]
    rank = len(dbs)
    shape = []
    for n, ln in zip(nb, lens):
        shape += [n, ln]
    sub = sub.reshape(shape)
    perm = list(range(0, 2 * rank, 2)) + list(range(1, 2 * rank, 2))
    return np.ascontiguousarray(sub.transpose(perm)), nb


def _flat_block_idx(dbs, ranges, nb):
    grids = np.meshgrid(*[np.arange(r0, r1) for r0, r1 in ranges],
                        indexing="ij")
    idx = grids[0]
    for d in range(1, len(dbs)):
        idx = idx * dbs[d].num + grids[d]
    return idx.ravel()


def compute_reg_coeffs(data, dbs, spec: _Spec) -> np.ndarray:
    """float/double[num_blocks, ncoeff], exact accumulation order."""
    T = spec.T
    num_blocks = int(np.prod([db.num for db in dbs]))
    coeffs = np.zeros((num_blocks, spec.ncoeff), dtype=T)
    with np.errstate(all="ignore"):
        for ranges, lens in _iter_regions(dbs):
            sub, nb = _gather_blocks(data, dbs, ranges, lens)
            nblk = int(np.prod(nb))
            s = sub.reshape(nblk, *lens)
            if spec.rank == 3:
                cbx, cby, cbz = lens
                fx = np.zeros(nblk, T)
                fy = np.zeros(nblk, T)
                fz = np.zeros(nblk, T)
                f = np.zeros(nblk, T)
                for ii in range(cbx):
                    sum_x = np.zeros(nblk, T)
                    for jj in range(cby):
                        sum_y = np.zeros(nblk, T)
                        for kk in range(cbz):
                            cur = s[:, ii, jj, kk]
                            sum_y += cur
                            fz += cur * T(kk)
                        fy += sum_y * T(jj)
                        sum_x += sum_y
                    fx += sum_x * T(ii)
                    f += sum_x
                coeff = T(1.0 / (cbx * cby * cbz))
                a = (2 * fx / T(cbx - 1) - f) * T(6) * coeff / T(cbx + 1)
                b = (2 * fy / T(cby - 1) - f) * T(6) * coeff / T(cby + 1)
                c = (2 * fz / T(cbz - 1) - f) * T(6) * coeff / T(cbz + 1)
                d = (f * coeff - (T(cbx - 1) * a / T(2)
                                  + T(cby - 1) * b / T(2)
                                  + T(cbz - 1) * c / T(2)))
                cols = (a, b, c, d)
            else:
                cbx, cby = lens
                fx = np.zeros(nblk, T)
                fy = np.zeros(nblk, T)
                f = np.zeros(nblk, T)
                for ii in range(cbx):
                    sum_x = np.zeros(nblk, T)
                    for jj in range(cby):
                        cur = s[:, ii, jj]
                        sum_x += cur
                        fy += cur * T(jj)
                    fx += sum_x * T(ii)
                    f += sum_x
                coeff = T(1.0 / (cbx * cby))
                a = (2 * fx / T(cbx - 1) - f) * T(6) * coeff / T(cbx + 1)
                b = (2 * fy / T(cby - 1) - f) * T(6) * coeff / T(cby + 1)
                c = (f * coeff - (T(cbx - 1) * a / T(2)
                                  + T(cby - 1) * b / T(2)))
                cols = (a, b, c)
            flat_idx = _flat_block_idx(dbs, ranges, nb)
            for e, col in enumerate(cols):
                coeffs[flat_idx, e] = col
    return coeffs


# ---------------------------------------------------------------------------
# Predictor selection
# ---------------------------------------------------------------------------

def select_predictor(data, coeffs, dbs, spec: _Spec, noise, use_mean,
                     mean) -> np.ndarray:
    T = spec.T
    num_blocks = int(np.prod([db.num for db in dbs]))
    use_reg = np.zeros(num_blocks, dtype=bool)
    for ranges, lens in _iter_regions(dbs):
        sub, nb = _gather_blocks(data, dbs, ranges, lens)
        nblk = int(np.prod(nb))
        s = sub.reshape(nblk, *lens)
        flat_idx = _flat_block_idx(dbs, ranges, nb)
        cf = coeffs[flat_idx]
        err_sz = np.zeros(nblk, T)
        err_reg = np.zeros(nblk, T)
        bs = min(lens)
        for i in range(1, bs):
            bmi = bs - i
            if spec.rank == 3:
                pts = (((i, i, i), (T(i), T(i), T(i))),
                       ((i, i, bmi), (T(i), T(i), T(bmi))),
                       ((i, bmi, i), (T(i), T(bmi), T(i))),
                       ((i, bmi, bmi), (T(i), T(bmi), T(bmi))))
            else:
                # 2D second sample uses a*(i-1) (sz_float.c:6023)
                pts = (((i, i), (T(i), T(i))),
                       ((i, bmi), (T(i - 1), T(bmi))))
            for pidx, pcoef in pts:
                cur = s[(slice(None),) + pidx]
                if spec.rank == 3:
                    pi, pj, pk = pidx
                    p = s[:, pi, pj, pk - 1] + s[:, pi, pj - 1, pk]
                    p = p + s[:, pi - 1, pj, pk]
                    p = p - s[:, pi, pj - 1, pk - 1]
                    p = p - s[:, pi - 1, pj, pk - 1]
                    p = p - s[:, pi - 1, pj - 1, pk]
                    p = p + s[:, pi - 1, pj - 1, pk - 1]
                    pr = (cf[:, 0] * pcoef[0] + cf[:, 1] * pcoef[1]
                          + cf[:, 2] * pcoef[2] + cf[:, 3])
                else:
                    pi, pj = pidx
                    p = s[:, pi, pj - 1] + s[:, pi - 1, pj] \
                        - s[:, pi - 1, pj - 1]
                    pr = cf[:, 0] * pcoef[0] + cf[:, 1] * pcoef[1] + cf[:, 2]
                e = np.abs(p - cur) + noise
                if use_mean:
                    e = np.minimum(e, np.abs(mean - cur))
                err_sz += e
                err_reg += np.abs(pr - cur)
        use_reg[flat_idx] = err_reg < err_sz
    return use_reg


# ---------------------------------------------------------------------------
# Coefficient chain
# ---------------------------------------------------------------------------

def quantize_coeff_chain(coeffs, use_reg, real_precision, dbs, spec: _Spec,
                         use_mean: bool):
    T = spec.T
    nc = spec.ncoeff
    rel = T(spec.rel_param_err_expr)
    if spec.rank == 3:
        precision = [T(rel * real_precision / T(dbs[0].late)),
                     T(rel * real_precision / T(dbs[1].late)),
                     T(rel * real_precision / T(dbs[2].late)),
                     T(rel * real_precision)]
    else:
        precision = [T(rel * real_precision / T(dbs[0].late)),
                     T(rel * real_precision / T(dbs[1].late)),
                     T(rel * real_precision)]
    precision = np.array(precision, dtype=T)
    recip = np.array([T(1) / p for p in precision], dtype=T)

    try:
        from sz_tpu import native
        ct, ulist, qc = native.coeff_chain(
            np.ascontiguousarray(coeffs[np.flatnonzero(use_reg)], dtype=T),
            precision, use_mean, COEFF_CAPACITY, COEFF_RADIUS)
        return ct, [list(u) for u in ulist], qc, precision
    except ImportError:  # pragma: no cover
        pass

    reg_idx = np.flatnonzero(use_reg)
    reg_count = len(reg_idx)
    ctypes = np.zeros((nc, reg_count), dtype=np.int32)
    unpred = [[] for _ in range(nc)]
    qcoeffs = np.zeros((reg_count, nc), dtype=T)
    last = [T(0)] * nc
    cap = T(COEFF_CAPACITY)
    for n in range(reg_count):
        bidx = reg_idx[n]
        for e in range(nc):
            cur = coeffs[bidx, e]
            diff = T(cur - last[e])
            if use_mean:
                # 3D mean branch multiplies by the reciprocal
                itv = T(T(abs(diff)) * recip[e] + T(1))
            else:
                itv = T(T(abs(diff)) / precision[e] + T(1))
            if itv < cap:
                if diff < 0:
                    itv = -itv
                t = int(itv / T(2)) + COEFF_RADIUS
                rec = T(last[e] + T(2 * (t - COEFF_RADIUS)) * precision[e])
                if T(abs(T(cur - rec))) > precision[e]:
                    ctypes[e, n] = 0
                    last[e] = cur
                    unpred[e].append(cur)
                else:
                    ctypes[e, n] = t
                    last[e] = rec
            else:
                ctypes[e, n] = 0
                last[e] = cur
                unpred[e].append(cur)
            qcoeffs[n, e] = last[e]
    return ctypes, unpred, qcoeffs, precision


# ---------------------------------------------------------------------------
# Vectorized host encoder/decoder (numpy fixpoint — the engine's lattice
# formulation, sz_tpu/tpu/engine.py, evaluated with numpy; numpy rounds
# per-op exactly like the serial C, so the fixpoint converges to the
# bit-exact serial result).  The per-point Python loops below
# (_encode_points_3d/_2d, _decode_points_3d/_2d) remain as the oracle
# the fast path is tested against.
# ---------------------------------------------------------------------------

def _np_geometry(dbs, shape):
    """(bflat, pos) lattices: block id per point and stream position."""
    rank = len(shape)
    bid, loc, cnt = [], [], []
    for db in dbs:
        counts = db.counts()
        bid.append(np.repeat(np.arange(db.num, dtype=np.int64), counts))
        loc.append((np.arange(db.r)
                    - np.repeat(db.starts(), counts)).astype(np.int64))
        cnt.append(np.repeat(counts, counts).astype(np.int64))
    if rank == 3:
        bsizes = (dbs[0].counts()[:, None, None]
                  * dbs[1].counts()[None, :, None]
                  * dbs[2].counts()[None, None, :]).ravel()
        bflat = ((bid[0][:, None, None] * dbs[1].num
                  + bid[1][None, :, None]) * dbs[2].num
                 + bid[2][None, None, :])
        intra = ((loc[0][:, None, None] * cnt[1][None, :, None]
                  + loc[1][None, :, None]) * cnt[2][None, None, :]
                 + loc[2][None, None, :])
    else:
        bsizes = (dbs[0].counts()[:, None]
                  * dbs[1].counts()[None, :]).ravel()
        bflat = bid[0][:, None] * dbs[1].num + bid[1][None, :]
        intra = loc[0][:, None] * cnt[1][None, :] + loc[1][None, :]
    offsets = np.concatenate([[0], np.cumsum(bsizes)[:-1]])
    pos = offsets[bflat] + intra
    return bflat, pos, loc


def _np_quant(cur, pred, rp, recip, capf, radius, T):
    """Vectorized _quant_point (engine._quant numpy twin)."""
    diff = cur - pred
    itv = np.abs(diff) * recip + T(1)
    within = itv < capf
    itv = np.where(diff < 0, -itv, itv)
    t = (itv / T(2)).astype(np.int32) + np.int32(radius)
    rec = pred + (2 * (t - radius)).astype(T) * rp
    ok = within & (np.abs(cur - rec) <= rp)
    return np.where(ok, t, 0), np.where(ok, rec, cur)


def _lorenzo_pred_np(R, rank, T):
    if rank == 3:
        Rp = np.zeros((R.shape[0] + 1, R.shape[1] + 1, R.shape[2] + 1),
                      dtype=T)
        Rp[1:, 1:, 1:] = R
        p = Rp[1:, 1:, :-1] + Rp[1:, :-1, 1:]
        p = p + Rp[:-1, 1:, 1:]
        p = p - Rp[1:, :-1, :-1]
        p = p - Rp[:-1, 1:, :-1]
        p = p - Rp[:-1, :-1, 1:]
        p = p + Rp[:-1, :-1, :-1]
        return p
    Rp = np.zeros((R.shape[0] + 1, R.shape[1] + 1), dtype=T)
    Rp[1:, 1:] = R
    return Rp[1:, :-1] + Rp[:-1, 1:] - Rp[:-1, :-1]


def _encode_points_fast(data, dbs, spec, use_reg, qcoeffs, rp, recip,
                        intervals, use_mean, mean):
    """Vectorized twin of _encode_points_3d/_2d (bit-identical output)."""
    T = spec.T
    rank = spec.rank
    shape = data.shape
    bflat, pos, loc = _np_geometry(dbs, shape)
    nblocks = int(np.prod([db.num for db in dbs]))
    lc_full = np.zeros((nblocks, spec.ncoeff), dtype=T)
    lc_full[np.flatnonzero(use_reg)] = qcoeffs
    reg_pts = np.asarray(use_reg, bool)[bflat]
    cap = np.int64(intervals)
    capf = T(cap)
    cap_szf = T(cap - 2)
    radius = int(intervals) // 2

    fl = [l.astype(T) for l in loc]
    if rank == 3:
        pred_reg = (lc_full[:, 0][bflat] * fl[0][:, None, None]
                    + lc_full[:, 1][bflat] * fl[1][None, :, None]
                    + lc_full[:, 2][bflat] * fl[2][None, None, :]
                    + lc_full[:, 3][bflat])
    else:
        pred_reg = (lc_full[:, 0][bflat] * fl[0][:, None]
                    + lc_full[:, 1][bflat] * fl[1][None, :]
                    + lc_full[:, 2][bflat])
    t_reg, rec_reg = _np_quant(data, pred_reg, T(rp), T(recip), capf,
                               radius, T)
    mean_mask = None
    if use_mean:
        mean_mask = (~reg_pts) & (np.abs(data - T(mean)) <= T(rp))

    def step(R):
        p = _lorenzo_pred_np(R, rank, T)
        t_l, rec_l = _np_quant(data, p, T(rp), T(recip), cap_szf,
                               radius, T)
        if use_mean:
            t_l = np.where((t_l != 0) & (t_l <= radius), t_l - 1, t_l)
            t_l = np.where(mean_mask, radius, t_l)
            rec_l = np.where(mean_mask, T(mean), rec_l)
        t = np.where(reg_pts, t_reg, t_l)
        R_new = np.where(reg_pts, rec_reg, rec_l)
        return t, R_new

    R = data
    # transient inf/nan in not-yet-converged regions is expected (the
    # wavefront overwrites them); silence the numpy warnings
    with np.errstate(all="ignore"):
        for _ in range(int(sum(shape)) + 4):
            _t, R_new = step(R)
            if np.array_equal(R_new, R):
                break
            R = R_new
        t, _ = step(R)

    result_type = np.zeros(data.size, np.int32)
    result_type[pos.reshape(-1)] = t.reshape(-1)
    esc_stream = np.flatnonzero(result_type == 0)
    iperm = np.zeros(data.size, np.int64)
    iperm[pos.reshape(-1)] = np.arange(data.size)
    unpred_arr = data.reshape(-1)[iperm[esc_stream]].astype(T)
    return result_type, unpred_arr


def _decode_points_fast(shape, T, dbs, indicator, qcoeffs, types, unpred,
                        intervals, rp, use_mean, mean):
    """Vectorized twin of _decode_points_3d/_2d."""
    rank = len(shape)
    bflat, pos, loc = _np_geometry(dbs, shape)
    nblocks = int(np.prod([db.num for db in dbs]))
    use_reg = (np.asarray(indicator) == 0)
    nc = 4 if rank == 3 else 3
    lc_full = np.zeros((nblocks, nc), dtype=T)
    if np.count_nonzero(use_reg):
        lc_full[np.flatnonzero(use_reg)] = qcoeffs
    reg_pts = use_reg[bflat]
    radius = int(intervals) // 2
    rp = T(rp)

    n = int(np.prod(shape))
    t_arr = np.asarray(types, np.int32)
    # gather: lattice cell takes the code at its stream position
    t_lat = t_arr[pos.reshape(-1)].reshape(shape)
    unpred_lat = np.zeros(n, T)
    esc_stream = np.flatnonzero(t_arr == 0)
    iperm = np.zeros(n, np.int64)
    iperm[pos.reshape(-1)] = np.arange(n)
    unpred_lat[iperm[esc_stream]] = np.asarray(unpred, T)
    unpred_lat = unpred_lat.reshape(shape)

    fl = [l.astype(T) for l in loc]
    if rank == 3:
        pred_reg = (lc_full[:, 0][bflat] * fl[0][:, None, None]
                    + lc_full[:, 1][bflat] * fl[1][None, :, None]
                    + lc_full[:, 2][bflat] * fl[2][None, None, :]
                    + lc_full[:, 3][bflat])
    else:
        pred_reg = (lc_full[:, 0][bflat] * fl[0][:, None]
                    + lc_full[:, 1][bflat] * fl[1][None, :]
                    + lc_full[:, 2][bflat])

    esc = t_lat == 0
    t_adj = t_lat
    if use_mean:
        t_adj = np.where((~reg_pts) & (t_lat < radius), t_lat + 1, t_lat)
    q_lor = (2 * (t_adj - radius)).astype(T) * rp
    q_reg = (2 * (t_lat - radius)).astype(T) * rp
    reg_val = pred_reg + q_reg
    if use_mean:
        mean_pts = (~reg_pts) & (t_lat == radius)
    else:
        mean_pts = np.zeros(shape, bool)
    known_mask = esc | reg_pts | mean_pts
    known = np.where(esc, unpred_lat,
                     np.where(reg_pts, reg_val, T(mean)))

    with np.errstate(all="ignore"):
        if rank == 3:
            # plane scan (see engine._decode_fn): the x-recurrence is
            # forward-only, so each plane needs at most r2+r3 sweeps of
            # a small 2D map instead of sum(shape) full-lattice sweeps
            R = np.zeros(shape, T)
            prev = np.zeros(shape[1:], T)
            for x in range(shape[0]):
                km, kv, qx = known_mask[x], known[x], q_lor[x]
                P = np.where(km, kv, np.zeros(shape[1:], T))
                Qp = np.zeros((shape[1] + 1, shape[2] + 1), T)
                Qp[1:, 1:] = prev
                for _ in range(shape[1] + shape[2] + 4):
                    Pp = np.zeros((shape[1] + 1, shape[2] + 1), T)
                    Pp[1:, 1:] = P
                    p = Pp[1:, :-1] + Pp[:-1, 1:]
                    p = p + Qp[1:, 1:]
                    p = p - Pp[:-1, :-1]
                    p = p - Qp[1:, :-1]
                    p = p - Qp[:-1, 1:]
                    p = p + Qp[:-1, :-1]
                    P_new = np.where(km, kv, p + qx)
                    if np.array_equal(P_new, P):
                        break
                    P = P_new
                R[x] = P
                prev = P
            return R
        R = np.where(known_mask, known, np.zeros(shape, T))
        for _ in range(int(sum(shape)) + 4):
            p = _lorenzo_pred_np(R, rank, T)
            val = p + q_lor
            R_new = np.where(known_mask, known, val)
            if np.array_equal(R_new, R):
                break
            R = R_new
    return R


def _quant_point(cur, pred, rp, recip, capacity, radius, T):
    diff = T(cur - pred)
    itv = T(T(abs(diff)) * recip + T(1))
    if itv < capacity:
        if diff < 0:
            itv = -itv
        t = int(itv / T(2)) + radius
        rec = T(pred + T(2 * (t - radius)) * rp)
        if T(abs(T(cur - rec))) > rp:
            return 0, cur
        return t, rec
    return 0, cur


# ---------------------------------------------------------------------------
# Encode
# ---------------------------------------------------------------------------

def compress(data: np.ndarray, real_precision, *, max_range_radius: int,
             sample_distance: int, pred_threshold, opt_quant_mode: int = 1,
             fixed_intervals: int = 0, size_type: int = 8,
             oracle: bool = False) -> EncodeResult:
    """Host (numpy) encoder.  By default the point quantization runs the
    vectorized fixpoint (_encode_points_fast, ~100x the per-point Python
    loops); oracle=True forces the serial loop implementation the fast
    path and the device engine are tested against."""
    rank = data.ndim
    spec = _spec(rank, data.dtype)
    T = spec.T
    data = np.ascontiguousarray(data, dtype=T)
    flat = data.reshape(-1)
    rp = T(real_precision)
    recip = T(T(1) / rp)

    dbs = [B.dim_blocks(r, spec.block_size) for r in data.shape]
    num_blocks = int(np.prod([db.num for db in dbs]))

    use_mean = False
    mean = T(0)
    if opt_quant_mode == 1:
        if rank == 3:
            intervals, dense_pos, max_freq, mean_freq = \
                opt.optimize_intervals_3d_freq_dense(
                    flat, *data.shape, float(real_precision),
                    max_range_radius, sample_distance, pred_threshold, T=T)
        else:
            intervals, dense_pos, max_freq, mean_freq = \
                opt.optimize_intervals_2d_freq_dense(
                    flat, *data.shape, float(real_precision),
                    max_range_radius, sample_distance, pred_threshold, T=T)
        use_mean = bool(mean_freq > 0.5) or bool(mean_freq > max_freq)
    else:
        intervals = fixed_intervals
    quantization_intervals = intervals

    if rank == 2:
        use_mean = False  # forced (sz_float.c:5615, sz_double.c:4999)

    if use_mean:
        mask = np.abs(data - dense_pos) < rp
        vals = flat[np.flatnonzero(mask.reshape(-1))]
        if len(vals):
            s = opt.seq_sum(vals, T)
            mean = T(s / T(len(vals)))

    noise = T(np.float64(rp) * spec.noise_factor)
    coeffs = use_reg = None
    if not oracle:
        try:
            from sz_tpu import native
            coeffs, use_reg = native.regnd_prep(data, dbs, noise,
                                                use_mean, mean)
        except ImportError:  # pragma: no cover - native unavailable
            pass
    if coeffs is None:
        coeffs = compute_reg_coeffs(data, dbs, spec)
        use_reg = select_predictor(data, coeffs, dbs, spec, noise,
                                   use_mean, mean)
    ctypes, cunpred, qcoeffs, cprec = quantize_coeff_chain(
        coeffs, use_reg, rp, dbs, spec, use_mean)
    reg_count = int(use_reg.sum())

    if oracle:
        if rank == 3:
            result_type, unpred_arr = _encode_points_3d(
                data, dbs, spec, use_reg, qcoeffs, rp, recip, intervals,
                use_mean, mean)
        else:
            result_type, unpred_arr = _encode_points_2d(
                data, dbs, spec, use_reg, qcoeffs, rp, recip, intervals,
                use_mean, mean)
    else:
        try:
            from sz_tpu.native import regnd_encode
            result_type, unpred_arr = regnd_encode(
                data, dbs, use_reg, qcoeffs, rp, recip, intervals,
                use_mean, mean)
        except ImportError:  # pragma: no cover - native unavailable
            result_type, unpred_arr = _encode_points_fast(
                data, dbs, spec, use_reg, qcoeffs, rp, recip, intervals,
                use_mean, mean)

    return assemble_body(
        spec, rp, quantization_intervals, use_mean, mean, use_reg,
        ctypes, cunpred, cprec, result_type, unpred_arr, size_type)


def assemble_body(spec: _Spec, rp, quantization_intervals: int,
                  use_mean: bool, mean, use_reg, ctypes, cunpred, cprec,
                  result_type, unpred_arr, size_type: int,
                  freq=None, tables=None, encoded=None) -> EncodeResult:
    """Serialize the regression-codec body (sz_float.c:7392-7473) from
    already-computed streams.  Shared by the numpy oracle and the device
    engine (sz_tpu.tpu.engine), which produce identical intermediates.
    `freq` optionally supplies a precomputed type histogram; `tables` /
    `encoded` a prebuilt Huffman table and device-packed bitstream."""
    reg_count = int(np.count_nonzero(use_reg))
    total_unpred = len(unpred_arr)
    if tables is None:
        tables = huffman.build_tables(result_type,
                                      2 * quantization_intervals,
                                      freq=freq)
    if encoded is None:
        encoded = huffman.encode(tables, result_type)

    from sz_tpu.utils import stats as _stats
    n_points = len(result_type)
    n_blocks = len(use_reg)
    _stats.record(
        use_mean=bool(use_mean), block_size=spec.block_size,
        regression_blocks=reg_count,
        lorenzo_blocks=n_blocks - reg_count,
        regression_percent=reg_count / n_blocks if n_blocks else 0.0,
        lorenzo_percent=(n_blocks - reg_count) / n_blocks
        if n_blocks else 0.0,
        quantization_intervals=quantization_intervals,
        unpredict_count=total_unpred,
        unpredict_percent=total_unpred / n_points if n_points else 0.0,
        huffman_tree_size=len(tables.tree_bytes),
        huffman_coding_size=len(encoded),
        huffman_node_count=tables.node_count,
        huffman_avg_bits=len(encoded) * 8 / n_points if n_points else 0.0)

    out = bytearray()
    out += bu.i32_be(spec.block_size)
    out += _val_be(spec, rp)
    out += bu.i32_be(quantization_intervals)
    out += bu.i32_be(len(tables.tree_bytes))
    out += bu.i32_be(tables.node_count)
    out += tables.tree_bytes
    out += bytes([1 if use_mean else 0])
    out += _val_le(spec, mean)
    out += bu.pack_bits_1(~np.asarray(use_reg, dtype=bool))
    if reg_count > 0:
        for e in range(spec.ncoeff):
            ct = huffman.build_tables(ctypes[e], 2 * COEFF_CAPACITY)
            cenc = huffman.encode(ct, ctypes[e])
            out += _val_be(spec, cprec[e])
            out += bu.i32_be(COEFF_RADIUS)
            out += bu.i32_be(len(ct.tree_bytes))
            out += bu.i32_be(ct.node_count)
            out += ct.tree_bytes
            out += bu.size_be(len(cenc), size_type)
            out += cenc
            out += bu.i32_be(len(cunpred[e]))
            out += np.array(cunpred[e], dtype=spec.fmt_le).tobytes()
    out += struct.pack("<Q", total_unpred)
    out += unpred_arr.astype(spec.fmt_le).tobytes()
    out += encoded
    return EncodeResult(body=bytes(out),
                        quantization_intervals=quantization_intervals,
                        use_mean=use_mean, reg_count=reg_count,
                        total_unpred=total_unpred)


def _encode_points_3d(data, dbs, spec, use_reg, qcoeffs, rp, recip,
                      intervals, use_mean, mean):
    T = spec.T
    bx, by, bz = dbs
    r1, r2, r3 = data.shape
    cap = intervals
    radius = intervals // 2
    cap_sz = cap - 2
    result_type = np.zeros(r1 * r2 * r3, dtype=np.int32)
    unpred_chunks = []
    strip = np.zeros((bx.early + 1, r2 + 1, r3 + 1), dtype=T)
    next_strip = np.zeros_like(strip)
    qn = 0
    for i in range(bx.num):
        cbx = bx.count(i)
        ox = bx.start(i)
        for j in range(by.num):
            cby = by.count(j)
            oy = by.start(j)
            tpos = ox * r2 * r3 + oy * cbx * r3
            for k in range(bz.num):
                cbz = bz.count(k)
                oz = bz.start(k)
                bidx = (i * by.num + j) * bz.num + k
                block = data[ox:ox + cbx, oy:oy + cby, oz:oz + cbz]
                btypes = np.zeros((cbx, cby, cbz), dtype=np.int32)
                bunpred = []
                if use_reg[bidx]:
                    lc = qcoeffs[qn]
                    qn += 1
                    for ii in range(cbx):
                        for jj in range(cby):
                            for kk in range(cbz):
                                cur = block[ii, jj, kk]
                                pred = T(lc[0] * T(ii) + lc[1] * T(jj)
                                         + lc[2] * T(kk) + lc[3])
                                t, rec = _quant_point(cur, pred, rp, recip,
                                                      cap, radius, T)
                                if t == 0:
                                    bunpred.append(cur)
                                btypes[ii, jj, kk] = t
                                if (jj == cby - 1) or (kk == cbz - 1):
                                    strip[ii + 1, oy + jj + 1,
                                          oz + kk + 1] = rec
                                if ii == cbx - 1:
                                    next_strip[0, oy + jj + 1,
                                               oz + kk + 1] = rec
                else:
                    for ii in range(cbx):
                        for jj in range(cby):
                            for kk in range(cbz):
                                cur = block[ii, jj, kk]
                                if use_mean and T(abs(T(cur - mean))) <= rp:
                                    t = radius
                                    rec = mean
                                else:
                                    sx = ii + 1
                                    sy = oy + jj + 1
                                    sz_ = oz + kk + 1
                                    p = strip[sx, sy, sz_ - 1] \
                                        + strip[sx, sy - 1, sz_]
                                    p = p + strip[sx - 1, sy, sz_]
                                    p = p - strip[sx, sy - 1, sz_ - 1]
                                    p = p - strip[sx - 1, sy, sz_ - 1]
                                    p = p - strip[sx - 1, sy - 1, sz_]
                                    p = p + strip[sx - 1, sy - 1, sz_ - 1]
                                    t, rec = _quant_point(cur, T(p), rp,
                                                          recip, cap_sz,
                                                          radius, T)
                                    if use_mean and t != 0 and t <= radius:
                                        t -= 1
                                if t == 0:
                                    bunpred.append(cur)
                                btypes[ii, jj, kk] = t
                                strip[ii + 1, oy + jj + 1, oz + kk + 1] = rec
                                if ii == cbx - 1:
                                    next_strip[0, oy + jj + 1,
                                               oz + kk + 1] = rec
                n = cbx * cby * cbz
                result_type[tpos:tpos + n] = btypes.reshape(-1)
                tpos += n
                if bunpred:
                    unpred_chunks.append(np.array(bunpred, dtype=T))
        strip, next_strip = next_strip, strip
    arr = (np.concatenate(unpred_chunks) if unpred_chunks
           else np.zeros(0, dtype=T))
    return result_type, arr


def _encode_points_2d(data, dbs, spec, use_reg, qcoeffs, rp, recip,
                      intervals, use_mean, mean):
    T = spec.T
    bx, by = dbs
    r1, r2 = data.shape
    cap = intervals
    radius = intervals // 2
    cap_sz = cap - 2
    result_type = np.zeros(r1 * r2, dtype=np.int32)
    unpred_chunks = []
    strip = np.zeros((bx.early + 1, r2 + 1), dtype=T)
    next_strip = np.zeros_like(strip)
    qn = 0
    for i in range(bx.num):
        cbx = bx.count(i)
        ox = bx.start(i)
        tpos = ox * r2
        for j in range(by.num):
            cby = by.count(j)
            oy = by.start(j)
            bidx = i * by.num + j
            block = data[ox:ox + cbx, oy:oy + cby]
            btypes = np.zeros((cbx, cby), dtype=np.int32)
            bunpred = []
            if use_reg[bidx]:
                lc = qcoeffs[qn]
                qn += 1
                for ii in range(cbx):
                    for jj in range(cby):
                        cur = block[ii, jj]
                        pred = T(lc[0] * T(ii) + lc[1] * T(jj) + lc[2])
                        t, rec = _quant_point(cur, pred, rp, recip, cap,
                                              radius, T)
                        if t == 0:
                            bunpred.append(cur)
                        btypes[ii, jj] = t
                        if jj == cby - 1:
                            strip[ii + 1, oy + jj + 1] = rec
                        if ii == cbx - 1:
                            next_strip[0, oy + jj + 1] = rec
            else:
                for ii in range(cbx):
                    for jj in range(cby):
                        cur = block[ii, jj]
                        sx, sy = ii + 1, oy + jj + 1
                        p = strip[sx, sy - 1] + strip[sx - 1, sy] \
                            - strip[sx - 1, sy - 1]
                        t, rec = _quant_point(cur, T(p), rp, recip, cap_sz,
                                              radius, T)
                        if t == 0:
                            bunpred.append(cur)
                        btypes[ii, jj] = t
                        strip[ii + 1, oy + jj + 1] = rec
                        if ii == cbx - 1:
                            next_strip[0, oy + jj + 1] = rec
            n = cbx * cby
            result_type[tpos:tpos + n] = btypes.reshape(-1)
            tpos += n
            if bunpred:
                unpred_chunks.append(np.array(bunpred, dtype=T))
        strip, next_strip = next_strip, strip
    arr = (np.concatenate(unpred_chunks) if unpred_chunks
           else np.zeros(0, dtype=T))
    return result_type, arr


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ParsedBody:
    """Decoded regression-codec body streams, before point reconstruction.
    Shared between the numpy decoder below and the device decoder
    (sz_tpu.tpu.engine)."""

    spec: object
    dbs: list
    rp: object
    intervals: int
    use_mean: int
    mean: object
    indicator: np.ndarray  # 1 = Lorenzo, 0 = regression, per block
    qcoeffs: np.ndarray    # reconstructed coeffs, one row per reg block
    types: np.ndarray      # Huffman-decoded quantization codes, stream order
    unpred: np.ndarray     # escape values, stream order
    # raw_types mode (device-side Huffman decode): types is None and the
    # coded section + tree arrays are exposed instead
    tree: tuple = None     # (L, R, C, T, node_count)
    encoded: bytes = None  # the Huffman-coded type-array bytes


def decompress(body: bytes, shape, dtype, size_type: int = 8,
               oracle: bool = False) -> np.ndarray:
    p = parse_body(body, shape, dtype, size_type)
    if not oracle:
        try:
            from sz_tpu.native import regnd_decode
            return regnd_decode(p.types, tuple(shape), p.dbs,
                                p.indicator, p.qcoeffs, p.unpred,
                                p.intervals, p.rp, p.use_mean, p.mean,
                                p.spec.T)
        except ImportError:  # pragma: no cover - native unavailable
            pass
        return _decode_points_fast(tuple(shape), p.spec.T, p.dbs,
                                   p.indicator, p.qcoeffs, p.types,
                                   p.unpred, p.intervals, p.rp,
                                   p.use_mean, p.mean)
    if p.spec.rank == 3:
        return _decode_points_3d(shape, p.spec.T, p.dbs, p.indicator,
                                 p.qcoeffs, p.types, p.unpred, p.intervals,
                                 p.rp, p.use_mean, p.mean)
    return _decode_points_2d(shape, p.spec.T, p.dbs, p.indicator,
                             p.qcoeffs, p.types, p.unpred, p.intervals,
                             p.rp, p.use_mean, p.mean)


def parse_body(body: bytes, shape, dtype, size_type: int = 8,
               raw_types: bool = False) -> ParsedBody:
    """raw_types=True defers the Huffman type decode: ParsedBody.types
    is None and (tree, encoded) carry the coded section for a device-
    side decoder (sz_tpu.tpu.fsm_kernel)."""
    rank = len(shape)
    spec = _spec(rank, dtype)
    T = spec.T
    pos = 0
    block_size = bu.read_i32_be(body, pos)
    pos += 4
    if T is np.float32:
        rp = bu.read_f32_be(body, pos)
        pos += 4
    else:
        rp = bu.read_f64_be(body, pos)
        pos += 8
    intervals = bu.read_i32_be(body, pos)
    pos += 4
    tree_size = bu.read_i32_be(body, pos)
    pos += 4
    node_count = bu.read_i32_be(body, pos)
    pos += 4
    L, R, C, Tt = huffman.deserialize_tree(body[pos:pos + tree_size],
                                           node_count)
    pos += tree_size
    use_mean = body[pos]
    pos += 1
    if T is np.float32:
        mean = bu.read_f32_le(body, pos)
        pos += 4
    else:
        mean = bu.read_f64_le(body, pos)
        pos += 8

    dbs = [B.dim_blocks(r, block_size) for r in shape]
    num_blocks = int(np.prod([db.num for db in dbs]))
    ind_len = (num_blocks - 1) // 8 + 1
    indicator = bu.unpack_bits_1(body[pos:pos + ind_len], num_blocks)
    pos += ind_len
    reg_count = int(np.count_nonzero(indicator == 0))

    nc = spec.ncoeff
    coeff_types = np.zeros((nc, max(reg_count, 1)), dtype=np.int32)
    coeff_unpred = [np.zeros(0, dtype=T)] * nc
    cprec = np.zeros(nc, dtype=T)
    cradius = np.zeros(nc, dtype=np.int64)
    if reg_count > 0:
        for e in range(nc):
            if T is np.float32:
                cprec[e] = bu.read_f32_be(body, pos)
                pos += 4
            else:
                cprec[e] = bu.read_f64_be(body, pos)
                pos += 8
            cradius[e] = bu.read_i32_be(body, pos)
            pos += 4
            tsz = bu.read_i32_be(body, pos)
            pos += 4
            ncnt = bu.read_i32_be(body, pos)
            pos += 4
            cL, cR, cC, cT = huffman.deserialize_tree(body[pos:pos + tsz],
                                                      ncnt)
            pos += tsz
            tasz = bu.read_size_be(body, pos, size_type)
            pos += size_type
            coeff_types[e] = huffman.decode(cL, cR, cC, cT,
                                            body[pos:pos + tasz], reg_count)
            pos += tasz
            ucnt = bu.read_i32_be(body, pos)
            pos += 4
            coeff_unpred[e] = np.frombuffer(body, dtype=spec.fmt_le,
                                            count=ucnt, offset=pos).copy()
            pos += spec.esize * ucnt

    total_unpred = struct.unpack_from("<Q", body, pos)[0]
    pos += 8
    unpred = np.frombuffer(body, dtype=spec.fmt_le, count=total_unpred,
                           offset=pos)
    pos += spec.esize * total_unpred
    num_elements = int(np.prod(shape))
    tree = encoded = None
    if raw_types:
        types = None
        tree = (L, R, C, Tt, node_count)
        encoded = body[pos:]
    else:
        types = huffman.decode(L, R, C, Tt, body[pos:], num_elements)

    try:
        from sz_tpu.native import coeff_chain_decode
        qcoeffs = coeff_chain_decode(coeff_types[:, :reg_count]
                                     if reg_count else coeff_types[:, :0],
                                     cprec, cradius, coeff_unpred, T)
    except ImportError:  # pragma: no cover - native unavailable
        qcoeffs = np.zeros((reg_count, nc), dtype=T)
        cu_cnt = [0] * nc
        last = [T(0)] * nc
        for n in range(reg_count):
            for e in range(nc):
                t = int(coeff_types[e, n])
                if t != 0:
                    last[e] = T(last[e]
                                + T(2 * (t - cradius[e])) * cprec[e])
                else:
                    last[e] = coeff_unpred[e][cu_cnt[e]]
                    cu_cnt[e] += 1
                qcoeffs[n, e] = last[e]

    return ParsedBody(spec=spec, dbs=dbs, rp=rp, intervals=intervals,
                      use_mean=use_mean, mean=mean, indicator=indicator,
                      qcoeffs=qcoeffs, types=types, unpred=unpred,
                      tree=tree, encoded=encoded)


def _decode_points_3d(shape, T, dbs, indicator, qcoeffs, types, unpred,
                      intervals, rp, use_mean, mean):
    r1, r2, r3 = shape
    bx, by, bz = dbs
    out = np.zeros((r1, r2, r3), dtype=T)
    radius = intervals // 2
    tpos = upos = qn = blk = 0
    for i in range(bx.num):
        cbx = bx.count(i)
        ox = bx.start(i)
        for j in range(by.num):
            cby = by.count(j)
            oy = by.start(j)
            for k in range(bz.num):
                cbz = bz.count(k)
                oz = bz.start(k)
                n = cbx * cby * cbz
                btypes = types[tpos:tpos + n].reshape(cbx, cby, cbz)
                tpos += n
                if indicator[blk]:
                    for ii in range(cbx):
                        for jj in range(cby):
                            for kk in range(cbz):
                                t = int(btypes[ii, jj, kk])
                                x, y, z = ox + ii, oy + jj, oz + kk
                                if use_mean and t == radius:
                                    out[x, y, z] = mean
                                elif t == 0:
                                    out[x, y, z] = unpred[upos]
                                    upos += 1
                                else:
                                    d110 = out[x, y, z - 1] if z else T(0)
                                    d101 = out[x, y - 1, z] if y else T(0)
                                    d011 = out[x - 1, y, z] if x else T(0)
                                    d100 = out[x, y - 1, z - 1] \
                                        if (y and z) else T(0)
                                    d010 = out[x - 1, y, z - 1] \
                                        if (x and z) else T(0)
                                    d001 = out[x - 1, y - 1, z] \
                                        if (x and y) else T(0)
                                    d000 = out[x - 1, y - 1, z - 1] \
                                        if (x and y and z) else T(0)
                                    if use_mean and t < radius:
                                        t += 1
                                    p = d110 + d101
                                    p = p + d011
                                    p = p - d100
                                    p = p - d010
                                    p = p - d001
                                    p = p + d000
                                    out[x, y, z] = T(
                                        p + T(2 * (t - radius)) * rp)
                else:
                    lc = qcoeffs[qn]
                    qn += 1
                    for ii in range(cbx):
                        for jj in range(cby):
                            for kk in range(cbz):
                                t = int(btypes[ii, jj, kk])
                                x, y, z = ox + ii, oy + jj, oz + kk
                                if t != 0:
                                    pred = T(lc[0] * T(ii) + lc[1] * T(jj)
                                             + lc[2] * T(kk) + lc[3])
                                    out[x, y, z] = T(
                                        pred + T(2 * (t - radius)) * rp)
                                else:
                                    out[x, y, z] = unpred[upos]
                                    upos += 1
                blk += 1
    return out


def _decode_points_2d(shape, T, dbs, indicator, qcoeffs, types, unpred,
                      intervals, rp, use_mean, mean):
    r1, r2 = shape
    bx, by = dbs
    out = np.zeros((r1, r2), dtype=T)
    radius = intervals // 2
    tpos = upos = qn = blk = 0
    for i in range(bx.num):
        cbx = bx.count(i)
        ox = bx.start(i)
        for j in range(by.num):
            cby = by.count(j)
            oy = by.start(j)
            n = cbx * cby
            btypes = types[tpos:tpos + n].reshape(cbx, cby)
            tpos += n
            if indicator[blk]:
                for ii in range(cbx):
                    for jj in range(cby):
                        t = int(btypes[ii, jj])
                        x, y = ox + ii, oy + jj
                        if use_mean and t == radius:
                            out[x, y] = mean
                        elif t == 0:
                            out[x, y] = unpred[upos]
                            upos += 1
                        else:
                            d10 = out[x, y - 1] if y else T(0)
                            d01 = out[x - 1, y] if x else T(0)
                            d00 = out[x - 1, y - 1] if (x and y) else T(0)
                            if use_mean and t < radius:
                                t += 1
                            p = d10 + d01 - d00
                            out[x, y] = T(p + T(2 * (t - radius)) * rp)
            else:
                lc = qcoeffs[qn]
                qn += 1
                for ii in range(cbx):
                    for jj in range(cby):
                        t = int(btypes[ii, jj])
                        x, y = ox + ii, oy + jj
                        if t != 0:
                            pred = T(lc[0] * T(ii) + lc[1] * T(jj) + lc[2])
                            out[x, y] = T(pred + T(2 * (t - radius)) * rp)
                        else:
                            out[x, y] = unpred[upos]
                            upos += 1
            blk += 1
    return out
