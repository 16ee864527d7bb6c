"""Device engine for the MSST19 multiplicative PW_REL codec.

Device analog of sz_tpu/core/pwr.py's accelerated pipeline (the oracle
for SZ_compress_float_{1,2,3}D_MDQ_MSST19, sz_float.c:1824+, selected
by sz_float.c:2890 when accelerate_pw_rel_compression and
maxRangeRadius <= 32768) — identical bytes to the host kernels:

- the default path is a single-pass anti-diagonal WAVEFRONT (one
  lax.scan over s = i+j+k diagonal slices, gather-free shear-by-
  reshape layout): the MULTIPLICATIVE Lorenzo predictors (A*B/D
  in-plane, the 7-factor A*B*C*G/(D*E*F) across planes) evaluate
  through the same float64 temp chains as the C kernels
  (`double temp, temp2`), each point computed once in dependency
  order, so parity is by construction (the plane-sweep FIXPOINT
  fallback, SZ_TPU_MSST19_WF=0, converges only at the induction bound
  ~r2+r3 sweeps for a multiplicative predictor — a product preserves
  low-bit seed perturbations that the additive codecs' sums absorb);
- the MultiLevelCacheTableWideInterval state lookup
  (MultiLevelCacheTable.c:47-186) keys on the EXPONENT+TRUNCATED-
  MANTISSA bits of the float64 prediction ratio.  The ratio is an
  exactly-widened float32, so the f64 bit fields are derived from the
  f32 bits (exponent rebias +896, mantissa << 29), including the
  subnormal-float32 and inf/NaN cases — verified bit-identical to the
  host lookup;
- reconstruction |pred| * precision_table[state] runs in the backend's
  IEEE f64.  Parity with the host encoder holds when the backend
  rounds every op separately (no FMA contraction, no skipped f32
  rounding; see engine._strict_jit) and divides f32 operands
  exactly (`_div_exact`).  A diverged stream is NOT self-correcting: the
  decoder replays the chain in f64, and the multiplicative A*B/D
  predictor can amplify a 1-ulp seed without bound.  pwr.compress_
  msst19 therefore VERIFIES device-encoded streams whose parity the
  backend does not guarantee (host decode + point-wise bound check,
  `verify_conformant`) and re-encodes on the host when the check fails
  ("host_fallback.msst19" counter); DEVICE_MAX_POINTS caps device
  routing;
- layer-0 row 0 (escape, prev-value, then the amplifying A*A/A2
  predictor) is solved by a short serial lax.scan and pinned, exactly
  like the classic engine's 2a-b row;
- epilogue (raster types, histogram, escape extraction, Huffman
  bit-pack, device decode) reuses the shared engine machinery.
"""

from __future__ import annotations

import functools

import numpy as np

from sz_tpu.config import DataType
from sz_tpu.core import classic
from sz_tpu.format import bytes_util as bu
from sz_tpu.format import huffman
from sz_tpu.format.tdps import TDPS
from sz_tpu.tpu import classic_engine as ce
from sz_tpu.tpu import engine as eng
from sz_tpu.utils import trace as _tr

jax = eng.jax
jnp = eng.jnp

ESC_K = eng.ESC_K


def _vshape(shape: tuple) -> tuple:
    """2D runs as a single layer-0 plane (the 2D kernel's rules are the
    3D layer-0 rules); 3D is a plane stack."""
    if len(shape) == 2:
        return (1,) + tuple(shape)
    return tuple(shape)


def _div_exact(a, b, T):
    """IEEE-correct division in dtype T: f32 operands divide in f64
    and round once to f32, which equals the correctly-rounded f32
    quotient.  The C contract is a plain float division (sz_float.c
    MSST19 `float ratio = cur / pred`); XLA:GPU's native f32 divide is
    not correctly rounded (1.19M of 2^22 quotients differ on an H100).
    Both f64 operands are doubled first (exact): LLVM narrows
    trunc(ext(a) / ext(b)) back to an f32 divide, and a product is not
    an extension it can see through.  f64 data divides natively."""
    if T == jnp.float32:
        return ((a.astype(jnp.float64) * 2)
                / (b.astype(jnp.float64) * 2)).astype(T)
    return a / b


def _esc_recon_raw_dev(data, req_length):
    """Raw-mode escape reconstruction (MSST19 ExactEncoder: binary
    truncation with NO median offset — classic_nd._esc_recon_vec with
    enc.raw)."""
    T = data.dtype
    if T == jnp.float32:
        ubits, width = jnp.uint32, 32
    else:
        ubits, width = jnp.uint64, 64
    ign = jnp.maximum(width - req_length, 0).astype(ubits)
    mask = ~((ubits(1) << ign) - ubits(1))
    bits = jax.lax.bitcast_convert_type(data, ubits) & mask
    return jax.lax.bitcast_convert_type(bits, T)


def _key_f32(ratio, base_index: int, top_index: int, bits: int):
    """Combined cache-table key (rel*size + manti, with the in-range
    mask) for float32 ratios: the host keys on the bits of
    float64(ratio); a float32 widens exactly, so expo64 = e32 + 896
    (normal), 2047 (inf/NaN), 874 + highbit(m32) (subnormal), and
    mantissa52 = m32 << 29 (normal/inf/NaN) or the renormalized
    fraction (subnormal).  Sign is masked like the C."""
    size = 1 << bits
    b = jax.lax.bitcast_convert_type(ratio, jnp.uint32) \
        & jnp.uint32(0x7FFFFFFF)
    e32 = (b >> jnp.uint32(23)).astype(jnp.int32)
    m32 = (b & jnp.uint32(0x7FFFFF)).astype(jnp.int32)
    # highest set bit of m32 via exact float conversion (m32 < 2^23)
    fhb = jax.lax.bitcast_convert_type(m32.astype(jnp.float32),
                                       jnp.uint32)
    hb = ((fhb >> jnp.uint32(23)) & jnp.uint32(0xFF)).astype(jnp.int32) \
        - 127
    is_sub = (e32 == 0) & (m32 != 0)
    expo = jnp.where(e32 == 255, 2047,
                     jnp.where(e32 > 0, e32 + 896,
                               jnp.where(is_sub, 874 + hb, 0)))
    # normal mantissa slice: top `bits` of (m32 << 29) in 52
    if bits <= 23:
        man_n = m32 >> (23 - bits)
    else:  # pragma: no cover - bits > 23 never happens for pw >= 1e-5
        man_n = m32 << (bits - 23)
    # subnormal: value = m32 * 2^-149; mant52 = (m32 - 2^hb) << (52-hb)
    frac = m32 - jnp.left_shift(jnp.int32(1), jnp.maximum(hb, 0))
    d = hb - bits
    man_s = jnp.where(d >= 0,
                      jnp.right_shift(frac, jnp.maximum(d, 0)),
                      jnp.left_shift(frac, jnp.maximum(-d, 0)))
    manti = jnp.where(is_sub, man_s, man_n)
    rel = expo - base_index
    ok = (rel >= 0) & (rel <= top_index - base_index)
    return rel * size + manti, ok


def _key_f64(ratio, base_index: int, top_index: int, bits: int):
    """Combined key for float64 ratios (CPU backend / float64 data)."""
    size = 1 << bits
    b = jax.lax.bitcast_convert_type(ratio.astype(jnp.float64),
                                     jnp.uint64) \
        & jnp.uint64(0x7FFFFFFFFFFFFFFF)
    expo = (b >> jnp.uint64(52)).astype(jnp.int32)
    manti = ((b & jnp.uint64(0x000FFFFFFFFFFFFF))
             >> jnp.uint64(52 - bits)).astype(jnp.int32)
    rel = expo - base_index
    ok = (rel >= 0) & (rel <= top_index - base_index)
    return rel * size + manti, ok


def _lookup_f32(ratio, table_flat, base_index: int, top_index: int,
                bits: int):
    key, ok = _key_f32(ratio, base_index, top_index, bits)
    idx = jnp.clip(key, 0, table_flat.shape[0] - 1)
    st = jnp.take(table_flat, idx).astype(jnp.int32)
    return jnp.where(ok, st, 0)


def _lookup_f64(ratio, table_flat, base_index: int, top_index: int,
                bits: int):
    key, ok = _key_f64(ratio, base_index, top_index, bits)
    idx = jnp.clip(key, 0, table_flat.shape[0] - 1)
    st = jnp.take(table_flat, idx).astype(jnp.int32)
    return jnp.where(ok, st, 0)


# ---------------------------------------------------------------------------
# Gather-free table lookups for the wavefront hot loop.
#
# The two per-step lookups (cache table + precision table) are the
# wavefront scan's per-point gathers.  Both tables have exploitable structure:
# the cache table is always two MONOTONE STAIRSTEP rows (validated at
# build), so state = count(boundaries <= key) — a fused compare-
# reduction; and the precision values select by a one-hot compare-sum
# of the table's exact (hi, lo) float32 split, whose emulated-f64
# recombination hi + lo is bit-identical to take(ptable_f64, st).
# ---------------------------------------------------------------------------

STAIR_MAX_STATES = 4096   # compare-reduction cost is O(states)/point


@functools.lru_cache(maxsize=16)
def _stair_pack(intervals: int, ratio: float, plus_bits: int):
    """(boundaries i32, lo_key, hi_key, pt_hi f32, pt_lo f32) for the
    compare-reduction lookup, or None when the table is outside the
    stairstep envelope (validated by exact reconstruction) or has more
    than STAIR_MAX_STATES states (the XLA compare-reduction is
    O(states)/point)."""
    from sz_tpu.core import pwr

    if 2 * intervals > STAIR_MAX_STATES:
        return None
    cache = pwr._cache_table(int(intervals), float(ratio),
                             int(plus_bits))
    table = np.ascontiguousarray(cache.table).reshape(-1).astype(
        np.int64)
    nz = np.flatnonzero(table)
    if len(nz) == 0:
        return None
    lo_key, hi_key = int(nz[0]), int(nz[-1])
    seg = table[lo_key:hi_key + 1]
    if (seg == 0).any() or (np.diff(seg) < 0).any():
        return None
    max_state = int(seg[-1])
    # boundaries[i] = first key with state > i+0  (i = 0..max_state-1)
    bounds = lo_key + np.searchsorted(seg, np.arange(1, max_state + 1),
                                      side="left")
    # exact reconstruction check
    keys = np.arange(len(table))
    recon = (keys[:, None] >= bounds[None, :]).sum(1)
    recon[(keys < lo_key) | (keys > hi_key)] = 0
    if not np.array_equal(recon, table):
        return None  # pragma: no cover - non-stairstep table
    ptable = pwr._precision_table(int(intervals), float(ratio),
                                  int(plus_bits))
    pt_hi = ptable.astype(np.float32)
    pt_lo = (ptable - pt_hi).astype(np.float32)
    # pt_exact: the (hi, lo) split reconstructs ptable bit-exactly in
    # f64.  A value needing > 2x24 significand bits would silently
    # diverge — callers must keep the gather path unless exact.
    pt_exact = bool(np.all(pt_hi.astype(np.float64)
                           + pt_lo.astype(np.float64) == ptable))
    return (bounds.astype(np.int32), lo_key, hi_key, pt_hi, pt_lo,
            pt_exact)


def _stair_state(key, ok, bounds, lo_key: int, hi_key: int):
    """state = count(boundaries <= key): a broadcast compare + sum
    that XLA fuses into a reduction (no gather, no materialized
    one-hot)."""
    inside = ok & (key >= lo_key) & (key <= hi_key)
    st = jnp.sum((key[..., None] >= bounds).astype(jnp.int32), axis=-1)
    return jnp.where(inside, st, 0)


def _pt_select(st, pt_hi, pt_lo):
    """f64 precision value for each state via one-hot compare-sums of
    the (hi, lo) float32 split — bit-identical to jnp.take(ptable_f64,
    st) when the split is exact (_stair_pack's pt_exact)."""
    oh = st[..., None] == jnp.arange(pt_hi.shape[0], dtype=jnp.int32)
    hi = jnp.sum(jnp.where(oh, pt_hi, jnp.float32(0)), axis=-1)
    lo = jnp.sum(jnp.where(oh, pt_lo, jnp.float32(0)), axis=-1)
    return hi.astype(jnp.float64) + lo.astype(jnp.float64)


@functools.lru_cache(maxsize=32)
def _pins_fn(r3: int, dtype_str: str, dbl: bool, bits: int,
             base_index: int, top_index: int, backend: str = "cpu"):
    """Layer-0 first row: escape, prev, A*A/A2 (amplifying -> pinned;
    sz_float.c MSST19 row-0 loop).  (row data, row esc-recon, tables)
    -> (pin_t, pin_rec)."""
    D = jnp.float64

    def f(row_d, row_er, table_flat, ptable):
        T = row_d.dtype
        lookup = _lookup_f32 if T == jnp.float32 else _lookup_f64

        def quant(d, pred, erx):
            ratio = _div_exact(d, pred, T)
            st = lookup(ratio, table_flat, base_index, top_index, bits)
            rec = (jnp.abs(pred.astype(D))
                   * jnp.take(ptable, st)).astype(T)
            return st, jnp.where(st == 0, erx, rec)

        def row_step(carry, xs):
            pm1, pm2, j = carry
            cur, erx = xs
            if dbl:
                lin = (pm1.astype(D) * pm1 / pm2).astype(T)
            else:
                lin = _div_exact((pm1 * pm1).astype(T), pm2, T)
            pred = jnp.where(j == 1, pm1, lin)
            t, rec = quant(cur, pred, erx)
            t = jnp.where(j == 0, 0, t)
            rec = jnp.where(t == 0, erx, rec)
            return (rec, pm1, j + 1), (t, rec)

        z = jnp.asarray(0, T)
        _, (pin_t, pin_rec) = jax.lax.scan(
            row_step, (z, z, jnp.asarray(0, jnp.int32)),
            (row_d, row_er))
        return pin_t, pin_rec

    return eng._strict_jit(f, backend)


@functools.lru_cache(maxsize=32)
def _encode_chunk_fn(G: int, r2: int, r3: int, dtype_str: str,
                     dbl: bool, bits: int, base_index: int,
                     top_index: int, backend: str = "cpu"):
    """One plane-chunk of the MSST19 encode fixpoint: (data chunk,
    tables, req_length, previous reconstructed plane, pinned row,
    chunk base plane index) -> (int32 type chunk, last reconstructed
    plane, max sweeps)."""
    plane_iter = r2 + r3 + 4
    row0 = (jnp.arange(r2) == 0)[:, None]
    col0 = (jnp.arange(r3) == 0)[None, :]
    D = jnp.float64

    def f(data, table_flat, ptable, req_length, prev0, pin_t, pin_rec,
          base):
        T = data.dtype
        lookup = _lookup_f32 if T == jnp.float32 else _lookup_f64
        er = _esc_recon_raw_dev(data, req_length)

        def quant(d, pred, erx):
            ratio = _div_exact(d, pred, T)
            st = lookup(ratio, table_flat, base_index, top_index, bits)
            rec = (jnp.abs(pred.astype(D))
                   * jnp.take(ptable, st)).astype(T)
            return st, jnp.where(st == 0, erx, rec)

        first_flags = base + jnp.arange(G, dtype=jnp.int32) == 0

        def pred_first(P, prev):
            # layer-0 plane: in-plane 3-point multiplicative Lorenzo
            # (row 0 pinned by the caller; col0 takes the above value)
            Pp = jnp.pad(P, ((1, 0), (1, 0)))
            A = Pp[1:, :-1]
            B = Pp[:-1, 1:]
            Dg = Pp[:-1, :-1]
            if dbl:
                p2 = (A.astype(D) * B / Dg).astype(T)
            else:
                p2 = _div_exact((A * B).astype(T), Dg, T)
            return jnp.where(col0, B, p2)

        def pred_rest(P, prev):
            # the f64-emulated division chains dominate sweep cost
            # (~1000 f32 ops each after emulation): the row-0 and
            # col-0 predictors only ever contribute one line, so they
            # compute on (1, r3)/(r2, 1) SLICES; only the 7-factor p3
            # runs at plane size.  Same op sequence per point as the C
            # kernels — the where-assembly keeps bit parity.
            Pp = jnp.pad(P, ((1, 0), (1, 0)))
            A = Pp[1:, :-1]
            B = Pp[:-1, 1:]
            Dg = Pp[:-1, :-1]
            Qp = jnp.pad(prev, ((1, 0), (1, 0)))
            C = Qp[1:, 1:]
            E = Qp[:-1, 1:]
            F = Qp[1:, :-1]
            G_ = Qp[:-1, :-1]
            rw = (A[:1].astype(D) * C[:1] / F[:1]).astype(T)
            cl = (B[:, :1].astype(D) * C[:, :1] / E[:, :1]).astype(T)
            p3 = ((A.astype(D) * B * C * G_)
                  / (Dg.astype(D) * E * F)).astype(T)
            return jnp.where(row0 & col0, C,
                             jnp.where(row0, rw,
                                       jnp.where(col0, cl, p3)))

        def plane(prev, xs):
            d, erx, first = xs
            pinm = first & row0

            def pstep(P):
                pred = jax.lax.cond(first, pred_first, pred_rest,
                                    P, prev)
                t, rec = quant(d, pred, erx)
                t = jnp.where(pinm, pin_t[None, :], t)
                rec = jnp.where(pinm, pin_rec[None, :], rec)
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

        last, (t, its) = jax.lax.scan(
            plane, prev0, (data, er, first_flags))
        return t, last, jnp.max(its)

    return eng._strict_jit(f, backend)


# ---------------------------------------------------------------------------
# Anti-diagonal WAVEFRONT engines (the default device path).
#
# The plane-sweep fixpoint above converges only at the induction bound
# for the MULTIPLICATIVE predictor (~r2+r3 sweeps measured vs ~15 for
# the additive codecs): rec = pred * precisionTable[state] preserves
# low-bit perturbations of pred (a product), where the additive
# rec = pred + 2eb*k absorbs them (a sum), so seed wiggles propagate
# the full dependency depth.  Iteration is therefore the wrong shape:
# the wavefront computes every point ONCE in dependency order — one
# lax.scan over anti-diagonal slices (s = i+j+k), each step a
# vectorized (r2, r3) slice in (j, k) coordinates — bit-exact by
# construction.  The lattice <-> diagonal-slice layout is the
# gather-free SHEAR-BY-RESHAPE: shifting axis 0 by the index of
# another axis is one pad + flatten + truncate + reshape.
# ---------------------------------------------------------------------------


def _shear0_by(x, ax: int):
    """Y with axis0 index i replaced by i + idx(ax); axis0 grows to
    n0 + n_ax - 1.  Pure pad/reshape/transpose."""
    x = jnp.moveaxis(x, ax, 0)               # (q, n0, rest...)
    q, n0 = x.shape[0], x.shape[1]
    rest = x.shape[2:]
    W = n0 + q
    xp = jnp.concatenate(
        [x, jnp.zeros((q, W - n0) + rest, x.dtype)], axis=1)
    flat = xp.reshape((q * W,) + rest)
    y = flat[: q * (W - 1)].reshape((q, W - 1) + rest)
    y = jnp.moveaxis(y, 1, 0)                # (n0+q-1, q, rest)
    return jnp.moveaxis(y, 1, ax)


def _unshear0_by(y, ax: int, n0: int):
    """Inverse of _shear0_by."""
    y = jnp.moveaxis(y, ax, 0)               # (q, S, rest...)
    q, S = y.shape[0], y.shape[1]
    rest = y.shape[2:]
    flat = y.reshape((q * S,) + rest)
    flat = jnp.concatenate(
        [flat, jnp.zeros((q,) + rest, y.dtype)], axis=0)
    x = flat.reshape((q, S + 1) + rest)[:, :n0]
    x = jnp.moveaxis(x, 1, 0)
    return jnp.moveaxis(x, 1, ax)


def _shear3(x):
    """(r1,r2,r3) lattice -> (r1+r2+r3-2, r2, r3) diagonal slices:
    out[i+j+k, j, k] = x[i, j, k] (zeros elsewhere)."""
    return _shear0_by(_shear0_by(x, 1), 2)


def _unshear3(y, r1: int, r2: int, r3: int):
    return _unshear0_by(_unshear0_by(y, 2, r1 + r2 - 1), 1, r1)


def _shiftk(x):
    return jnp.pad(x, ((0, 0), (1, 0)))[:, :-1]


def _shiftj(x):
    return jnp.pad(x, ((1, 0), (0, 0)))[:-1, :]


def _shiftjk(x):
    return jnp.pad(x, ((1, 0), (1, 0)))[:-1, :-1]


@functools.lru_cache(maxsize=32)
def _wf2_encode_fn(r2: int, r3: int, dtype_str: str, dbl: bool,
                   bits: int, base_index: int, top_index: int,
                   backend: str = "cpu", stair_lo: int = -1,
                   stair_hi: int = -1):
    """Layer-0 plane by 2-D wavefront: (sheared data lines, sheared
    esc-recon lines, tables, pins) -> (t lines, rec lines), each
    (r2+r3-1, r3) in k-coordinates (j = d - k).  tabs is
    (table_flat, ptable) or, when stair_lo >= 0, the gather-free
    (bounds, pt_hi, pt_lo) pack."""
    S2 = r2 + r3 - 1
    kk = jnp.arange(r3)
    D = jnp.float64
    stair = stair_lo >= 0

    def f(d_lines, er_lines, tabs, pin_t, pin_rec):
        T = d_lines.dtype
        keyf = _key_f32 if T == jnp.float32 else _key_f64

        def quant_st(ratio):
            key, okk = keyf(ratio, base_index, top_index, bits)
            if stair:
                st = _stair_state(key, okk, tabs[0], stair_lo,
                                  stair_hi)
                return st, _pt_select(st, tabs[1], tabs[2])
            idx = jnp.clip(key, 0, tabs[0].shape[0] - 1)
            st = jnp.where(okk, jnp.take(tabs[0], idx).astype(
                jnp.int32), 0)
            return st, jnp.take(tabs[1], st)

        def step(carry, xs):
            p1, p2l, d_idx = carry
            dl, erl = xs
            jrow = d_idx - kk
            valid = (jrow >= 0) & (jrow < r2)
            A = jnp.pad(p1, (1, 0))[:-1]          # P[j, k-1]
            B = p1                                # P[j-1, k]
            Dg = jnp.pad(p2l, (1, 0))[:-1]        # P[j-1, k-1]
            if dbl:
                p2v = (A.astype(D) * B / Dg).astype(T)
            else:
                p2v = _div_exact((A * B).astype(T), Dg, T)
            pred = jnp.where(kk == 0, B, p2v)
            ratio = _div_exact(dl, pred, T)
            st, ptv = quant_st(ratio)
            rec = (jnp.abs(pred.astype(D)) * ptv).astype(T)
            rec = jnp.where(st == 0, erl, rec)
            # row 0 of the plane (j==0 <=> k==d): pinned
            pin_mask = kk == d_idx
            st = jnp.where(pin_mask, pin_t, st)
            rec = jnp.where(pin_mask, pin_rec, rec)
            st = jnp.where(valid, st, 0)
            rec = jnp.where(valid, rec, jnp.asarray(0, T))
            return (rec, p1, d_idx + 1), (st, rec)

        z = jnp.zeros((r3,), T)
        _, (t_lines, rec_lines) = jax.lax.scan(
            step, (z, z, jnp.asarray(0, jnp.int32)),
            (d_lines[:S2], er_lines[:S2]))
        return t_lines, rec_lines

    return eng._strict_jit(f, backend)


@functools.lru_cache(maxsize=32)
def _wf3_encode_fn(G: int, r1: int, r2: int, r3: int, dtype_str: str,
                   bits: int, base_index: int, top_index: int,
                   backend: str = "cpu", stair_lo: int = -1,
                   stair_hi: int = -1):
    """G steps of the 3-D encode wavefront: (sheared data/esc slices, plane-0
    t/rec lines, tables, carries, s base) -> (t slices, carries).
    tabs: (table_flat, ptable), or the gather-free stairstep pack
    (bounds, pt_hi, pt_lo) when stair_lo >= 0 (no per-step
    gathers)."""
    jk = (jnp.arange(r2)[:, None] + jnp.arange(r3)[None, :]).astype(
        jnp.int32)
    row0 = (jnp.arange(r2) == 0)[:, None]
    col0 = (jnp.arange(r3) == 0)[None, :]
    D = jnp.float64
    stair = stair_lo >= 0

    def f(d_sl, er_sl, p0t, p0rec, tabs, c1, c2, c3,
          base):
        T = d_sl.dtype
        keyf = _key_f32 if T == jnp.float32 else _key_f64

        def quant_st(ratio):
            key, okk = keyf(ratio, base_index, top_index, bits)
            if stair:
                st = _stair_state(key, okk, tabs[0], stair_lo,
                                  stair_hi)
                return st, _pt_select(st, tabs[1], tabs[2])
            idx = jnp.clip(key, 0, tabs[0].shape[0] - 1)
            st = jnp.where(okk, jnp.take(tabs[0], idx).astype(
                jnp.int32), 0)
            return st, jnp.take(tabs[1], st)

        def step(carry, xs):
            c1, c2, c3, s = carry
            dl, erl, p0t_l, p0rec_l = xs
            i_idx = s - jk
            valid = (i_idx >= 0) & (i_idx < r1)
            plane0 = valid & (i_idx == 0)
            A = _shiftk(c1)        # P[i, j, k-1]
            Bv = _shiftj(c1)       # P[i, j-1, k]
            Dg = _shiftjk(c2)      # P[i, j-1, k-1]
            Cv = c1                # P[i-1, j, k]
            Ev = _shiftj(c2)       # P[i-1, j-1, k]
            Fv = _shiftk(c2)       # P[i-1, j, k-1]
            Gv = _shiftjk(c3)      # P[i-1, j-1, k-1]
            # interior predictors: row-0/col-0 chains on line slices,
            # only the 7-factor p3 at slice size (the f64-emulated
            # division chains dominate)
            rw = (A[:1].astype(D) * Cv[:1] / Fv[:1]).astype(T)
            cl = (Bv[:, :1].astype(D) * Cv[:, :1]
                  / Ev[:, :1]).astype(T)
            p3 = ((A.astype(D) * Bv * Cv * Gv)
                  / (Dg.astype(D) * Ev * Fv)).astype(T)
            pred = jnp.where(row0 & col0, Cv,
                             jnp.where(row0, rw,
                                       jnp.where(col0, cl, p3)))
            ratio = _div_exact(dl, pred, T)
            st, ptv = quant_st(ratio)
            rec = (jnp.abs(pred.astype(D)) * ptv).astype(T)
            rec = jnp.where(st == 0, erl, rec)
            # plane-0 points (one per k at j = s-k): inject the 2-D
            # wavefront's values via their k-line broadcast
            st = jnp.where(plane0, p0t_l[None, :], st)
            rec = jnp.where(plane0, p0rec_l[None, :], rec)
            st = jnp.where(valid, st, 0)
            rec = jnp.where(valid, rec, jnp.asarray(0, T))
            return (rec, c1, c2, s + 1), st

        (c1, c2, c3, _s), t_sl = jax.lax.scan(
            step, (c1, c2, c3, base), (d_sl, er_sl, p0t, p0rec))
        return t_sl, c1, c2, c3

    return eng._strict_jit(f, backend)


@functools.lru_cache(maxsize=32)
def _wf2_decode_fn(r2: int, r3: int, dtype_str: str, dbl: bool,
                   backend: str = "cpu"):
    """Layer-0 plane decode by 2-D wavefront: (km, kv, pt lines) ->
    rec lines (r2+r3-1, r3)."""
    S2 = r2 + r3 - 1
    kk = jnp.arange(r3)
    D = jnp.float64
    T = jnp.dtype(dtype_str)

    def f(km_l, kv_l, pt_l):
        def step(carry, xs):
            p1, p2l, d_idx = carry
            kml, kvl, ptl = xs
            jrow = d_idx - kk
            valid = (jrow >= 0) & (jrow < r2)
            A = jnp.pad(p1, (1, 0))[:-1]
            B = p1
            Dg = jnp.pad(p2l, (1, 0))[:-1]
            A2 = jnp.pad(p2l, (2, 0))[:-2]        # P[0, k-2]
            if dbl:
                lin = (A.astype(D) * A / A2).astype(T)
                p2v = (A.astype(D) * B / Dg).astype(T)
            else:
                lin = _div_exact((A * A).astype(T), A2, T)
                p2v = _div_exact((A * B).astype(T), Dg, T)
            # row0 of the plane: k==d (escape / prev / A*A/A2 rules)
            pin = kk == d_idx
            pred = jnp.where(pin & (kk == 1), A,
                             jnp.where(pin, lin,
                                       jnp.where(kk == 0, B, p2v)))
            v = (jnp.abs(pred.astype(D)) * ptl).astype(T)
            rec = jnp.where(kml, kvl, v)
            rec = jnp.where(valid, rec, jnp.asarray(0, T))
            return (rec, p1, d_idx + 1), rec

        z = jnp.zeros((r3,), T)
        _, rec_lines = jax.lax.scan(
            step, (z, z, jnp.asarray(0, jnp.int32)),
            (km_l[:S2], kv_l[:S2], pt_l[:S2]))
        return rec_lines

    return eng._strict_jit(f, backend)


@functools.lru_cache(maxsize=32)
def _wf3_decode_fn(G: int, r1: int, r2: int, r3: int, dtype_str: str,
                   backend: str = "cpu"):
    """G steps of the 3-D decode wavefront: (km/kv/pt slices, plane-0
    rec lines, carries, s base) -> (rec slices, carries)."""
    jk = (jnp.arange(r2)[:, None] + jnp.arange(r3)[None, :]).astype(
        jnp.int32)
    row0 = (jnp.arange(r2) == 0)[:, None]
    col0 = (jnp.arange(r3) == 0)[None, :]
    D = jnp.float64
    T = jnp.dtype(dtype_str)

    def f(km_sl, kv_sl, pt_sl, p0rec, c1, c2, c3, base):
        def step(carry, xs):
            c1, c2, c3, s = carry
            kml, kvl, ptl, p0rec_l = xs
            i_idx = s - jk
            valid = (i_idx >= 0) & (i_idx < r1)
            plane0 = valid & (i_idx == 0)
            A = _shiftk(c1)
            Bv = _shiftj(c1)
            Dg = _shiftjk(c2)
            Cv = c1
            Ev = _shiftj(c2)
            Fv = _shiftk(c2)
            Gv = _shiftjk(c3)
            rw = (A[:1].astype(D) * Cv[:1] / Fv[:1]).astype(T)
            cl = (Bv[:, :1].astype(D) * Cv[:, :1]
                  / Ev[:, :1]).astype(T)
            p3 = ((A.astype(D) * Bv * Cv * Gv)
                  / (Dg.astype(D) * Ev * Fv)).astype(T)
            pred = jnp.where(row0 & col0, Cv,
                             jnp.where(row0, rw,
                                       jnp.where(col0, cl, p3)))
            v = (jnp.abs(pred.astype(D)) * ptl).astype(T)
            rec = jnp.where(kml, kvl, v)
            rec = jnp.where(plane0, p0rec_l[None, :], rec)
            rec = jnp.where(valid, rec, jnp.asarray(0, T))
            return (rec, c1, c2, s + 1), rec

        (c1, c2, c3, _s), r_sl = jax.lax.scan(
            step, (c1, c2, c3, base), (km_sl, kv_sl, pt_sl, p0rec))
        return r_sl, c1, c2, c3

    return eng._strict_jit(f, backend)


def _wf_enabled() -> bool:
    return eng._os.environ.get("SZ_TPU_MSST19_WF", "1") != "0"


def _stair_enabled() -> bool:
    """SZ_TPU_MSST19_STAIR=0 keeps the per-step gather lookups in the
    wavefront scan (the stairstep compare-reduction is the default)."""
    return eng._os.environ.get("SZ_TPU_MSST19_STAIR", "1") != "0"


@functools.lru_cache(maxsize=8)
def _pad_lines_fn(S2: int, S: int, r3: int, dtype_str: str,
                  backend: str = "cpu"):
    def f(t_lines, rec_lines):
        pt = jnp.zeros((S - S2, r3), t_lines.dtype)
        pr = jnp.zeros((S - S2, r3), rec_lines.dtype)
        return (jnp.concatenate([t_lines, pt], 0),
                jnp.concatenate([rec_lines, pr], 0))

    return eng._strict_jit(f, backend)


def _stair_tabs(cache, stair, tbl_dev, pt_dev):
    """(stair_lo, stair_hi, device tabs) for the builder calls."""
    if stair is None:
        return -1, -1, (tbl_dev, pt_dev)
    bounds, lo_key, hi_key, pt_hi, pt_lo, _pt_exact = stair
    return lo_key, hi_key, (jax.device_put(bounds),
                            jax.device_put(pt_hi),
                            jax.device_put(pt_lo))


def _encode_device_wf(work_dev, vshape, dstr, dbl, cache, pt_dev,
                      tbl_dev, req_length, be, stair=None):
    """Wavefront encode driver (3-D; 2-D runs as a single layer-0
    plane through the 2-D wavefront alone)."""
    r1, r2, r3 = vshape
    S = r1 + r2 + r3 - 2
    S2 = r2 + r3 - 1
    rl = jnp.asarray(req_length, jnp.int32)
    bits = int(cache.bits)
    bi, ti = int(cache.base_index), int(cache.top_index)
    slo, shi, tabs = _stair_tabs(cache, stair, tbl_dev, pt_dev)
    data = work_dev.reshape(vshape)
    row_er = _esc_recon_raw_dev(data[0, 0, :], rl)
    pin_t, pin_rec = _pins_fn(r3, dstr, dbl, bits, bi, ti, be)(
        data[0, 0, :], row_er, tbl_dev, pt_dev)
    # plane 0 by 2-D wavefront (k-coordinate lines)
    p0 = data[0]
    p0_sh = _shear0_by(p0, 1)                    # (S2, r3)
    er0_sh = _esc_recon_raw_dev(p0_sh, rl)
    p0t, p0rec = _wf2_encode_fn(r2, r3, dstr, dbl, bits, bi, ti, be,
                                slo, shi)(
        p0_sh, er0_sh, tabs, pin_t.astype(jnp.int32),
        pin_rec)
    d_sh = _shear3(data)
    er_sh = _esc_recon_raw_dev(d_sh, rl)
    p0t_pad, p0rec_pad = _pad_lines_fn(S2, S, r3, dstr, be)(
        p0t, p0rec)
    G = S   # the whole wavefront in one dispatch
    T = work_dev.dtype
    c1 = c2 = c3 = jnp.zeros((r2, r3), T)
    chunks = []
    a = 0
    while a < S:
        g = min(G, S - a)
        fn = _wf3_encode_fn(g, r1, r2, r3, dstr, bits, bi, ti, be,
                            slo, shi)
        t_sl, c1, c2, c3 = fn(
            jax.lax.slice_in_dim(d_sh, a, a + g, axis=0),
            jax.lax.slice_in_dim(er_sh, a, a + g, axis=0),
            jax.lax.slice_in_dim(p0t_pad, a, a + g, axis=0),
            jax.lax.slice_in_dim(p0rec_pad, a, a + g, axis=0),
            tabs, c1, c2, c3, jnp.asarray(a, jnp.int32))
        chunks.append(t_sl)
        a += g
    t_sh = chunks[0] if len(chunks) == 1 else jnp.concatenate(chunks, 0)
    t = _unshear3(t_sh, r1, r2, r3)
    n = r1 * r2 * r3
    t_stream, hist, esc = _enc_epilogue_fn(n, be)(
        t.reshape(-1), work_dev.reshape(-1))
    return t_stream, hist, esc, [jnp.asarray(1)]


def _encode_device_wf2(work_dev, vshape, dstr, dbl, cache, pt_dev,
                       tbl_dev, req_length, be, stair=None):
    """2-D data: the whole field is one layer-0 plane."""
    _one, r2, r3 = vshape
    rl = jnp.asarray(req_length, jnp.int32)
    bits = int(cache.bits)
    bi, ti = int(cache.base_index), int(cache.top_index)
    slo, shi, tabs = _stair_tabs(cache, stair, tbl_dev, pt_dev)
    data = work_dev.reshape((r2, r3))
    row_er = _esc_recon_raw_dev(data[0, :], rl)
    pin_t, pin_rec = _pins_fn(r3, dstr, dbl, bits, bi, ti, be)(
        data[0, :], row_er, tbl_dev, pt_dev)
    p_sh = _shear0_by(data, 1)
    er_sh = _esc_recon_raw_dev(p_sh, rl)
    p0t, _p0rec = _wf2_encode_fn(r2, r3, dstr, dbl, bits, bi, ti, be,
                                 slo, shi)(
        p_sh, er_sh, tabs, pin_t.astype(jnp.int32), pin_rec)
    t = _unshear0_by(p0t, 1, r2)
    n = r2 * r3
    t_stream, hist, esc = _enc_epilogue_fn(n, be)(
        t.reshape(-1), work_dev.reshape(-1))
    return t_stream, hist, esc, [jnp.asarray(1)]


def _decode_device_wf(t_dev, unpred_pad, ptable, vshape, dstr, dbl,
                      be):
    """Wavefront decode driver -> flat reconstruction (pre-restore)."""
    r1, r2, r3 = vshape
    km, kv, pt = _dec_stage_fn(vshape, dstr, be)(
        t_dev, jax.device_put(unpred_pad), jax.device_put(ptable))
    if r1 == 1:
        km2 = _shear0_by(km[0], 1)
        kv2 = _shear0_by(kv[0], 1)
        pt2 = _shear0_by(pt[0], 1)
        rec = _wf2_decode_fn(r2, r3, dstr, dbl, be)(km2, kv2, pt2)
        return _unshear0_by(rec, 1, r2).reshape(r2 * r3)
    S = r1 + r2 + r3 - 2
    S2 = r2 + r3 - 1
    p0rec = _wf2_decode_fn(r2, r3, dstr, dbl, be)(
        _shear0_by(km[0], 1), _shear0_by(kv[0], 1),
        _shear0_by(pt[0], 1))
    km_sh = _shear3(km)
    kv_sh = _shear3(kv)
    pt_sh = _shear3(pt)
    T = jnp.dtype(dstr)
    p0rec_pad = jnp.concatenate(
        [p0rec, jnp.zeros((S - S2, r3), T)], 0)
    G = S   # the whole wavefront in one dispatch
    c1 = c2 = c3 = jnp.zeros((r2, r3), T)
    chunks = []
    a = 0
    while a < S:
        g = min(G, S - a)
        fn = _wf3_decode_fn(g, r1, r2, r3, dstr, be)
        r_sl, c1, c2, c3 = fn(
            jax.lax.slice_in_dim(km_sh, a, a + g, axis=0),
            jax.lax.slice_in_dim(kv_sh, a, a + g, axis=0),
            jax.lax.slice_in_dim(pt_sh, a, a + g, axis=0),
            jax.lax.slice_in_dim(p0rec_pad, a, a + g, axis=0),
            c1, c2, c3, jnp.asarray(a, jnp.int32))
        chunks.append(r_sl)
        a += g
    r_sh = chunks[0] if len(chunks) == 1 else jnp.concatenate(chunks, 0)
    return _unshear3(r_sh, r1, r2, r3).reshape(r1 * r2 * r3)


# ---------------------------------------------------------------------------
# softf64 wavefront (guaranteed f64 parity on ANY backend): the same
# anti-diagonal scan, but every chain op runs in the integer software-
# f64 arithmetic of tpu/softf64.py instead of the backend's f64.
# Streams are bit-exact with the host C chain BY CONSTRUCTION, so
# pwr.compress_msst19 skips the decode-verify fallback for these
# streams (TDPS._device_exact).  Reached only when forced
# (SZ_TPU_MSST19_SOFT=1); float data only.
# ---------------------------------------------------------------------------


def soft_policy(be: str, dbl: bool, dstr: str) -> bool:
    """True when the MSST19 device route should use the softf64
    wavefront: f32 data with SZ_TPU_MSST19_SOFT=1 (the native-f64
    float wavefront is the default on every backend)."""
    if dstr != "f4":
        return False
    env = eng._os.environ.get("SZ_TPU_MSST19_SOFT", "0").lower()
    return env in ("1", "force", "on")


def _encode_device_soft(work_dev, vshape, cache, tbl_dev, req_length,
                        be, stair_key, dbl: bool = True):
    """Soft-wavefront encode driver -> (t_stream, hist, esc, iters):
    the XLA scan in softf64, host-bit-exact."""
    from sz_tpu.tpu import msst19_soft as ms

    r1, r2, r3 = vshape
    S = r1 + r2 + r3 - 2
    tabs = ms.soft_tables(stair_key[0], stair_key[1], stair_key[2])
    bits_mag = (jax.lax.bitcast_convert_type(
        work_dev.reshape(vshape), jnp.uint32) & jnp.uint32(0x7FFFFFFF))
    ign = jnp.uint32(max(32 - int(req_length), 0))
    pte = jax.device_put(tabs.pt_e)
    pth = jax.device_put(tabs.pt_mh)
    ptl = jax.device_put(tabs.pt_ml)
    if not dbl:
        # 2D DATA (vshape (1, r2, r3)): the reference's single-
        # precision chain over sheared k-lines.  3D data with r1 == 1
        # keeps the f64 chains and the 3D shear path below.
        p_sh = _shear0_by(bits_mag.reshape(r2, r3), 1)
        er_sh = ms.esc_recon_bits(p_sh, ign)
        st_lines = ms.wf2_soft_encode_fn(r2, r3, tabs.bits,
                                         tabs.base_index,
                                         tabs.top_index, be)(
            p_sh, er_sh, tbl_dev, pte, pth, ptl)
        t = _unshear0_by(st_lines, 1, r2)
        n = r2 * r3
        t_stream, hist, esc = _enc_epilogue_fn(n, be)(
            t.reshape(-1), work_dev.reshape(-1))
        return t_stream, hist, esc, [jnp.asarray(1)]
    er = ms.esc_recon_bits(bits_mag, ign)
    d_sh = _shear3(bits_mag)
    er_sh = _shear3(er)
    c1 = c2 = c3 = jnp.zeros((r2, r3), jnp.uint32)
    fn = ms.wf3_soft_encode_fn(S, r1, r2, r3, tabs.bits,
                               tabs.base_index, tabs.top_index, be)
    t_sh, c1, c2, c3 = fn(d_sh, er_sh, tbl_dev, pte, pth, ptl,
                          c1, c2, c3, jnp.asarray(0, jnp.int32))
    t = _unshear3(t_sh, r1, r2, r3)
    n = r1 * r2 * r3
    t_stream, hist, esc = _enc_epilogue_fn(n, be)(
        t.reshape(-1), work_dev.reshape(-1))
    return t_stream, hist, esc, [jnp.asarray(1)]


@functools.lru_cache(maxsize=32)
def _dec_stage_soft_fn(vshape: tuple, backend: str = "cpu"):
    """(u16 type stream, padded escape BITS) -> (t lattice i32,
    kv lattice u32 signed escape bits)."""
    npl, r2, r3 = vshape

    def f(t_stream, unpred_bits_pad):
        t_flat = t_stream.astype(jnp.int32)
        is_esc = t_flat == 0
        rank = jnp.cumsum(is_esc.astype(jnp.int32)) - 1
        kv_flat = jnp.take(unpred_bits_pad,
                           jnp.clip(rank, 0,
                                    unpred_bits_pad.shape[0] - 1))
        kv = jnp.where(is_esc, kv_flat, jnp.uint32(0))
        return (t_flat.reshape(npl, r2, r3),
                kv.reshape(npl, r2, r3))

    return eng._strict_jit(f, backend)


def _decode_device_soft(t_dev, unpred_pad, ptable, vshape, be,
                        stair_key=None, dbl: bool = True):
    """Soft-wavefront decode driver -> flat f32 reconstruction
    (pre-restore), bit-exact with the host's f64 replay."""
    from sz_tpu.tpu import msst19_soft as ms

    r1, r2, r3 = vshape
    S = r1 + r2 + r3 - 2
    pte_np, pth_np, ptl_np = ms.pt_triples(ptable)
    pte = jax.device_put(pte_np)
    pth = jax.device_put(pth_np)
    ptl = jax.device_put(ptl_np)
    unpred_bits = np.ascontiguousarray(
        unpred_pad, np.float32).view(np.uint32)
    t_lat, kv_lat = _dec_stage_soft_fn(vshape, be)(
        t_dev, jax.device_put(unpred_bits))
    if not dbl:
        t_sh2 = _shear0_by(t_lat.reshape(r2, r3), 1)
        kv_sh2 = _shear0_by(kv_lat.reshape(r2, r3), 1)
        out_lines = ms.wf2_soft_decode_fn(r2, r3, be)(
            t_sh2, kv_sh2, pte, pth, ptl)
        out_bits = _unshear0_by(out_lines, 1, r2).reshape(r2 * r3)
        return jax.lax.bitcast_convert_type(out_bits, jnp.float32)
    t_sh = _shear3(t_lat)
    kv_sh = _shear3(kv_lat)
    c1 = c2 = c3 = jnp.zeros((r2, r3), jnp.uint32)
    o_sh, c1, c2, c3 = ms.wf3_soft_decode_fn(S, r1, r2, r3, be)(
        t_sh, kv_sh, pte, pth, ptl, c1, c2, c3, jnp.asarray(0, jnp.int32))
    out_bits = _unshear3(o_sh, r1, r2, r3).reshape(r1 * r2 * r3)
    return jax.lax.bitcast_convert_type(out_bits, jnp.float32)


@functools.lru_cache(maxsize=32)
def _enc_epilogue_fn(n: int, backend: str = "cpu"):
    """Concatenated type chunks -> (u16 raster stream, histogram,
    padded escape values)."""

    def f(t_flat, data_flat):
        t_stream = t_flat.astype(jnp.uint16)
        hist = eng.histogram(t_flat)
        esc_vals = ce._esc_vals_raster(t_flat, data_flat, ESC_K)
        return t_stream, hist, esc_vals

    return eng._strict_jit(f, backend)


def _encode_device(work_dev, vshape, dstr, dbl, cache, pt_dev, tbl_dev,
                   req_length, be, stair_key=None):
    """Encode driver: the softf64 wavefront when forced (guaranteed
    parity — see soft_policy), else the float wavefront,
    with the chunked plane-sweep fixpoint as the SZ_TPU_MSST19_WF=0
    fallback.  stair_key = (intervals, ratio, plus_bits) enables the
    gather-free stairstep lookups on the float path.  Returns
    (t_stream u16 dev, hist dev, esc dev, iters, exact: bool — True
    when the stream is bit-exact with the host BY CONSTRUCTION)."""
    npl, r2, r3 = vshape
    if (_wf_enabled() and stair_key is not None
            and soft_policy(be, dbl, dstr)):
        t_stream, hist, esc, iters = _encode_device_soft(
            work_dev, vshape, cache, tbl_dev, req_length, be,
            stair_key, dbl)
        return t_stream, hist, esc, iters, True
    if _wf_enabled():
        stair = (_stair_pack(stair_key[0], stair_key[1], stair_key[2])
                 if stair_key is not None and _stair_enabled()
                 else None)
        if stair is not None and not stair[-1]:
            # inexact (hi, lo) split: keep the gather path, or hi + lo
            # would silently diverge from take(ptable, st)
            stair = None
        if (stair is None and stair_key is not None and _stair_enabled()
                and be not in ("cpu", "raw")):
            # surface the ~4.5x slower per-step gather fallback (large
            # interval counts / non-stairstep tables) instead of
            # silently degrading — visible in traces and stats
            import warnings

            warnings.warn(
                f"MSST19 float wavefront: stairstep lookup unavailable "
                f"for intervals={stair_key[0]} (cap "
                f"{STAIR_MAX_STATES // 2}); using the ~4.5x slower "
                f"gather path", RuntimeWarning, stacklevel=2)
        exact = be in ("cpu", "raw")   # true-f64 backends: CI-gated
        if npl == 1:
            return (*_encode_device_wf2(work_dev, vshape, dstr, dbl,
                                        cache, pt_dev, tbl_dev,
                                        req_length, be, stair), exact)
        return (*_encode_device_wf(work_dev, vshape, dstr, dbl, cache,
                                   pt_dev, tbl_dev, req_length, be,
                                   stair), exact)
    rl = jnp.asarray(req_length, jnp.int32)
    data = work_dev.reshape(vshape)
    row_er = _esc_recon_raw_dev(data[0, 0, :], rl)
    pin_t, pin_rec = _pins_fn(r3, dstr, dbl, int(cache.bits),
                              int(cache.base_index),
                              int(cache.top_index), be)(
        data[0, 0, :], row_er, tbl_dev, pt_dev)
    G = npl
    chunks = []
    prev = jnp.zeros((r2, r3), work_dev.dtype)
    iters = []
    a = 0
    while a < npl:
        g = min(G, npl - a)
        fn = _encode_chunk_fn(g, r2, r3, dstr, dbl, int(cache.bits),
                              int(cache.base_index),
                              int(cache.top_index), be)
        t_c, prev, it = fn(
            jax.lax.slice_in_dim(data, a, a + g, axis=0), tbl_dev,
            pt_dev, rl, prev, pin_t, pin_rec,
            jnp.asarray(a, jnp.int32))
        chunks.append(t_c)
        iters.append(it)
        a += g
    t_flat = (chunks[0] if len(chunks) == 1 else
              jnp.concatenate(chunks, axis=0)).reshape(-1)
    n = npl * r2 * r3
    t_stream, hist, esc = _enc_epilogue_fn(n, be)(
        t_flat, work_dev.reshape(-1))
    return t_stream, hist, esc, iters, be in ("cpu", "raw")


@functools.lru_cache(maxsize=32)
def _dec_stage_fn(vshape: tuple, dtype_str: str, backend: str = "cpu"):
    """(u16 type stream, padded escapes, precision table) -> the
    per-plane decode inputs: escape mask, known (escape) values,
    per-point precision factors."""
    npl, r2, r3 = vshape
    T = jnp.dtype(dtype_str)

    def f(t_stream, unpred_pad, ptable):
        t_flat = t_stream.astype(jnp.int32)
        is_esc = t_flat == 0
        rank = jnp.cumsum(is_esc.astype(jnp.int32)) - 1
        kv_flat = jnp.take(unpred_pad,
                           jnp.clip(rank, 0, unpred_pad.shape[0] - 1))
        known = jnp.where(is_esc, kv_flat, jnp.asarray(0, T))
        ptv_flat = jnp.take(ptable, t_flat)  # hoisted: one gather total
        return (is_esc.reshape(npl, r2, r3),
                known.reshape(npl, r2, r3),
                ptv_flat.reshape(npl, r2, r3))

    return eng._strict_jit(f, backend)


@functools.lru_cache(maxsize=32)
def _decode_chunk_fn(G: int, r2: int, r3: int, dtype_str: str,
                     dbl: bool, backend: str = "cpu"):
    """G planes of the MSST19 decode fixpoint."""
    plane_iter = r2 + r3 + 4
    row0 = (jnp.arange(r2) == 0)[:, None]
    col0 = (jnp.arange(r3) == 0)[None, :]
    col1 = (jnp.arange(r3) == 1)[None, :]
    D = jnp.float64
    T = jnp.dtype(dtype_str)

    def f(km, kv, pt, prev0, base):
        first_flags = base + jnp.arange(G, dtype=jnp.int32) == 0

        def pred_first(P, prev):
            # layer-0 plane incl. its row-0 rules (escape/prev/A*A/A2);
            # the amplifying lin predictor computes on the (1, r3) row
            # slice only
            Pp = jnp.pad(P, ((1, 0), (1, 0)))
            A = Pp[1:, :-1]
            B = Pp[:-1, 1:]
            Dg = Pp[:-1, :-1]
            A2 = jnp.pad(P, ((0, 0), (2, 0)))[:, :-2]
            if dbl:
                lin = (A[:1].astype(D) * A[:1] / A2[:1]).astype(T)
                p2 = (A.astype(D) * B / Dg).astype(T)
            else:
                lin = _div_exact((A[:1] * A[:1]).astype(T), A2[:1], T)
                p2 = _div_exact((A * B).astype(T), Dg, T)
            return jnp.where(row0 & col1, A,
                             jnp.where(row0, lin,
                                       jnp.where(col0, B, p2)))

        def pred_rest(P, prev):
            # row-0/col-0 predictors on line slices; only the 7-factor
            # p3 chain runs at plane size (see the encode-side note)
            Pp = jnp.pad(P, ((1, 0), (1, 0)))
            A = Pp[1:, :-1]
            B = Pp[:-1, 1:]
            Dg = Pp[:-1, :-1]
            Qp = jnp.pad(prev, ((1, 0), (1, 0)))
            C = Qp[1:, 1:]
            E = Qp[:-1, 1:]
            F = Qp[1:, :-1]
            G_ = Qp[:-1, :-1]
            rw = (A[:1].astype(D) * C[:1] / F[:1]).astype(T)
            cl = (B[:, :1].astype(D) * C[:, :1] / E[:, :1]).astype(T)
            p3 = ((A.astype(D) * B * C * G_)
                  / (Dg.astype(D) * E * F)).astype(T)
            return jnp.where(row0 & col0, C,
                             jnp.where(row0, rw,
                                       jnp.where(col0, cl, p3)))

        def plane(prev, xs):
            kmx, kvx, ptx, first = xs

            def val(P):
                p = jax.lax.cond(first, pred_first, pred_rest, P, prev)
                v = (jnp.abs(p.astype(D)) * ptx).astype(T)
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

        last, (R, its) = jax.lax.scan(
            plane, prev0, (km, kv, pt, first_flags))
        return R, last, jnp.max(its)

    return eng._strict_jit(f, backend)


@functools.lru_cache(maxsize=32)
def _restore_fn(n: int, dtype_str: str, backend: str = "cpu"):
    """MSST19 sign/zero epilogue (decompress_pwrel msst19 branch /
    szd_float_pwr.c:1425): values below minLogValue flush to zero,
    serialized sign bits flip the rest."""
    T = jnp.dtype(dtype_str)

    def f(out, thr, signs, has_signs):
        ubits = jnp.uint32 if T == jnp.float32 else jnp.uint64
        signbit = ubits(1) << ubits(8 * T.itemsize - 1)
        zero = jnp.where(has_signs,
                         (out < thr) & (out >= 0), out < thr)
        out = jnp.where(zero, jnp.asarray(0, T), out)
        u = jax.lax.bitcast_convert_type(out, ubits)
        flip = has_signs & (signs != 0) & ~zero
        u = jnp.where(flip, u | signbit, u)
        return jax.lax.bitcast_convert_type(u, T)

    return eng._strict_jit(f, backend)


def _decode_device(t_dev, unpred_pad, ptable, vshape, dstr, dbl, be,
                   stair_key=None):
    """Decode driver -> flat reconstruction (pre-restore); softf64
    wavefront when forced (bit-exact with the host's true-f64 replay),
    float wavefront otherwise, plane-sweep fixpoint fallback
    (SZ_TPU_MSST19_WF=0)."""
    npl, r2, r3 = vshape
    if _wf_enabled() and soft_policy(be, dbl, dstr):
        return _decode_device_soft(t_dev, unpred_pad, ptable, vshape,
                                   be, stair_key, dbl)
    if _wf_enabled():
        return _decode_device_wf(t_dev, unpred_pad, ptable, vshape,
                                 dstr, dbl, be)
    km, kv, pt = _dec_stage_fn(vshape, dstr, be)(
        t_dev, jax.device_put(unpred_pad), jax.device_put(ptable))
    G = npl
    prev = jnp.zeros((r2, r3), jnp.dtype(dstr))
    chunks = []
    a = 0
    while a < npl:
        g = min(G, npl - a)
        fn = _decode_chunk_fn(g, r2, r3, dstr, dbl, be)
        R, prev, _it = fn(
            jax.lax.slice_in_dim(km, a, a + g, axis=0),
            jax.lax.slice_in_dim(kv, a, a + g, axis=0),
            jax.lax.slice_in_dim(pt, a, a + g, axis=0),
            prev, jnp.asarray(a, jnp.int32))
        chunks.append(R)
        a += g
    R = chunks[0] if len(chunks) == 1 else jnp.concatenate(chunks, 0)
    return R.reshape(npl * r2 * r3)


# ---------------------------------------------------------------------------
# Drivers (host side): mirror pwr.compress_msst19 / decompress_msst19
# ---------------------------------------------------------------------------


# Size gate for the device engine: the float wavefront's parity is
# empirical past it (verify-and-fallback still guards every stream).
DEVICE_MAX_POINTS = 1 << 24


def device_ok(engine: str, dtype, ndim: int, n: int) -> bool:
    """Route MSST19 to the device engine?  Only on explicit
    engine="jax" for 2D/3D data up to DEVICE_MAX_POINTS: "auto" keeps
    PW_REL on the host codec, whose one-pass C chain the dispatch-bound
    XLA wavefront scan does not beat."""
    return engine == "jax" and ndim in (2, 3) and n <= DEVICE_MAX_POINTS


def verify_conformant(tdps: TDPS, work: np.ndarray,
                      pw_ratio: float) -> bool:
    """True iff `tdps` decodes (HOST decode — true f64) within the
    point-wise relative bound of `work`.  Called by pwr.compress_msst19
    after a device encode on emulated-f64 backends: a near-tie f32
    rounding flip can seed a divergence between the device chain and
    the decoder's true-f64 replay, and the MULTIPLICATIVE A*B/D
    predictor amplifies a 1-ulp seed without bound (a 256^3 field was
    observed decoding to inf).  Tolerance matches the suite's bound
    checks (1 + 1e-5 slack for the escape quantization ulp).

    The decode is the RAW chain replay (decompress_msst19, no sign/zero
    restore): at this point the caller has not yet attached the sign
    bitmap or min_log_value to `tdps`, so the restored decode of a
    signed field would zero every negative escape.  The restore is an
    exact, orthogonal epilogue (signs flip bits, the zero flush only
    fires below min_log_value), so comparing MAGNITUDES against the
    signed working field is the bound the final output satisfies."""
    from sz_tpu.core import pwr

    with _tr.trace("verify"):
        out = pwr.decompress_msst19(tdps, work.shape, work.dtype)
        aw = np.abs(work.astype(np.float64))
        err = np.abs(np.abs(np.asarray(out, np.float64)) - aw)
        lim = float(pw_ratio) * aw
        return bool(np.isfinite(err).all()
                    and (err <= lim * (1 + 1e-5)).all())


def compress(work: np.ndarray, pw_ratio: float, fmax, near_zero, *,
             max_range_radius: int, sample_distance: int,
             pred_threshold: float, plus_bits: int = 3,
             opt_quant_mode: int = 1, fixed_intervals: int = 0,
             engine: str = "jax"):
    """Device analog of pwr.compress_msst19 — identical byte output.
    `work` must already have zeros replaced (the caller's copy)."""
    from sz_tpu.core import pwr

    T = np.float32 if work.dtype == np.float32 else np.float64
    dt = DataType.FLOAT if T is np.float32 else DataType.DOUBLE
    work = np.ascontiguousarray(work, dtype=T)
    n = work.size
    shape = tuple(int(r) for r in work.shape)
    dstr = np.dtype(T).str.lstrip("<>=")
    be = jax.default_backend()
    ratio = float(pw_ratio)

    if opt_quant_mode == 1:
        with _tr.trace("optimizer"):
            intervals = pwr._optimize_intervals_msst19(
                work, ratio, max_range_radius, sample_distance,
                pred_threshold)
    else:
        intervals = fixed_intervals

    ptable = pwr._precision_table(intervals, ratio, plus_bits)
    cache = pwr._cache_table(int(intervals), ratio, int(plus_bits))

    median = T(np.sqrt(np.float64(abs(T(near_zero * fmax)))))
    if T is np.float32 and work.ndim != 2:
        req_expo = classic.get_exponent(np.float32(ratio), np.float32)
        req_length = 9 - req_expo
    else:
        req_expo = classic.get_exponent(np.float64(ratio), np.float64)
        req_length = 12 - req_expo

    dbl = work.ndim == 3
    with _tr.trace("upload"):
        dev = jax.device_put(work)
        tbl_dev = jax.device_put(
            np.ascontiguousarray(cache.table).reshape(-1))
        pt_dev = jax.device_put(ptable)
        dev.block_until_ready()
    with _tr.trace("quantize"):
        t_stream_d, hist_d, esc_d, _iters, exact = _encode_device(
            dev, _vshape(shape), dstr, dbl, cache, pt_dev, tbl_dev,
            req_length, be,
            stair_key=(int(intervals), float(ratio), int(plus_bits)))
        t_stream_d.block_until_ready()
        hist = np.asarray(hist_d)

    n_esc = int(hist[0])
    with _tr.trace("escapes"):
        if n_esc <= ESC_K:
            esc_vals = np.asarray(esc_d)[:n_esc]
        else:
            k = eng._pad_pow2(n_esc)
            esc_vals = np.asarray(ce._escapes_fn(n, k, be)(
                t_stream_d, dev.reshape(-1)))[:n_esc]
    enc = classic.ExactEncoder(req_length, T(0), T, raw=True)
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
    tdps = TDPS(
        data_type=dt, ds_length=n, intervals=intervals,
        median_value=float(median), req_length=req_length,
        real_precision=ratio, type_array=type_array,
        lead_num=enc.lead_packed(), exact_mid_bytes=bytes(enc.mid_bytes),
        residual_mid_bits=enc.resi_packed(),
        exact_data_num=enc.exact_count(),
        max_quant_intervals=max_range_radius * 2,
        is_pwr=True, msst19=True, plus_bits=plus_bits,
        max_bits=max_len)
    # softf64 streams are host-bit-exact BY CONSTRUCTION: the caller
    # (pwr.compress_msst19) skips its decode-verify fallback for them
    tdps._device_exact = bool(exact)
    return tdps


def decompress(tdps: TDPS, shape, dtype, as_jax: bool = False):
    """Device analog of pwr's MSST19 decode INCLUDING the sign/zero
    restore (decompress_pwrel msst19 branch) — bit-identical output."""
    from sz_tpu.core import pwr
    from sz_tpu.format import lossless as ll

    T = np.float32 if np.dtype(dtype) == np.float32 else np.float64
    n = int(np.prod(shape))
    shape = tuple(int(s) for s in shape)
    dstr = np.dtype(T).str.lstrip("<>=")
    be = jax.default_backend()
    dbl = len(shape) == 3

    use_dd = eng.device_decode_policy(be)
    t_dev = None
    if use_dd:
        node_count = bu.read_u32_be(tdps.type_array, 0)
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
        t_dev = jax.device_put(t_np.astype(np.uint16))
    else:
        n_esc = int(jnp.sum(jnp.equal(t_dev, 0),
                            promote_integers=False))
        t_dev = t_dev.astype(jnp.uint16)

    dec = classic.ExactDecoder(tdps, T, raw=True)
    ptable = pwr._precision_table(tdps.intervals, tdps.real_precision,
                                  tdps.plus_bits)
    k = eng._pad_pow2(max(n_esc, 1))
    unpred_pad = np.zeros(k, dtype=T)
    unpred_pad[:n_esc] = dec.next_batch(n_esc)

    thr = T(tdps.min_log_value)
    has_signs = len(tdps.pwr_err_bound_bytes) > 0
    if has_signs:
        signs = np.frombuffer(
            ll.decompress(tdps.pwr_err_bound_bytes, expected_size=n),
            dtype=np.uint8, count=n)
    else:
        signs = np.zeros(1, np.uint8)  # broadcasts; nothing to upload

    with _tr.trace("decode_fixpoint"):
        out = _decode_device(t_dev, unpred_pad, ptable,
                             _vshape(shape), dstr, dbl, be,
                             stair_key=(int(tdps.intervals),
                                        float(tdps.real_precision),
                                        int(tdps.plus_bits)))
        out = _restore_fn(n, dstr, be)(
            out, T(thr), jax.device_put(signs),
            jnp.asarray(has_signs, jnp.bool_))
        out.block_until_ready()
    if as_jax:
        return out.reshape(shape)
    with _tr.trace("download"):
        return np.asarray(out).reshape(shape)
