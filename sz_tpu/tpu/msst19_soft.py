"""Exact MSST19 step arithmetic on f32 bit patterns (softf64-based).

The per-point quantize/reconstruct math of the MSST19 accelerated
PW_REL codec (sz_float.c SZ_compress_float_3D_MDQ_MSST19 hot loop,
szd_float.c decode replay), expressed over uint32 f32 BIT PATTERNS
with the software-f64 chain ops from sz_tpu/tpu/softf64.py — true IEEE
binary64 semantics on any backend (a float-float f64 emulation rounds
differently near f32 ties;
this path is bit-exact with the host C chain BY CONSTRUCTION, retiring
the decode-verify fallback for routes that use it).

Everything here is magnitude arithmetic (the chain is sign-free — see
softf64's module docstring); callers pass |data| bits and carry
magnitude reconstructions.

The predictor variants all have the form

    pred = f32( ((m1*m2)*m3)*m4 / ((d1*d2)*d3) )

with per-op f64 rounding, where unused factors are exactly 1.0 (an
exact multiplication, so e.g. the layer-0 row chain A*A/A2 and the
single-factor preds A, B, C fall out of the same op sequence with the
same rounding as the C's dedicated expressions).  Operand selection is
the caller's job (wavefront masks); this module owns the arithmetic
and the table lookups.
"""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp

from sz_tpu.tpu import softf64 as sf

_U32 = jnp.uint32
_I32 = jnp.int32

ONE_BITS = np.uint32(0x3F800000)
INF_BITS = np.uint32(0x7F800000)


def _u(x):
    return jnp.uint32(x)


def _i(x):
    return jnp.int32(x)


# ---------------------------------------------------------------------------
# host-side table preparation
# ---------------------------------------------------------------------------

def pt_triples(ptable: np.ndarray):
    """precisionTable entries as canonical softf64 triples (e, mh, ml).
    Nonfinite entries get a huge exponent so rec = |pred| * pt rounds
    to +inf exactly like the C's inf product (NaN entries cannot occur:
    pow(1+ratio, x) with ratio > 0)."""
    e, mh, ml, nonfin = sf.unpack_f64_host(ptable)
    e = np.where(nonfin != 0, np.int32(0x100000), e)
    mh = np.where(nonfin != 0, np.uint32(1 << 20), mh)
    ml = np.where(nonfin != 0, np.uint32(0), ml)
    return (np.ascontiguousarray(e, np.int32),
            np.ascontiguousarray(mh, np.uint32),
            np.ascontiguousarray(ml, np.uint32))


class SoftTables:
    """Integer-form MSST19 tables for the softf64 step math.

    pt_e/pt_mh/pt_ml: precisionTable triples (always available).
    bounds: the cache table's monotone stairstep boundaries (int32,
    state = count(bounds <= key) inside [lo_key, hi_key]; see
    msst19_engine._stair_pack — the same host-validated envelope).
    stair_ok is False when the table falls outside the stairstep
    envelope; the Pallas kernel then declines and the XLA soft path
    (flat-table gather) covers the case."""

    def __init__(self, intervals: int, ratio: float, plus_bits: int):
        from sz_tpu.core import pwr
        from sz_tpu.tpu import msst19_engine as me

        cache = pwr._cache_table(int(intervals), float(ratio),
                                 int(plus_bits))
        self.bits = int(cache.bits)
        self.base_index = int(cache.base_index)
        self.top_index = int(cache.top_index)
        self.table_flat = np.ascontiguousarray(cache.table).reshape(-1)
        ptable = pwr._precision_table(int(intervals), float(ratio),
                                      int(plus_bits))
        self.pt_e, self.pt_mh, self.pt_ml = pt_triples(ptable)
        self.n_states = len(ptable)
        pack = me._stair_pack(int(intervals), float(ratio),
                              int(plus_bits))
        if pack is None:
            self.stair_ok = False
            return
        bounds, lo_key, hi_key, _pt_hi, _pt_lo, _pt_exact = pack
        self.stair_ok = True
        self.bounds = np.ascontiguousarray(bounds, np.int32)
        self.lo_key = int(lo_key)
        self.hi_key = int(hi_key)


@functools.lru_cache(maxsize=16)
def soft_tables(intervals: int, ratio: float, plus_bits: int):
    return SoftTables(intervals, ratio, plus_bits)


# ---------------------------------------------------------------------------
# cache-table key from f32 ratio bits (mirror of msst19_engine._key_f32,
# starting from the bit pattern)
# ---------------------------------------------------------------------------

def key_from_f32_bits(bits, base_index: int, top_index: int,
                      bits_n: int):
    """Combined cache-table key (rel*size + manti, in-range mask) from
    the f32 bit pattern of the ratio: the host keys on float64(ratio)
    bits, and an f32 widens exactly (msst19_engine._key_f32, verified
    bit-identical to the host lookup)."""
    b = bits & _u(0x7FFFFFFF)
    e32 = (b >> _u(23)).astype(_I32)
    m32 = (b & _u(0x7FFFFF)).astype(_I32)
    fhb = jax.lax.bitcast_convert_type(m32.astype(jnp.float32), _U32)
    hb = ((fhb >> _u(23)) & _u(0xFF)).astype(_I32) - _i(127)
    is_sub = (e32 == _i(0)) & (m32 != _i(0))
    expo = jnp.where(e32 == _i(255), _i(2047),
                     jnp.where(e32 > _i(0), e32 + _i(896),
                               jnp.where(is_sub, _i(874) + hb, _i(0))))
    if bits_n <= 23:
        man_n = m32 >> _i(23 - bits_n)
    else:  # pragma: no cover - bits > 23 never happens for pw >= 1e-5
        man_n = m32 << _i(bits_n - 23)
    frac = m32 - jnp.left_shift(_i(1), jnp.maximum(hb, _i(0)))
    d = hb - _i(bits_n)
    man_s = jnp.where(d >= _i(0),
                      jnp.right_shift(frac, jnp.maximum(d, _i(0))),
                      jnp.left_shift(frac, jnp.maximum(-d, _i(0))))
    manti = jnp.where(is_sub, man_s, man_n)
    rel = expo - _i(base_index)
    okk = (rel >= _i(0)) & (rel <= _i(top_index - base_index))
    return rel * _i(1 << bits_n) + manti, okk


def stair_state_xla(key, okk, bounds, lo_key: int, hi_key: int):
    """state = count(bounds <= key) — XLA reference form (searchsorted);
    the Pallas kernel uses the multi-level counting search, asserted
    equal over the full key range in tests."""
    inside = okk & (key >= _i(lo_key)) & (key <= _i(hi_key))
    st = jnp.searchsorted(bounds, key, side="right").astype(_I32)
    return jnp.where(inside, st, _i(0))


# ---------------------------------------------------------------------------
# the per-point step math
# ---------------------------------------------------------------------------

def _up(bits):
    e, m, _z, nf = sf.unpack_f32_mag(bits)
    return e, m, nf


def predict_bits(m1, m2, m3, m4, d1, d2, d3):
    """pred = f32(((m1*m2)*m3)*m4 / ((d1*d2)*d3)) with per-op RN53 —
    operands are f32 bit patterns (magnitudes).  Returns (pred_bits,
    force_escape): force_escape marks lanes whose C-chain pred is
    inf/NaN-driven (nonfinite operand or zero denominator) — those
    points always take the escape state, so the garbage chain value is
    never consumed."""
    e1, q1, f1 = _up(m1)
    e2, q2, f2 = _up(m2)
    e3, q3, f3 = _up(m3)
    e4, q4, f4 = _up(m4)
    g1, p1, h1 = _up(d1)
    g2, p2, h2 = _up(d2)
    g3, p3, h3 = _up(d3)
    num = sf.mul24_exact(e1, q1, e2, q2)
    num = sf.mul53x24_rn(*num, e3, q3)
    num = sf.mul53x24_rn(*num, e4, q4)
    den = sf.mul24_exact(g1, p1, g2, p2)
    den = sf.mul53x24_rn(*den, g3, p3)
    q = sf.div53_rn(*num, *den)
    pred = sf.pack_f32_rn(*q)
    den_zero = (p1 == _u(0)) | (p2 == _u(0)) | (p3 == _u(0))
    any_nf = f1 | f2 | f3 | f4 | h1 | h2 | h3
    return pred, any_nf | den_zero


def predict_bits_2d(m1, m2, d1):
    """2D float chain: pred = f32(f32(m1*m2) / d1) — the reference's
    2D float MSST19 kernel chains in SINGLE precision (sz_float.c
    quirk; the 3D kernel's `double temp` chains do not apply).  The
    multiply is the exact RN24 product (soft, so a backend's subnormal
    flushing can never leak in), the divide is the correctly rounded
    soft f32 division.  Unused factors are exactly 1.0."""
    e1, q1, f1 = _up(m1)
    e2, q2, f2 = _up(m2)
    g1, p1, h1 = _up(d1)
    prod = sf.pack_f32_rn(*sf.mul24_exact(e1, q1, e2, q2))
    pe, pm, pnf = _up(prod)
    pred = sf.div24_f32_rn(pe, pm, g1, p1)
    force = f1 | f2 | h1 | pnf | (p1 == _u(0))
    return pred, force


def select_operands_2d(row0, col0, k1, A, Bv, A2k, Dg, one):
    """Per-lane (m1, m2, d1) for the 2D chain.  Cases (j = d-k):
    j0&k0 forced escape | j0&k1 -> A | j0 -> A*A/A2k | k0 -> Bv |
    else A*Bv/Dg."""
    j0r = row0 & ~col0 & ~k1
    int2 = ~row0 & ~col0
    m1 = jnp.where(row0 & col0, one, jnp.where(col0, Bv, A))
    m2 = jnp.where(j0r, A, jnp.where(int2, Bv, one))
    d1 = jnp.where(j0r, A2k, jnp.where(int2, Dg, one))
    return m1, m2, d1


def esc_recon_bits(cur_bits, ign):
    """Raw-mode escape reconstruction magnitude: binary truncation of
    the |cur| bits (MSST19 ExactEncoder, no median offset).  ign =
    max(32 - req_length, 0) as a uint32 scalar/array."""
    mask = ~((_u(1) << ign) - _u(1))
    return (cur_bits & _u(0x7FFFFFFF)) & mask


def quant_bits(cur_bits, pred_bits, force_escape, er_bits, st_lookup,
               pt_lookup):
    """One MSST19 quantize step: (|cur| bits, pred bits, escape-force
    mask, escape-recon bits, state-lookup fn key->st, pt-lookup fn
    st->(e,mh,ml)) -> (state i32, rec bits u32 magnitude).

    ratio = RN24(|cur|/|pred|) correctly rounded; state from the cache
    key of the ratio's (widened) bit pattern; rec = RN24(RN53(
    f64(|pred|) * ptable[state])) — each identical to the C chain."""
    ce, cm, cnf = _up(cur_bits)
    pe, pm, pnf = _up(pred_bits)
    ratio_bits = sf.div24_f32_rn(ce, cm, pe, pm)
    key, okk = st_lookup[0](ratio_bits)
    okk = okk & ~(cnf | pnf | force_escape)
    st = st_lookup[1](key, okk)
    pt_e, pt_mh, pt_ml = pt_lookup(st)
    rec64 = sf.mul53x24_rn(pt_e, pt_mh, pt_ml, pe, pm)
    rec = sf.pack_f32_rn(*rec64)
    st = jnp.where(okk, st, _i(0))
    rec = jnp.where(st == _i(0), er_bits, rec)
    return st, rec


def recon_bits(pred_bits, pt_e, pt_mh, pt_ml):
    """Decode reconstruction: RN24(RN53(f64(|pred|) * pt)) bits."""
    pe, pm, _pnf = _up(pred_bits)
    rec64 = sf.mul53x24_rn(pt_e, pt_mh, pt_ml, pe, pm)
    return sf.pack_f32_rn(*rec64)


# ---------------------------------------------------------------------------
# predictor operand selection (shared by the XLA wavefront below and
# the Pallas kernel): the nine dependency cases of the 3D lattice in
# anti-diagonal slice coordinates.  2D float data does NOT ride this
# path (its C kernel chains in f32, not f64 temps — sz_float.c quirk).
# ---------------------------------------------------------------------------

def select_operands(plane0, row0, col0, k1, A, Bv, Cv, Gv, Dg, Ev, Fv,
                    A2k, one):
    """Per-lane (m1..m4, d1..d3) f32-bit operands for
    pred = ((m1*m2)*m3)*m4 / ((d1*d2)*d3).  Cases (i = s-j-k):

      i==0:  j0&k0 forced escape | j0&k1 -> A | j0 -> A*A/A2k
             | k0 -> Bv | else A*Bv/Dg
      i>=1:  j0&k0 -> Cv | j0 -> A*Cv/Fv | k0 -> Bv*Cv/Ev
             | else A*Bv*Cv*Gv/(Dg*Ev*Fv)

    Unused factors are exactly 1.0 (exact multiplications, so each
    case's rounding sequence equals the C's dedicated expression)."""
    p0r0 = plane0 & row0
    int3 = ~plane0 & ~row0 & ~col0
    m1 = jnp.where(p0r0 & col0, one,
                   jnp.where(row0, A,
                             jnp.where(col0 & plane0, Bv,
                                       jnp.where(col0, Bv,
                                                 A))))
    # i>=1, j0&k0 -> Cv overrides the row0->A pick
    m1 = jnp.where(~plane0 & row0 & col0, Cv, m1)
    m2 = jnp.where(p0r0 & ~col0 & ~k1, A,
                   jnp.where(plane0 & ~row0 & ~col0, Bv,
                             jnp.where(~plane0 & row0 & ~col0, Cv,
                                       jnp.where(~plane0 & ~row0 & col0,
                                                 Cv,
                                                 jnp.where(int3, Bv,
                                                           one)))))
    m3 = jnp.where(int3, Cv, one)
    m4 = jnp.where(int3, Gv, one)
    d1 = jnp.where(p0r0 & ~col0 & ~k1, A2k,
                   jnp.where(plane0 & ~row0 & ~col0, Dg,
                             jnp.where(~plane0 & row0 & ~col0, Fv,
                                       jnp.where(~plane0 & ~row0 & col0,
                                                 Ev,
                                                 jnp.where(int3, Dg,
                                                           one)))))
    d2 = jnp.where(int3, Ev, one)
    d3 = jnp.where(int3, Fv, one)
    return m1, m2, m3, m4, d1, d2, d3


def _shiftk(x):
    return jnp.pad(x, ((0, 0), (1, 0)))[:, :-1]


def _shiftk2(x):
    return jnp.pad(x, ((0, 0), (2, 0)))[:, :-2]


def _shiftj(x):
    return jnp.pad(x, ((1, 0), (0, 0)))[:-1, :]


def _shiftjk(x):
    return jnp.pad(x, ((1, 0), (1, 0)))[:-1, :-1]


# ---------------------------------------------------------------------------
# XLA wavefront (lax.scan over anti-diagonal slices) — the reference
# form of the Pallas kernel and the guaranteed-parity fallback where
# the kernel's size/state envelope does not reach.  Layer 0 is handled
# INLINE (cases above), so there is no separate 2-D wavefront or
# pinned first row.
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=32)
def wf3_soft_encode_fn(G: int, r1: int, r2: int, r3: int, bits_n: int,
                       base_index: int, top_index: int,
                       backend: str = "cpu"):
    """G steps of the softf64 3-D encode wavefront over f32 BIT slices:
    (d_sl |bits|, er_sl bits, table_flat, pte, pth, ptl, carries,
    s base) -> (st slices i32, carries).  Carries hold magnitude rec
    bits.  The state lookup is the flat cache-table gather (total for
    any table; the Pallas kernel swaps in the stairstep counting
    search, asserted equal in tests)."""
    from sz_tpu.tpu import engine as eng

    jk = (jnp.arange(r2)[:, None] + jnp.arange(r3)[None, :]).astype(
        jnp.int32)
    row0m = (jnp.arange(r2) == 0)[:, None]
    col0m = (jnp.arange(r3) == 0)[None, :]
    k1m = (jnp.arange(r3) == 1)[None, :]
    one = jnp.full((r2, r3), ONE_BITS, jnp.uint32)

    def f(d_sl, er_sl, table_flat, pte, pth, ptl, c1, c2, c3, base):
        def st_key(ratio_bits):
            return key_from_f32_bits(ratio_bits, base_index, top_index,
                                     bits_n)

        def st_search(key, okk):
            idx = jnp.clip(key, 0, table_flat.shape[0] - 1)
            return jnp.where(okk,
                             jnp.take(table_flat, idx).astype(_I32),
                             _i(0))

        def pt_take(st):
            return (jnp.take(pte, st), jnp.take(pth, st),
                    jnp.take(ptl, st))

        def step(carry, xs):
            c1, c2, c3, s = carry
            dl, erl = xs
            i_idx = s - jk
            valid = (i_idx >= 0) & (i_idx < r1)
            plane0 = i_idx == 0
            A = _shiftk(c1)
            Bv = _shiftj(c1)
            Dg = _shiftjk(c2)
            Cv = c1
            Ev = _shiftj(c2)
            Fv = _shiftk(c2)
            Gv = _shiftjk(c3)
            A2k = _shiftk2(c2)
            ops = select_operands(plane0, row0m, col0m, k1m, A, Bv, Cv,
                                  Gv, Dg, Ev, Fv, A2k, one)
            pred, force = predict_bits(*ops)
            first = plane0 & row0m & col0m       # the global (0,0,0)
            st, rec = quant_bits(dl, pred, force | first, erl,
                                 (st_key, st_search), pt_take)
            st = jnp.where(valid, st, _i(0))
            rec = jnp.where(valid, rec, _u(0))
            return (rec, c1, c2, s + 1), st

        (c1, c2, c3, _s), st_sl = jax.lax.scan(
            step, (c1, c2, c3, base), (d_sl, er_sl))
        return st_sl, c1, c2, c3

    return eng._strict_jit(f, backend)


def _shift1(x):
    return jnp.pad(x, (1, 0))[:-1]


def _shift2(x):
    return jnp.pad(x, (2, 0))[:-2]


@functools.lru_cache(maxsize=32)
def wf2_soft_encode_fn(r2: int, r3: int, bits_n: int, base_index: int,
                       top_index: int, backend: str = "cpu"):
    """2D softf64 wavefront over sheared k-LINES (r2+r3-1, r3): the
    2D float chain (predict_bits_2d) with the row-0 escape/prev/lin
    rules INLINE — no pinned first row.  (d lines |bits|, er lines,
    table_flat, pte, pth, ptl) -> st lines i32.  Guaranteed host
    parity by construction (the last empirical route closed)."""
    from sz_tpu.tpu import engine as eng

    S2 = r2 + r3 - 1
    kk = jnp.arange(r3)
    one = jnp.full((r3,), ONE_BITS, jnp.uint32)
    col0m = kk == 0
    k1m = kk == 1

    def f(d_lines, er_lines, table_flat, pte, pth, ptl):
        def st_key(ratio_bits):
            return key_from_f32_bits(ratio_bits, base_index, top_index,
                                     bits_n)

        def st_search(key, okk):
            idx = jnp.clip(key, 0, table_flat.shape[0] - 1)
            return jnp.where(okk,
                             jnp.take(table_flat, idx).astype(_I32),
                             _i(0))

        def pt_take(st):
            return (jnp.take(pte, st), jnp.take(pth, st),
                    jnp.take(ptl, st))

        def step(carry, xs):
            p1, p2l, d_idx = carry
            dl, erl = xs
            jrow = d_idx - kk
            valid = (jrow >= 0) & (jrow < r2)
            row0 = kk == d_idx
            A = _shift1(p1)
            Bv = p1
            Dg = _shift1(p2l)
            A2k = _shift2(p2l)
            m1, m2, d1 = select_operands_2d(row0, col0m, k1m, A, Bv,
                                            A2k, Dg, one)
            pred, force = predict_bits_2d(m1, m2, d1)
            first = row0 & col0m
            st, rec = quant_bits(dl, pred, force | first, erl,
                                 (st_key, st_search), pt_take)
            st = jnp.where(valid, st, _i(0))
            rec = jnp.where(valid, rec, _u(0))
            return (rec, p1, d_idx + 1), st

        z = jnp.zeros((r3,), jnp.uint32)
        _, st_lines = jax.lax.scan(
            step, (z, z, jnp.asarray(0, jnp.int32)),
            (d_lines[:S2], er_lines[:S2]))
        return st_lines

    return eng._strict_jit(f, backend)


@functools.lru_cache(maxsize=32)
def wf2_soft_decode_fn(r2: int, r3: int, backend: str = "cpu"):
    """2D softf64 decode wavefront: (t lines i32, kv lines u32 signed
    bits, pte, pth, ptl) -> out lines u32 signed bits."""
    from sz_tpu.tpu import engine as eng

    S2 = r2 + r3 - 1
    kk = jnp.arange(r3)
    one = jnp.full((r3,), ONE_BITS, jnp.uint32)
    col0m = kk == 0
    k1m = kk == 1

    def f(t_lines, kv_lines, pte, pth, ptl):
        def step(carry, xs):
            p1, p2l, d_idx = carry
            tl, kvl = xs
            jrow = d_idx - kk
            valid = (jrow >= 0) & (jrow < r2)
            row0 = kk == d_idx
            A = _shift1(p1)
            Bv = p1
            Dg = _shift1(p2l)
            A2k = _shift2(p2l)
            m1, m2, d1 = select_operands_2d(row0, col0m, k1m, A, Bv,
                                            A2k, Dg, one)
            pred, _force = predict_bits_2d(m1, m2, d1)
            val = recon_bits(pred, jnp.take(pte, tl),
                             jnp.take(pth, tl), jnp.take(ptl, tl))
            esc = tl == _i(0)
            out = jnp.where(esc, kvl, val)
            rec = jnp.where(esc, kvl & _u(0x7FFFFFFF), val)
            out = jnp.where(valid, out, _u(0))
            rec = jnp.where(valid, rec, _u(0))
            return (rec, p1, d_idx + 1), out

        z = jnp.zeros((r3,), jnp.uint32)
        _, out_lines = jax.lax.scan(
            step, (z, z, jnp.asarray(0, jnp.int32)),
            (t_lines[:S2], kv_lines[:S2]))
        return out_lines

    return eng._strict_jit(f, backend)


@functools.lru_cache(maxsize=32)
def wf3_soft_decode_fn(G: int, r1: int, r2: int, r3: int,
                       backend: str = "cpu"):
    """G steps of the softf64 3-D decode wavefront: (t slices i32,
    kv slices u32 SIGNED escape bits, pte, pth, ptl, carries, base)
    -> (out slices u32 signed bits, carries).  Carries are magnitude
    bits; outputs keep escape signs (quantized points are positive
    magnitudes, exactly like the host's pre-restore reconstruction)."""
    from sz_tpu.tpu import engine as eng

    jk = (jnp.arange(r2)[:, None] + jnp.arange(r3)[None, :]).astype(
        jnp.int32)
    row0m = (jnp.arange(r2) == 0)[:, None]
    col0m = (jnp.arange(r3) == 0)[None, :]
    k1m = (jnp.arange(r3) == 1)[None, :]
    one = jnp.full((r2, r3), ONE_BITS, jnp.uint32)

    def f(t_sl, kv_sl, pte, pth, ptl, c1, c2, c3, base):
        def step(carry, xs):
            c1, c2, c3, s = carry
            tl, kvl = xs
            i_idx = s - jk
            valid = (i_idx >= 0) & (i_idx < r1)
            plane0 = i_idx == 0
            A = _shiftk(c1)
            Bv = _shiftj(c1)
            Dg = _shiftjk(c2)
            Cv = c1
            Ev = _shiftj(c2)
            Fv = _shiftk(c2)
            Gv = _shiftjk(c3)
            A2k = _shiftk2(c2)
            ops = select_operands(plane0, row0m, col0m, k1m, A, Bv, Cv,
                                  Gv, Dg, Ev, Fv, A2k, one)
            val = recon_bits(
                # pred from the same op sequence; force/escape handling
                # is by the type stream here
                predict_bits(*ops)[0],
                jnp.take(pte, tl), jnp.take(pth, tl),
                jnp.take(ptl, tl))
            esc = tl == _i(0)
            out = jnp.where(esc, kvl, val)
            carry_rec = jnp.where(esc, kvl & _u(0x7FFFFFFF), val)
            out = jnp.where(valid, out, _u(0))
            carry_rec = jnp.where(valid, carry_rec, _u(0))
            return (carry_rec, c1, c2, s + 1), out

        (c1, c2, c3, _s), out_sl = jax.lax.scan(
            step, (c1, c2, c3, base), (t_sl, kv_sl))
        return out_sl, c1, c2, c3

    return eng._strict_jit(f, backend)
