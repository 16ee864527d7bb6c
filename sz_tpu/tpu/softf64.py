"""Software IEEE-754 binary64 arithmetic on uint32 lanes (magnitude only).

The MSST19 multiplicative chains (sz_float.c `double temp, temp2`
predictor arithmetic, szd_float.c decode replay) need TRUE f64
semantics: a float-float f64 emulation carries ~49 significand bits
and rounds differently within ~2^-48 of f32 ties, which seeds unbounded
divergence through the multiplicative predictor (msst19_engine module
docstring).  This module implements the exact operations the chain
needs in pure u32/i32/f32 jnp ops — correctly rounded by construction,
traceable under plain XLA on backends without IEEE f64 (no f64, no
u32<->f32 casts, no 64-bit integers: u32 mul/shift-by-vector/
unsigned-compare, i32<->f32 converts, bitcasts).

Key simplification: the MSST19 chain is SIGN-FREE.  Every predictor is
a product/quotient (no additions), the cache-table key masks the sign
bit, and reconstructions are |pred| * precisionTable[state]; escape
reconstructions truncate low mantissa bits, which commutes with |.|.
So all values here are MAGNITUDES.

Representation of a finite nonzero f64 magnitude: (e: int32, mh:
uint32, ml: uint32) with value = M * 2^(e-52), M = mh*2^32 + ml in
[2^52, 2^53) (mh in [2^20, 2^21)).  Zero: mh = ml = 0, e = E_ZERO.
Inf/NaN never ARISE mid-chain (products/quotients of <= 4+3 float32
magnitudes span 2^-959..2^959, strictly inside the f64 normal range);
nonfinite OPERANDS are screened by the caller (they force the escape
state in the codec, so their chain value is never used).

f32 magnitudes: (e: int32, m: uint32) with value = m * 2^(e-23),
m in [2^23, 2^24) (subnormals normalized by unpack_f32_mag).

Every rounding is round-to-nearest-even, verified bit-exact against
numpy's IEEE f64/f32 in tests/test_softf64.py (random + directed tie /
subnormal / overflow cases)."""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

_U32 = jnp.uint32
_I32 = jnp.int32
_F32 = jnp.float32

E_ZERO = np.int32(-0x100000)


def _u(x):
    return jnp.uint32(x)


def _i(x):
    return jnp.int32(x)


def _f(x):
    return jnp.float32(np.float32(x))


def _bits_f32(f):
    return jax.lax.bitcast_convert_type(f, _U32)


def _nz32(x):
    """(x != 0) as uint32 0/1."""
    return (x != _u(0)).astype(_U32)


# ---------------------------------------------------------------------------
# f32 unpack
# ---------------------------------------------------------------------------

def unpack_f32_mag(bits):
    """f32 bit pattern -> (e i32, m u32 in [2^23,2^24), zero, nonfinite).

    Magnitude only (sign bit ignored).  Subnormals are normalized: the
    leading-bit position comes from the exact i32->f32 convert of the
    raw mantissa (< 2^23, exactly convertible)."""
    b = bits & _u(0x7FFFFFFF)
    e8 = (b >> _u(23)).astype(_I32)
    m = b & _u(0x7FFFFF)
    zero = b == _u(0)
    nonfinite = e8 == _i(255)
    sub = (e8 == _i(0)) & ~zero
    fm = _bits_f32(m.astype(_I32).astype(_F32))
    hb = ((fm >> _u(23)) & _u(0xFF)).astype(_I32) - _i(127)
    sh = jnp.clip(_i(23) - hb, _i(0), _i(31)).astype(_U32)
    m24 = jnp.where(sub, m << sh, m | _u(0x800000))
    e = jnp.where(sub, hb - _i(149), e8 - _i(127))
    e = jnp.where(zero, jnp.full_like(e, E_ZERO), e)
    m24 = jnp.where(zero, _u(0), m24)
    return e, m24, zero, nonfinite


def widen24(e, m):
    """Exact f32 magnitude -> 53-bit representation (never rounds)."""
    return e, m >> _u(3), m << _u(29)


# ---------------------------------------------------------------------------
# multiply
# ---------------------------------------------------------------------------

def mul24_exact(e1, m1, e2, m2):
    """Exact product of two f32 magnitudes -> 53-bit rep (<= 48
    significant bits: never rounds; the C chain's first f64 multiply
    of two widened floats is exact the same way)."""
    a0 = m1 & _u(0xFFFF)
    a1 = m1 >> _u(16)
    b0 = m2 & _u(0xFFFF)
    b1 = m2 >> _u(16)
    p00 = a0 * b0
    mid = a0 * b1 + a1 * b0          # < 2^25: no overflow
    p11 = a1 * b1
    lo = p00 + (mid << _u(16))
    ca = (lo < p00).astype(_U32)
    hi = p11 + (mid >> _u(16)) + ca  # P = hi*2^32 + lo in [2^46, 2^48)
    big = hi >= _u(1 << 15)          # msb 47 vs 46
    sh = jnp.where(big, _u(5), _u(6))
    mh = (hi << sh) | (lo >> (_u(32) - sh))
    ml = lo << sh
    e = e1 + e2 + jnp.where(big, _i(1), _i(0))
    z = (m1 == _u(0)) | (m2 == _u(0))
    return (jnp.where(z, jnp.full_like(e, E_ZERO), e),
            jnp.where(z, _u(0), mh), jnp.where(z, _u(0), ml))


def mul53x24_rn(e1, mh, ml, eb, mb):
    """RN53( (53-bit magnitude) * (f32 magnitude) ) — one f64 multiply
    of a running double by a widened float, rounded to nearest-even
    exactly as hardware f64 would.  Multiplying by 1.0 (eb=0,
    mb=2^23) is exact, which is how callers express 'no factor'."""
    x0 = ml & _u(0xFFFF)
    x1 = ml >> _u(16)
    x2 = mh & _u(0xFFFF)
    x3 = mh >> _u(16)                # < 2^5
    b0 = mb & _u(0xFFFF)
    b1 = mb >> _u(16)                # < 2^8
    c0 = x0 * b0
    c1 = x1 * b0
    t1 = c1 + x0 * b1
    cc1 = (t1 < c1).astype(_U32)
    c2 = x2 * b0
    t2 = c2 + x1 * b1
    cc2 = (t2 < c2).astype(_U32)
    t3 = x3 * b0 + x2 * b1           # < 2^25: no overflow
    t4 = x3 * b1                     # < 2^13
    # accumulate into 3 words: P = w2*2^64 + w1*2^32 + w0
    w0 = c0 + (t1 << _u(16))
    k0 = (w0 < c0).astype(_U32)
    w1a = (t1 >> _u(16)) + (cc1 << _u(16)) + k0
    w1b = w1a + t2
    k1 = (w1b < w1a).astype(_U32)
    w1 = w1b + (t3 << _u(16))
    k2 = (w1 < w1b).astype(_U32)
    w2 = t4 + cc2 + k1 + k2 + (t3 >> _u(16))   # in [2^11, 2^13)
    # normalize: msb 76 iff w2 >= 2^12; shift right by k in {24, 23}
    big = w2 >= _u(1 << 12)
    k = jnp.where(big, _u(24), _u(23))
    s_lo = (w0 >> k) | (w1 << (_u(32) - k))
    s_mid = (w1 >> k) | (w2 << (_u(32) - k))
    rbit = (w0 >> (k - _u(1))) & _u(1)
    sticky = _nz32(w0 & ((_u(1) << (k - _u(1))) - _u(1)))
    inc = rbit & (sticky | (s_lo & _u(1)))
    ml_o = s_lo + inc
    carry = ((ml_o == _u(0)) & (inc == _u(1))).astype(_U32)
    mh_o = s_mid + carry
    ovf = mh_o == _u(1 << 21)        # rounded up to 2^53
    ml_o2 = jnp.where(ovf, (ml_o >> _u(1)) | (mh_o << _u(31)), ml_o)
    mh_o2 = jnp.where(ovf, mh_o >> _u(1), mh_o)
    e = (e1 + eb + jnp.where(big, _i(1), _i(0))
         + jnp.where(ovf, _i(1), _i(0)))
    z = (mb == _u(0)) | ((mh == _u(0)) & (ml == _u(0)))
    return (jnp.where(z, jnp.full_like(e, E_ZERO), e),
            jnp.where(z, _u(0), mh_o2), jnp.where(z, _u(0), ml_o2))


# ---------------------------------------------------------------------------
# divide
# ---------------------------------------------------------------------------

def _shl18(w0, w1, w2):
    """(w2,w1,w0) << 18 — value must stay under 2^78."""
    return (w0 << _u(18),
            (w1 << _u(18)) | (w0 >> _u(14)),
            (w2 << _u(18)) | (w1 >> _u(14)))


def _sub3(a0, a1, a2, b0, b1, b2):
    """3-word two's-complement subtract (word order lo, mid, hi)."""
    d0 = a0 - b0
    bw0 = (a0 < b0).astype(_U32)
    t = a1 - b1
    bwa = (a1 < b1).astype(_U32)
    d1 = t - bw0
    bwb = (t < bw0).astype(_U32)
    d2 = a2 - b2 - (bwa | bwb)
    return d0, d1, d2


def _add3(a0, a1, a2, b0, b1, b2):
    s0 = a0 + b0
    c0 = (s0 < a0).astype(_U32)
    t = a1 + b1
    ca = (t < a1).astype(_U32)
    s1 = t + c0
    cb = (s1 < t).astype(_U32)
    s2 = a2 + b2 + (ca | cb)
    return s0, s1, s2


def _mulq53(q, dh, dl):
    """(q u32 < 2^20) * (53-bit D) -> 3 words (< 2^73)."""
    ql = q & _u(0xFFFF)
    qh = q >> _u(16)                 # < 2^4
    x0 = dl & _u(0xFFFF)
    x1 = dl >> _u(16)
    x2 = dh & _u(0xFFFF)
    x3 = dh >> _u(16)                # < 2^5
    c0 = ql * x0
    c1a = ql * x1
    c1 = c1a + qh * x0
    k1 = (c1 < c1a).astype(_U32)
    c2a = ql * x2
    c2 = c2a + qh * x1
    k2 = (c2 < c2a).astype(_U32)
    c3 = ql * x3 + qh * x2           # < 2^22: no overflow
    c4 = qh * x3                     # < 2^9
    w0 = c0 + (c1 << _u(16))
    j0 = (w0 < c0).astype(_U32)
    w1a = (c1 >> _u(16)) + (k1 << _u(16)) + j0
    w1b = w1a + c2
    j1 = (w1b < w1a).astype(_U32)
    w1 = w1b + (c3 << _u(16))
    j2 = (w1 < w1b).astype(_U32)
    w2 = c4 + k2 + j1 + j2 + (c3 >> _u(16))
    return w0, w1, w2


def _approx_scaled(w0, w1, w2):
    """f32 ~ (3-word value) * 2^-32 (drops w0 and the low 9 bits of
    w1: relative error ~2^-22 against a >= 2^52-scale value — the
    quotient-chunk estimates only need absolute error < 1)."""
    hi = w2.astype(_I32).astype(_F32)                      # < 2^23
    mid = (w1 >> _u(9)).astype(_I32).astype(_F32)          # < 2^23
    return hi * _f(4294967296.0) + mid * _f(512.0)


_N_FIX = 1   # conditional correction rounds per chunk each way.
             # Provably sufficient: the chunk estimate's error is
             # |delta| <= ~0.15 before truncation (approx value drops
             # <= 2^9 absolute against a >= 2^52-scale operand, the
             # Newton-refined reciprocal is f32-accurate, products are
             # exactly rounded), so floor(true + delta) is within ONE
             # of the true digit in each direction — verified by the
             # exhaustive random + adversarial boundary tests
             # (tests/test_softf64.py) and the hardware parity gates.


def _div_chunk(r0, r1, r2, dh, dl, rcp):
    """One 18-bit long-division chunk: q = floor(R*2^18 / D), new
    remainder.  Preconditions: R < D (3rd word zero after the previous
    chunk), rcp ~ 2^32/D."""
    s0, s1, s2 = _shl18(r0, r1, r2)
    qf = _approx_scaled(s0, s1, s2) * rcp
    q = jnp.clip(qf.astype(_I32), _i(0), _i(1 << 19)).astype(_U32)
    p0, p1, p2 = _mulq53(q, dh, dl)
    r0, r1, r2 = _sub3(s0, s1, s2, p0, p1, p2)
    for _ in range(_N_FIX):
        neg = (r2 >> _u(31)) != _u(0)
        a0, a1, a2 = _add3(r0, r1, r2, dl, dh, _u(0) * dl)
        r0 = jnp.where(neg, a0, r0)
        r1 = jnp.where(neg, a1, r1)
        r2 = jnp.where(neg, a2, r2)
        q = q - neg.astype(_U32)
    for _ in range(_N_FIX):
        ge = (r2 != _u(0)) | (r1 > dh) | ((r1 == dh) & (r0 >= dl))
        m0, m1, m2 = _sub3(r0, r1, r2, dl, dh, _u(0) * dl)
        r0 = jnp.where(ge, m0, r0)
        r1 = jnp.where(ge, m1, r1)
        r2 = jnp.where(ge, m2, r2)
        q = q + ge.astype(_U32)
    return q, r0, r1, r2


def div53_rn(e1, nh, nl, e2, dh, dl):
    """RN53( N / D ) for 53-bit magnitudes — a correctly rounded f64
    division (the C chain's `temp / temp2`).  Precondition: D nonzero
    finite (callers screen: such points escape in the codec anyway).
    N zero -> zero.

    Long division in three exact 18-bit chunks: each chunk's quotient
    digit comes from an f32 estimate against the Newton-refined
    reciprocal and is corrected to the true floor by exact multi-word
    remainder arithmetic; the final 54-bit quotient + remainder give
    the round/sticky bits for a provably correct RN53."""
    zero3 = _u(0) * dl
    # df ~ D * 2^-32 with ~2^-23 relative error (dh exact, top 23 bits
    # of dl folded in) — the reciprocal's accuracy bounds every chunk's
    # quotient-estimate error, which must stay within the _N_FIX budget
    df = (dh.astype(_I32).astype(_F32)
          + (dl >> _u(9)).astype(_I32).astype(_F32) * _f(2.0 ** -23))
    rcp = _f(1.0) / df
    rcp = rcp * (_f(2.0) - df * rcp)           # Newton: ~f32-accurate
    # fold N >= D into the leading quotient bit so every chunk runs
    # with R < D: N/D in [1,2) has implicit bit 2^54 of Q = N*2^54/D
    nge = (nh > dh) | ((nh == dh) & (nl >= dl))
    s0, s1, s2 = _sub3(nl, nh, zero3, dl, dh, zero3)
    r0 = jnp.where(nge, s0, nl)
    r1 = jnp.where(nge, s1, nh)
    r2 = zero3
    q1, r0, r1, r2 = _div_chunk(r0, r1, r2, dh, dl, rcp)
    q2, r0, r1, r2 = _div_chunk(r0, r1, r2, dh, dl, rcp)
    q3, r0, r1, r2 = _div_chunk(r0, r1, r2, dh, dl, rcp)
    # compose Qfrac = q1*2^36 + q2*2^18 + q3 (quotient chunks < 2^18
    # by the R < D invariant; 2-word value < 2^54)
    qlo = q3 + (q2 << _u(18))
    kc = (qlo < q3).astype(_U32)
    qhi = (q2 >> _u(14)) + (q1 << _u(4)) + kc
    sticky = _nz32(r0 | r1 | r2)
    # nge:  Q = 2^54 + Qfrac in [2^54, 2^55) -> M = Q >> 2
    # ~nge: Q = Qfrac in [2^53, 2^54)        -> M = Q >> 1
    ml_a = (qlo >> _u(2)) | (qhi << _u(30))
    mh_a = (qhi >> _u(2)) | _u(1 << 20)
    rb_a = (qlo >> _u(1)) & _u(1)
    st_a = sticky | (qlo & _u(1))
    ml_b = (qlo >> _u(1)) | (qhi << _u(31))
    mh_b = qhi >> _u(1)
    rb_b = qlo & _u(1)
    ml_o = jnp.where(nge, ml_a, ml_b)
    mh_o = jnp.where(nge, mh_a, mh_b)
    rbit = jnp.where(nge, rb_a, rb_b)
    stk = jnp.where(nge, st_a, sticky)
    inc = rbit & (stk | (ml_o & _u(1)))
    ml_r = ml_o + inc
    carry = ((ml_r == _u(0)) & (inc == _u(1))).astype(_U32)
    mh_r = mh_o + carry
    ovf = mh_r == _u(1 << 21)
    ml_f = jnp.where(ovf, (ml_r >> _u(1)) | (mh_r << _u(31)), ml_r)
    mh_f = jnp.where(ovf, mh_r >> _u(1), mh_r)
    e = (e1 - e2 + jnp.where(nge, _i(0), _i(-1))
         + jnp.where(ovf, _i(1), _i(0)))
    z = (nh == _u(0)) & (nl == _u(0))
    return (jnp.where(z, jnp.full_like(e, E_ZERO), e),
            jnp.where(z, _u(0), mh_f), jnp.where(z, _u(0), ml_f))


# ---------------------------------------------------------------------------
# f64 -> f32 rounding
# ---------------------------------------------------------------------------

def pack_f32_rn(e, mh, ml):
    """Round a 53-bit magnitude to its f32 bit pattern — the exact
    (float) cast of the RN53 double, including subnormal f32 results,
    gradual underflow ties, and overflow to +inf.  Zero -> 0 bits."""
    zero = (mh == _u(0)) & (ml == _u(0))
    # shift amount: 29 for normals, + (-126 - e) extra for subnormals,
    # clamped to 54 (values below half the minimum subnormal round to
    # zero; exactly half ties to even = zero)
    # clips stay in SIGNED i32 before the u32 casts
    t = jnp.clip(_i(29) + jnp.maximum(_i(0), _i(-126) - e),
                 _i(29), _i(54))
    tu = t.astype(_U32)
    lo_path = t <= _i(31)
    tc = jnp.clip(t, _i(0), _i(31)).astype(_U32)
    keep_lo = (ml >> tc) | (mh << (_u(32) - tc))
    rb_lo = (ml >> (tc - _u(1))) & _u(1)
    st_lo = _nz32(ml & ((_u(1) << (tc - _u(1))) - _u(1)))
    t2 = jnp.clip(t - _i(32), _i(0), _i(22)).astype(_U32)
    t3 = jnp.clip(t - _i(33), _i(0), _i(31)).astype(_U32)
    keep_hi = mh >> t2
    rb_hi = jnp.where(tu == _u(32), ml >> _u(31), (mh >> t3) & _u(1))
    st_hi = (_nz32(ml)
             | jnp.where(tu <= _u(32), _u(0),
                         _nz32(mh & ((_u(1) << t3) - _u(1)))))
    keep = jnp.where(lo_path, keep_lo, keep_hi)
    rbit = jnp.where(lo_path, rb_lo, rb_hi)
    sticky = jnp.where(lo_path, st_lo, st_hi)
    inc = rbit & (sticky | (keep & _u(1)))
    ebase = jnp.clip(e + _i(126), _i(0), _i(255)).astype(_U32)
    # normals: keep in [2^23,2^24) so (ebase<<23)+keep+inc composes the
    # biased exponent and mantissa together, with rounding carry and
    # subnormal->normal promotion rolling into the exponent naturally
    bits = (ebase << _u(23)) + keep + inc
    # overflow -> +inf (unsigned compare+select: Mosaic lacks minui)
    bits = jnp.where(bits >= _u(0x7F800000), _u(0x7F800000), bits)
    return jnp.where(zero, _u(0), bits)


# ---------------------------------------------------------------------------
# correctly rounded f32 division (the `float ratio = cur / pred`)
# ---------------------------------------------------------------------------

def _div24_chunk(r0, r1, pm, q_init_f):
    """13-bit chunk of the 24-bit division: q = floor(R*2^13 / pm).
    R arrives as (r0 < 2^24) single-word; returns single-word R'."""
    w0 = r0 << _u(13)
    w1 = r0 >> _u(19)
    q = jnp.clip(q_init_f.astype(_I32), _i(0),
                 _i(1 << 15)).astype(_U32)
    p0 = q * (pm & _u(0xFFFF))
    p1h = q * (pm >> _u(16))                 # < 2^15 * 2^8 = 2^23
    a0 = p0 + (p1h << _u(16))
    ka = (a0 < p0).astype(_U32)
    a1 = (p1h >> _u(16)) + ka
    r0n = w0 - a0
    bw = (w0 < a0).astype(_U32)
    r1n = w1 - a1 - bw
    for _ in range(_N_FIX):
        neg = (r1n >> _u(31)) != _u(0)
        s0 = r0n + pm
        c0 = (s0 < r0n).astype(_U32)
        r1n = jnp.where(neg, r1n + c0, r1n)
        r0n = jnp.where(neg, s0, r0n)
        q = q - neg.astype(_U32)
    for _ in range(_N_FIX):
        ge = (r1n != _u(0)) | (r0n >= pm)
        d0 = r0n - pm
        bb = (r0n < pm).astype(_U32)
        r1n = jnp.where(ge, r1n - bb, r1n)
        r0n = jnp.where(ge, d0, r0n)
        q = q + ge.astype(_U32)
    return q, r0n


def div24_f32_rn(ce, cm, pe, pm):
    """f32 bit pattern of RN24(|cur| / |pred|) from unpacked f32
    magnitudes — a correctly rounded single float division including
    subnormal results and overflow to +inf.  cur zero -> 0; pred zero
    -> +inf (the C's x/0 with nonzero x; 0/0 would be NaN in C, but
    both key out of the cache range identically, forcing the escape
    state — we return +inf)."""
    cf = cm.astype(_I32).astype(_F32)
    pf = pm.astype(_I32).astype(_F32)
    rcp = _f(1.0) / pf
    rcp = rcp * (_f(2.0) - pf * rcp)
    rcp13 = rcp * _f(8192.0)
    q1, r = _div24_chunk(cm, _u(0) * cm, pm, cf * rcp13)
    rf = r.astype(_I32).astype(_F32)         # R < pm < 2^24: exact
    q2, r = _div24_chunk(r, _u(0) * cm, pm, rf * rcp13)
    Q = (q1 << _u(13)) + q2                  # floor(cm*2^26/pm) < 2^27
    sticky0 = _nz32(r)
    lead26 = Q >= _u(1 << 26)                # cm >= pm: ratio in [1,2)
    e_out = ce - pe + jnp.where(lead26, _i(0), _i(-1))
    lead = jnp.where(lead26, _i(26), _i(25))
    t = (lead - _i(23)) + jnp.maximum(_i(0), _i(-126) - e_out)
    t = jnp.clip(t, _i(1), _i(31)).astype(_U32)
    keep = Q >> t
    rbit = (Q >> (t - _u(1))) & _u(1)
    sticky = sticky0 | _nz32(Q & ((_u(1) << (t - _u(1))) - _u(1)))
    inc = rbit & (sticky | (keep & _u(1)))
    ebase = jnp.clip(e_out + _i(126), _i(0), _i(255)).astype(_U32)
    bits = (ebase << _u(23)) + keep + inc
    bits = jnp.where(bits >= _u(0x7F800000), _u(0x7F800000), bits)
    bits = jnp.where(cm == _u(0), _u(0), bits)
    bits = jnp.where(pm == _u(0), _u(0x7F800000), bits)
    return bits


# ---------------------------------------------------------------------------
# host-side helpers
# ---------------------------------------------------------------------------

def unpack_f64_host(vals: np.ndarray):
    """Precompute the (e, mh, ml, nonfinite u8) arrays for an f64 table
    (the MSST19 precisionTable) on the host — subnormal-normalized so
    kernels never see denormal table mantissas."""
    v = np.ascontiguousarray(vals, np.float64)
    bits = v.view(np.uint64) & np.uint64(0x7FFFFFFFFFFFFFFF)
    e11 = (bits >> np.uint64(52)).astype(np.int64)
    m52 = (bits & np.uint64(0x000FFFFFFFFFFFFF)).astype(np.uint64)
    zero = bits == 0
    nonfinite = e11 == 2047
    M = np.where(e11 > 0, m52 | np.uint64(1 << 52), m52).astype(
        np.uint64)
    e = np.where(e11 > 0, e11 - 1023, np.int64(-1022)).astype(np.int64)
    sub = (e11 == 0) & ~zero
    if sub.any():                    # normalize f64 subnormals
        idx = np.flatnonzero(sub)
        for i in idx:
            mm = int(M[i])
            shift = 53 - mm.bit_length()
            M[i] = np.uint64(mm << shift)
            e[i] = e[i] - shift
    e = np.where(zero, np.int64(E_ZERO), e)
    M = np.where(zero, np.uint64(0), M)
    mh = (M >> np.uint64(32)).astype(np.uint32)
    ml = (M & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    return (e.astype(np.int32), mh, ml, nonfinite.astype(np.uint8))
