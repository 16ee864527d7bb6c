"""Device (JAX/XLA) engine for the SZ2.1 blocked-regression codec.

This is the data-parallel re-expression of the reference hot loop
(SZ_compress_float_3D_MDQ_nonblocked_with_blocked_regression,
sz_float.c:6527; 2D sz_float.c:5516; double sz_double.c:5904/:4900), not a
translation.  The reference is a single serial sweep in which every point's
quantization depends on the *reconstructed* values of its already-processed
neighbors.  On the device we split the work by data-dependency structure:

  * per-block regression coefficient sums — embarrassingly parallel
    reductions, vectorized over all blocks at once (the accumulation order
    inside a block is preserved exactly, so results are bit-identical);
  * predictor selection — vectorized sampling over all blocks (reads only
    original data, sz_float.c:6746-6786);
  * regression-block quantization — the regression predictor reads only the
    block's plane coefficients, never neighbors, so every regression point
    quantizes in parallel in one shot;
  * Lorenzo-block quantization — the only true recurrence.  We solve it by
    **fixpoint iteration on the reconstruction lattice**: start from the
    original data as the estimate of the reconstruction, apply the
    elementwise predict+quantize map to every point simultaneously, and
    repeat until the lattice is bit-stable.  Because the reference's
    dependency graph is acyclic (raster order), each sweep makes at least
    one more wavefront of points exactly correct, so the iteration provably
    converges to the *bit-exact* serial result in at most depth(=r1+r2+r3)
    sweeps — and in practice in a handful, because the quantizer re-centers
    each estimate to within one bin of the original value.

Escapes ("unpredictable" points), the mean-flush bin and the machine-epsilon
recheck (sz_float.c:6834) are all folded into the same elementwise map.
The serial encoder only ever *reads* reconstructed values that it has
published into its rolling strip buffers (block edge planes,
sz_float.c:6673-6693); every such read position is published in our full
reconstruction lattice too, so the lattice formulation is equivalent.

The small strictly-serial chains (coefficient delta-quantization, Huffman
tree construction, byte assembly) run on the host where they are O(#blocks),
shared with the numpy oracle in sz_tpu.core.regnd.
"""

from __future__ import annotations

import functools

import numpy as np

import jax

jax.config.update("jax_enable_x64", True)

# Persistent compilation cache: every engine build is shape-specialized,
# so compiled executables are kept across processes.  JAX reads
# JAX_COMPILATION_CACHE_DIR itself; without it the cache lives at a fixed
# path inside the checkout (listed in .gitignore).
import os as _os  # noqa: E402

if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    try:  # pragma: no cover - best effort
        _cache_dir = _os.path.join(
            _os.path.dirname(_os.path.dirname(_os.path.dirname(
                _os.path.abspath(__file__)))), ".jax_cache")
        _os.makedirs(_cache_dir, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", _cache_dir)
    except Exception:
        pass
jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)

import jax.numpy as jnp  # noqa: E402

from sz_tpu.core import blocks as B  # noqa: E402
from sz_tpu.core import optimizer as opt  # noqa: E402
from sz_tpu.core import regnd  # noqa: E402
from sz_tpu.core.regnd import EncodeResult  # noqa: E402
from sz_tpu.utils import trace as _tr  # noqa: E402


# --- routing policy (one place; see README "Runtime configuration") --------

def device_decode_policy(backend: str) -> bool:
    """Huffman decode on the device (fsm_kernel, a Triton kernel) on
    the GPU; other backends decode on the host."""
    return backend == "gpu"


def device_bitpack_policy() -> bool:
    """Pack the entropy stream on device (download packed bits) vs
    download the raw u16 types and pack on the host
    (SZ_TPU_DEVICE_BITPACK: 1|0 — backend-independent: it trades
    transfer volume, not kernel speed)."""
    return _os.environ.get("SZ_TPU_DEVICE_BITPACK", "1") != "0"


# ---------------------------------------------------------------------------
# Geometry (host, cached per shape)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=16)
def _geom_small(shape: tuple, block_size: int):
    """Per-dimension geometry vectors only — O(r) host work (the full
    lattices are built on device by _dev_geom; at 512^3 they are
    gigabytes)."""
    dbs = [B.dim_blocks(r, block_size) for r in shape]
    loc, bid, cnt = [], [], []
    for db in dbs:
        counts = db.counts()
        bid.append(np.repeat(np.arange(db.num, dtype=np.int32), counts))
        loc.append((np.arange(db.r)
                    - np.repeat(db.starts(), counts)).astype(np.int32))
        cnt.append(np.repeat(counts, counts).astype(np.int32))
    if len(shape) == 3:
        bsizes = (dbs[0].counts()[:, None, None]
                  * dbs[1].counts()[None, :, None]
                  * dbs[2].counts()[None, None, :]).ravel()
    else:
        bsizes = (dbs[0].counts()[:, None]
                  * dbs[1].counts()[None, :]).ravel()
    offsets = np.concatenate([[0], np.cumsum(bsizes)[:-1]]).astype(np.int32)
    return {"dbs": dbs, "loc": loc, "bid": bid, "cnt": cnt,
            "offsets": offsets,
            "nblocks": int(np.prod([db.num for db in dbs]))}


def lattices(shape: tuple, block_size: int):
    """Traceable jnp builder of the geometry lattices from the per-dim
    vectors (embedded as small constants): bflat (block id per point),
    pos (stream position per point), iperm (lattice index per stream
    position).  Usable inside any jit/shard_map (parallel/slab)."""
    g = _geom_small(shape, block_size)
    rank = len(shape)
    n = int(np.prod(shape))
    bid = [jnp.asarray(b) for b in g["bid"]]
    loc = [jnp.asarray(l) for l in g["loc"]]
    cnt = [jnp.asarray(c) for c in g["cnt"]]
    offsets = jnp.asarray(g["offsets"])
    if rank == 3:
        bflat = ((bid[0][:, None, None] * g["dbs"][1].num
                  + bid[1][None, :, None]) * g["dbs"][2].num
                 + bid[2][None, None, :])
        intra = ((loc[0][:, None, None] * cnt[1][None, :, None]
                  + loc[1][None, :, None]) * cnt[2][None, None, :]
                 + loc[2][None, None, :])
    else:
        bflat = bid[0][:, None] * g["dbs"][1].num + bid[1][None, :]
        intra = loc[0][:, None] * cnt[1][None, :] + loc[1][None, :]
    pos = offsets[bflat] + intra
    iperm = jnp.zeros((n,), jnp.int32).at[pos.reshape(-1)].set(
        jnp.arange(n, dtype=jnp.int32))
    return bflat, pos, iperm


def _host_stream_maps(shape: tuple, block_size: int):
    """numpy mirror of `lattices` — (pos, iperm) on the host.  Used by
    host-side fallbacks that need the block-stream ordering without a
    device round-trip (parallel/slab escape overflow path)."""
    g = _geom_small(shape, block_size)
    rank = len(shape)
    n = int(np.prod(shape))
    bid, loc, cnt = g["bid"], g["loc"], g["cnt"]
    if rank == 3:
        bflat = ((bid[0][:, None, None] * g["dbs"][1].num
                  + bid[1][None, :, None]) * g["dbs"][2].num
                 + bid[2][None, None, :])
        intra = ((loc[0][:, None, None] * cnt[1][None, :, None]
                  + loc[1][None, :, None]) * cnt[2][None, None, :]
                 + loc[2][None, None, :])
    else:
        bflat = bid[0][:, None] * g["dbs"][1].num + bid[1][None, :]
        intra = loc[0][:, None] * cnt[1][None, :] + loc[1][None, :]
    pos = g["offsets"][bflat] + intra
    iperm = np.zeros((n,), np.int32)
    iperm[pos.reshape(-1)] = np.arange(n, dtype=np.int32)
    return pos, iperm


def _corner_box_to_lattice(seg, esizes: tuple):
    """(c0..ck, prod(esizes)) corner segment -> its (c0*E0, .., ck*Ek)
    lattice region (one blocked transpose)."""
    rank = len(esizes)
    cs = tuple(int(c) for c in seg.shape[:-1])
    perm = tuple(v for i in range(rank) for v in (i, rank + i))
    out_shape = tuple(c * e for c, e in zip(cs, esizes))
    return seg.reshape(cs + esizes).transpose(perm).reshape(out_shape)


def _corner_unstream(x, dbs, shape: tuple):
    """COMPACT block-major stream (n elements, no holes) -> lattice,
    gather-free and hole-free.

    Along each axis the `split` early blocks (length `early`) precede
    the late blocks (length `late`) CONTIGUOUSLY (core/blocks.py
    dim_blocks), so the stream partitions hierarchically into <= 2^rank
    corner segments whose in-block boxes are UNIFORM: each level's
    split is one static slice + reshape, each corner is one blocked
    transpose, and the lattice reassembles by per-axis concatenation.
    Replaces jnp.take(stream, pos) (a per-point gather) with pure
    bandwidth ops."""
    rank = len(shape)
    parts = []
    for db in dbs:
        p = []
        if db.split:
            p.append((db.split, db.early))
        if db.num - db.split:
            p.append((db.num - db.split, db.late))
        parts.append(p)

    def rec(seg, ax, eprod, esizes):
        if ax == rank:
            return _corner_box_to_lattice(seg, esizes)
        inner = int(np.prod(shape[ax + 1:], dtype=np.int64))
        outs, off = [], 0
        for cnt, esz in parts[ax]:
            ln = cnt * esz * eprod * inner
            sub = jax.lax.slice_in_dim(seg, off, off + ln,
                                       axis=seg.ndim - 1)
            sub = sub.reshape(seg.shape[:-1] + (cnt, esz * eprod * inner))
            outs.append(rec(sub, ax + 1, eprod * esz, esizes + (esz,)))
            off += ln
        return outs[0] if len(outs) == 1 else jnp.concatenate(outs, ax)

    return rec(x, 0, 1, ())


@functools.lru_cache(maxsize=16)
def _dev_geom(shape: tuple, block_size: int, backend: str = "cpu"):
    """Device-resident geometry lattices (cached jit of `lattices`).
    Only the v1 (gather-based) stream paths need the full n-sized
    pos/iperm lattices — the v2 pipeline uses _dev_loc instead (at
    512^3 these are 3 x 0.5 GB of HBM and a multi-second build)."""
    g = _geom_small(shape, block_size)
    bflat, pos, iperm = _strict_jit(
        lambda: lattices(shape, block_size), backend)()
    return {
        "bflat": bflat,
        "pos": pos,
        "iperm": iperm,
        "loc": [jax.device_put(l) for l in g["loc"]],
    }


@functools.lru_cache(maxsize=16)
def _dev_loc(shape: tuple, block_size: int):
    """Just the per-axis in-block offset vectors on device (O(r) data;
    the only geometry the v2 gather-free pipeline needs)."""
    g = _geom_small(shape, block_size)
    return [jax.device_put(l) for l in g["loc"]]


# ---------------------------------------------------------------------------
# Elementwise quantizer (sz_float.c:6826-6845 / regnd._quant_point)
# ---------------------------------------------------------------------------

def _quant(cur, pred, rp, recip, capf, radius):
    """Vectorized predict->quantize with escape + epsilon recheck.

    Every intermediate rounds in the data dtype exactly like the serial C
    (each jnp op is a separately rounded HLO op; XLA does not contract
    mul+add into FMA).
    """
    T = cur.dtype
    diff = cur - pred
    itv = jnp.abs(diff) * recip + jnp.asarray(1, T)
    within = itv < capf
    itv = jnp.where(diff < 0, -itv, itv)
    t = (itv / jnp.asarray(2, T)).astype(jnp.int32) + radius
    rec = pred + (2 * (t - radius)).astype(T) * rp
    ok = within & (jnp.abs(cur - rec) <= rp)
    return jnp.where(ok, t, 0), jnp.where(ok, rec, cur)


def _strict_jit(f, backend: str):
    """jit with bit-strict compilation per backend.

    XLA:CPU contracts mul+add into FMA inside fused loops — no debug flag
    disables it and lax.optimization_barrier is stripped before fusion —
    which breaks bit-parity with the serial C (verified: last-ulp coeff
    differences).  Disabling the `fusion` pass on CPU restores strict
    per-op rounding (tests / virtual-mesh runs only; small arrays).
    XLA:GPU does not contract: on an H100, fused a*b+c and |d|*r+1 in
    f32 and f64 match numpy's separately rounded ops on 2^22 elements,
    and the 512^3 streams are byte-equal to the host engine's
    (chip_smoke.py), so full fusion stays on for the GPU.  XLA:GPU does,
    by default, drop f64->f32->f64 round trips ("excess precision"),
    which skips the C's rounding of a float intermediate (the MSST19
    chains round predictions to float before dividing in double); the
    GPU build turns that off.
    """
    if backend == "raw":
        return f  # for callers embedding in an outer jit (parallel/slab)
    if backend == "cpu":
        return jax.jit(f, compiler_options={
            "xla_disable_hlo_passes": "fusion"})
    return jax.jit(f, compiler_options={"xla_allow_excess_precision": False})


def _same_bits(a, b):
    """Convergence check: plain value equality is sufficient for bitwise
    convergence.  Reconstruction outputs depend only on the *numeric*
    values of their inputs — a zero's sign cannot propagate: escapes and
    the mean flush copy fixed inputs verbatim, and every computed rec is
    `pred + q` whose result is +0 whenever it is zero-valued (IEEE
    round-to-nearest: x + (-x) = +0, and q==+0 forces p + (+0) = +0 even
    for p = -0).  So once the lattice is value-stable, one more sweep (the
    one that produced R_new) yields the bit-exact serial result.
    NaN inputs never converge and fall out via the max_iter bound."""
    return jnp.all(a == b)


# ---------------------------------------------------------------------------
# Stage 1: regression coefficient sums (vectorized over all blocks)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=32)
def _coeff_sums_fn(shape: tuple, dtype_str: str, block_size: int,
                   backend: str = 'cpu'):
    """Build a jitted fn: data -> per-block sums [fx, fy(, fz), f].

    Accumulation order inside a block matches the serial C loops
    (sz_float.c:6596-6637) so float rounding is identical; blocks
    vectorize freely because blocks are independent.
    """
    dbs = [B.dim_blocks(r, block_size) for r in shape]
    rank = len(shape)
    T = jnp.dtype(dtype_str)
    nblocks = int(np.prod([db.num for db in dbs]))
    regions = list(regnd._iter_regions(dbs))

    def f(data):
        out = jnp.zeros((nblocks, rank + 1), dtype=T)
        for ranges, lens in regions:
            starts = [db.start(r0) for db, (r0, r1) in zip(dbs, ranges)]
            nb = [r1 - r0 for r0, r1 in ranges]
            ix = tuple(slice(s, s + n * ln)
                       for s, n, ln in zip(starts, nb, lens))
            sub = data[ix]
            shp = []
            for n_, ln in zip(nb, lens):
                shp += [n_, ln]
            sub = sub.reshape(shp)
            perm = list(range(0, 2 * rank, 2)) + list(range(1, 2 * rank, 2))
            nblk = int(np.prod(nb))
            s = sub.transpose(perm).reshape(nblk, *lens)
            z = jnp.zeros((nblk,), T)
            # nested lax.scan keeps the serial C accumulation order
            # (bit-identical rounding) with a tiny compiled graph.
            if rank == 3:
                cbx, cby, cbz = lens
                sT = s.transpose(1, 2, 3, 0)  # (cbx, cby, cbz, nblk)
                kf = jnp.arange(cbz).astype(T)
                jf = jnp.arange(cby).astype(T)
                if_ = jnp.arange(cbx).astype(T)

                def kk_body(carry, xs):
                    sum_y, fz = carry
                    cur, kkf = xs
                    return (sum_y + cur, fz + cur * kkf), None

                def jj_body(carry, xs):
                    sum_x, fy, fz = carry
                    row, jjf = xs
                    (sum_y, fz), _ = jax.lax.scan(
                        kk_body, (z, fz), (row, kf))
                    return (sum_x + sum_y, fy + sum_y * jjf, fz), None

                def ii_body(carry, xs):
                    fx, fy, fz, fsum = carry
                    plane, iif = xs
                    (sum_x, fy, fz), _ = jax.lax.scan(
                        jj_body, (z, fy, fz), (plane, jf))
                    return (fx + sum_x * iif, fy, fz, fsum + sum_x), None

                (fx, fy, fz, fsum), _ = jax.lax.scan(
                    ii_body, (z, z, z, z), (sT, if_))
                cols = jnp.stack([fx, fy, fz, fsum], axis=1)
            else:
                cbx, cby = lens
                sT = s.transpose(1, 2, 0)  # (cbx, cby, nblk)
                jf = jnp.arange(cby).astype(T)
                if_ = jnp.arange(cbx).astype(T)

                def jj_body(carry, xs):
                    sum_x, fy = carry
                    cur, jjf = xs
                    return (sum_x + cur, fy + cur * jjf), None

                def ii_body(carry, xs):
                    fx, fy, fsum = carry
                    row, iif = xs
                    (sum_x, fy), _ = jax.lax.scan(
                        jj_body, (z, fy), (row, jf))
                    return (fx + sum_x * iif, fy, fsum + sum_x), None

                (fx, fy, fsum), _ = jax.lax.scan(
                    ii_body, (z, z, z), (sT, if_))
                cols = jnp.stack([fx, fy, fsum], axis=1)
            flat_idx = regnd._flat_block_idx(dbs, ranges, nb)
            out = out.at[jnp.asarray(flat_idx)].set(cols)
        return out

    return _strict_jit(f, backend)


def _finalize_coeffs(sums: np.ndarray, shape, block_size, T) -> np.ndarray:
    """Closed-form plane coefficients from the block sums — host side so
    the divisions round exactly like C (device float division need not
    be correctly rounded).  Mirrors sz_float.c:6627-6637."""
    g = _geom_small(tuple(shape), block_size)
    dbs = g["dbs"]
    rank = len(shape)
    grids = np.meshgrid(*[db.counts() for db in dbs], indexing="ij")
    lens = [gr.ravel().astype(np.int64) for gr in grids]
    with np.errstate(all="ignore"):
        if rank == 3:
            fx, fy, fz, f = (sums[:, i].astype(T) for i in range(4))
            cbx, cby, cbz = lens
            coeff = (1.0 / (cbx * cby * cbz)).astype(T)
            a = (2 * fx / (cbx - 1).astype(T) - f) * T(6) * coeff \
                / (cbx + 1).astype(T)
            b = (2 * fy / (cby - 1).astype(T) - f) * T(6) * coeff \
                / (cby + 1).astype(T)
            c = (2 * fz / (cbz - 1).astype(T) - f) * T(6) * coeff \
                / (cbz + 1).astype(T)
            d = (f * coeff - ((cbx - 1).astype(T) * a / T(2)
                              + (cby - 1).astype(T) * b / T(2)
                              + (cbz - 1).astype(T) * c / T(2)))
            return np.stack([a, b, c, d], axis=1)
        fx, fy, f = (sums[:, i].astype(T) for i in range(3))
        cbx, cby = lens
        coeff = (1.0 / (cbx * cby)).astype(T)
        a = (2 * fx / (cbx - 1).astype(T) - f) * T(6) * coeff \
            / (cbx + 1).astype(T)
        b = (2 * fy / (cby - 1).astype(T) - f) * T(6) * coeff \
            / (cby + 1).astype(T)
        c = (f * coeff - ((cbx - 1).astype(T) * a / T(2)
                          + (cby - 1).astype(T) * b / T(2)))
        return np.stack([a, b, c], axis=1)


# ---------------------------------------------------------------------------
# Stage 2: predictor selection (vectorized, sz_float.c:6746-6786)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=32)
def _select_fn(shape: tuple, dtype_str: str, block_size: int,
               use_mean: bool, backend: str = 'cpu'):
    dbs = [B.dim_blocks(r, block_size) for r in shape]
    rank = len(shape)
    T = jnp.dtype(dtype_str)
    nblocks = int(np.prod([db.num for db in dbs]))
    regions = list(regnd._iter_regions(dbs))

    # Host-precomputed sample tables per region: flat in-block indices of
    # the sampled point + its Lorenzo neighbors, and the regression
    # position coefficients (sz_float.c:6746-6786; 2D quirk a*(i-1) at
    # sz_float.c:6023).  The scan preserves the serial accumulation order.
    def _samples(lens):
        bs = min(lens)
        idxs, pcs = [], []
        for i in range(1, bs):
            bmi = bs - i
            if rank == 3:
                pts = (((i, i, i), (i, i, i)),
                       ((i, i, bmi), (i, i, bmi)),
                       ((i, bmi, i), (i, bmi, i)),
                       ((i, bmi, bmi), (i, bmi, bmi)))
            else:
                pts = (((i, i), (i, i)),
                       ((i, bmi), (i - 1, bmi)))
            for pidx, pcoef in pts:
                if rank == 3:
                    pi, pj, pk = pidx
                    _, cby, cbz = lens

                    def fi(a, b, c):
                        return (a * cby + b) * cbz + c

                    nb = [fi(pi, pj, pk), fi(pi, pj, pk - 1),
                          fi(pi, pj - 1, pk), fi(pi - 1, pj, pk),
                          fi(pi, pj - 1, pk - 1), fi(pi - 1, pj, pk - 1),
                          fi(pi - 1, pj - 1, pk),
                          fi(pi - 1, pj - 1, pk - 1)]
                else:
                    pi, pj = pidx
                    cby = lens[1]
                    nb = [pi * cby + pj, pi * cby + pj - 1,
                          (pi - 1) * cby + pj, (pi - 1) * cby + pj - 1]
                idxs.append(nb)
                pcs.append(list(pcoef))
        return (np.array(idxs, dtype=np.int32),
                np.array(pcs, dtype=np.dtype(dtype_str)))

    def f(data, coeffs, noise, mean):
        use_reg = jnp.zeros((nblocks,), dtype=bool)
        for ranges, lens in regions:
            starts = [db.start(r0) for db, (r0, r1) in zip(dbs, ranges)]
            nb = [r1 - r0 for r0, r1 in ranges]
            ix = tuple(slice(s, s + n * ln)
                       for s, n, ln in zip(starts, nb, lens))
            sub = data[ix]
            shp = []
            for n_, ln in zip(nb, lens):
                shp += [n_, ln]
            perm = list(range(0, 2 * rank, 2)) + list(range(1, 2 * rank, 2))
            nblk = int(np.prod(nb))
            s2 = (sub.reshape(shp).transpose(perm)
                  .reshape(nblk, int(np.prod(lens))))
            flat_idx = regnd._flat_block_idx(dbs, ranges, nb)
            cf = coeffs[jnp.asarray(flat_idx)]
            sidx, spc = _samples(lens)
            z = jnp.zeros((nblk,), T)

            def body(carry, xs):
                err_sz, err_reg = carry
                nbi, pc = xs
                cur = s2[:, nbi[0]]
                if rank == 3:
                    p = s2[:, nbi[1]] + s2[:, nbi[2]]
                    p = p + s2[:, nbi[3]]
                    p = p - s2[:, nbi[4]]
                    p = p - s2[:, nbi[5]]
                    p = p - s2[:, nbi[6]]
                    p = p + s2[:, nbi[7]]
                    pr = (cf[:, 0] * pc[0] + cf[:, 1] * pc[1]
                          + cf[:, 2] * pc[2] + cf[:, 3])
                else:
                    p = s2[:, nbi[1]] + s2[:, nbi[2]] - s2[:, nbi[3]]
                    pr = cf[:, 0] * pc[0] + cf[:, 1] * pc[1] + cf[:, 2]
                e = jnp.abs(p - cur) + noise
                if use_mean:
                    e = jnp.minimum(e, jnp.abs(mean - cur))
                return (err_sz + e, err_reg + jnp.abs(pr - cur)), None

            (err_sz, err_reg), _ = jax.lax.scan(
                body, (z, z), (jnp.asarray(sidx), jnp.asarray(spc)))
            use_reg = use_reg.at[jnp.asarray(flat_idx)].set(err_reg < err_sz)
        return use_reg

    return _strict_jit(f, backend)


@functools.lru_cache(maxsize=32)
def _select_fn_dyn(shape: tuple, dtype_str: str, block_size: int,
                   backend: str = 'raw'):
    """Predictor selection with use_mean as a *traced* flag (one graph
    serves both decisions — the parallel slab pipeline compiles a single
    sharded program even when slabs disagree on use_mean).  When um is
    False the arithmetic is identical to _select_fn(use_mean=False)."""
    base_t = _select_fn(shape, dtype_str, block_size, True, "raw")
    base_f = _select_fn(shape, dtype_str, block_size, False, "raw")

    def f(data, coeffs, noise, mean, um):
        return jax.lax.cond(
            um, lambda: base_t(data, coeffs, noise, mean),
            lambda: base_f(data, coeffs, noise, mean))

    return _strict_jit(f, backend)


@functools.lru_cache(maxsize=32)
def _quantize_fn_dyn(shape: tuple, dtype_str: str, block_size: int,
                     backend: str = 'raw'):
    """_quantize_fn with use_mean as a traced flag (lax.cond between the
    two compiled bodies; only the taken branch executes)."""
    base_t = _quantize_fn(shape, dtype_str, block_size, True, "raw")
    base_f = _quantize_fn(shape, dtype_str, block_size, False, "raw")

    def f(data, lc_full, reg_blk, locs, iperm, rp, recip,
          intervals, mean, um):
        return jax.lax.cond(
            um,
            lambda: base_t(data, lc_full, reg_blk, locs, iperm,
                           rp, recip, intervals, mean),
            lambda: base_f(data, lc_full, reg_blk, locs, iperm,
                           rp, recip, intervals, mean))

    return _strict_jit(f, backend)


@functools.lru_cache(maxsize=32)
def _decode_fn_dyn(shape: tuple, dtype_str: str, block_size: int,
                   backend: str = 'raw'):
    """_decode_fn with use_mean as a traced flag."""
    base_t = _decode_fn(shape, dtype_str, block_size, True, "raw")
    base_f = _decode_fn(shape, dtype_str, block_size, False, "raw")

    def f(t_lat, lc_full, reg_blk, unpred_lat, locs, rp,
          intervals, mean, um):
        return jax.lax.cond(
            um,
            lambda: base_t(t_lat, lc_full, reg_blk, unpred_lat,
                           locs, rp, intervals, mean),
            lambda: base_f(t_lat, lc_full, reg_blk, unpred_lat,
                           locs, rp, intervals, mean))

    return _strict_jit(f, backend)


# ---------------------------------------------------------------------------
# Stage 3: fixpoint predict+quantize over the full lattice
# ---------------------------------------------------------------------------

def _lorenzo_pred(R, rank):
    """Exact-order Lorenzo stencil on the zero-padded reconstruction
    lattice (szd_float.c replay order; regnd oracle lines)."""
    if rank == 3:
        Rp = jnp.pad(R, ((1, 0), (1, 0), (1, 0)))
        d110 = Rp[1:, 1:, :-1]
        d101 = Rp[1:, :-1, 1:]
        d011 = Rp[:-1, 1:, 1:]
        d100 = Rp[1:, :-1, :-1]
        d010 = Rp[:-1, 1:, :-1]
        d001 = Rp[:-1, :-1, 1:]
        d000 = Rp[:-1, :-1, :-1]
        p = d110 + d101
        p = p + d011
        p = p - d100
        p = p - d010
        p = p - d001
        p = p + d000
        return p
    Rp = jnp.pad(R, ((1, 0), (1, 0)))
    return Rp[1:, :-1] + Rp[:-1, 1:] - Rp[:-1, :-1]


@functools.lru_cache(maxsize=32)
def _quantize_fn(shape: tuple, dtype_str: str, block_size: int,
                 use_mean: bool, backend: str = 'cpu', epi: str = "v1"):
    """epi="v1": epilogue returns (t_stream u16, hist, esc, R, iters) —
    the stream reordered through iperm (parallel/slab).  epi="v2":
    gather-free epilogue for compress — (compact corner stream i32,
    hist, esc, R, iters)."""
    rank = len(shape)
    max_iter = int(sum(shape)) + 4
    _g = _geom_small(shape, block_size)
    nbs = tuple(db.num for db in _g["dbs"])
    bids = tuple(np.asarray(b) for b in _g["bid"])
    dbs_t = tuple(_g["dbs"])

    def f(data, lc_full, reg_blk, locs, iperm, rp, recip,
          intervals, mean):
        T = data.dtype
        cap = intervals
        capf = cap.astype(T)
        cap_szf = (cap - 2).astype(T)
        radius = cap // 2

        # block->point coefficient expansion via per-axis takes on a
        # channel-major block grid (the flat block id is separable:
        # (b0*nb1+b1)*nb2+b2).  A flat row-gather producing an
        # (npts, C) intermediate gets a T(8,128) layout that pads the
        # minor C=5 dim to 128 — a 25.6x HBM blow-up that OOMs
        # 2^25-point lattices; the per-axis form peaks at the final
        # (C, *shape) lattice with no pad.
        aug = jnp.concatenate(
            [lc_full, reg_blk.astype(T)[:, None]], axis=1).T
        lcb = aug.reshape((aug.shape[0], *nbs))
        for ax, b in enumerate(bids):
            lcb = jnp.take(lcb, b, axis=ax + 1)
        reg_pts = lcb[lc_full.shape[1]] != 0
        # regression predictor: position-only, one-shot for all points
        fl = [l.astype(T) for l in locs]
        if rank == 3:
            fii = fl[0][:, None, None]
            fjj = fl[1][None, :, None]
            fkk = fl[2][None, None, :]
            pred_reg = (lcb[0] * fii + lcb[1] * fjj
                        + lcb[2] * fkk + lcb[3])
        else:
            fii = fl[0][:, None]
            fjj = fl[1][None, :]
            pred_reg = (lcb[0] * fii + lcb[1] * fjj
                        + lcb[2])
        t_reg, rec_reg = _quant(data, pred_reg, rp, recip, capf, radius)

        if use_mean:
            mean_mask = (~reg_pts) & (jnp.abs(data - mean) <= rp)
        else:
            mean_mask = None

        def step(R):
            """One sweep of the predict+quantize map (reconstruction
            only — types are derived in a single pass after
            convergence, which keeps a 4-byte-per-point lattice out
            of the loop carry)."""
            p = _lorenzo_pred(R, rank)
            t_l, rec_l = _quant(data, p, rp, recip, cap_szf, radius)
            if use_mean:
                t_l = jnp.where((t_l != 0) & (t_l <= radius),
                                t_l - 1, t_l)
                t_l = jnp.where(mean_mask, radius, t_l)
                rec_l = jnp.where(mean_mask, mean, rec_l)
            t = jnp.where(reg_pts, t_reg, t_l)
            R_new = jnp.where(reg_pts, rec_reg, rec_l)
            return t, R_new

        def body(carry):
            R, it, _ = carry
            _, R_new = step(R)
            return R_new, it + 1, _same_bits(R_new, R)

        def cond(carry):
            _, it, done = carry
            return (~done) & (it < max_iter)

        init = (data, jnp.asarray(0), jnp.asarray(False))
        R, iters, _ = jax.lax.while_loop(cond, body, init)
        # R is the bit-exact fixpoint: one more application leaves it
        # unchanged and yields the matching type codes
        t, R = step(R)

        if epi == "v2":
            # gather-free epilogue: the stream is the COMPACT corner-
            # transpose form (n items, no holes), the escapes use a
            # closed-form position map (no n-sized iperm lattice)
            tp = _corner_stream(t, dbs_t, shape)
            hist = histogram(t.reshape(-1))
            is_esc = tp == 0
            cum = jnp.cumsum(is_esc.astype(jnp.int32))
            esc_pos = jnp.searchsorted(
                cum, jnp.arange(1, ESC_K + 1, dtype=jnp.int32),
                side="left")
            lat_idx = _pos_to_lat_expr(esc_pos, dbs_t, shape)
            esc_vals = jnp.take(data.reshape(-1), lat_idx,
                                mode="fill", fill_value=0.0)
            return tp, hist, esc_vals, R, iters

        # v1 epilogue (the sharded slab pipeline): stream reorder through
        # iperm + histogram + escape gather in the same device call
        t_stream = jnp.take(t.reshape(-1), iperm).astype(jnp.uint16)
        hist = histogram(t.reshape(-1))
        esc_vals = _escape_values(t_stream, iperm, data.reshape(-1))
        return t_stream, hist, esc_vals, R, iters

    return _strict_jit(f, backend)


# escapes returned inline by the quantize epilogue, padded to this size;
# streams with more escapes take one extra device call (_escapes_fn)
ESC_K = 4096


def _corner_box_stream(box, csizes: tuple, esizes: tuple):
    """Interleaved corner box (c0, E0, .., ck, Ek) -> (c0, c1.., ck,
    prod(E)) block-major stream form (adjoint of
    _corner_box_to_lattice)."""
    rank = len(csizes)
    perm = tuple(2 * i for i in range(rank)) \
        + tuple(2 * i + 1 for i in range(rank))
    eprod = int(np.prod(esizes, dtype=np.int64))
    return box.transpose(perm).reshape(tuple(csizes) + (eprod,))


def _corner_parts(dbs):
    """Per-axis [(lattice offset, block count, block length)] corner
    partition: the `split` early blocks then the late blocks."""
    parts = []
    for db in dbs:
        p = []
        if db.split:
            p.append((0, db.split, db.early))
        if db.num - db.split:
            p.append((db.split * db.early, db.num - db.split, db.late))
        parts.append(p)
    return parts


def _corner_stream(x, dbs, shape: tuple):
    """Lattice -> COMPACT block-major stream (n elements, no holes) —
    the exact adjoint of _corner_unstream: per-axis early/late corner
    slices, one blocked transpose per corner, per-prefix concatenation
    along the flat tail.  Pure bandwidth ops; replaces the take(iperm)
    gather on the encode side."""
    rank = len(shape)
    parts = _corner_parts(dbs)

    def rec(region, ax, csizes, esizes):
        # region: (c0, E0, .., c_{ax-1}, E_{ax-1}, shape_ax, ..)
        if ax == rank:
            return _corner_box_stream(region, csizes, esizes)
        outs = []
        for off, cnt, esz in parts[ax]:
            sub = jax.lax.slice_in_dim(region, off, off + cnt * esz,
                                       axis=2 * ax)
            sub = sub.reshape(region.shape[:2 * ax] + (cnt, esz)
                              + region.shape[2 * ax + 1:])
            r = rec(sub, ax + 1, csizes + (cnt,), esizes + (esz,))
            # fold the c_ax block dim into the flat tail
            r = r.reshape(r.shape[:ax]
                          + (r.shape[ax] * r.shape[ax + 1],)
                          + r.shape[ax + 2:])
            outs.append(r)
        return outs[0] if len(outs) == 1 else jnp.concatenate(outs, ax)

    return rec(x, 0, (), ()).reshape(-1)


def _pos_to_lat_expr(pos, dbs, shape: tuple):
    """Traceable COMPACT-stream position -> lattice flat index, in
    closed form (no n-sized mapping vector): invert the per-axis
    block-cumulative point counts C_i(b) (early/late closed forms),
    then the in-block mixed radix.  Positions >= n pass through
    unchanged (OOB fill sentinel for mode=\"fill\" gathers)."""
    rank = len(shape)
    n = int(np.prod(shape))
    pos = pos.astype(jnp.int64)
    oob = pos >= n
    w = pos
    coords = []
    eprod = jnp.ones((), jnp.int64)  # prod of E_j(b_j) for j < ax
    esz_list = []
    for ax, db in enumerate(dbs):
        inner = int(np.prod(shape[ax + 1:], dtype=np.int64))
        # chunk index along this axis in units of (eprod * inner)
        u = w // (eprod * inner)
        cs = db.split * db.early     # points in early blocks
        b = jnp.where(u < cs, u // max(db.early, 1),
                      db.split + (u - cs) // max(db.late, 1))
        C = jnp.where(b < db.split, b * db.early,
                      cs + (b - db.split) * db.late)
        E = jnp.where(b < db.split, db.early, db.late).astype(jnp.int64)
        w = w - C * eprod * inner
        coords.append(C)            # block start coordinate
        esz_list.append(E)
        eprod = eprod * E
    # w is now the in-block index, layout (e0*E1 + e1)*E2 + e2 ...
    lat = jnp.zeros_like(pos)
    for ax in range(rank):
        tail = jnp.ones((), jnp.int64)
        for j in range(ax + 1, rank):
            tail = tail * esz_list[j]
        e = (w // tail) % esz_list[ax]
        lat = lat * shape[ax] + (coords[ax] + e)
    return jnp.where(oob, jnp.int64(n), lat).astype(jnp.int32)


def histogram(t_flat):
    """65536-bin histogram of int32 type codes (XLA scatter-add)."""
    return jnp.bincount(t_flat.astype(jnp.int32), length=65536).astype(
        jnp.int32)


def _escape_values(t_stream, iperm, data_flat):
    """First ESC_K escape values in stream order, zero-padded.

    The r-th escape's stream index is searchsorted(cumsum(is_esc),
    r+1): K binary searches over the sorted cumsum, no full-stream
    scatter."""
    n = t_stream.shape[0]
    is_esc = t_stream == 0
    cum = jnp.cumsum(is_esc.astype(jnp.int32))
    esc_stream_idx = jnp.searchsorted(
        cum, jnp.arange(1, ESC_K + 1, dtype=jnp.int32), side="left")
    # ranks past the escape count return n -> OOB -> fill
    lat = jnp.take(iperm, esc_stream_idx, mode="fill", fill_value=n)
    return jnp.take(data_flat, lat, mode="fill", fill_value=0.0)


@functools.lru_cache(maxsize=32)
def bitpack_fn(n: int, out_bytes: int, backend: str = "cpu"):
    """Device-side Huffman bit pack: MSB-first concatenation of per-symbol
    variable-length codes (<=32 bits), the data-parallel form of the
    reference's serial encode() (Huffman.c:205-308).

    Formulation: per-symbol bit offsets are an (exact, integer) cumsum of
    code lengths; a <=32-bit code at any bit offset spans at most TWO
    consecutive 32-bit words, so two sorted segment-sums (u32 scatter-
    adds) assemble the stream — contributions have pairwise-disjoint
    bits, making sum equivalent to OR."""
    assert out_bytes % 4 == 0
    nwords = out_bytes // 4

    # total bits < 2^31 whenever n*32 fits — int32 cumsum then
    off_t = jnp.int32 if n * 32 < (1 << 31) else jnp.int64

    def f(t_stream, code_hi, code_len):
        sym = t_stream.astype(jnp.int32)
        lens = jnp.take(code_len, sym)  # int32
        offs = jnp.cumsum(lens.astype(off_t)) - lens
        hi = jnp.take(code_hi, sym)  # uint64, MSB-aligned
        c32 = (hi >> jnp.uint64(32)).astype(jnp.uint32)  # MSB-aligned
        w0 = (offs >> 5).astype(jnp.int32)
        s = (offs & 31).astype(jnp.uint32)
        lo = c32 >> s
        hi_p = jnp.where(s > 0, c32 << (jnp.uint32(32) - s),
                         jnp.uint32(0))
        acc = jax.ops.segment_sum(lo, w0, num_segments=nwords,
                                  indices_are_sorted=True)
        acc = acc + jax.ops.segment_sum(hi_p, w0 + 1,
                                        num_segments=nwords,
                                        indices_are_sorted=True)
        b = jax.lax.bitcast_convert_type(acc, jnp.uint8)  # (nwords, 4) LE
        return b[:, ::-1].reshape(-1)  # big-endian byte stream

    return _strict_jit(f, backend)


def pack_stream_device(t_stream_d, tables, n: int, nbytes: int,
                       backend: str) -> np.ndarray:
    """Device Huffman pack of an in-order type stream with the
    scatter-add pack (bitpack_fn).  Shared by the regression, classic
    (SZ1.4), MSST19, temporal and RA engines.  Returns >= nbytes
    uint8."""
    out_pad = _pad_pow2(nbytes + 8)
    packed_d = bitpack_fn(n, out_pad, backend)(
        t_stream_d, jax.device_put(tables.code_hi),
        jax.device_put(tables.code_len.astype(np.int32)))
    return np.asarray(packed_d)[:nbytes]


@functools.lru_cache(maxsize=32)
def _escapes2_fn(shape: tuple, dtype_str: str, block_size: int, k: int,
                 backend: str = "cpu"):
    """Escape values (type==0) in COMPACT corner-stream order, padded to
    static size k: k binary searches over the escape cumsum, and the
    stream position -> lattice index map is closed-form
    (_pos_to_lat_expr), so no n-sized iperm vector is needed."""
    g = _geom_small(shape, block_size)
    dbs_t = tuple(g["dbs"])

    def f(data, tp):
        is_esc = tp == 0
        cum = jnp.cumsum(is_esc.astype(jnp.int32))
        esc_pos = jnp.searchsorted(
            cum, jnp.arange(1, k + 1, dtype=jnp.int32), side="left")
        lat = _pos_to_lat_expr(esc_pos, dbs_t, shape)
        return jnp.take(data.reshape(-1), lat, mode="fill",
                        fill_value=0.0)

    return _strict_jit(f, backend)


# ---------------------------------------------------------------------------
# Stage 4 (decode): fixpoint reconstruction
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=32)
def _decode_fn(shape: tuple, dtype_str: str, block_size: int,
               use_mean: bool, backend: str = 'cpu'):
    rank = len(shape)
    max_iter = int(sum(shape)) + 4
    _g = _geom_small(shape, block_size)
    nbs = tuple(db.num for db in _g["dbs"])
    bids = tuple(np.asarray(b) for b in _g["bid"])

    def f(t_lat, lc_full, reg_blk, unpred_lat, locs, rp, intervals,
          mean):
        T = unpred_lat.dtype
        radius = intervals // 2

        # per-axis block->point expansion — see the layout note in
        # _quantize_fn
        aug = jnp.concatenate(
            [lc_full, reg_blk.astype(T)[:, None]], axis=1).T
        lcb = aug.reshape((aug.shape[0], *nbs))
        for ax, b in enumerate(bids):
            lcb = jnp.take(lcb, b, axis=ax + 1)
        reg_pts = lcb[lc_full.shape[1]] != 0
        esc = t_lat == 0
        fl = [l.astype(T) for l in locs]
        if rank == 3:
            pred_reg = (lcb[0] * fl[0][:, None, None]
                        + lcb[1] * fl[1][None, :, None]
                        + lcb[2] * fl[2][None, None, :]
                        + lcb[3])
        else:
            pred_reg = (lcb[0] * fl[0][:, None]
                        + lcb[1] * fl[1][None, :]
                        + lcb[2])

        # per-point correction 2*(t-radius)*rp, with the use_mean index
        # shift on the Lorenzo side (szd_float.c:3697)
        t_adj = t_lat
        if use_mean:
            t_adj = jnp.where((~reg_pts) & (t_lat < radius), t_lat + 1,
                              t_lat)
        q_lor = (2 * (t_adj - radius)).astype(T) * rp
        q_reg = (2 * (t_lat - radius)).astype(T) * rp
        reg_val = pred_reg + q_reg

        if use_mean:
            mean_pts = (~reg_pts) & (t_lat == radius)
        else:
            mean_pts = jnp.zeros(shape, bool)
        known_mask = esc | reg_pts | mean_pts
        known = jnp.where(esc, unpred_lat,
                          jnp.where(reg_pts, reg_val,
                                    jnp.asarray(mean, T)))

        def body(carry):
            R, it, _ = carry
            p = _lorenzo_pred(R, rank)
            val = p + q_lor
            R_new = jnp.where(known_mask, known, val)
            done = _same_bits(R_new, R)
            return R_new, it + 1, done

        def cond(carry):
            _, it, done = carry
            return (~done) & (it < max_iter)

        init = (jnp.where(known_mask, known, jnp.zeros(shape, T)),
                jnp.asarray(0), jnp.asarray(False))
        R, iters, _ = jax.lax.while_loop(cond, body, init)
        return R, iters

    return _strict_jit(f, backend)


# ---------------------------------------------------------------------------
# Drivers
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=32)
def _opt_gather_fn(shape: tuple, dtype_str: str, backend: str = "cpu"):
    """Device gathers for the interval optimizer (device-resident input).

    The sampling walks (optimizer.optimize_intervals_*_freq_dense,
    sz_float.c:6399/6442) read ~n/sample_distance points plus their
    Lorenzo neighbors; only these compact sample vectors leave the
    device.  The float64 histogram + selection tail runs on the host
    (optimizer._finish), shared with the host engine for exact C
    parity (the bin edges are f64 divisions).  Neighbor sums
    accumulate in the data dtype in the serial order (each op a
    separately rounded HLO, FMA-free per _strict_jit)."""
    rank = len(shape)
    if rank == 3:
        r3 = int(shape[2])
        r23 = int(shape[1] * shape[2])
    else:
        r2 = int(shape[1])

    def f(flat, midx, sidx):
        mean_vals = jnp.take(flat, midx)
        cur = jnp.take(flat, sidx)
        if rank == 3:
            pred = jnp.take(flat, sidx - 1) + jnp.take(flat, sidx - r3)
            pred = pred + jnp.take(flat, sidx - r23)
            pred = pred - jnp.take(flat, sidx - 1 - r23)
            pred = pred - jnp.take(flat, sidx - r3 - 1)
            pred = pred - jnp.take(flat, sidx - r3 - r23)
            pred = pred + jnp.take(flat, sidx - r3 - r23 - 1)
        else:
            pred = (jnp.take(flat, sidx - 1) + jnp.take(flat, sidx - r2)
                    - jnp.take(flat, sidx - r2 - 1))
        return mean_vals, cur, pred

    return _strict_jit(f, backend)


@functools.lru_cache(maxsize=32)
def _mask_vals_fn(n: int, dtype_str: str, k: int, backend: str = "cpu"):
    """Dense-value extraction for the mean flush (device-resident input):
    values within rp of dense_pos, compacted in flat order and padded to
    k, plus the exact count (sz_float.c:6811-6817 mask).  The strictly
    sequential mean accumulation (C fold order) runs on the host over
    the downloaded compact vector — it cannot be parallelized
    bit-exactly.  Same cumsum+index-scatter formulation as
    _escape_values (no data-dependent nonzero)."""

    def f(flat, dense_pos, rp):
        m = jnp.abs(flat - dense_pos) < rp
        count = jnp.sum(m.astype(jnp.int32))
        rankc = jnp.cumsum(m.astype(jnp.int32)) - 1
        idx = jnp.where(m, jnp.minimum(rankc, k), k)
        sel = jnp.full((k + 1,), n, jnp.int32).at[idx].set(
            jnp.arange(n, dtype=jnp.int32), mode="drop")[:k]
        vals = jnp.take(flat, sel, mode="fill", fill_value=0.0)
        return count, vals

    return _strict_jit(f, backend)


def _opt_walks(shape: tuple, rank: int, sample_distance: int):
    """Host-cached data-independent walk indices for the optimizer."""
    if rank == 3:
        return (opt._mean_walk_indices_3d(*shape),
                opt._sample_walk_indices_3d(*shape, sample_distance))
    return (opt._mean_walk_indices_2d(*shape),
            opt._sample_walk_indices_2d(*shape, sample_distance))


def _optimizer_host_tail(mv, cur, pred, n_mean, n_samp, real_precision,
                         max_range_radius, pred_threshold, T):
    """f64 histogram/selection tail over downloaded sample vectors —
    the single implementation shared by the serial device-input path
    and the sharded one (parallel/slab.py), so the parity-critical
    logic lives in one place."""
    mean0 = opt.seq_sum(mv, T)
    if n_mean > 0:
        mean0 = T(mean0 / T(n_mean))
    return opt._finish(cur, pred, mean0, float(real_precision), n_samp,
                       max_range_radius, pred_threshold, T)


@functools.lru_cache(maxsize=32)
def _opt_gather_cat_fn(shape: tuple, dtype_str: str,
                       backend: str = "cpu"):
    """_opt_gather_fn with the three sample vectors concatenated into
    ONE array: a single D2H transfer instead of three."""
    g = _opt_gather_fn(shape, dtype_str, "raw")

    def f(flat, midx, sidx):
        mv, cur, pred = g(flat, midx, sidx)
        return jnp.concatenate([mv, cur, pred])

    return _strict_jit(f, backend)


def _device_optimizer(dev, shape, rank, real_precision, max_range_radius,
                      sample_distance, pred_threshold, T, dstr, be):
    """Interval optimizer for device-resident input: walk indices are
    data-independent (host-cached), gathers run on device, and the f64
    histogram/selection tail is the shared host implementation."""
    midx, sidx = _opt_walks(shape, rank, sample_distance)
    it = np.int32 if int(np.prod(shape)) < (1 << 31) else np.int64
    cat = np.asarray(_opt_gather_cat_fn(shape, dstr, be)(
        dev.reshape(-1), jax.device_put(midx.astype(it)),
        jax.device_put(sidx.astype(it))))
    nm, ns = len(midx), len(sidx)
    return _optimizer_host_tail(
        cat[:nm], cat[nm:nm + ns], cat[nm + ns:], nm,
        ns, real_precision, max_range_radius, pred_threshold, T)


def _device_dense_mean(dev, n, dense_pos, rp, T, dstr, be):
    """Mean of the dense-value cluster for device-resident input: compact
    device gather + host sequential fold (exact C order)."""
    k = 1 << 16
    count, vals_pad = _mask_vals_fn(n, dstr, k, be)(
        dev.reshape(-1), T(dense_pos), rp)
    count = int(count)
    if count > k:
        k = _pad_pow2(count)
        _, vals_pad = _mask_vals_fn(n, dstr, k, be)(
            dev.reshape(-1), T(dense_pos), rp)
    return opt.fold_mean(np.asarray(vals_pad)[:count], T)


@functools.lru_cache(maxsize=32)
def _delattice_fn(shape: tuple, dtype_str: str, k: int,
                  backend: str = "cpu"):
    """Decode-side device staging: stream-ordered uint16 types + padded
    unpred values -> (int32 type lattice, unpred lattice)."""
    T = jnp.dtype(dtype_str)
    n = int(np.prod(shape))

    def f(t_stream, unpred_pad, pos, iperm):
        t_lat = jnp.take(t_stream.astype(jnp.int32),
                         pos.reshape(-1)).reshape(shape)
        esc_stream = jnp.nonzero(t_stream == 0, size=k, fill_value=n)[0]
        lat_idx = jnp.take(iperm, esc_stream, mode="fill", fill_value=n)
        unpred_lat = jnp.zeros((n,), T).at[lat_idx].set(
            unpred_pad, mode="drop").reshape(shape)
        return t_lat, unpred_lat

    return _strict_jit(f, backend)


def unpack_w_bits(packed, n: int, w: int):
    """Traceable device unpack of an MSB-first fixed-width bit stream
    (native.pack_wide_bits_u32 counterpart), gather-free: a row of w
    words holds exactly 32 symbols, and symbol j's word index and shift
    within the row are STATIC — 32 column extracts + shifts replace the
    two per-symbol word gathers.  Returns int32."""
    assert 1 <= w <= 31
    m = -(-n // 32)                     # rows of w words / 32 symbols
    need = m * w
    if packed.shape[0] < need:
        packed = jnp.concatenate(
            [packed, jnp.zeros((need - packed.shape[0],), jnp.uint32)])
    rows = packed[:need].reshape(m, w)
    cols = []
    for j in range(32):
        bit = j * w
        wi, sh = bit >> 5, bit & 31
        v = rows[:, wi] << jnp.uint32(sh)
        if sh + w > 32:                 # field crosses into word wi+1
            v = v | (rows[:, wi + 1] >> jnp.uint32(32 - sh))
        cols.append(v >> jnp.uint32(32 - w))
    out = jnp.stack(cols, axis=1).reshape(-1)
    return out[:n].astype(jnp.int32)


def packed_types_enabled() -> bool:
    return _os.environ.get("SZ_TPU_PACKED_TYPES", "1") != "0"


@functools.lru_cache(maxsize=32)
def _delattice3_fn(shape: tuple, dtype_str: str, block_size: int,
                   k: int, w: int, backend: str = "cpu"):
    """Decode-side staging v3 — one path for every source: COMPACT
    type stream -> (int32 type lattice, unpred lattice) with zero
    per-point gathers and zero hole handling (_corner_unstream).

    w > 0: `tp` is the host's fixed-width MSB-first bit-pack of the
    compact stream (native.pack_wide_bits_u32, upload is ~w/16 of raw
    u16).  w = 0: `tp` is the stream itself — a raw u16 host upload or
    the device-resident fsm_kernel output.  Escape values land via a
    k-element scatter into a dense stream copy that rides the same
    corner transform (k = padded escape count, small)."""
    T = jnp.dtype(dtype_str)
    n = int(np.prod(shape))
    g = _geom_small(shape, block_size)
    dbs_t = tuple(g["dbs"])

    def f(tp, unpred_pad):
        if w:
            tp = unpack_w_bits(tp, n, w)
        else:
            tp = tp[:n].astype(jnp.int32)
        t_lat = _corner_unstream(tp, dbs_t, shape)
        is_esc = tp == 0
        cum = jnp.cumsum(is_esc.astype(jnp.int32))
        esc_idx = jnp.searchsorted(
            cum, jnp.arange(1, k + 1, dtype=jnp.int32), side="left")
        u_stream = jnp.zeros((n,), T).at[esc_idx].set(
            unpred_pad, mode="drop")
        unpred_lat = _corner_unstream(u_stream, dbs_t, shape)
        return t_lat, unpred_lat

    return _strict_jit(f, backend)


def _device_decode_types(p, n: int):
    """Device-side Huffman decode of a ParsedBody's type stream."""
    return _device_decode_stream(p.tree, p.encoded, n)


def _device_decode_stream(tree, encoded: bytes, n: int):
    """Device-side Huffman decode of the type stream (fsm_kernel).
    Returns a device int32 stream, or None when a chunk failed to
    self-sync even in the kernel's full chain-repair pass (the caller then
    decodes on the host; the "host_fallback.huffman_decode" counter
    records it).  Shared by the regression, classic, MSST19 and RA
    decoders."""
    from sz_tpu.tpu import fsm_kernel as _fsm

    Lh, Rh, Ch, Th, _node_count = tree
    if Th[0] or not encoded:       # constant stream: the root is a leaf
        return jnp.full((n,), int(Ch[0]) if Th[0] else 0, jnp.int32)
    trans = _fsm.build_trans(Lh, Rh, Ch, Th)
    syms, ok = _fsm.decode(encoded, trans, n)
    if not bool(ok):
        _tr.count("host_fallback.huffman_decode")
        return None
    return syms


def _pad_pow2(n: int) -> int:
    return 1 << max(int(n - 1).bit_length(), 4)


def compress(data, real_precision, *, max_range_radius: int,
             sample_distance: int, pred_threshold, opt_quant_mode: int = 1,
             fixed_intervals: int = 0, size_type: int = 8) -> EncodeResult:
    """Device-engine analog of regnd.compress — identical byte output.

    All lattice-sized
    work (quantize, stream reorder, histogram, escape gather) stays on
    device; the host only receives the uint16 type stream, the 65536-bin
    histogram and the escape values, then runs the serial byte stages
    (Huffman tree, native bitstream pack, assembly).

    `data` may be a jax.Array already resident on the device
    (compress-from-device: simulation output / checkpoint shards living
    in HBM) — the upload is skipped entirely and the optimizer's
    sampling walks gather on device, so only compact sample vectors
    (~n/sample_distance elements) cross the bus before the compressed
    stream itself.
    """
    is_dev = isinstance(data, jax.Array) and not isinstance(data, np.ndarray)
    rank = data.ndim
    spec = regnd._spec(rank, np.dtype(data.dtype))
    T = spec.T
    shape = tuple(int(r) for r in data.shape)
    rp = T(real_precision)
    recip = T(T(1) / rp)
    dstr = np.dtype(T).str.lstrip("<>=")
    be = jax.default_backend()

    g = _geom_small(shape, spec.block_size)
    dbs = g["dbs"]
    loc = _dev_loc(shape, spec.block_size)

    if is_dev:
        with _tr.trace("device_input"):
            dev = jnp.asarray(data, T)
            dev.block_until_ready()
        flat = None
    else:
        data = np.ascontiguousarray(data, dtype=T)
        flat = data.reshape(-1)
        with _tr.trace("upload"):
            dev = jax.device_put(data)
            dev.block_until_ready()
    with _tr.trace("coeff_sums"):
        sums = np.asarray(_coeff_sums_fn(shape, dstr, spec.block_size,
                                         be)(dev))
    with _tr.trace("coeff_finalize"):
        coeffs = _finalize_coeffs(sums, shape, spec.block_size, T)

    use_mean = False
    mean = T(0)
    dense_pos = T(0)
    if opt_quant_mode == 1:
        _t_opt = _tr.trace("optimizer"); _t_opt.__enter__()
        if is_dev:
            intervals, dense_pos, max_freq, mean_freq = _device_optimizer(
                dev, shape, rank, real_precision, max_range_radius,
                sample_distance, pred_threshold, T, dstr, be)
        elif rank == 3:
            intervals, dense_pos, max_freq, mean_freq = \
                opt.optimize_intervals_3d_freq_dense(
                    flat, *shape, float(real_precision), max_range_radius,
                    sample_distance, pred_threshold, T=T)
        else:
            intervals, dense_pos, max_freq, mean_freq = \
                opt.optimize_intervals_2d_freq_dense(
                    flat, *shape, float(real_precision), max_range_radius,
                    sample_distance, pred_threshold, T=T)
        use_mean = opt.decide_use_mean(mean_freq, max_freq, rank)
        _t_opt.__exit__(None, None, None)
    else:
        intervals = fixed_intervals

    if use_mean:
        if is_dev:
            mean = _device_dense_mean(dev, int(np.prod(shape)), dense_pos,
                                      rp, T, dstr, be)
        else:
            mask = np.abs(data - dense_pos) < rp
            mean = opt.fold_mean(flat[np.flatnonzero(mask.reshape(-1))],
                                 T)

    noise = T(np.float64(rp) * spec.noise_factor)
    with _tr.trace("select"):
        use_reg = np.asarray(
            _select_fn(shape, dstr, spec.block_size, use_mean, be)(
                dev, jax.device_put(coeffs), T(noise), T(mean)))

    with _tr.trace("coeff_chain"):
        ctypes, cunpred, qcoeffs, cprec = regnd.quantize_coeff_chain(
            coeffs, use_reg, rp, dbs, spec, use_mean)

    lc_full = np.zeros((g["nblocks"], spec.ncoeff), dtype=T)
    lc_full[np.flatnonzero(use_reg)] = qcoeffs

    with _tr.trace("quantize"):
        # iperm is untraced in the v2 epilogue: a 1-element placeholder
        # keeps the signature without materializing the n-sized lattice
        tp_d, hist_d, esc_d, _R, iters = _quantize_fn(
            shape, dstr, spec.block_size, use_mean, be, "v2")(
            dev, jax.device_put(lc_full), jax.device_put(use_reg),
            tuple(loc), jnp.zeros((1,), jnp.int32), T(rp), T(recip),
            jnp.asarray(intervals, jnp.int32), T(mean))
        hist = np.asarray(hist_d)
    _tr.count("fixpoint_sweeps", int(iters))
    n_esc = int(hist[0])
    with _tr.trace("escapes"):
        if n_esc <= ESC_K:
            unpred_arr = np.asarray(esc_d)[:n_esc]
        else:
            k = _pad_pow2(n_esc)
            unpred_arr = np.asarray(
                _escapes2_fn(shape, dstr, spec.block_size, k, be)(
                    dev, tp_d))[:n_esc]
    state_num = 2 * intervals
    freq = np.zeros(2 * state_num, np.int64)
    freq[:min(65536, 2 * state_num)] = hist[:min(65536, 2 * state_num)]

    with _tr.trace("huffman_tree"):
        from sz_tpu.format import huffman as _huff
        tables = _huff.build_tables(None, state_num, freq=freq)
    max_len = int(tables.code_len.max()) if tables.code_len.size else 0
    total_bits = int((freq[:len(tables.code_len)]
                      * tables.code_len.astype(np.int64)).sum())
    encoded = None
    result_type = None
    n = int(np.prod(shape))
    # SZ_TPU_DEVICE_BITPACK=0 downloads the u16 type stream and packs on
    # the host (OpenMP chunk pack) instead of the device scatter-add pack
    if device_bitpack_policy() and 0 < max_len <= 32 and total_bits > 0:
        nbytes = (total_bits + 7) // 8
        with _tr.trace("bitpack_device"):
            packed = pack_stream_device(tp_d, tables, n, nbytes, be)
        encoded = packed.tobytes()
        result_type = np.zeros(0, np.uint16)  # not needed downstream
    else:
        with _tr.trace("types_download"):
            result_type = np.asarray(tp_d).astype(np.uint16)

    with _tr.trace("assemble"):
        return regnd.assemble_body(
            spec, rp, intervals, use_mean, mean, use_reg, ctypes, cunpred,
            cprec, result_type, unpred_arr, size_type, freq=freq,
            tables=tables, encoded=encoded)


def decompress(body: bytes, shape, dtype, size_type: int = 8,
               as_jax: bool = False) -> np.ndarray:
    """Device-engine analog of regnd.decompress — bit-identical output.

    as_jax=True returns the reconstruction as a device-resident jax
    array (no device->host transfer — the natural mode when the
    decompressed field feeds an on-device pipeline)."""
    shape = tuple(int(r) for r in shape)
    be = jax.default_backend()
    # device-side Huffman decode (fsm_kernel) on the GPU: the host never
    # runs the FSM and only the coded bytes cross the bus
    use_dd = device_decode_policy(be)
    with _tr.trace("parse_body"):
        p = regnd.parse_body(body, shape, dtype, size_type,
                             raw_types=use_dd)
    t_dev = None
    if use_dd:
        with _tr.trace("huffman_device"):
            t_dev = _device_decode_types(p, int(np.prod(shape)))
            if t_dev is not None:
                t_dev.block_until_ready()
        if t_dev is None:  # fall back to the host FSM decoder
            from sz_tpu.format import huffman as _huff
            Lh, Rh, Ch, Th, _nc = p.tree
            p.types = _huff.decode(Lh, Rh, Ch, Th, p.encoded,
                                   int(np.prod(shape)))
    spec = p.spec
    T = spec.T
    dstr = np.dtype(T).str.lstrip("<>=")
    g = _geom_small(shape, spec.block_size)
    loc = _dev_loc(shape, spec.block_size)

    use_reg = (p.indicator == 0)
    lc_full = np.zeros((g["nblocks"], spec.ncoeff), dtype=T)
    lc_full[np.flatnonzero(use_reg)] = p.qcoeffs

    n_esc = len(p.unpred)
    k = _pad_pow2(max(n_esc, 1))
    unpred_pad = np.zeros(k, dtype=T)
    unpred_pad[:n_esc] = p.unpred
    # fixed-width pack of the type codes (native, OpenMP) cuts the
    # decode upload to ~w/16 of the raw uint16 stream;
    # SZ_TPU_PACKED_TYPES=0 uploads raw u16 instead
    w = (0 if p.types is None else
         int(max(int(p.types.max(initial=0)), 1)).bit_length())
    packed_ok = 0 < w < 16 and packed_types_enabled()
    with _tr.trace("delattice"):
        unpred_d = jax.device_put(unpred_pad)
        if t_dev is not None:
            t_src, w_eff = t_dev, 0
        elif packed_ok:
            from sz_tpu import native as _nat
            t_src = jax.device_put(_nat.pack_wide_bits_u32(
                np.asarray(p.types, np.int32), w))
            w_eff = w
        else:
            t_src = jax.device_put(p.types.astype(np.uint16))
            w_eff = 0
        t_lat, unpred_lat = _delattice3_fn(
            shape, dstr, spec.block_size, k, w_eff, be)(t_src, unpred_d)
        jax.block_until_ready((t_lat, unpred_lat))

    with _tr.trace("decode_fixpoint"):
        out, iters = _decode_fn(shape, dstr, spec.block_size,
                                bool(p.use_mean), be)(
            t_lat, jax.device_put(lc_full), jax.device_put(use_reg),
            unpred_lat, tuple(loc), T(p.rp),
            jnp.asarray(p.intervals, jnp.int32), T(p.mean))
        out.block_until_ready()
    _tr.count("decode_sweeps", int(iters))
    if as_jax:
        return out
    with _tr.trace("download"):
        res = np.asarray(out)
    return res
