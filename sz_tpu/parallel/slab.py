"""Slab-parallel (data-parallel) compression over a device mesh.

This is the device-mesh re-expression of the reference's two scaling
mechanisms (SURVEY §2.3):

  * OpenMP block-parallel codec (`SZ_compress_float_3D_MDQ_openmp`,
    sz_omp.c:63): blocks are compressed independently per thread; the
    Huffman histogram is computed in parallel; per-block streams are
    concatenated by exclusive-scan offsets (sz_omp.c:258-325) and a
    parallel decoder reverses it (sz_omp.c:366).
  * MPI-rank-independent chunk compression (the HDF5 filter pattern,
    hdf5-filter/H5Z-SZ/test/test_mpio.c): each rank compresses its chunk
    independently; the container orders the streams.

Here the grid is sharded into slabs along the slowest axis over a
`jax.sharding.Mesh`.  The device-side stages (regression coefficient
sums, predictor selection, fixpoint predict+quantize, Huffman bit-pack)
each run as ONE sharded dispatch covering every slab; the small serial
stages (coefficient finalize/chain, interval optimizer, Huffman tree
build, byte assembly) run per-slab on the host exactly as the serial
engine does.  The result is an SZRA container whose slab payloads are
**byte-identical to `api.compress` of each slab** — the strongest
possible parity statement, asserted by tests/test_parallel.py on an
8-device CPU mesh and by __graft_entry__.dryrun_multichip.

Each slab is a self-contained SZ stream boundary (no halo exchange —
matching the reference's random-access blockwise format, where
cross-block prediction stops at chunk borders), so decode of any slab
needs only that slab's bytes.  `decompress_sharded` runs the fixpoint
reconstruction for all slabs in one sharded dispatch (the sz_omp.c:366
analog).
"""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from sz_tpu import api
from sz_tpu import ra
from sz_tpu.config import (
    SZConfig, DEFAULT_CONFIG, ErrorBoundMode, DataType, SZMode,
    MIN_NUM_OF_ELEMENTS,
)
from sz_tpu.core import blocks as B
from sz_tpu.core import optimizer as opt
from sz_tpu.core import regnd
from sz_tpu.format import huffman
from sz_tpu.format import lossless as ll
from sz_tpu.format import metadata as md
from sz_tpu.format import bytes_util as bu
from sz_tpu.tpu import engine

AXIS = "slabs"
NBINS = 65536


def _pmap_host(fn, n: int):
    """Run fn(i) for i in range(n) on a thread pool, ordered results.

    The per-slab host stages (coefficient finalize/chain, native
    Huffman tree build, byte assembly) are numpy/ctypes-bound and
    release the GIL, so threads keep the host tail ~O(1) in slab count
    up to core count instead of a linear Python loop (the reference's
    analog work is the per-thread section of sz_omp.c:165-193).
    SZ_TPU_HOST_THREADS=1 restores the serial loop."""
    import os as _o
    k = int(_o.environ.get("SZ_TPU_HOST_THREADS", _o.cpu_count() or 1))
    if n <= 1 or k <= 1:
        return [fn(i) for i in range(n)]
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(max_workers=min(k, n)) as ex:
        return list(ex.map(fn, range(n)))

_DTYPE_MAP = {np.dtype(np.float32): DataType.FLOAT,
              np.dtype(np.float64): DataType.DOUBLE}


def slab_shapes(global_shape, n_devices: int):
    """Split the slowest axis into n_devices equal slabs (must divide)."""
    r0 = global_shape[0]
    if r0 % n_devices:
        raise ValueError(f"axis 0 ({r0}) must divide by mesh size "
                         f"{n_devices}")
    return (r0 // n_devices, *global_shape[1:])


@functools.lru_cache(maxsize=8)
def _mesh(n_devices: int) -> Mesh:
    return Mesh(np.array(jax.devices()[:n_devices]), (AXIS,))


# ---------------------------------------------------------------------------
# Sharded stage programs (cached per mesh size × slab shape × dtype)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=8)
def _encode_stages(n_dev: int, lshape: tuple, dtype_str: str,
                   block_size: int, backend: str):
    """Three sharded dispatches: coefficient sums; predictor selection;
    fixpoint quantize (+ fused histogram/escape epilogue).  use_mean and
    all bound parameters are per-slab *data*, so one compiled program
    serves every stream configuration."""
    mesh = _mesh(n_dev)
    rank = len(lshape)
    sums_f = engine._coeff_sums_fn(lshape, dtype_str, block_size, "raw")
    select_f = engine._select_fn_dyn(lshape, dtype_str, block_size, "raw")
    quant_f = engine._quantize_fn_dyn(lshape, dtype_str, block_size, "raw")
    dspec = P(AXIS, *([None] * (rank - 1)))
    v = P(AXIS)

    def sums_local(d):
        return sums_f(d.reshape(lshape))[None]

    def select_local(d, coeffs, noise, mean, um):
        return select_f(d.reshape(lshape), coeffs[0], noise[0], mean[0],
                        um[0])[None]

    def quant_local(d, lc, ur, rp, recip, intervals, mean, um):
        _bflat, pos, iperm = engine.lattices(lshape, block_size)
        g = engine._geom_small(lshape, block_size)
        locs = tuple(jnp.asarray(l) for l in g["loc"])
        t_stream, hist, esc, _R, _it = quant_f(
            d.reshape(lshape), lc[0], ur[0], locs, iperm,
            rp[0], recip[0], intervals[0], mean[0], um[0])
        return t_stream[None], hist[:NBINS][None], esc[None]

    # check_vma=False: the per-slab scans carry from unvarying zeros and
    # pick up the slab-varying axis inside the body, which the vma
    # checker rejects even though the computation is slab-local.
    sums_sh = shard_map(sums_local, mesh=mesh, in_specs=(dspec,),
                        out_specs=P(AXIS), check_vma=False)
    select_sh = shard_map(select_local, mesh=mesh,
                          in_specs=(dspec, v, v, v, v),
                          out_specs=P(AXIS), check_vma=False)
    quant_sh = shard_map(quant_local, mesh=mesh,
                         in_specs=(dspec, v, v, v, v, v, v, v),
                         out_specs=(P(AXIS), P(AXIS), P(AXIS)),
                         check_vma=False)
    jit = engine._strict_jit
    return (jit(sums_sh, backend), jit(select_sh, backend),
            jit(quant_sh, backend))


@functools.lru_cache(maxsize=8)
def _range_stage(n_dev: int, lshape: tuple, backend: str):
    """Per-slab (min, max) in one sharded dispatch — the device-input
    analog of computeRangeSize (dataCompression.c:102; both reductions
    are order-independent, so any tree order is bit-exact)."""
    mesh = _mesh(n_dev)
    dspec = P(AXIS, *([None] * (len(lshape) - 1)))

    def local(d):
        f = d.reshape(-1)
        return jnp.min(f)[None], jnp.max(f)[None]

    sh = shard_map(local, mesh=mesh, in_specs=(dspec,),
                   out_specs=(P(AXIS), P(AXIS)), check_vma=False)
    return engine._strict_jit(sh, backend)


@functools.lru_cache(maxsize=8)
def _optgather_stage(n_dev: int, lshape: tuple, dtype_str: str,
                     sample_distance: int, backend: str):
    """Per-slab optimizer sampling gathers (device-input path): the
    walk indices are data-independent lshape constants, so one sharded
    dispatch returns the compact (mean_vals, cur, pred) sample vectors
    for every slab; the f64 histogram/selection tail stays on the host
    (engine._opt_gather_fn rationale)."""
    mesh = _mesh(n_dev)
    rank = len(lshape)
    dspec = P(AXIS, *([None] * (rank - 1)))
    gather_f = engine._opt_gather_fn(lshape, dtype_str, "raw")
    midx, sidx = engine._opt_walks(lshape, rank, sample_distance)
    it = np.int32 if int(np.prod(lshape)) < (1 << 31) else np.int64
    midx = midx.astype(it)
    sidx = sidx.astype(it)

    def local(d):
        mv, cur, pred = gather_f(d.reshape(-1), jnp.asarray(midx),
                                 jnp.asarray(sidx))
        return mv[None], cur[None], pred[None]

    sh = shard_map(local, mesh=mesh, in_specs=(dspec,),
                   out_specs=(P(AXIS),) * 3, check_vma=False)
    return engine._strict_jit(sh, backend), len(midx), len(sidx)


@functools.lru_cache(maxsize=8)
def _maskvals_stage(n_dev: int, lshape: tuple, dtype_str: str, k: int,
                    backend: str):
    """Per-slab dense-value extraction for the mean flush (device-input
    path): compact masked vectors + exact counts in one dispatch; the
    sequential mean fold runs on the host per slab."""
    mesh = _mesh(n_dev)
    dspec = P(AXIS, *([None] * (len(lshape) - 1)))
    n_local = int(np.prod(lshape))
    mask_f = engine._mask_vals_fn(n_local, dtype_str, k, "raw")

    def local(d, dense_pos, rp):
        c, v = mask_f(d.reshape(-1), dense_pos[0], rp[0])
        return c[None], v[None]

    sh = shard_map(local, mesh=mesh, in_specs=(dspec, P(AXIS), P(AXIS)),
                   out_specs=(P(AXIS), P(AXIS)), check_vma=False)
    return engine._strict_jit(sh, backend)


@functools.lru_cache(maxsize=16)
def _bitpack_stage(n_dev: int, npts: int, out_bytes: int, backend: str):
    """Per-slab Huffman bit-pack (shared dispatch, per-slab code tables)."""
    mesh = _mesh(n_dev)
    pack_f = engine.bitpack_fn(npts, out_bytes, "raw")

    def local(t_stream, code_hi, code_len):
        return pack_f(t_stream[0], code_hi[0], code_len[0])[None]

    sh = shard_map(local, mesh=mesh, in_specs=(P(AXIS), P(AXIS), P(AXIS)),
                   out_specs=P(AXIS), check_vma=False)
    return engine._strict_jit(sh, backend)


@functools.lru_cache(maxsize=16)
def _decode_stage(n_dev: int, lshape: tuple, dtype_str: str,
                  block_size: int, k: int, backend: str):
    """Sharded fixpoint reconstruction of all slabs in one dispatch
    (parallel decoder analog, sz_omp.c:366)."""
    mesh = _mesh(n_dev)
    delatt = engine._delattice_fn(lshape, dtype_str, k, "raw")
    dec = engine._decode_fn_dyn(lshape, dtype_str, block_size, "raw")

    def local(types, unpred_pad, lc, ur, rp, intervals, mean, um):
        _bflat, pos, iperm = engine.lattices(lshape, block_size)
        g = engine._geom_small(lshape, block_size)
        locs = tuple(jnp.asarray(l) for l in g["loc"])
        t_lat, unpred_lat = delatt(types[0], unpred_pad[0], pos, iperm)
        R, _it = dec(t_lat, lc[0], ur[0], unpred_lat, locs,
                     rp[0], intervals[0], mean[0], um[0])
        return R[None]

    sh = shard_map(local, mesh=mesh, in_specs=(P(AXIS),) * 8,
                   out_specs=P(AXIS), check_vma=False)
    return engine._strict_jit(sh, backend)


# ---------------------------------------------------------------------------
# Encode driver
# ---------------------------------------------------------------------------

def _eligible(cfg: SZConfig, lshape: tuple) -> bool:
    """Can the sharded fast path produce this stream?  (Must mirror the
    api.compress dispatch: regression-engine streams only.)"""
    rank = len(lshape)
    if rank == 4:
        rank = 3  # folded (sz_float.c:3010)
    return (rank in (2, 3) and cfg.with_regression
            and not cfg.random_access
            and int(np.prod(lshape)) > MIN_NUM_OF_ELEMENTS
            and cfg.error_bound_mode != ErrorBoundMode.PW_REL)


def compress_sharded(data, cfg: SZConfig = DEFAULT_CONFIG,
                     n_devices: int = None) -> bytes:
    """Data-parallel compress over a device mesh into an SZRA container.

    Every slab payload is byte-identical to `api.compress(slab, cfg)`;
    slabs that the fast path cannot serve (constant fields, PW_REL,
    classic-path configs, non-float dtypes) fall back to the serial
    driver per slab, preserving the parity guarantee by construction.

    `data` may be a device-resident (sharded) jax.Array — the SPMD
    checkpoint-compression case: each shard is compressed where it
    lives with NO host round-trip of the lattice (per-slab range scan,
    optimizer sampling gathers and dense-mean extraction all run as
    sharded dispatches; only compact vectors and the streams cross the
    bus).
    """
    is_dev = api._is_jax_array(data)
    if not is_dev:
        data = np.asarray(data)
    if n_devices is None:
        n_devices = len(jax.devices())
    dt = _DTYPE_MAP.get(np.dtype(data.dtype))
    shape = tuple(int(r) for r in data.shape)
    eligible = (dt is not None and data.ndim >= 2
                and shape[0] % n_devices == 0
                and all(int(d) > 1 for d in shape)  # filterDimension
                and _eligible(cfg, slab_shapes(shape, n_devices)))
    if not eligible:
        # serial per-slab fallback (still the MPI-chunk pattern)
        return ra.compress(np.asarray(data), cfg,
                           n_slabs=min(n_devices, shape[0]))

    T = np.float32 if dt == DataType.FLOAT else np.float64
    lshape0 = slab_shapes(shape, n_devices)
    # 4D regression folds to 3D per slab (sz_float.c:3010)
    lshape = lshape0
    if len(lshape0) == 4:
        lshape = (lshape0[0] * lshape0[1], lshape0[2], lshape0[3])
    rank = len(lshape)
    spec = regnd._spec(rank, T)
    dstr = np.dtype(T).str.lstrip("<>=")
    backend = jax.default_backend()
    bs = spec.block_size
    dbs = [B.dim_blocks(r, bs) for r in lshape]
    nblocks = int(np.prod([db.num for db in dbs]))
    n_local = int(np.prod(lshape))
    starts = ra._slab_bounds(shape[0], n_devices)
    mesh = _mesh(n_devices)
    dsh = NamedSharding(mesh, P(AXIS, *([None] * (len(shape) - 1))))

    # --- pre-pass: per-slab range / bound / header params -----------------
    if is_dev:
        dev = jax.device_put(jnp.asarray(data, T), dsh)
        slabs = None
        mins, maxs = _range_stage(n_devices, lshape0, backend)(dev)
        mins, maxs = np.asarray(mins), np.asarray(maxs)
        ne = int(np.prod(lshape0))
        params = [api._fp_params_from_range(
            cfg, dt, T(mins[i]), T(T(maxs[i]) - T(mins[i])), ne)
            for i in range(n_devices)]
    else:
        data = np.ascontiguousarray(data, dtype=T)
        dev = None
        slabs = [data[int(starts[i]):int(starts[i + 1])]
                 for i in range(n_devices)]
        params = [api._fp_stream_params(s, cfg, dt) for s in slabs]
    # constant slabs (value_range <= rp) can't use the fast path
    if any(p[2] <= p[3] for p in params):
        return ra.compress(np.asarray(data), cfg, n_slabs=n_devices)

    rp_arr = np.array([T(p[3]) for p in params], dtype=T)
    recip_arr = np.array([T(T(1) / T(p[3])) for p in params], dtype=T)
    noise_arr = np.array(
        [T(np.float64(T(p[3])) * spec.noise_factor) for p in params],
        dtype=T)

    sums_st, select_st, quant_st = _encode_stages(
        n_devices, lshape, dstr, bs, backend)
    if dev is None:
        dev = jax.device_put(data, dsh)

    # --- stage 1: coefficient sums (device) + finalize (host) ------------
    sums = np.asarray(sums_st(dev))  # (n_dev, nblocks, ncoeff)
    coeffs = np.stack(_pmap_host(
        lambda i: engine._finalize_coeffs(sums[i], lshape, bs, T),
        n_devices))

    # --- per-slab interval optimizer / mean ------------------------------
    # (host-sampled for numpy input; sharded device gathers + host f64
    # selection tail for device input — engine._device_optimizer split)
    intervals = np.zeros(n_devices, np.int32)
    use_mean = np.zeros(n_devices, bool)
    mean_arr = np.zeros(n_devices, T)
    if cfg.quantization_intervals != 0:
        intervals[:] = cfg.quantization_intervals
    elif is_dev:
        gst, n_mean, n_samp = _optgather_stage(
            n_devices, lshape, dstr, cfg.sample_distance, backend)
        mv_a, cur_a, pred_a = gst(dev)
        mv_a, cur_a, pred_a = (np.asarray(mv_a), np.asarray(cur_a),
                               np.asarray(pred_a))
        dense_arr = np.zeros(n_devices, T)
        for i in range(n_devices):
            itv, dense_pos, max_freq, mean_freq = \
                engine._optimizer_host_tail(
                    mv_a[i], cur_a[i], pred_a[i], n_mean, n_samp,
                    float(params[i][3]), cfg.max_range_radius,
                    np.float32(cfg.pred_threshold), T)
            use_mean[i] = opt.decide_use_mean(mean_freq, max_freq, rank)
            intervals[i] = itv
            dense_arr[i] = dense_pos
        if use_mean.any():
            k = 1 << 16
            while True:
                counts, vals = _maskvals_stage(
                    n_devices, lshape0, dstr, k, backend)(
                    dev, jnp.asarray(dense_arr), jnp.asarray(rp_arr))
                counts = np.asarray(counts)
                cmax = int(max(counts[i] for i in range(n_devices)
                               if use_mean[i]))
                if cmax <= k:
                    break
                k = engine._pad_pow2(cmax)
            vals = np.asarray(vals)
            for i in range(n_devices):
                if use_mean[i]:
                    mean_arr[i] = opt.fold_mean(vals[i][:counts[i]], T)
    else:
        for i in range(n_devices):
            # the optimizer receives the unrounded double bound, the mean
            # mask the T-rounded one — exactly as regnd.compress does
            rp_d = float(params[i][3])
            rp = T(rp_d)
            sflat = slabs[i].reshape(-1)
            if rank == 3:
                itv, dense_pos, max_freq, mean_freq = \
                    opt.optimize_intervals_3d_freq_dense(
                        sflat, *lshape, rp_d, cfg.max_range_radius,
                        cfg.sample_distance,
                        np.float32(cfg.pred_threshold), T=T)
            else:
                itv, dense_pos, max_freq, mean_freq = \
                    opt.optimize_intervals_2d_freq_dense(
                        sflat, *lshape, rp_d, cfg.max_range_radius,
                        cfg.sample_distance,
                        np.float32(cfg.pred_threshold), T=T)
            um = opt.decide_use_mean(mean_freq, max_freq, rank)
            if um:
                mask = np.abs(slabs[i].reshape(lshape) - dense_pos) < rp
                mean_arr[i] = opt.fold_mean(
                    slabs[i].reshape(-1)[np.flatnonzero(mask.reshape(-1))],
                    T)
            use_mean[i] = um
            intervals[i] = itv

    # --- stage 2: predictor selection (device) ---------------------------
    use_reg = np.asarray(select_st(dev, jnp.asarray(coeffs), noise_arr,
                                   mean_arr, use_mean))

    # --- coefficient delta chain (host, serial per slab) -----------------
    chains = _pmap_host(
        lambda i: regnd.quantize_coeff_chain(coeffs[i], use_reg[i],
                                             T(params[i][3]), dbs, spec,
                                             bool(use_mean[i])),
        n_devices)
    lc_full = np.zeros((n_devices, nblocks, spec.ncoeff), dtype=T)
    for i in range(n_devices):
        lc_full[i][np.flatnonzero(use_reg[i])] = chains[i][2]

    # --- stage 3: fixpoint quantize + epilogue (device) ------------------
    t_stream_d, hist_d, esc_d = quant_st(
        dev, jnp.asarray(lc_full), jnp.asarray(use_reg), rp_arr,
        recip_arr, intervals, mean_arr, use_mean)
    hist = np.asarray(hist_d)
    esc = np.asarray(esc_d)

    # --- host: per-slab Huffman tables -----------------------------------
    def _tree(i):
        state_num = 2 * int(intervals[i])
        freq = np.zeros(2 * state_num, np.int64)
        m = min(NBINS, 2 * state_num)
        freq[:m] = hist[i][:m]
        tb = huffman.build_tables(None, state_num, freq=freq)
        max_len = int(tb.code_len.max()) if tb.code_len.size else 0
        total_bits = int((freq[:len(tb.code_len)]
                          * tb.code_len.astype(np.int64)).sum())
        return (tb, freq, (total_bits + 7) // 8,
                not (0 < max_len <= 32 and total_bits > 0))

    trees = _pmap_host(_tree, n_devices)
    tables = [t[0] for t in trees]
    freqs = [t[1] for t in trees]
    nbytes = [t[2] for t in trees]
    host_encode = [t[3] for t in trees]

    # --- stage 4: bit pack (device, per-slab tables) ---------------------
    smax = max(len(tb.code_hi) for tb in tables)
    code_hi = np.zeros((n_devices, smax), np.uint64)
    code_len = np.zeros((n_devices, smax), np.int32)
    for i, tb in enumerate(tables):
        code_hi[i, :len(tb.code_hi)] = tb.code_hi
        code_len[i, :len(tb.code_len)] = tb.code_len
    out_bytes = engine._pad_pow2(max(nbytes) + 8)
    # same 1 MB-granularity download cut as engine.compress: the pow2
    # padding keeps the kernel shape-cached but would up-to-double the
    # per-slab D2H transfer
    cut = min(out_bytes, ((max(nbytes) + 8 + (1 << 20) - 1) >> 20) << 20)
    packed_d = _bitpack_stage(n_devices, n_local, out_bytes, backend)(
        t_stream_d, jnp.asarray(code_hi), jnp.asarray(code_len))
    packed = np.asarray(packed_d[:, :cut])

    # --- host: per-slab assembly + container ------------------------------
    def _assemble(i):
        fmin, fmax, _vr, rp, _em, hdr_cfg, _ri = params[i]
        rp = T(rp)
        n_esc = int(hist[i][0])
        if n_esc <= engine.ESC_K:
            unpred_arr = esc[i][:n_esc].astype(T)
        else:  # rare: escape overflow — host gather via stream maps
            types_i = np.asarray(t_stream_d[i])
            _pos, iperm = engine._host_stream_maps(lshape, bs)
            lat = iperm[np.flatnonzero(types_i == 0)]
            if slabs is None:  # device input: materialize this slab only
                snp = np.asarray(
                    dev[int(starts[i]):int(starts[i + 1])]).reshape(-1)
            else:
                snp = slabs[i].reshape(-1)
            unpred_arr = snp[lat]
        if host_encode[i]:  # pragma: no cover - pathological trees
            result_type = np.asarray(t_stream_d[i])
            encoded = None
        else:
            result_type = np.zeros(0, np.uint16)
            encoded = packed[i][:nbytes[i]].tobytes()
        ctypes, cunpred, _qc, cprec = chains[i]
        res = regnd.assemble_body(
            spec, rp, int(intervals[i]), bool(use_mean[i]),
            T(mean_arr[i]), use_reg[i], ctypes, cunpred, cprec,
            result_type, unpred_arr, cfg.size_type, freq=freqs[i],
            tables=tables[i], encoded=encoded)
        # flat is consulted only by the (rare) StoreOriData fallback;
        # for device input pass the lazy device slice — _store_ori
        # materializes it only when the fallback actually triggers
        flat_i = (dev[int(starts[i]):int(starts[i + 1])].reshape(-1)
                  if slabs is None else slabs[i].reshape(-1))
        return api._frame_regression_stream(
            cfg, hdr_cfg, dt, fmin, fmax, flat_i,
            int(np.prod(lshape0)), res)

    payloads = _pmap_host(_assemble, n_devices)
    return ra.build_container(shape, data.dtype, starts, payloads)


# ---------------------------------------------------------------------------
# Decode driver
# ---------------------------------------------------------------------------

def decompress_sharded(blob: bytes, n_devices: int = None,
                       as_jax: bool = False):
    """Decode an SZRA container with all slabs reconstructed in one
    sharded dispatch.  Falls back to the serial reader for containers the
    fast path cannot serve (unequal slabs, non-regression payloads)."""
    r = ra.Reader(blob)
    if n_devices is None:
        n_devices = len(jax.devices())
    sizes = np.diff(r.starts.astype(np.int64))
    if (r.n_slabs != n_devices or len(set(sizes.tolist())) != 1
            or len(r.shape) not in (2, 3)):
        return r.decode()
    lshape = (int(sizes[0]), *r.shape[1:])
    T = np.float32 if np.dtype(r.dtype) == np.float32 else np.float64
    dt = _DTYPE_MAP[np.dtype(r.dtype)]
    dstr = np.dtype(T).str.lstrip("<>=")
    spec = regnd._spec(len(lshape), T)
    bs = spec.block_size
    dbs = [B.dim_blocks(d, bs) for d in lshape]
    nblocks = int(np.prod([db.num for db in dbs]))
    n_local = int(np.prod(lshape))
    backend = jax.default_backend()

    parsed = []
    for i in range(r.n_slabs):
        slab = r.slab_bytes(i)
        mlen = md.meta_length(dt)
        if len(slab) not in (8 + 4 + mlen, 8 + 8 + mlen):
            inner = ll.decompress(
                slab, expected_size=n_local * spec.esize + 4 + mlen + 8)
        else:
            inner = slab
        hdr = md.parse_header(inner, dt)
        if not hdr.regression or hdr.same or hdr.lossless or hdr.pw_rel:
            return r.decode()  # mixed container: serial path
        off = hdr.body_offset + hdr.size_type
        parsed.append(regnd.parse_body(inner[off:], lshape, T,
                                       size_type=hdr.size_type))

    k = engine._pad_pow2(max(max(len(p.unpred) for p in parsed), 1))
    types = np.zeros((n_devices, n_local), np.uint16)
    unpred_pad = np.zeros((n_devices, k), T)
    lc_full = np.zeros((n_devices, nblocks, spec.ncoeff), T)
    use_reg = np.zeros((n_devices, nblocks), bool)
    rp_arr = np.zeros(n_devices, T)
    intervals = np.zeros(n_devices, np.int32)
    mean_arr = np.zeros(n_devices, T)
    um_arr = np.zeros(n_devices, bool)
    for i, p in enumerate(parsed):
        types[i] = p.types.astype(np.uint16)
        unpred_pad[i, :len(p.unpred)] = p.unpred
        ur = (p.indicator == 0)
        use_reg[i] = ur
        lc_full[i][np.flatnonzero(ur)] = p.qcoeffs
        rp_arr[i] = T(p.rp)
        intervals[i] = p.intervals
        mean_arr[i] = T(p.mean)
        um_arr[i] = bool(p.use_mean)

    out = _decode_stage(n_devices, lshape, dstr, bs, k, backend)(
        types, unpred_pad, lc_full, use_reg, rp_arr, intervals,
        mean_arr, um_arr)
    out = out.reshape(r.shape)
    if as_jax:
        return out
    return np.asarray(out).astype(r.dtype, copy=False)
