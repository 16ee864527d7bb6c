"""Device (jax) path for the random-access block codec.

SURVEY 2.3: the randomAccess blockwise format (sz_float.c:7492-10106)
is the natural device container — fixed-size edge-replicated blocks map
onto a regular device grid with no cross-block dependence.  This module
jits the per-block raster quantization/reconstruction as a `lax.scan`
over the bs^rank cells, vectorized over all blocks at once; each step
is one fused elementwise pass over the block axis, and the bordered
reconstruction buffer stays on chip for the whole scan.

Arithmetic matches the RA kernels' double quantizer (core/rablock.py
`_quant_cell`, sz_float.c:9751-9766) bit-for-bit; jax x64 is enabled by
sz_tpu.tpu.engine.  Outputs are the same type lattices the host
container assembly consumes — `compress_ra(..., engine="jax")` routes
here and produces byte-identical bodies (tests/test_ra_format.py).
"""

from __future__ import annotations

import functools

import numpy as np

from sz_tpu.tpu import engine as _eng

jax = _eng.jax
jnp = _eng.jnp


def _cell_tables(rank: int, bs: int):
    """Static per-cell geometry: coordinates, bordered-buffer flat
    index, and the 7 Lorenzo neighbor indices (bordered, zero guard)."""
    b1 = bs + 1
    cells = []
    if rank == 3:
        for ii in range(bs):
            for jj in range(bs):
                for kk in range(bs):
                    cells.append((ii, jj, kk))

        def bidx(ii, jj, kk):
            return ((ii + 1) * b1 + (jj + 1)) * b1 + (kk + 1)

        coords = np.array(cells, np.int32)
        self_idx = np.array([bidx(*c) for c in cells], np.int32)
        offs = []
        for (ii, jj, kk) in cells:
            i1, j1, k1 = ii + 1, jj + 1, kk + 1
            offs.append([
                (i1 * b1 + j1) * b1 + k1 - 1,
                (i1 * b1 + (j1 - 1)) * b1 + k1,
                ((i1 - 1) * b1 + j1) * b1 + k1,
                (i1 * b1 + (j1 - 1)) * b1 + k1 - 1,
                ((i1 - 1) * b1 + j1) * b1 + k1 - 1,
                ((i1 - 1) * b1 + (j1 - 1)) * b1 + k1,
                ((i1 - 1) * b1 + (j1 - 1)) * b1 + k1 - 1,
            ])
        nbrs = np.array(offs, np.int32)
        rsize = b1 ** 3
    elif rank == 2:
        for ii in range(bs):
            for jj in range(bs):
                cells.append((ii, jj))
        coords = np.array(cells, np.int32)
        self_idx = np.array([(c[0] + 1) * b1 + c[1] + 1 for c in cells],
                            np.int32)
        offs = []
        for (ii, jj) in cells:
            i1, j1 = ii + 1, jj + 1
            offs.append([i1 * b1 + j1 - 1, (i1 - 1) * b1 + j1,
                         (i1 - 1) * b1 + j1 - 1, 0, 0, 0, 0])
        nbrs = np.array(offs, np.int32)
        rsize = b1 ** 2
    else:
        for ii in range(bs):
            cells.append((ii,))
        coords = np.array(cells, np.int32)
        self_idx = np.arange(1, bs + 1, dtype=np.int32)
        nbrs = np.stack([np.arange(bs, dtype=np.int32)]
                        + [np.zeros(bs, np.int32)] * 6, axis=1)
        rsize = b1
    return coords, self_idx, nbrs, rsize


@functools.lru_cache(maxsize=16)
def _encode_fn(rank: int, bs: int, nc: int, use_mean: bool,
               backend: str = "cpu"):
    coords, self_idx, nbrs, rsize = _cell_tables(rank, bs)

    def f(blocks, lor, qc, rp64, cap, radius, mean):
        nb = blocks.shape[0]
        F32 = jnp.float32
        F64 = jnp.float64
        capf = cap.astype(F64)
        cap_szf = (cap - 2).astype(F64)
        lorb = lor.astype(bool)
        regb = ~lorb

        def step(R, xs):
            cell, sidx, nb7, cur = xs
            # regression predictor (float chain, qc columns)
            if rank == 3:
                pred_r = (qc[:, 0] * cell[0].astype(F32)
                          + qc[:, 1] * cell[1].astype(F32)
                          + qc[:, 2] * cell[2].astype(F32) + qc[:, 3])
            elif rank == 2:
                pred_r = (qc[:, 0] * cell[0].astype(F32)
                          + qc[:, 1] * cell[1].astype(F32) + qc[:, 2])
            else:
                pred_r = qc[:, 0] * cell[0].astype(F32) + qc[:, 1]
            # Lorenzo predictor from the bordered buffer (C order)
            if rank == 3:
                p = R[:, nb7[0]] + R[:, nb7[1]]
                p = p + R[:, nb7[2]]
                p = p - R[:, nb7[3]]
                p = p - R[:, nb7[4]]
                p = p - R[:, nb7[5]]
                p = p + R[:, nb7[6]]
            elif rank == 2:
                p = R[:, nb7[0]] + R[:, nb7[1]] - R[:, nb7[2]]
            else:
                p = R[:, nb7[0]]
            pred = jnp.where(regb, pred_r, p)
            ccap = jnp.where(regb, capf, cap_szf)

            diff = (cur - pred).astype(F64)
            itv = jnp.abs(diff) / rp64 + 1.0
            within = itv < ccap
            itv = jnp.where(diff < 0, -itv, itv)
            t = jnp.trunc(itv / 2).astype(jnp.int32) + radius
            rec = (pred.astype(F64)
                   + (2 * (t - radius)).astype(F64) * rp64).astype(F32)
            ok = within & (jnp.abs((cur - rec).astype(F64)) <= rp64)
            t = jnp.where(ok, t, 0)
            rec = jnp.where(ok, rec, cur)
            if use_mean:
                mmask = lorb & (jnp.abs((cur - mean).astype(F64))
                                <= rp64)
                t = jnp.where(mmask, 1, t)
                rec = jnp.where(mmask, mean, rec)
            stored = jnp.where(regb, cur, rec)
            R = R.at[:, sidx].set(stored)
            return R, t

        R0 = jnp.zeros((nb, rsize), jnp.float32)
        xs = (jnp.asarray(coords), jnp.asarray(self_idx),
              jnp.asarray(nbrs), blocks.swapaxes(0, 1))
        _, types = jax.lax.scan(step, R0, xs)
        return types.swapaxes(0, 1)

    return _eng._strict_jit(f, backend)


def _shard_over_blocks(fn_raw, n_devices: int, arrs, scalars):
    """Run a per-block device computation data-parallel over an
    n-device mesh: the (independent) block batches shard over the mesh
    axis, scalars replicate — the SURVEY §2.3 regular-device-grid
    mapping of the RA format.  Pads the block axis to a multiple of the
    mesh size (duplicate blocks are discarded)."""
    from jax.sharding import Mesh, PartitionSpec as P
    try:
        from jax import shard_map  # jax >= 0.8
        vma_kw = {"check_vma": False}
    except ImportError:  # pragma: no cover - older jax
        from jax.experimental.shard_map import shard_map  # type: ignore
        vma_kw = {"check_rep": False}
    avail = len(jax.devices())
    if n_devices > avail:
        raise ValueError(
            f"n_devices={n_devices} but only {avail} devices attached")
    devs = np.array(jax.devices()[:n_devices])
    mesh = Mesh(devs, ("blocks",))
    nb = arrs[0].shape[0]
    pad = (-nb) % n_devices
    if pad:
        arrs = [np.concatenate([np.asarray(a),
                                np.repeat(np.asarray(a)[-1:], pad, 0)])
                for a in arrs]
    in_specs = tuple([P("blocks")] * len(arrs) + [P()] * len(scalars))
    # vma/rep check off: the scan carry is created inside the body
    # (unvarying zeros) and joins the varying block batch — no
    # collectives anywhere, every block is independent
    f = shard_map(fn_raw, mesh=mesh, in_specs=in_specs,
                  out_specs=P("blocks"), **vma_kw)
    f = _eng._strict_jit(f, jax.default_backend())
    out = np.asarray(f(*[jnp.asarray(a) for a in arrs], *scalars))
    return out[:nb]


def encode_blocks(blocks: np.ndarray, indicator: np.ndarray,
                  qcoeffs_full: np.ndarray, rank: int, bs: int, rp,
                  intervals: int, use_mean: bool, mean,
                  n_devices: int | None = None) -> np.ndarray:
    """Device analog of rablock._encode_blocks — identical type
    lattices (tests gate byte equality of the assembled body).
    n_devices > 1 shards the block batch over a device mesh."""
    be = jax.default_backend()
    ncell = bs ** rank
    scalars = (jnp.float64(float(rp)),
               jnp.asarray(int(intervals), jnp.int32),
               jnp.asarray(int(intervals) // 2, jnp.int32),
               jnp.float32(mean))
    if n_devices and n_devices > 1:
        fn = _encode_fn(rank, bs, qcoeffs_full.shape[1], bool(use_mean),
                        "raw")
        return _shard_over_blocks(
            fn, n_devices,
            [blocks.reshape(blocks.shape[0], ncell),
             np.asarray(indicator, np.uint8), qcoeffs_full], scalars)
    fn = _encode_fn(rank, bs, qcoeffs_full.shape[1], bool(use_mean), be)
    types = fn(jnp.asarray(blocks.reshape(blocks.shape[0], ncell)),
               jnp.asarray(np.asarray(indicator, np.uint8)),
               jnp.asarray(qcoeffs_full), *scalars)
    return np.asarray(types)


@functools.lru_cache(maxsize=16)
def _decode_fn(rank: int, bs: int, nc: int, use_mean: bool,
               backend: str = "cpu"):
    coords, self_idx, nbrs, rsize = _cell_tables(rank, bs)

    def f(types, escv, lor, qc, rp64, radius, mean):
        nb = types.shape[0]
        F32 = jnp.float32
        F64 = jnp.float64
        lorb = lor.astype(bool)
        regb = ~lorb

        def step(R, xs):
            cell, sidx, nb7, t, ev = xs
            if rank == 3:
                pred_r = (qc[:, 0] * cell[0].astype(F32)
                          + qc[:, 1] * cell[1].astype(F32)
                          + qc[:, 2] * cell[2].astype(F32) + qc[:, 3])
            elif rank == 2:
                pred_r = (qc[:, 0] * cell[0].astype(F32)
                          + qc[:, 1] * cell[1].astype(F32) + qc[:, 2])
            else:
                pred_r = qc[:, 0] * cell[0].astype(F32) + qc[:, 1]
            if rank == 3:
                p = R[:, nb7[0]] + R[:, nb7[1]]
                p = p + R[:, nb7[2]]
                p = p - R[:, nb7[3]]
                p = p - R[:, nb7[4]]
                p = p - R[:, nb7[5]]
                p = p + R[:, nb7[6]]
            elif rank == 2:
                p = R[:, nb7[0]] + R[:, nb7[1]] - R[:, nb7[2]]
            else:
                p = R[:, nb7[0]]
            pred = jnp.where(regb, pred_r, p)
            val = (pred.astype(F64)
                   + (2 * (t - radius)).astype(F64) * rp64).astype(F32)
            if use_mean:
                val = jnp.where(lorb & (t == 1), mean, val)
            val = jnp.where(t == 0, ev, val)
            R = R.at[:, sidx].set(val)
            return R, val

        R0 = jnp.zeros((nb, rsize), jnp.float32)
        xs = (jnp.asarray(coords), jnp.asarray(self_idx),
              jnp.asarray(nbrs), types.swapaxes(0, 1),
              escv.swapaxes(0, 1))
        _, vals = jax.lax.scan(step, R0, xs)
        return vals.swapaxes(0, 1)

    return _eng._strict_jit(f, backend)


def decode_blocks(types: np.ndarray, rank: int, bs: int,
                  lor_sel: np.ndarray, qc_sel: np.ndarray, rp,
                  radius: int, use_mean: bool, mean,
                  unpred: np.ndarray, esc_base: np.ndarray,
                  n_devices: int | None = None) -> np.ndarray:
    """Device analog of the host per-block reconstruction: escape
    values are pre-gathered per cell on host (cumulative escape ranks),
    so the scan is one fused elementwise step per cell.
    n_devices > 1 shards the block batch over a device mesh."""
    be = jax.default_backend()
    nsel, ncell = types.shape
    esc_mask = types == 0
    ranks = np.cumsum(esc_mask, axis=1) - 1
    take = np.asarray(esc_base)[:, None] + ranks
    escv = np.zeros((nsel, ncell), np.float32)
    if len(unpred):
        escv[esc_mask] = np.asarray(unpred, np.float32)[take[esc_mask]]
    scalars = (jnp.float64(float(rp)),
               jnp.asarray(int(radius), jnp.int32), jnp.float32(mean))
    if n_devices and n_devices > 1:
        fn = _decode_fn(rank, bs, qc_sel.shape[1], bool(use_mean),
                        "raw")
        return _shard_over_blocks(
            fn, n_devices,
            [types, escv, np.asarray(lor_sel, np.uint8),
             np.asarray(qc_sel, np.float32)], scalars)
    fn = _decode_fn(rank, bs, qc_sel.shape[1], bool(use_mean), be)
    out = fn(jnp.asarray(types), jnp.asarray(escv),
             jnp.asarray(np.asarray(lor_sel, np.uint8)),
             jnp.asarray(qc_sel, np.float32), *scalars)
    return np.asarray(out)
