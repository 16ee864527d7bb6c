"""Multi-host (1->N process) scaling measurement over jax.distributed.

The reference's multi-node story is rank-independent chunk compression
through parallel HDF5 (hdf5-filter/H5Z-SZ/test/test_mpio.c:34-59): each
rank compresses its chunk, the container orders the streams.  This is
the accelerator-native equivalent: N processes join a jax.distributed cluster
(CPU backend here; the same code drives multi-host GPU clusters), each
compresses its local slab independently, per-rank stream sizes are
all-gathered, the byte streams ride a padded all-gather (the DCN
collective), and process 0 assembles the ordered SZRA container.

Usage:
    python tools/multihost_bench.py            # sweep N = 1, 2, 4
    python tools/multihost_bench.py --worker I N PORT   # internal
"""

import os
import subprocess
import sys
import time

SLAB = (128, 128, 128)  # per-process slab (weak scaling)


def worker(rank: int, nprocs: int, port: int) -> None:
    os.environ["JAX_PLATFORMS"] = "cpu"
    # one core per "host": without affinity the N co-located processes
    # contend for the same cores and the efficiency measures the box,
    # not the design
    ncpu = os.cpu_count() or 1
    try:
        os.sched_setaffinity(0, {rank % ncpu})
    except OSError:  # pragma: no cover
        pass
    import jax

    jax.config.update("jax_platforms", "cpu")
    if nprocs > 1:
        jax.distributed.initialize(f"localhost:{port}", nprocs, rank)
    import numpy as np
    from jax.experimental import multihost_utils

    import sz_tpu
    from sz_tpu import ra
    from sz_tpu.config import SZConfig, ErrorBoundMode

    rng = np.random.default_rng(1234 + rank)
    ax = [np.linspace(0, 4 * np.pi, n) for n in SLAB]
    g = np.meshgrid(*ax, indexing="ij")
    data = (np.sin(g[0]) * np.cos(g[1]) * np.sin(g[2])
            + 0.05 * rng.standard_normal(SLAB)).astype(np.float32)
    # native host codec per rank: the distributed mechanism under
    # test is jax.distributed + the ordered allgather, not XLA:CPU
    cfg = SZConfig(engine="numpy").with_bound(ErrorBoundMode.ABS, 1e-3)

    # warm (compile) outside the timed section — the codec AND the
    # collective path (process_allgather compiles per shape)
    blob = sz_tpu.compress(data, cfg)

    if nprocs > 1:
        import jax.numpy as jnp

        _ = multihost_utils.process_allgather(
            jnp.asarray([len(blob)], jnp.int32))
        warm_pad = np.zeros(1 << 22, np.uint8)
        _ = multihost_utils.process_allgather(jnp.asarray(warm_pad))
        multihost_utils.sync_global_devices("warmup")
    t0 = time.time()
    blob = sz_tpu.compress(data, cfg)
    t_local = time.time() - t0

    if nprocs > 1:
        import jax.numpy as jnp

        # ordered gather of per-rank streams over the cluster: sizes
        # first, then zero-padded payloads (the DCN all-gather)
        sizes = multihost_utils.process_allgather(
            jnp.asarray([len(blob)], jnp.int32))
        # fixed pad size so the gather reuses the warmed executable
        pad = np.zeros(1 << 22, np.uint8)
        pad[:len(blob)] = np.frombuffer(blob, np.uint8)
        streams = multihost_utils.process_allgather(jnp.asarray(pad))
        t_total = time.time() - t0
        if rank == 0:
            payloads = [streams[i, :int(sizes[i, 0])].tobytes()
                        for i in range(nprocs)]
            shape = (SLAB[0] * nprocs, *SLAB[1:])
            starts = np.arange(nprocs + 1, dtype=np.uint64) * SLAB[0]
            container = ra.build_container(shape, np.float32, starts,
                                           payloads)
            # correctness: rank 0's slab decodes bit-exactly from the
            # gathered container
            out0 = ra.Reader(container).decode_slab(0)
            ref0 = sz_tpu.decompress(blob, SLAB, np.float32)
            assert np.array_equal(out0, ref0), "gathered slab diverges"
            nbytes = int(np.prod(shape)) * 4
            print(f"RESULT {nprocs} {t_local:.3f} {t_total:.3f} "
                  f"{nbytes / 1e6 / t_total:.2f}", flush=True)
    else:
        nbytes = int(np.prod(SLAB)) * 4
        print(f"RESULT 1 {t_local:.3f} {t_local:.3f} "
              f"{nbytes / 1e6 / t_local:.2f}", flush=True)


def main():
    if len(sys.argv) > 1 and sys.argv[1] == "--worker":
        worker(int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]))
        return
    results = {}
    for nprocs in (1, 2, 4):
        port = 12345 + nprocs
        procs = [subprocess.Popen(
            [sys.executable, __file__, "--worker", str(i), str(nprocs),
             str(port)], stdout=subprocess.PIPE, text=True)
            for i in range(nprocs)]
        out = ""
        for p in procs:
            o, _ = p.communicate(timeout=600)
            out += o or ""
        for line in out.splitlines():
            if line.startswith("RESULT"):
                _, n, tl, tt, mbps = line.split()
                results[int(n)] = (float(tl), float(tt), float(mbps))
                print(f"N={n}: local {tl}s total {tt}s "
                      f"aggregate {mbps} MB/s", flush=True)
    if 1 in results:
        base = results[1][2]
        for n, (tl, tt, mbps) in sorted(results.items()):
            eff = mbps / (base * n) if n else 0
            print(f"N={n}: {mbps:.2f} MB/s, scaling efficiency "
                  f"{eff:.2f}")


if __name__ == "__main__":
    main()
