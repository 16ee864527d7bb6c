"""Worker process for tests/test_multihost.py (run via subprocess).

Each rank joins a jax.distributed cluster, compresses its slab of a
deterministic global field, and the streams ride an ordered
process_allgather; rank 0 assembles the SZRA container and writes it
to the path in argv.  Mirrors the reference's rank-independent-chunk
multi-node pattern (hdf5-filter/H5Z-SZ/test/test_mpio.c:34-59).
"""

import sys


def main(rank: int, nprocs: int, port: int, out_path: str) -> None:
    import os
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax
    jax.config.update("jax_platforms", "cpu")
    if nprocs > 1:
        jax.distributed.initialize(f"localhost:{port}", nprocs, rank)
    import numpy as np
    import jax.numpy as jnp
    from jax.experimental import multihost_utils

    import sz_tpu
    from sz_tpu import ra
    from sz_tpu.config import SZConfig, ErrorBoundMode

    shape = (32, 48, 40)
    rng = np.random.default_rng(99)  # same field on every rank
    data = (np.sin(np.linspace(0, 11, int(np.prod(shape)),
                               dtype=np.float32))
            + 0.05 * rng.standard_normal(int(np.prod(shape)))
            ).astype(np.float32).reshape(shape)
    starts = ra._slab_bounds(shape[0], nprocs)
    a, b = int(starts[rank]), int(starts[rank + 1])
    cfg = SZConfig(engine="numpy").with_bound(ErrorBoundMode.ABS, 1e-3)
    blob = sz_tpu.compress(data[a:b], cfg)

    if nprocs == 1:
        payloads = [blob]
    else:
        sizes = multihost_utils.process_allgather(
            jnp.asarray([len(blob)], jnp.int32))
        cap = 1 << 20
        pad = np.zeros(cap, np.uint8)
        pad[:len(blob)] = np.frombuffer(blob, np.uint8)
        streams = multihost_utils.process_allgather(jnp.asarray(pad))
        payloads = [streams[i, :int(sizes[i, 0])].tobytes()
                    for i in range(nprocs)]
    if rank == 0:
        container = ra.build_container(shape, np.float32, starts,
                                       payloads)
        with open(out_path, "wb") as f:
            f.write(container)


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]),
         sys.argv[4])
