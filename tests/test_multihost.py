"""Multi-process jax.distributed data parallelism, in-suite.

The reference's multi-node story is rank-independent chunk compression
with ordered assembly (hdf5-filter/H5Z-SZ/test/test_mpio.c:34-59, via
parallel HDF5).  Here N separate PROCESSES join a jax.distributed
cluster (CPU backend in CI; the identical code drives multi-host GPU
clusters), each compresses its slab, the streams ride an
ordered process_allgather, and rank 0's assembled SZRA container must
be BYTE-IDENTICAL to the serial ra.compress of the same global field.
tools/multihost_bench.py is the scaling-measurement sibling of this
correctness gate.
"""

import os
import pathlib
import socket
import subprocess
import sys

import numpy as np
import pytest

WORKER = pathlib.Path(__file__).parent / "_mh_worker.py"


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _serial_container() -> bytes:
    from sz_tpu import ra
    from sz_tpu.config import SZConfig, ErrorBoundMode

    shape = (32, 48, 40)
    rng = np.random.default_rng(99)
    data = (np.sin(np.linspace(0, 11, int(np.prod(shape)),
                               dtype=np.float32))
            + 0.05 * rng.standard_normal(int(np.prod(shape)))
            ).astype(np.float32).reshape(shape)
    cfg = SZConfig(engine="numpy").with_bound(ErrorBoundMode.ABS, 1e-3)
    return data, ra.compress(data, cfg, n_slabs=NPROCS), cfg


NPROCS = 2


@pytest.mark.parametrize("nprocs", [2, 4])
def test_distributed_container_matches_serial(tmp_path, nprocs):
    global NPROCS
    if nprocs == 4 and (os.cpu_count() or 1) < 4:
        pytest.skip("needs >= 4 CPUs")
    NPROCS = nprocs
    out = tmp_path / "mh.szra"
    port = _free_port()
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("XLA_FLAGS", None)  # no virtual 8-dev mesh in workers
    # the worker is a bare script: put the repo root on its sys.path
    repo = str(pathlib.Path(__file__).resolve().parent.parent)
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    procs = [subprocess.Popen(
        [sys.executable, str(WORKER), str(i), str(nprocs), str(port),
         str(out)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE)
        for i in range(nprocs)]
    for p in procs:
        _, err = p.communicate(timeout=300)
        assert p.returncode == 0, err.decode()[-2000:]

    data, serial, cfg = _serial_container()
    got = out.read_bytes()
    assert got == serial

    # and the container decodes bit-exactly
    from sz_tpu import ra
    back = ra.decompress(got, engine="numpy")
    ref = ra.decompress(serial, engine="numpy")
    np.testing.assert_array_equal(back.view(np.uint32),
                                  ref.view(np.uint32))
