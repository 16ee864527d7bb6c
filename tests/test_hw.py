"""GPU tests: compiled kernels and engines on a real card.

The regular suite runs on the CPU, where the Triton decode kernel runs
in interpret mode and the engines run fusion-disabled XLA:CPU — a GPU
lowering or rounding difference would pass there and only surface on
the card.  These tests carry the `gpu` marker and skip without a GPU;
`python chip_smoke.py` runs them on the card:

    SZ_TPU_TEST_PLATFORM=gpu python -m pytest -m gpu tests/test_hw.py

(SZ_TPU_TEST_PLATFORM overrides conftest's CPU pin.)  Each test compiles
for the card and asserts bit parity against the host oracle.
"""

import numpy as np
import pytest

pytestmark = pytest.mark.gpu

KW = dict(max_range_radius=32768, sample_distance=100,
          pred_threshold=np.float32(0.99))


@pytest.fixture(scope="module")
def gpu():
    jax = pytest.importorskip("jax")
    if jax.default_backend() != "gpu":
        pytest.skip("no GPU attached (set SZ_TPU_TEST_PLATFORM=gpu)")
    return jax


def _field(shape, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    n = int(np.prod(shape))
    return (np.sin(np.linspace(0, 40, n)) + 0.2 * rng.standard_normal(n)
            ).astype(dtype).reshape(shape)


def test_hw_fsm_decode(gpu):
    """The compiled Triton decode kernel recovers a skewed multi-
    million-symbol stream exactly (the host FSM is the reference)."""
    from sz_tpu.format import huffman
    from sz_tpu.tpu import fsm_kernel as fsm

    rng = np.random.default_rng(29)
    n, nstate = 1 << 22, 4000
    p = 1.0 / np.arange(1, nstate + 1) ** 1.5
    types = rng.choice(nstate, size=n, p=p / p.sum()).astype(np.int32)
    tables = huffman.build_tables(types, nstate)
    enc = huffman.encode(tables, types)
    trans = fsm.build_trans(tables.L, tables.R, tables.C, tables.T)
    syms, ok = fsm.decode(enc, trans, n)
    assert bool(ok)
    np.testing.assert_array_equal(np.asarray(syms), types)


@pytest.mark.parametrize("shape,dtype", [
    ((96, 80, 72), np.float32), ((600, 700), np.float32),
    ((64, 64, 64), np.float64)])
def test_hw_engine_roundtrip(gpu, shape, dtype):
    """Regression engine on the card: bytes equal the numpy oracle's and
    the reconstruction is bit-identical."""
    from sz_tpu.core import regnd
    from sz_tpu.tpu import engine

    data = _field(shape, 3, dtype)
    a = regnd.compress(data, 1e-3, **KW)
    b = engine.compress(data, 1e-3, **KW)
    assert a.body == b.body
    u = np.uint32 if dtype == np.float32 else np.uint64
    oa = regnd.decompress(a.body, shape, dtype)
    ob = engine.decompress(a.body, shape, dtype)
    np.testing.assert_array_equal(oa.view(u), ob.view(u))


def test_hw_histogram_and_pack(gpu):
    """XLA histogram and scatter-add pack on the card equal numpy."""
    from sz_tpu.format import huffman
    from sz_tpu.tpu import engine

    rng = np.random.default_rng(11)
    n = 1 << 22
    t = (32768 + rng.geometric(0.4, n) * rng.choice([-1, 1], n)).astype(
        np.int32)
    t[rng.random(n) < 0.01] = 0
    hist = np.asarray(engine.histogram(engine.jnp.asarray(t)))
    np.testing.assert_array_equal(hist, np.bincount(t, minlength=65536))
    freq = np.bincount(t, minlength=65536 * 2).astype(np.int64)
    tables = huffman.build_tables(None, 65536, freq=freq)
    bits = int((freq[:len(tables.code_len)]
                * tables.code_len.astype(np.int64)).sum())
    nbytes = (bits + 7) // 8
    got = engine.pack_stream_device(engine.jnp.asarray(t), tables, n,
                                    nbytes, "gpu")
    assert got.tobytes() == huffman.encode(tables, t)[:nbytes]


def test_hw_graft_entry(gpu):
    """__graft_entry__.entry() compiles the fixpoint quantize for the
    card and runs it."""
    import pathlib
    import sys
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
    import __graft_entry__ as ge
    fn, args = ge.entry()
    t_stream, hist, _esc, _R, iters = fn(*args)
    t = np.asarray(t_stream)
    assert t.shape == (64 ** 3,) and int(iters) > 0
    np.testing.assert_array_equal(np.asarray(hist),
                                  np.bincount(t, minlength=65536))
