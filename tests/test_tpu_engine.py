"""Device (JAX) engine parity: identical bytes to the numpy oracle and
to reference-produced goldens.

Runs on the CPU backend in CI (conftest sets JAX_PLATFORMS=cpu); the
same parity on the GPU is checked by tests/test_hw.py and chip_smoke.py
(the fixpoint formulation is backend-independent as long as every op is
a separately rounded HLO op).
"""

import pathlib

import numpy as np
import pytest

from sz_tpu.core import regnd

engine = pytest.importorskip("sz_tpu.tpu.engine")

GOLDEN = pathlib.Path(__file__).parent / "golden"

KW = dict(max_range_radius=32768, sample_distance=100,
          pred_threshold=np.float32(0.99))
KW64 = dict(max_range_radius=32768, sample_distance=100,
            pred_threshold=np.float32(0.99))


def _synth64():
    return np.fromfile(GOLDEN / "synth_f32_64.dat",
                       dtype="<f4").reshape(64, 64, 64)


def _seeded(shape, dtype, seed):
    """Smooth field plus noise, made from a seed (the shapes of the
    reference's testfloat_8_8_128 / testdouble_8_8_128 inputs)."""
    rng = np.random.default_rng(seed)
    n = int(np.prod(shape))
    x = np.linspace(0, 6 * np.pi, n)
    return (np.sin(x) * 10 + rng.standard_normal(n) * 0.01).astype(
        dtype).reshape(shape)


CASES = [
    ("f32_3d", lambda: _seeded((128, 8, 8), np.float32, 1), 1e-4),
    # synth 64^3 exercises use_mean + many escapes
    ("f32_3d64_mean", _synth64, 1e-3),
    ("f32_2d", lambda: _seeded((128, 64), np.float32, 2), 1e-4),
    ("f64_3d", lambda: _seeded((128, 8, 8), np.float64, 3), 1e-4),
]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_engine_matches_oracle(case):
    _, load, eb = case
    data = load()
    kw = dict(KW)
    a = regnd.compress(data, eb, **kw)
    b = engine.compress(data, eb, **kw)
    assert a.body == b.body
    # decode side: bit-identical reconstruction lattice
    oa = regnd.decompress(a.body, data.shape, data.dtype)
    ob = engine.decompress(a.body, data.shape, data.dtype)
    u = np.uint32 if data.dtype == np.float32 else np.uint64
    np.testing.assert_array_equal(oa.view(u), ob.view(u))


def test_engine_decodes_reference_golden():
    data = _synth64()
    golden_out = np.fromfile(GOLDEN / "f32_3d64_abs1e-3.out",
                             dtype="<f4").reshape(64, 64, 64)
    from sz_tpu.format import lossless as ll
    from sz_tpu.format import metadata as md
    from sz_tpu.config import DataType
    blob = (GOLDEN / "f32_3d64_abs1e-3.sz").read_bytes()
    inner = ll.decompress(blob, expected_size=data.nbytes * 2 + 64)
    hdr = md.parse_header(inner, DataType.FLOAT)
    off = hdr.body_offset + hdr.size_type
    out = engine.decompress(inner[off:], data.shape, np.float32)
    np.testing.assert_array_equal(out.view(np.uint32),
                                  golden_out.view(np.uint32))


def test_engine_escape_overflow_path():
    """>ESC_K escapes exercises _escapes_fn (the second device call);
    its cumsum+scatter extraction must keep byte parity with the oracle."""
    rng = np.random.default_rng(3)
    data = rng.standard_normal((48, 48, 48)).astype(np.float32)
    kw = dict(KW, opt_quant_mode=0, fixed_intervals=16)
    a = regnd.compress(data, 1e-5, **kw)
    b = engine.compress(data, 1e-5, **kw)
    assert a.total_unpred > engine.ESC_K
    assert a.body == b.body


def test_engine_packed_types_decode():
    """The fixed-width packed type upload (_delattice_packed_fn +
    native.pack_wide_bits_u32) must reconstruct bit-identically to the
    raw-u16 upload path and the numpy oracle, including wide codes
    (intervals up to 2^15 -> w=15) and the w>=16 raw fallback."""
    import os
    data = _synth64()
    res = regnd.compress(data, 1e-3, **KW)
    oracle = regnd.decompress(res.body, data.shape, np.float32)
    out = engine.decompress(res.body, data.shape, np.float32)
    np.testing.assert_array_equal(out.view(np.uint32),
                                  oracle.view(np.uint32))
    old = os.environ.get("SZ_TPU_PACKED_TYPES")
    os.environ["SZ_TPU_PACKED_TYPES"] = "0"
    try:
        raw = engine.decompress(res.body, data.shape, np.float32)
    finally:
        if old is None:
            os.environ.pop("SZ_TPU_PACKED_TYPES", None)
        else:
            os.environ["SZ_TPU_PACKED_TYPES"] = old
    np.testing.assert_array_equal(out.view(np.uint32),
                                  raw.view(np.uint32))


def test_pack_wide_bits_u32():
    """Native fixed-width packer vs a pure-python bit stream, across
    widths and OpenMP chunk boundaries."""
    from sz_tpu import native
    rng = np.random.default_rng(9)
    for w in (1, 5, 9, 12, 15):
        for n in (0, 1, 7, 8, 4096, (1 << 18) + 13):
            vals = rng.integers(0, 1 << w, size=n).astype(np.int32)
            words = native.pack_wide_bits_u32(vals, w)
            stream = np.unpackbits(
                words.astype(">u4").view(np.uint8))

            def check(lo, hi):
                lo, hi = max(lo, 0), min(hi, n)
                if lo >= hi:
                    return
                ref = np.zeros((hi - lo) * w, np.uint8)
                for i, v in enumerate(vals[lo:hi]):
                    for b in range(w):
                        ref[i * w + b] = (v >> (w - 1 - b)) & 1
                np.testing.assert_array_equal(
                    stream[lo * w:hi * w], ref)

            check(0, 3000)               # head
            check((1 << 18) - 64, (1 << 18) + 64)  # OpenMP chunk seam
            check(n - 64, n)             # tail byte


@pytest.mark.parametrize("n", [5, 100, 4096, 100001, 1 << 17])
def test_histogram_and_pack_match_numpy(n):
    """The XLA histogram equals np.bincount and the scatter-add Huffman
    pack equals the host encoder, across sizes (non-pow2 streams,
    skewed symbols, full-width 32-bit codes)."""
    from sz_tpu.format import huffman
    rng = np.random.default_rng(n)
    t = (300 + rng.geometric(0.3, n) * rng.choice([-1, 1], n)).astype(
        np.int32)
    t[rng.random(n) < 0.02] = 0
    hist = np.asarray(engine.histogram(engine.jnp.asarray(t)))
    np.testing.assert_array_equal(hist, np.bincount(t, minlength=65536))
    freq = np.zeros(1024, np.int64)
    freq[:600] = np.bincount(t, minlength=600)
    freq[599] += 1 << 33    # a rare symbol gets a 32+-bit-deep code
    tables = huffman.build_tables(None, 512, freq=freq)
    bits = int((np.bincount(t, minlength=len(tables.code_len))
                * tables.code_len.astype(np.int64)).sum())
    nbytes = (bits + 7) // 8
    got = engine.pack_stream_device(engine.jnp.asarray(t), tables, n,
                                    nbytes, "cpu")
    assert got.tobytes() == huffman.encode(tables, t)[:nbytes]


@pytest.mark.parametrize("shape", [(25, 14, 20), (13, 30), (6, 6, 6)])
def test_corner_stream_roundtrip(shape):
    """The compact corner-transpose stream equals take(iperm), the
    unstream inverts it, and the closed-form position map matches
    iperm (positions past n map to the n sentinel)."""
    import jax.numpy as jnp
    g = engine._geom_small(shape, 6)
    dbs = tuple(g["dbs"])
    x = np.arange(int(np.prod(shape)), dtype=np.int32).reshape(shape)
    _, iperm = engine._host_stream_maps(shape, 6)
    cs = engine._corner_stream(jnp.asarray(x), dbs, shape)
    np.testing.assert_array_equal(np.asarray(cs), x.reshape(-1)[iperm])
    np.testing.assert_array_equal(
        np.asarray(engine._corner_unstream(cs, dbs, shape)), x)
    pos = jnp.arange(int(np.prod(shape)) + 3, dtype=jnp.int32)
    lat = np.asarray(engine._pos_to_lat_expr(pos, dbs, shape))
    np.testing.assert_array_equal(lat[:len(iperm)], iperm)
    assert (lat[len(iperm):] == int(np.prod(shape))).all()


@pytest.mark.parametrize("shape,dtype,seed", [
    ((30, 26, 22), np.float32, 7), ((17, 40, 9), np.float64, 8)])
def test_fixpoint_matches_oracle(shape, dtype, seed):
    """The full-lattice fixpoint (encode from the data, decode from the
    known points) gives the oracle's bytes and bit-identical decodes on
    non-cubic shapes with partial edge blocks."""
    data = _seeded(shape, dtype, seed)
    a = regnd.compress(data, 1e-3, **KW)
    b = engine.compress(data, 1e-3, **KW)
    assert a.body == b.body
    u = np.uint32 if dtype == np.float32 else np.uint64
    oa = regnd.decompress(a.body, data.shape, dtype)
    ob = engine.decompress(a.body, data.shape, dtype)
    np.testing.assert_array_equal(oa.view(u), ob.view(u))
