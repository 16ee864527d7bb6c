"""Bit-exact parity for the classic (SZ1.4) 1D path, float + double.

Note: the reference leaves params byte 15 (stream offset 19)
uninitialized in classic streams (convertSZParamsToBytes writes
result[0..14] and [16..]; the TDPS buffer is malloc'd, unlike the
regression path's calloc) — verified nondeterministic across reference
runs.  The parity comparison normalizes that byte; the reference
decoder never reads it.
"""

import pathlib

import numpy as np
import pytest

from sz_tpu import api, SZConfig, ErrorBoundMode
from sz_tpu.format import lossless as ll

GOLDEN = pathlib.Path(__file__).parent / "golden"
REF_DATA = pathlib.Path("/root/reference/example/testdata/x86")

CASES = [
    ("f32_1d_abs1e-4", "testfloat_8_8_128.dat", "<f4", (8192,),
     ErrorBoundMode.ABS, 1e-4),
    ("f64_1d_abs1e-4", "testdouble_8_8_128.dat", "<f8", (8192,),
     ErrorBoundMode.ABS, 1e-4),
]
IDS = [c[0] for c in CASES]


def _normalize(inner: bytes) -> bytes:
    b = bytearray(inner)
    if not (b[3] & 0x80):
        b[19] = 0
    return bytes(b)


def _load(case):
    """(input, golden stream, golden decode, mode, bound); the input is
    the reference's own test file, which only its source tree holds."""
    name, datafile, dt, shape, mode, val = case
    if not (REF_DATA / datafile).exists():
        pytest.skip(f"reference input {REF_DATA / datafile} not present")
    data = np.fromfile(REF_DATA / datafile, dtype=dt).reshape(shape)
    golden_sz = (GOLDEN / f"{name}.sz").read_bytes()
    golden_out = np.fromfile(GOLDEN / f"{name}.out", dtype=dt).reshape(shape)
    return data, golden_sz, golden_out, mode, val


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_compress_inner_stream_bit_exact(case):
    data, golden_sz, _, mode, val = _load(case)
    ours = api.compress(data, SZConfig().with_bound(mode, val))
    cap = data.nbytes * 2 + 64
    assert _normalize(ll.decompress(ours, expected_size=cap)) == \
        _normalize(ll.decompress(golden_sz, expected_size=cap))


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_decompress_golden_bit_exact(case):
    """Needs only the committed golden stream and its decode."""
    name, _, dt, shape, _, _ = case
    golden_sz = (GOLDEN / f"{name}.sz").read_bytes()
    golden_out = np.fromfile(GOLDEN / f"{name}.out", dtype=dt).reshape(shape)
    out = api.decompress(golden_sz, shape, np.dtype(dt))
    ubits = np.uint32 if out.dtype == np.float32 else np.uint64
    np.testing.assert_array_equal(out.view(ubits), golden_out.view(ubits))


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_roundtrip_bound(case):
    data, _, _, mode, val = _load(case)
    blob = api.compress(data, SZConfig().with_bound(mode, val))
    out = api.decompress(blob, data.shape, data.dtype)
    assert float(np.abs(out - data).max()) <= val * (1 + 1e-6)
