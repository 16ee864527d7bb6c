"""The GPU Huffman decode kernel (sz_tpu/tpu/fsm_kernel.py, Pallas on
the Triton route) in interpret mode against the host decoder — the
parallel C FSM (native.huff_fsm_decode2, through huffman.decode).

Small chunk sizes keep the interpret-mode runs short while still
spreading each stream over several Triton programs."""

import numpy as np
import pytest

from sz_tpu.format import huffman
from sz_tpu.tpu import engine
from sz_tpu.tpu import fsm_kernel as fsm
from sz_tpu.utils import trace


def _stream(n, nstate, alpha, seed):
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, nstate + 1) ** alpha   # Zipf, like type codes
    types = rng.choice(nstate, size=n, p=p / p.sum()).astype(np.int32)
    tables = huffman.build_tables(types, nstate)
    return types, tables, huffman.encode(tables, types)


def _host(tables, enc, n):
    return huffman.decode(tables.L, tables.R, tables.C, tables.T, enc, n)


@pytest.mark.parametrize("n,nstate,alpha,seed", [
    (30000, 600, 1.5, 1),       # skewed, tree of hundreds of nodes
    (20000, 64, 1.0, 2),        # short codes
    (40000, 4000, 1.1, 3),      # wide alphabet, deep codes
    (25000, 3, 3.0, 4),         # nearly one symbol
])
def test_fsm_decode_matches_host(n, nstate, alpha, seed):
    types, tables, enc = _stream(n, nstate, alpha, seed)
    trans = fsm.build_trans(tables.L, tables.R, tables.C, tables.T)
    syms, ok = fsm.decode(enc, trans, n, f_bits=1024, p_bits=256,
                          interpret=True)
    assert bool(ok)
    np.testing.assert_array_equal(np.asarray(syms), _host(tables, enc, n))
    np.testing.assert_array_equal(np.asarray(syms), types)


def test_fsm_late_sync_repaired_by_full_pass():
    """A sync window too short for the code fails verification; decode
    then runs the full chain-repair pass (p_bits = f_bits), which
    decodes exactly and is counted."""
    types, tables, enc = _stream(30000, 3000, 1.05, 5)
    trans = fsm.build_trans(tables.L, tables.R, tables.C, tables.T)
    trace.reset()
    syms, ok = fsm.decode(enc, trans, len(types), f_bits=1024, p_bits=32,
                          interpret=True)
    assert bool(ok)
    assert trace.counters() == {"huffman_decode.repair_pass": 1}
    np.testing.assert_array_equal(np.asarray(syms), types)
    trace.reset()
    fsm.decode(enc, trans, len(types), f_bits=1024, p_bits=1024,
               interpret=True)
    assert trace.counters() == {}


def test_fsm_non_syncing_chunk_falls_back(monkeypatch):
    """A fixed-length code never resynchronizes from a misaligned chunk
    start (3-bit codes, chunk starts not on codeword boundaries): the
    kernel reports not-ok, and the engine wrapper returns None and
    counts a host fallback."""
    n = 6000
    types = np.tile(np.arange(8, dtype=np.int32), n // 8)
    tables = huffman.build_tables(types, 8)
    assert set(tables.code_len[:8].tolist()) == {3}
    enc = huffman.encode(tables, types)
    trans = fsm.build_trans(tables.L, tables.R, tables.C, tables.T)
    for p in (256, 1024):
        _, ok = fsm.decode(enc, trans, n, f_bits=1024, p_bits=p,
                           interpret=True)
        assert not bool(ok)
    real = fsm.decode
    monkeypatch.setattr(fsm, "decode", lambda e, t, k, p_bits=256: real(
        e, t, k, f_bits=1024, p_bits=min(p_bits, 1024), interpret=True))
    trace.reset()
    tree = (tables.L, tables.R, tables.C, tables.T, len(tables.L))
    assert engine._device_decode_stream(tree, enc, n) is None
    assert trace.counters() == {"huffman_decode.repair_pass": 1,
                                "host_fallback.huffman_decode": 1}


def test_fsm_constant_stream():
    """A one-symbol tree (root is a leaf) needs no kernel."""
    tree = (np.zeros(1, np.int32), np.zeros(1, np.int32),
            np.array([7], np.int32), np.array([1], np.uint8), 1)
    out = engine._device_decode_stream(tree, b"", 50)
    np.testing.assert_array_equal(np.asarray(out), np.full(50, 7))


@pytest.mark.parametrize("total_bits", [1, 4096, 4097, (1 << 33) + 5])
def test_chunk_layout_has_no_int32_overflow(total_bits):
    """Per-chunk bit budgets come from int64 host arithmetic, so a
    stream past 2^31 (here 2^33) bits gets exact budgets, and the
    chunk bucket is a multiple of BLOCK within 1/8 of the need."""
    Lp, nbits = fsm.chunk_layout(total_bits, 4096)
    need = -(-total_bits // 4096)
    assert Lp % fsm.BLOCK == 0 and Lp >= need
    assert Lp <= max(fsm.BLOCK, need + need // 8 + 1)
    assert int(nbits.astype(np.int64).sum()) == total_bits
    assert nbits.max() <= 4096 and nbits.min() >= 0
