"""Huffman DECODE on the GPU: speculative chunk-parallel bit FSM
(Pallas, Triton route).

GPU form of the C speculative byte-FSM decoder (native/core.c
huff_fsm_decode_par, itself the parallel form of the reference's serial
tree walk, Huffman.c decode):

  * the coded bitstream splits into F-bit chunks, ONE CHUNK PER GPU
    THREAD: a Triton program holds BLOCK chunks as one vector, one lane
    per thread, and walks them in lockstep one 32-bit word at a time.
    The tree walk is a table lookup trans[2*state + bit] (a gather from
    a table of 2 x nodes words that stays in L1).
  * pass A (speculative): every chunk decodes from the ROOT and keeps
    its (state, symbol count) at bit P and at its end.  Huffman codes
    self-synchronize, so a chunk that starts mid-codeword is back on
    the true state trajectory within a few codewords.
  * reconcile (XLA): chunk c's true entry state is chunk c-1's
    speculative exit state (chunk 0 starts at the root, which is exact;
    the induction holds when every chunk verifies).
  * pass B (verify): re-decode the first P bits of each chunk from its
    true entry.  Its state at P must equal pass A's snapshot, and the
    chunk's true symbol count is count_B(P) + count_A(end) - count_A(P).
  * offsets (XLA): exclusive cumsum of the true counts.
  * pass C (emit): decode each chunk from its true entry and scatter
    its symbols at its offset.

There is no per-bit record buffer: device memory is the word stream,
O(chunks) state and the output.  Per-chunk bit budgets are computed on
the host in int64, so streams of 2^31 bits and more decode in the same
single pipeline.  A chunk that fails to self-sync within P bits makes
`ok` false; decode() then reruns with P = F (a full chain-repair pass
that accepts any chunk merging anywhere inside itself), and the caller
falls back to the host decoder when that fails too.
"""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from sz_tpu.utils import trace as _tr

F_BITS = 16384          # bits per chunk (one GPU thread each)
# speculative sync window: a 1.1 Gbit stream (512^3 field) needed 2048
# bits on an H100, and pass B's length barely moves the kernel time
P_BITS = 4096
BLOCK = 128             # chunks per Triton program (4 warps)

_LEAF = np.uint32(0x80000000)


def build_trans(L, R, C, T) -> np.ndarray:
    """Flat uint32 transition table: trans[2s+b] = child of node s on
    bit b; a leaf child encodes (0x80000000 | symbol) and the walk
    restarts at the root."""
    nc = len(L)
    s = np.arange(nc, dtype=np.int64)
    out = np.zeros(2 * nc, np.uint32)
    for b, kid in ((0, np.asarray(L)), (1, np.asarray(R))):
        kid = kid.astype(np.int64)
        leaf = np.asarray(T)[kid] != 0
        val = np.where(leaf, _LEAF | np.asarray(C)[kid].astype(np.uint32),
                       kid.astype(np.uint32))
        out[2 * s + b] = val
    return out


def _sweep_kernel(nwords: int, snap_w: int, emit: bool):
    """One pass over every chunk's first `nwords` words.  Count mode
    returns (state, count) at word `snap_w` and at the end; emit mode
    scatters each symbol at its chunk offset + running count."""

    def kernel(*refs):
        if emit:
            trans_ref, entry_ref, nbits_ref, wt_ref, offs_ref, out_ref = refs
            cap = out_ref.shape[0]
        else:
            (trans_ref, entry_ref, nbits_ref, wt_ref,
             end_ref, snap_ref) = refs
        sl = pl.ds(pl.program_id(0) * BLOCK, BLOCK)
        nb = nbits_ref[sl]
        st = entry_ref[sl]
        cnt = offs_ref[sl] if emit else jnp.zeros((BLOCK,), jnp.int32)

        def body(j, carry):
            st, cnt, sst, scnt = carry
            w = wt_ref[j, sl]
            for b in range(32):
                bit = ((w >> jnp.uint32(31 - b)) & jnp.uint32(1)).astype(
                    jnp.int32)
                val = trans_ref[2 * st + bit]
                live = j * 32 + b < nb
                hit = ((val & _LEAF) != 0) & live
                if emit:
                    # idle lanes aim at the spare last slot: a finished
                    # chunk's cursor equals the next chunk's first
                    # position, and a masked lane must not alias it
                    put = hit & (cnt < cap - 1)
                    plt.store(out_ref.at[jnp.where(put, cnt, cap - 1)],
                              (val & jnp.uint32(0x7FFFFFFF)).astype(
                                  jnp.int32),
                              mask=put)
                cnt = cnt + hit.astype(jnp.int32)
                st = jnp.where(hit, 0, jnp.where(
                    live, (val & jnp.uint32(0x7FFFFFFF)).astype(jnp.int32),
                    st))
            if not emit:
                at = j == snap_w - 1
                sst = jnp.where(at, st, sst)
                scnt = jnp.where(at, cnt, scnt)
            return st, cnt, sst, scnt

        st, cnt, sst, scnt = jax.lax.fori_loop(
            0, nwords, body, (st, cnt, st, cnt))
        if not emit:
            end_ref[0, sl] = st
            end_ref[1, sl] = cnt
            snap_ref[0, sl] = sst
            snap_ref[1, sl] = scnt

    return kernel


def _sweep(nwords: int, snap_w: int, Lp: int, interpret: bool,
           out_len: int = 0):
    emit = out_len > 0
    if emit:
        out_shape = jax.ShapeDtypeStruct((out_len,), jnp.int32)
    else:
        out_shape = (jax.ShapeDtypeStruct((2, Lp), jnp.int32),
                     jax.ShapeDtypeStruct((2, Lp), jnp.int32))
    return pl.pallas_call(
        _sweep_kernel(nwords, snap_w, emit),
        out_shape=out_shape,
        grid=(Lp // BLOCK,),
        compiler_params=plt.CompilerParams(num_warps=BLOCK // 32,
                                           num_stages=1),
        backend="triton",
        interpret=interpret,
        name="huffman_fsm_emit" if emit else "huffman_fsm_count",
    )


@functools.lru_cache(maxsize=32)
def _decode_fn(ntrans: int, Lp: int, n_sym: int, f_bits: int,
               p_bits: int, interpret: bool):
    """Jitted A / reconcile / B / offsets / C pipeline for one
    (table bucket, chunk bucket, symbol count, F, P) shape."""
    fw, pw = f_bits // 32, p_bits // 32
    out_len = n_sym + 9   # <= 7 junk symbols from the byte pad + spare

    def f(words_le, trans, nbits):
        # the coded stream is big-endian: swap each little-endian load
        w = words_le
        w = ((w << 24) | ((w & 0xFF00) << 8) | ((w >> 8) & 0xFF00)
             | (w >> 24))
        wt = w.reshape(Lp, fw).T                         # (fw, Lp)
        root = jnp.zeros((Lp,), jnp.int32)
        end, snap = _sweep(fw, pw, Lp, interpret)(trans, root, nbits, wt)
        entry = jnp.concatenate([root[:1], end[0, :-1]])
        end_b, _ = _sweep(pw, pw, Lp, interpret)(trans, entry, nbits, wt)
        # a chunk whose bits all lie within P is decoded exactly by pass
        # B; every other chunk's exit state seeds its successor and must
        # have synced by P
        exempt = (nbits <= p_bits) & (nbits < f_bits)
        ok = jnp.all(exempt | (end_b[0] == snap[0]))
        true_cnt = end_b[1] + end[1] - snap[1]
        total = jnp.sum(true_cnt)
        # trailing byte-pad bits may emit junk symbols after the last
        # real one; each consumes >= 1 of the <= 7 pad bits.  `ok` is a
        # self-consistency check (sync + plausible count), not stream
        # authentication, matching the reference decoder (Huffman.c:310)
        ok = ok & (total >= n_sym) & (total <= n_sym + 7)
        offs = jnp.cumsum(true_cnt) - true_cnt
        out = _sweep(fw, pw, Lp, interpret, out_len)(
            trans, entry, nbits, wt, offs)
        return out[:n_sym], ok

    return jax.jit(f)


def chunk_layout(total_bits: int, f_bits: int = F_BITS):
    """(Lp, nbits): the chunk count padded to a bucket (a multiple of
    BLOCK, sixteen buckets per power of two, so one compiled program
    serves streams of nearby length at <= 1/8 padding) and each
    chunk's live bit count, computed in int64 so no stream length
    overflows."""
    L = max(-(-total_bits // f_bits), 1)
    step = max(BLOCK, (1 << (L - 1).bit_length()) // 16)
    Lp = -(-L // step) * step
    starts = np.arange(Lp, dtype=np.int64) * f_bits
    nbits = np.clip(total_bits - starts, 0, f_bits).astype(np.int32)
    return Lp, nbits


def decode(encoded: bytes, trans: np.ndarray, n_sym: int, *,
           f_bits: int = F_BITS, p_bits: int = P_BITS,
           interpret: bool = False):
    """Device Huffman decode of a big-endian coded byte stream.
    Returns (syms (n_sym,) int32 device array, ok device bool); syms
    is valid only when ok.  When a chunk fails to sync within p_bits,
    the pipeline runs once more with p_bits = f_bits (the full chain
    repair, counted as "huffman_decode.repair_pass"); callers fall
    back to the host decoder when that fails too."""
    assert f_bits % 32 == 0 and p_bits % 32 == 0 and p_bits <= f_bits
    Lp, nbits = chunk_layout(len(encoded) * 8, f_bits)
    buf = np.zeros(Lp * (f_bits // 8), np.uint8)
    buf[:len(encoded)] = np.frombuffer(encoded, np.uint8)
    # table padded to a power of two: one program per tree-size bucket
    tr = np.zeros(1 << max(int(len(trans) - 1).bit_length(), 1), np.uint32)
    tr[:len(trans)] = trans
    args = (jax.device_put(buf.view("<u4")), jax.device_put(tr),
            jax.device_put(nbits))
    syms, ok = _decode_fn(len(tr), Lp, n_sym, f_bits, p_bits,
                          interpret)(*args)
    if not bool(ok) and p_bits < f_bits:
        _tr.count("huffman_decode.repair_pass")
        syms, ok = _decode_fn(len(tr), Lp, n_sym, f_bits, f_bits,
                              interpret)(*args)
    return syms, ok
