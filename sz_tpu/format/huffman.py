"""SZ2-compatible Huffman coder.

The reference serializes its Huffman tree *structure* into every stream
(Huffman.c:503-585), and the tree shape depends on the exact tie-breaking
behavior of its binary-heap priority queue (qinsert/qremove,
Huffman.c:76-114).  For byte-identical streams we therefore reproduce the
same tree-construction algorithm — a small host-side computation over at
most 2*65536 symbols — while the heavy work (frequency histogram, bit
packing of millions of codes) is vectorized with numpy here and runs as
device kernels in sz_tpu/tpu.

Design notes (device-first):
  * tree build is O(#distinct symbols log n) on host — never a bottleneck;
  * encoding = table lookup of (code,len) per element + bitstream pack,
    both data-parallel; the numpy path below is the host reference, and
    ops/bitpack.py provides the on-device version;
  * decoding walks the serialized tree; we build a byte-level FSM table so
    decode is table-driven per *byte* rather than per bit.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from sz_tpu.format import bytes_util as bu

try:
    from sz_tpu import native as _native
except Exception:  # pragma: no cover - fallback when cc is unavailable
    _native = None


@dataclasses.dataclass
class HuffmanTables:
    """Everything needed to encode/decode one stream."""

    state_num: int
    node_count: int  # 2*distinct-1
    # per-symbol code as two uint64 halves (MSB-aligned like the reference)
    code_hi: np.ndarray  # uint64[state_num]
    code_lo: np.ndarray  # uint64[state_num]
    code_len: np.ndarray  # uint8[state_num]
    tree_bytes: bytes  # serialized tree (Huffman.c:503)
    # flat tree for decoding: left/right child indices in preorder layout
    L: np.ndarray
    R: np.ndarray
    C: np.ndarray
    T: np.ndarray


# ---------------------------------------------------------------------------
# Tree construction — exact replica of the reference algorithm
# ---------------------------------------------------------------------------

class _Heap:
    """The reference's 1-indexed binary min-heap with its exact
    (non-stable) tie behavior (Huffman.c:76-114)."""

    __slots__ = ("slots", "freqs", "qend")

    def __init__(self, cap: int):
        self.slots = [0] * (cap + 2)
        self.freqs = [0] * (cap + 2)
        self.qend = 1

    def insert(self, node_id: int, freq: int) -> None:
        i = self.qend
        self.qend += 1
        slots, freqs = self.slots, self.freqs
        while True:
            j = i >> 1
            if j == 0 or freqs[j] <= freq:
                break
            slots[i] = slots[j]
            freqs[i] = freqs[j]
            i = j
        slots[i] = node_id
        freqs[i] = freq

    def remove(self) -> int:
        slots, freqs = self.slots, self.freqs
        n = slots[1]
        if self.qend < 2:
            return -1
        self.qend -= 1
        qend = self.qend
        slots[1] = slots[qend]
        freqs[1] = freqs[qend]
        i = 1
        while True:
            l = i << 1
            if l >= qend:
                break
            if l + 1 < qend and freqs[l + 1] < freqs[l]:
                l += 1
            if freqs[i] > freqs[l]:
                slots[i], slots[l] = slots[l], slots[i]
                freqs[i], freqs[l] = freqs[l], freqs[i]
                i = l
            else:
                break
        return n


def _build_tree(freq: np.ndarray):
    """Build the Huffman tree; returns (root, left[], right[], sym[], leaf[]).

    Node ids are allocated in the reference's creation order: one leaf per
    nonzero-frequency symbol in ascending symbol order, then internal nodes
    as pairs are merged (Huffman.c:165-185).
    """
    nz = np.flatnonzero(freq)
    n_leaves = len(nz)
    max_nodes = 2 * n_leaves + 2
    left = np.full(max_nodes, -1, dtype=np.int64)
    right = np.full(max_nodes, -1, dtype=np.int64)
    sym = np.zeros(max_nodes, dtype=np.int64)
    leaf = np.zeros(max_nodes, dtype=bool)
    freqs = np.zeros(max_nodes, dtype=np.int64)

    heap = _Heap(max_nodes)
    n_nodes = 0
    for s in nz:
        sym[n_nodes] = s
        leaf[n_nodes] = True
        freqs[n_nodes] = freq[s]
        heap.insert(n_nodes, int(freq[s]))
        n_nodes += 1

    while heap.qend > 2:
        # the reference builds internal nodes as
        # new_node(0, 0, qremove(), qremove()) (Huffman.c:183); gcc
        # evaluates those arguments right-to-left, so the FIRST element
        # removed becomes the RIGHT child — replicate that order
        b = heap.remove()
        a = heap.remove()
        left[n_nodes] = a
        right[n_nodes] = b
        f = int(freqs[a] + freqs[b])
        freqs[n_nodes] = f
        heap.insert(n_nodes, f)
        n_nodes += 1

    root = heap.slots[1]
    return root, left, right, sym, leaf


def _assign_codes(root, left, right, sym, leaf, state_num):
    """Iterative preorder walk replicating build_code (Huffman.c:122-157)."""
    code_hi = np.zeros(state_num, dtype=np.uint64)
    code_lo = np.zeros(state_num, dtype=np.uint64)
    code_len = np.zeros(state_num, dtype=np.uint8)
    M = (1 << 64) - 1
    # stack entries: (node, len, out1, out2) with out1/out2 raw (not aligned)
    stack = [(root, 0, 0, 0)]
    while stack:
        n, ln, o1, o2 = stack.pop()
        if leaf[n]:
            s = sym[n]
            if ln <= 64:
                code_hi[s] = np.uint64((o1 << (64 - ln)) & M if ln else 0)
                code_lo[s] = np.uint64(o2 & M)
            else:
                code_hi[s] = np.uint64(o1 & M)
                code_lo[s] = np.uint64((o2 << (128 - ln)) & M)
            code_len[s] = ln
            continue
        if (ln >> 6) == 0:
            n1 = (o1 << 1) & M
            stack.append((right[n], ln + 1, n1 | 1, 0))
            stack.append((left[n], ln + 1, n1, 0))
        else:
            n2 = ((o2 << 1) & M) if ln % 64 != 0 else o2
            stack.append((right[n], ln + 1, o1, n2 | 1))
            stack.append((left[n], ln + 1, o1, n2))
    return code_hi, code_lo, code_len


def _serialize_tree(root, left, right, sym, leaf, node_count: int) -> tuple:
    """pad_tree_* + convert_HuffTree_to_bytes_anyStates (Huffman.c:443-585).

    Preorder DFS index assignment; arrays L,R (child indices, width by
    node_count), C (symbol, u32 native LE), t (leaf flags, u8).
    """
    L = np.zeros(node_count, dtype=np.uint32)
    R = np.zeros(node_count, dtype=np.uint32)
    C = np.zeros(node_count, dtype=np.uint32)
    T = np.zeros(node_count, dtype=np.uint8)

    # iterative preorder, assigning indices in the order the recursive
    # reference visits: node, then left subtree, then right subtree
    counter = [0]

    def visit(n, i):
        C[i] = sym[n]
        T[i] = 1 if leaf[n] else 0
        if left[n] >= 0:
            counter[0] += 1
            li = counter[0]
            L[i] = li
            visit(left[n], li)
        if right[n] >= 0:
            counter[0] += 1
            ri = counter[0]
            R[i] = ri
            visit(right[n], ri)

    import sys
    old = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old, node_count + 100))
    try:
        visit(root, 0)
    finally:
        sys.setrecursionlimit(old)

    if node_count <= 256:
        lr_dtype = np.uint8
    elif node_count <= 65536:
        lr_dtype = np.uint16
    else:
        lr_dtype = np.uint32
    out = (b"\x00"  # sysEndianType: little
           + L.astype(lr_dtype).tobytes()
           + R.astype(lr_dtype).tobytes()
           + C.tobytes()  # u32 native little-endian (memcpy)
           + T.tobytes())
    return out, L, R, C, T


def deserialize_tree(tree_bytes: bytes, node_count: int):
    """reconstruct_HuffTree_from_bytes_anyStates (Huffman.c:656)."""
    if node_count <= 256:
        w = 1
        dt = np.uint8
    elif node_count <= 65536:
        w = 2
        dt = np.uint16
    else:
        w = 4
        dt = np.uint32
    off = 1
    L = np.frombuffer(tree_bytes, dtype=dt, count=node_count, offset=off
                      ).astype(np.uint32)
    off += node_count * w
    R = np.frombuffer(tree_bytes, dtype=dt, count=node_count, offset=off
                      ).astype(np.uint32)
    off += node_count * w
    C = np.frombuffer(tree_bytes, dtype=np.uint32, count=node_count,
                      offset=off)
    off += node_count * 4
    T = np.frombuffer(tree_bytes, dtype=np.uint8, count=node_count,
                      offset=off)
    return L, R, C, T


def tree_bytes_size(node_count: int) -> int:
    if node_count <= 256:
        return 1 + 3 * node_count + 4 * node_count
    elif node_count <= 65536:
        return 1 + 2 * 2 * node_count + node_count + 4 * node_count
    else:
        return 1 + 3 * 4 * node_count + node_count


def build_tables(type_codes: np.ndarray, state_num: int,
                 freq=None) -> HuffmanTables:
    """Histogram + tree + codes + serialized tree for one stream."""
    if freq is None:
        if _native is not None:
            freq = _native.i32_hist(type_codes.ravel(), 2 * state_num)
        if freq is None:
            freq = np.bincount(type_codes.ravel(),
                               minlength=2 * state_num)
    else:
        freq = np.asarray(freq)
        if len(freq) < 2 * state_num:
            freq = np.concatenate(
                [freq, np.zeros(2 * state_num - len(freq), freq.dtype)])
    node_count = int(np.count_nonzero(freq)) * 2 - 1
    native_t = None
    if _native is not None and node_count >= 1:
        try:
            native_t = _native.huff_build_tree(freq, state_num, node_count)
        except Exception:  # pragma: no cover - native unavailable
            native_t = None
    if native_t is not None:
        code_hi, code_lo, code_len, L, R, C, T = native_t
        if node_count <= 256:
            lr_dtype = np.uint8
        elif node_count <= 65536:
            lr_dtype = np.uint16
        else:
            lr_dtype = np.uint32
        tree_bytes = (b"\x00" + L.astype(lr_dtype).tobytes()
                      + R.astype(lr_dtype).tobytes()
                      + C.tobytes() + T.tobytes())
    else:
        root, left, right, sym, leaf = _build_tree(freq)
        code_hi, code_lo, code_len = _assign_codes(
            root, left, right, sym, leaf, state_num)
        tree_bytes, L, R, C, T = _serialize_tree(
            root, left, right, sym, leaf, node_count)
    return HuffmanTables(state_num=state_num, node_count=node_count,
                         code_hi=code_hi, code_lo=code_lo, code_len=code_len,
                         tree_bytes=tree_bytes, L=L, R=R, C=C, T=T)


# ---------------------------------------------------------------------------
# Encoding — vectorized MSB-first bitstream pack (Huffman.c encode:205)
# ---------------------------------------------------------------------------

def encode(tables: HuffmanTables, type_codes: np.ndarray) -> bytes:
    """Pack the per-symbol variable-length codes MSB-first, zero-padded to a
    byte boundary.  Equivalent to the reference's encode() output."""
    if _native is not None:
        syms = np.asarray(type_codes).ravel()
        if syms.dtype != np.uint16:
            syms = syms.astype(np.int32, copy=False)
        return _native.huff_encode(syms, tables.code_hi, tables.code_lo,
                                   tables.code_len)
    syms = np.asarray(type_codes, dtype=np.int64).ravel()
    lens = tables.code_len[syms].astype(np.int64)
    total_bits = int(lens.sum())
    if total_bits == 0:
        return b""
    offsets = np.concatenate([[0], np.cumsum(lens)[:-1]])
    nbytes = (total_bits + 7) // 8
    max_len = int(tables.code_len.max())

    bits = np.zeros(nbytes * 8, dtype=np.uint8)
    hi = tables.code_hi[syms]
    lo = tables.code_lo[syms] if max_len > 64 else None
    # bit j (0-based from MSB) of each code
    for j in range(max_len):
        active = lens > j
        if not active.any():
            break
        if j < 64:
            bit = (hi[active] >> np.uint64(63 - j)) & np.uint64(1)
        else:
            bit = (lo[active] >> np.uint64(63 - (j - 64))) & np.uint64(1)
        bits[offsets[active] + j] = bit.astype(np.uint8)
    return np.packbits(bits).tobytes()


# ---------------------------------------------------------------------------
# Decoding — byte-level FSM over the serialized tree
# ---------------------------------------------------------------------------

def decode(tree_L, tree_R, tree_C, tree_T, data: bytes,
           count: int) -> np.ndarray:
    """Decode `count` symbols.  (decode, Huffman.c:310-343.)

    Uses a per-(state,byte) FSM table when the tree is small enough,
    falling back to a bit-walk otherwise.
    """
    if count == 0:
        return np.zeros(0, dtype=np.int32)
    if tree_T[0]:  # constant stream: root is a leaf
        return np.full(count, tree_C[0], dtype=np.int32)

    n_nodes = len(tree_L)
    out = np.empty(count, dtype=np.int32)
    if _native is not None:
        # The FSM build is native (OpenMP over states); it pays off
        # once the stream is a few symbols per tree node, or when a
        # cached FSM already exists for this tree.
        key = (tree_L.tobytes(), tree_R.tobytes(), tree_C.tobytes())
        if key not in _fsm_cache and count < n_nodes * 8:
            return _native.huff_tree_decode(
                tree_L, tree_R, tree_C, tree_T,
                np.frombuffer(data, dtype=np.uint8), count)
        tab = _fsm_tables(tree_L, tree_R, tree_C, tree_T)
        return _native.huff_fsm_decode2(
            tab, tree_L, tree_R, tree_C, tree_T,
            np.frombuffer(data, dtype=np.uint8), out)
    if n_nodes * 256 <= 64_000_000:
        next_state, emit_cnt, emit_syms = _fsm_tables(
            tree_L, tree_R, tree_C, tree_T)
        return _fsm_decode(next_state, emit_cnt, emit_syms,
                           np.frombuffer(data, dtype=np.uint8), out)
    # fallback: pure bit walk (slow; only for pathological trees)
    bits = np.unpackbits(np.frombuffer(data, dtype=np.uint8))
    n = 0
    k = 0
    for b in bits:
        n = tree_R[n] if b else tree_L[n]
        if tree_T[n]:
            out[k] = tree_C[n]
            k += 1
            if k == count:
                break
            n = 0
    return out


_fsm_cache = {}


def _fsm_tables(L, R, C, T):
    """Build (state, byte) -> (next_state, symbols emitted) tables.
    Cached per tree (repeated decodes of e.g. temporal streams).
    Native: a compact 16-byte-entry table (huff_fsm_build2); numpy
    fallback: the 3-array layout."""
    key = (L.tobytes(), R.tobytes(), C.tobytes())
    hit = _fsm_cache.get(key)
    if hit is not None:
        return hit
    if _native is not None:
        tabs = _native.huff_fsm_build2(L, R, C, T)
        if len(_fsm_cache) > 16:
            _fsm_cache.clear()
        _fsm_cache[key] = tabs
        return tabs
    n_nodes = len(L)
    # internal states are node indices with T==0
    next_state = np.zeros((n_nodes, 256), dtype=np.int32)
    emit_cnt = np.zeros((n_nodes, 256), dtype=np.int8)
    emit_syms = np.zeros((n_nodes, 256, 8), dtype=np.int32)
    Ls = L.astype(np.int32)
    Rs = R.astype(np.int32)
    internal = np.flatnonzero(T == 0)
    # vectorized over bytes for each state via repeated child steps
    for s in internal:
        state = np.full(256, s, dtype=np.int32)
        cnt = np.zeros(256, dtype=np.int8)
        byte = np.arange(256, dtype=np.uint8)
        for bitpos in range(7, -1, -1):
            b = (byte >> bitpos) & 1
            state = np.where(b, Rs[state], Ls[state])
            isleaf = T[state] == 1
            if isleaf.any():
                idx = np.flatnonzero(isleaf)
                emit_syms[s, idx, cnt[idx]] = C[state[idx]]
                cnt[idx] += 1
                state[idx] = 0
        next_state[s] = state
        emit_cnt[s] = cnt
    if len(_fsm_cache) > 16:
        _fsm_cache.clear()
    _fsm_cache[key] = (next_state, emit_cnt, emit_syms)
    return next_state, emit_cnt, emit_syms


def _fsm_decode(next_state, emit_cnt, emit_syms, data_u8, out):
    count = len(out)
    k = 0
    s = 0
    for byte in data_u8:
        cnt = emit_cnt[s, byte]
        if cnt:
            syms = emit_syms[s, byte, :cnt]
            take = min(int(cnt), count - k)
            out[k:k + take] = syms[:take]
            k += take
            if k >= count:
                break
        s = next_state[s, byte]
    return out


# ---------------------------------------------------------------------------
# Framed helpers (encode_withTree / decode_withTree, Huffman.c:790,865)
# ---------------------------------------------------------------------------

def encode_with_tree(type_codes: np.ndarray, state_num: int) -> bytes:
    t = build_tables(type_codes, state_num)
    body = encode(t, type_codes)
    # second field is "the real number of intervals" = stateNum/2
    # (Huffman.c:806)
    return (bu.u32_be(t.node_count) + bu.u32_be(state_num // 2)
            + t.tree_bytes + body)


def encode_with_tree_max_bits(type_codes: np.ndarray,
                              state_num: int) -> tuple:
    """encode_withTree_MSST19 (Huffman.c:818): same frame, also returns
    the maximum code length (serialized as tdps.max_bits)."""
    t = build_tables(type_codes, state_num)
    body = encode(t, type_codes)
    max_bits = int(t.code_len.max()) if t.code_len.size else 0
    blob = (bu.u32_be(t.node_count) + bu.u32_be(state_num // 2)
            + t.tree_bytes + body)
    return blob, max_bits


def decode_with_tree(blob: bytes, count: int) -> tuple:
    """Returns (symbols, bytes consumed is unknowable without count walk —
    the reference also relies on the caller to know sizes)."""
    node_count = bu.read_u32_be(blob, 0)
    tsize = tree_bytes_size(node_count)
    L, R, C, T = deserialize_tree(blob[8:8 + tsize], node_count)
    syms = decode(L, R, C, T, blob[8 + tsize:], count)
    return syms
