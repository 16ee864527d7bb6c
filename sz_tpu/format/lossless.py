"""Final lossless stage: zstd / zlib, with format sniffing.

Mirrors sz_lossless_compress / sz_lossless_decompress /
is_lossless_compressed_data (utility.c:156-215).  The reference vendors
zstd 1.3.5; we build the SAME release (sz_tpu/native/vendor/zstd, see
its PROVENANCE.md) so outer frames are byte-identical to the reference
binary's and the "compressed size <= reference" clause holds exactly.
Fallback order for compression: vendored 1.3.5 -> system zstandard
(newer encoder: equally decodable frames, slightly different bytes).
Set SZ_TPU_SYSTEM_ZSTD=1 to force the system encoder (multithreaded for
frames >= 4 MB — faster on big streams, loses frame byte-parity).
"""

from __future__ import annotations

import os
import zlib

try:
    import zstandard as _zstd

    _HAS_ZSTD = True
except ImportError:  # pragma: no cover
    _zstd = None
    _HAS_ZSTD = False

try:
    from sz_tpu import native as _native

    _HAS_ZSTD135 = _native.HAVE_ZSTD135
except Exception:  # pragma: no cover - toolchain unavailable
    _native = None
    _HAS_ZSTD135 = False

from sz_tpu.config import Lossless

_ZSTD_MAGIC = b"\x28\xb5\x2f\xfd"


def _use_vendored() -> bool:
    return _HAS_ZSTD135 and os.environ.get("SZ_TPU_SYSTEM_ZSTD") != "1"


def compress(data: bytes, backend: Lossless, level: int) -> bytes:
    if backend == Lossless.ZSTD:
        if _use_vendored():
            # single-shot ZSTD_compress, identical call shape to
            # sz_lossless_compress (utility.c:174)
            return _native.zstd135_compress(data, level)
        if not _HAS_ZSTD:
            raise RuntimeError("zstandard module unavailable")
        # write_content_size must be on: the reference's sniffing relies on
        # ZSTD_getFrameContentSize succeeding (utility.c:158-161).
        # Multithreaded frames are standard zstd frames (any decoder,
        # including the reference's vendored 1.3.5, reads them).
        threads = -1 if len(data) >= (4 << 20) else 0
        c = _zstd.ZstdCompressor(level=level, write_content_size=True,
                                 write_checksum=False, threads=threads)
        return c.compress(data)
    elif backend == Lossless.GZIP:
        # zlib_compress5 (callZlib.c:205): plain zlib stream at `level`
        return zlib.compress(data, level)
    raise ValueError(f"unknown lossless backend {backend}")


def sniff(blob: bytes):
    """is_lossless_compressed_data (utility.c:156): returns Lossless or None."""
    if len(blob) >= 4 and blob[:4] == _ZSTD_MAGIC:
        return Lossless.ZSTD
    if len(blob) >= 2 and _is_zlib_format(blob[0], blob[1]):
        return Lossless.GZIP
    return None


def _is_zlib_format(b0: int, b1: int) -> bool:
    """isZlibFormat (callZlib.c:30): RFC1950 magic pairs."""
    return (b0, b1) in {
        (0x78, 0x01), (0x78, 0x5E), (0x78, 0x9C), (0x78, 0xDA),
        (0x78, 0x20), (0x78, 0x7D), (0x78, 0xBB), (0x78, 0xF9),
    }


def decompress(blob: bytes, expected_size: int | None = None) -> bytes:
    backend = sniff(blob)
    if backend is None:
        return blob  # SZ_BEST_SPEED stream: not lossless-wrapped
    if backend == Lossless.ZSTD:
        if _HAS_ZSTD135:
            # frames written by this package always carry the content
            # size; the caller's expected_size covers foreign frames
            n = _native.zstd135_frame_content_size(blob)
            if n < 0:
                n = expected_size or 0
            if n > 0:
                try:
                    return _native.zstd135_decompress(blob, n)
                except RuntimeError:
                    if not _HAS_ZSTD:
                        raise
                    # fall through to the system decoder
        if not _HAS_ZSTD:
            raise RuntimeError("zstandard module unavailable and the "
                               "vendored zstd could not decode the frame")
        d = _zstd.ZstdDecompressor()
        return d.decompress(blob, max_output_size=expected_size or 0)
    return zlib.decompress(blob)
