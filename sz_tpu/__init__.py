"""sz_tpu — an accelerator-native error-bounded lossy compression framework.

A from-scratch JAX/XLA/Pallas re-design of the SZ2 error-bounded lossy
compressor for scientific data (reference: szcompressor/SZ 2.1.12.4).
Produces byte streams that the reference SZ2 decompressor accepts
bit-exactly, while running the parallel passes (prediction, quantization,
histograms, bit packing) as device kernels and scaling over device meshes.

Public API:
    compress(data, error_bound=..., mode=...) -> bytes
    decompress(blob, shape, dtype) -> np.ndarray
    SZConfig — immutable configuration (analog of sz_params, conf.c:99-141)
"""

from sz_tpu.config import (
    SZConfig,
    ErrorBoundMode,
    SZMode,
    Lossless,
    DataType,
)
from sz_tpu.api import (compress, compress_region, decompress,
                        decompress_region, get_metadata)

__version__ = "0.1.0"

__all__ = [
    "SZConfig",
    "ErrorBoundMode",
    "SZMode",
    "Lossless",
    "DataType",
    "compress",
    "compress_region",
    "decompress",
    "decompress_region",
    "get_metadata",
    "__version__",
]
