#!/usr/bin/env python3
"""Point-wise-relative (PW_REL / MSST19) compression with the device
engine.

The reference's marquee accelerated mode (user guide §6(5),
sz_float_pwr.c:1978 MSST19).  engine="jax" runs the multiplicative-
Lorenzo chain as an anti-diagonal wavefront on the device; every device
stream is decode-verified on the host and re-encoded there if it would
break the bound, so the output is always reference-conformant.
engine="auto" keeps PW_REL on the host codec, which the wavefront scan
does not beat yet.
"""

import numpy as np

import sz_tpu

rng = np.random.default_rng(0)
x = np.linspace(0.1, 9.3, 256)[:, None, None]
y = np.linspace(0.2, 7.1, 256)[None, :, None]
z = np.linspace(0.3, 5.7, 256)[None, None, :]
data = (np.exp(np.sin(x) * np.cos(y) + 0.2 * np.sin(z))
        * (1 + 0.05 * rng.standard_normal((256, 256, 256)))
        ).astype(np.float32)

cfg = sz_tpu.SZConfig(
    error_bound_mode=sz_tpu.ErrorBoundMode.PW_REL,
    pw_rel_bound_ratio=1e-3,      # every point within 0.1% of itself
    engine="jax",                 # the device wavefront
)

blob = sz_tpu.compress(data, cfg)
out = sz_tpu.decompress(blob, data.shape, np.float32)

rel = np.abs(out - data) / np.maximum(np.abs(data), 1e-30)
print(f"ratio        {data.nbytes / len(blob):.2f}x")
print(f"max point-wise relative error {rel.max():.3e}  (bound 1e-3)")

# the stream is reference-compatible: `sz -x -f -s out.sz -3 256 256
# 256` decodes it bit-identically
with open("/tmp/pwrel_example.sz", "wb") as f:
    f.write(blob)
print("wrote /tmp/pwrel_example.sz (decodable by the reference CLI)")
