#!/usr/bin/env python3
"""Compress device-resident (sharded) arrays in place — the device-native
production mode with no reference-example analog: simulation output or
checkpoint shards living in device memory go straight into the codec without a
host round-trip of the lattice.

Three modes, all producing reference-compatible bytes:

  1. single-device jax.Array -> sz_tpu.compress(dev_array, cfg)
     (upload skipped; the interval optimizer's sampling walks gather
     on device, engine._opt_gather_fn)
  2. mesh-sharded jax.Array -> slab.compress_sharded(sharded, cfg)
     (each shard compressed where it lives; per-slab range scan,
     optimizer gathers and dense-mean extraction are sharded
     dispatches; payloads byte-identical to api.compress per slab)
  3. decompress-to-device -> sz_tpu.decompress(..., as_jax=True)
     (bit-packed type upload + on-device reconstruction; the output
     never touches the host)

Run anywhere: uses however many jax devices exist (force a virtual
mesh with XLA_FLAGS=--xla_force_host_platform_device_count=8
JAX_PLATFORMS=cpu).
"""

import time

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

import sz_tpu
from sz_tpu import api, ra
from sz_tpu.parallel import slab

devs = jax.devices()
print(f"devices: {devs}")

# a "checkpoint shard": some on-device computation's output
n = 128
ax = jnp.linspace(0, 4 * jnp.pi, n)
field = (jnp.sin(ax)[:, None, None] * jnp.cos(ax)[None, :, None]
         * jnp.cos(0.5 * ax)[None, None, :])
field = field + 0.05 * jax.random.normal(jax.random.key(0), (n, n, n))
# the engine enables jax x64, so cast AFTER the arithmetic: a float64
# field would (correctly) produce a DOUBLE stream
field = field.astype(jnp.float32)
field.block_until_ready()

cfg = sz_tpu.SZConfig(engine="jax").with_bound(sz_tpu.ErrorBoundMode.ABS,
                                               1e-3)

# --- 1. single-device compress-from-device ---------------------------
t0 = time.perf_counter()
blob = sz_tpu.compress(field, cfg)
dt = time.perf_counter() - t0
print(f"compress-from-device: {field.nbytes / 1e6:.1f} MB -> "
      f"{len(blob) / 1e6:.2f} MB in {dt:.2f}s "
      f"(ratio {field.nbytes / len(blob):.2f})")
assert blob == sz_tpu.compress(np.asarray(field), cfg), \
    "device path must be byte-identical to the host path"

# --- 2. mesh-sharded compress (SPMD checkpoint shards) ----------------
n_dev = len(devs)
if n % n_dev == 0 and n_dev > 1:
    mesh = slab._mesh(n_dev)
    sharded = jax.device_put(field, NamedSharding(mesh,
                                                  P(slab.AXIS, None, None)))
    t0 = time.perf_counter()
    container = slab.compress_sharded(sharded, cfg, n_devices=n_dev)
    dt = time.perf_counter() - t0
    print(f"sharded compress ({n_dev} devices): {dt:.2f}s, "
          f"container {len(container) / 1e6:.2f} MB")
    r = ra.Reader(container)
    a, b = int(r.starts[0]), int(r.starts[1])
    assert r.slab_bytes(0) == api.compress(np.asarray(field)[a:b], cfg)
    print("slab 0 byte-identical to serial api.compress of that slab")

# --- 3. decompress-to-device ------------------------------------------
t0 = time.perf_counter()
out = sz_tpu.decompress(blob, field.shape, np.float32, engine="jax",
                        as_jax=True)
out.block_until_ready()
dt = time.perf_counter() - t0
err = float(jnp.max(jnp.abs(out - field)))
print(f"decompress-to-device: {dt:.2f}s, max err {err:.2e} "
      f"(bound 1e-3), result stays in HBM: {type(out).__name__}")
