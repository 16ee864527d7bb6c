#!/usr/bin/env python3
"""Smoke test of the codec on a GPU: the main path at a size users run,
every device engine once, each checked byte for byte against the host
engine (engine="numpy").

    python chip_smoke.py            # one GPU: phases a-e + the gpu tests
    python chip_smoke.py --four     # four GPUs: the sharded path only

Phases (one GPU):
  a  SZ2.1 regression codec, 512^3 f32 field from a seed, ABS 1e-3,
     through sz_tpu.compress / decompress with engine="jax" and "auto":
     compress from a host array and from a device jax.Array, decompress
     to the host and with as_jax=True;
  b  2D 1800x3600 f32 at ABS (the rank-2 plane path);
  c  3D f64 256^3 with engine="jax";
  d  classic SZ1.4, random access, temporal (5 steps) and PW_REL 256^3
     (engine="jax") at small sizes;
  e  the Huffman decode kernel against the host decoder, timed.
Four GPUs: compress_sharded of a 2048x512x512 f32 field from a host
array and from a sharded jax.Array (each slab equal to api.compress of
the slab), decompress_sharded equal to ra.decompress, and the random-
access mesh container equal to the host container.

Every phase prints its wall times (after block_until_ready), stage spans
and counters.  The script exits non-zero, printing no result line, when
JAX finds no GPU, when bytes differ, when a bound is violated, or when a
device engine took a host fallback ("host_fallback.*" counters).  The
last line is one JSON object with the device as JAX reports it.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import subprocess
import sys
import time
import traceback

REPO = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(REPO))

import numpy as np  # noqa: E402

import sz_tpu  # noqa: E402  (fails outside a checkout of the repo)
from sz_tpu import ErrorBoundMode, SZConfig, api, ra  # noqa: E402
from sz_tpu.utils import trace  # noqa: E402

FAILURES: list = []


def log(*a):
    print(*a, flush=True)


def check(cond: bool, what: str) -> None:
    log(("  ok   " if cond else "  FAIL ") + what)
    if not cond:
        FAILURES.append(what)


def synth(shape, dtype=np.float32, seed=42):
    """Smooth field plus noise (bench.synth's field at any shape)."""
    rng = np.random.default_rng(seed)
    axes = [np.linspace(0, 8 * np.pi, n, dtype=np.float32) for n in shape]
    f = np.ones(shape, np.float32)
    for i, a in enumerate(axes):
        s = [1] * len(shape)
        s[i] = -1
        f = f * (np.sin(a) if i % 2 == 0 else np.cos(a)).reshape(s)
    f = f + np.float32(0.1) * rng.standard_normal(shape, np.float32)
    return f.astype(dtype)


def timed(fn):
    """(result, seconds) with the result's device work finished."""
    import jax
    t0 = time.perf_counter()
    out = fn()
    jax.block_until_ready(out)
    return out, time.perf_counter() - t0


def spans_and_counters(label: str) -> dict:
    sp = {}
    for name, dt in trace.last_spans():
        sp[name] = sp.get(name, 0.0) + dt
    ctr = trace.counters()
    log(f"  {label} spans_ms " + json.dumps(
        {k: round(v * 1e3, 3) for k, v in sp.items()}))
    log(f"  {label} counters " + json.dumps(ctr))
    fb = {k: v for k, v in ctr.items() if k.startswith("host_fallback")}
    check(not fb, f"{label}: no host fallback {fb or ''}")
    return ctr


def run(label: str, fn):
    """Run fn with fresh spans/counters; returns (result, seconds)."""
    trace.reset()
    out, dt = timed(fn)
    log(f"  {label} wall_s {dt:.6f}")
    ctr = spans_and_counters(label)
    return out, dt, ctr


def guard(name: str, fn, *args):
    """Run one phase; an exception fails the run (with its traceback on
    stderr) but the later phases still run and report."""
    try:
        return fn(*args)
    except Exception:  # noqa: BLE001 - recorded as a failure, not hidden
        traceback.print_exc()
        check(False, f"phase {name} raised (traceback on stderr)")
        return None


def bits_equal(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    u = np.uint32 if a.dtype == np.float32 else np.uint64
    return a.shape == b.shape and np.array_equal(a.view(u), b.view(u))


def within(out, data, eb) -> bool:
    err = np.abs(np.asarray(out, np.float64) - data.astype(np.float64))
    return bool(np.isfinite(err).all() and err.max() <= eb * (1 + 1e-6))


def regression_case(tag, data, eb, engines=("jax", "auto")):
    """Host-engine reference, then every engine's compress/decompress
    against it."""
    import jax
    cfg_np = SZConfig(engine="numpy").with_bound(ErrorBoundMode.ABS, eb)
    ref, t_np, _ = run(f"{tag} compress[numpy]",
                       lambda: sz_tpu.compress(data, cfg_np))
    log(f"  {tag} ratio {data.nbytes / len(ref):.6f} "
        f"({data.nbytes} -> {len(ref)} bytes)")
    ref_out, _, _ = run(f"{tag} decompress[numpy]", lambda: sz_tpu.decompress(
        ref, data.shape, data.dtype, engine="numpy"))
    check(within(ref_out, data, eb), f"{tag}: host decode within {eb}")
    for eng in engines:
        cfg = SZConfig(engine=eng).with_bound(ErrorBoundMode.ABS, eb)
        for rep in ("cold", "warm"):
            blob, _, ctr = run(f"{tag} compress[{eng},host,{rep}]",
                               lambda: sz_tpu.compress(data, cfg))
            check(blob == ref, f"{tag}: compress[{eng},host] bytes == numpy")
            check("fixpoint_sweeps" in ctr,
                  f"{tag}: compress[{eng}] ran the device engine "
                  f"(sweeps {ctr.get('fixpoint_sweeps')})")
        dev = jax.device_put(data)
        blob, _, _ = run(f"{tag} compress[{eng},device]",
                         lambda: sz_tpu.compress(dev, cfg))
        check(blob == ref, f"{tag}: compress[{eng},jax.Array] bytes == numpy")
        del dev
        for rep in ("cold", "warm"):
            out, _, ctr = run(f"{tag} decompress[{eng},host,{rep}]",
                              lambda: sz_tpu.decompress(
                                  ref, data.shape, data.dtype, engine=eng))
            check(bits_equal(out, ref_out),
                  f"{tag}: decompress[{eng}] == numpy decode (bitwise)")
            check("decode_sweeps" in ctr,
                  f"{tag}: decompress[{eng}] ran the device engine")
        out, _, _ = run(f"{tag} decompress[{eng},as_jax]",
                        lambda: sz_tpu.decompress(ref, data.shape,
                                                  data.dtype, engine=eng,
                                                  as_jax=True))
        check(isinstance(out, jax.Array)
              and out.devices().pop().platform == "gpu",
              f"{tag}: as_jax output lives on the GPU")
        check(bits_equal(np.asarray(out), ref_out),
              f"{tag}: decompress[{eng},as_jax] == numpy decode")
        del out
    return ref


def phase_a():
    log("phase a: 512^3 f32 ABS 1e-3, regression codec")
    data = synth((512, 512, 512))
    return regression_case("a", data, 1e-3), data


def phase_b():
    log("phase b: 2D 1800x3600 f32 ABS 1e-3")
    regression_case("b", synth((1800, 3600), seed=7), 1e-3,
                    engines=("jax",))


def phase_c():
    log("phase c: 3D f64 256^3 ABS 1e-6, engine=jax")
    regression_case("c", synth((256, 256, 256), np.float64, seed=9), 1e-6,
                    engines=("jax",))


def phase_d():
    import jax
    import jax.numpy as jnp
    from sz_tpu.core import rablock
    from sz_tpu.temporal import TemporalCompressor

    log("phase d: classic, random access, temporal, PW_REL")
    ch = SZConfig(engine="numpy", with_regression=False).with_bound(
        ErrorBoundMode.ABS, 1e-3)
    cj = SZConfig(engine="jax", with_regression=False).with_bound(
        ErrorBoundMode.ABS, 1e-3)
    for dt in (np.float32, np.float64):
        tag = f"d classic {np.dtype(dt).name}"
        d = synth((96, 100, 104), dt, seed=11)
        bh = sz_tpu.compress(d, ch)
        bj, _, _ = run(f"{tag} compress[jax]",
                       lambda: sz_tpu.compress(d, cj))
        check(bj == bh, f"{tag}: bytes == numpy")
        oh = sz_tpu.decompress(bh, d.shape, dt, engine="numpy")
        oj, _, _ = run(f"{tag} decompress[jax]", lambda: sz_tpu.decompress(
            bh, d.shape, dt, engine="jax"))
        check(bits_equal(oj, oh) and within(oj, d, 1e-3),
              f"{tag}: decode == numpy, within bound")

    r = synth((64, 72, 80), seed=12)
    cfg = SZConfig().with_bound(ErrorBoundMode.ABS, 1e-3)
    host = rablock.compress_ra(r, 1e-3, cfg)
    dev, _, _ = run("d ra compress[jax]",
                    lambda: rablock.compress_ra(r, 1e-3, cfg, engine="jax"))
    check(dev.body == host.body, "d ra: container == host")
    rh = rablock.decompress_ra(host.body, r.shape)
    rj, _, _ = run("d ra decompress[jax]", lambda: rablock.decompress_ra(
        host.body, r.shape, engine="jax"))
    check(bits_equal(rj, rh), "d ra: decode == host")

    shape = (128, 128, 64)
    base = synth(shape, seed=13)
    steps = [base + np.float32(0.01 * k) for k in range(5)]
    tc_h = TemporalCompressor(snapshot_step=3)
    tc_d = TemporalCompressor(snapshot_step=3)
    for tc in (tc_h, tc_d):
        tc.register(0, "v", shape, np.float32, cfg)
    trace.reset()
    frames = []
    for k, s in enumerate(steps):
        f_h = tc_h.compress_step({0: s})
        f_d = tc_d.compress_step({0: jnp.asarray(s)})
        check(f_d == f_h, f"d temporal step {k}: device frame == host")
        frames.append(f_h)
    dec_h = TemporalCompressor(snapshot_step=3)
    dec_d = TemporalCompressor(snapshot_step=3)
    for tc in (dec_h, dec_d):
        tc.register(0, "v", shape, np.float32, cfg)
    for k, f in enumerate(frames):
        o_h = dec_h.decompress_step(f)[0]
        o_d = dec_d.decompress_step(f, as_jax=True)[0]
        check(isinstance(o_d, jax.Array) and bits_equal(o_d, o_h)
              and within(o_h, steps[k], 1e-3),
              f"d temporal step {k}: device decode == host, within bound")
    spans_and_counters("d temporal")

    p = np.abs(synth((256, 256, 256), seed=14)) + np.float32(0.01)
    pw_h = SZConfig(engine="numpy", error_bound_mode=ErrorBoundMode.PW_REL,
                    pw_rel_bound_ratio=1e-3)
    pw_j = SZConfig(engine="jax", error_bound_mode=ErrorBoundMode.PW_REL,
                    pw_rel_bound_ratio=1e-3)
    ph = sz_tpu.compress(p, pw_h)
    pj, _, _ = run("d pwrel compress[jax]", lambda: sz_tpu.compress(p, pw_j))
    check(pj == ph, "d pwrel: bytes == numpy")
    qh = sz_tpu.decompress(ph, p.shape, np.float32, engine="numpy")
    qj, _, _ = run("d pwrel decompress[jax]", lambda: sz_tpu.decompress(
        ph, p.shape, np.float32, engine="jax"))
    rel = np.abs(np.asarray(qj, np.float64) - p) / np.abs(p)
    check(bits_equal(qj, qh) and rel.max() <= 1e-3 * (1 + 1e-5),
          "d pwrel: decode == numpy, within bound")


def phase_e(blob, data):
    """Huffman decode of phase a's stream: the Triton kernel against
    the host FSM (native, parallel C) plus one upload of the types."""
    import jax
    from sz_tpu.core import regnd
    from sz_tpu.format import huffman, lossless as ll, metadata as md
    from sz_tpu.config import DataType
    from sz_tpu.tpu import engine

    log("phase e: Huffman decode kernel vs host FSM + upload (512^3)")
    inner = ll.decompress(blob, expected_size=data.nbytes * 2 + 64)
    hdr = md.parse_header(inner, DataType.FLOAT)
    body = inner[hdr.body_offset + hdr.size_type:]
    p = regnd.parse_body(body, data.shape, np.float32, hdr.size_type,
                         raw_types=True)
    n = data.size
    Lh, Rh, Ch, Th, _ = p.tree
    log(f"  e stream bits {len(p.encoded) * 8} symbols {n} "
        f"tree nodes {len(Lh)}")

    def kernel():
        return engine._device_decode_stream(p.tree, p.encoded, n)

    def host():
        t = huffman.decode(Lh, Rh, Ch, Th, p.encoded, n)
        return jax.device_put(t)

    ref = host()
    res = {}
    for name, fn in (("kernel", kernel), ("host_fsm_upload", host)):
        trace.reset()
        ts = []
        for _ in range(4):
            out, dt = timed(fn)
            ts.append(dt)
        res[name] = ts
        log(f"  e {name} wall_s " + " ".join(f"{t:.6f}" for t in ts)
            + f" counters {json.dumps(trace.counters())}")
    syms = kernel()
    check(syms is not None, "e kernel: decoded on the device (no host "
          "fallback)")
    check(syms is not None and bool(jax.numpy.array_equal(syms, ref)),
          "e kernel: symbols == host FSM")
    # end to end: decompress(as_jax) with the device decode vs the host
    # FSM + packed-type upload
    e2e = {}
    for name, pol in (("kernel", True), ("host_fsm", False)):
        old = engine.device_decode_policy
        engine.device_decode_policy = lambda be, pol=pol: pol
        try:
            ts = []
            for _ in range(3):
                trace.reset()
                _, dt = timed(lambda: engine.decompress(
                    body, data.shape, np.float32, as_jax=True))
                ts.append(dt)
        finally:
            engine.device_decode_policy = old
        e2e[name] = ts
        log(f"  e decompress_as_jax[{name}] wall_s "
            + " ".join(f"{t:.6f}" for t in ts) + " last spans_ms "
            + json.dumps({k: round(v * 1e3, 3)
                          for k, v in trace.last_spans()}))
    return res, e2e


def gpu_tests() -> None:
    """The `gpu`-marked tests, in a child process that owns the card
    until it exits (this process has not touched the card yet)."""
    env = dict(os.environ, SZ_TPU_TEST_PLATFORM="gpu")
    r = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-m", "gpu",
         "-p", "no:cacheprovider", str(REPO / "tests" / "test_hw.py")],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=600)
    lines = (r.stdout + r.stderr).strip().splitlines()
    for line in lines[-(3 if r.returncode == 0 else 60):]:
        log("  pytest: " + line)
    check(r.returncode == 0, "gpu-marked tests pass on the card")


def four() -> None:
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from sz_tpu.core import rablock
    from sz_tpu.parallel import slab

    nd = 4
    log("four: sharded regression path, 2048x512x512 f32, ABS 1e-3")
    data = synth((2048, 512, 512), seed=21)
    cfg = SZConfig().with_bound(ErrorBoundMode.ABS, 1e-3)
    blob, _, _ = run("four compress_sharded[host,cold]",
                     lambda: slab.compress_sharded(data, cfg, n_devices=nd))
    blob, _, _ = run("four compress_sharded[host,warm]",
                     lambda: slab.compress_sharded(data, cfg, n_devices=nd))
    r = ra.Reader(blob)
    check(r.n_slabs == nd, f"four: {r.n_slabs} slabs")
    for i in range(r.n_slabs):
        a, b = int(r.starts[i]), int(r.starts[i + 1])
        check(r.slab_bytes(i) == api.compress(
            np.ascontiguousarray(data[a:b]), cfg),
            f"four: slab {i} bytes == api.compress(slab)")
    sharded = jax.device_put(jnp.asarray(data), NamedSharding(
        slab._mesh(nd), P(slab.AXIS, None, None)))
    blob_d, _, _ = run("four compress_sharded[jax.Array]",
                       lambda: slab.compress_sharded(sharded, cfg,
                                                     n_devices=nd))
    check(blob_d == blob, "four: sharded jax.Array container == host")
    del sharded
    out, _, _ = run("four decompress_sharded",
                    lambda: slab.decompress_sharded(blob, n_devices=nd))
    serial = ra.decompress(blob)
    check(bits_equal(out, serial), "four: decompress_sharded == ra.decompress")
    check(within(serial, data, 1e-3), "four: within bound")
    rdata = synth((128, 120, 112), seed=22)
    host = rablock.compress_ra(rdata, 1e-3, cfg)
    mesh, _, _ = run("four rablock compress[mesh]",
                     lambda: rablock.compress_ra(rdata, 1e-3, cfg,
                                                 engine="jax",
                                                 n_devices=nd))
    check(mesh.body == host.body, "four: rablock mesh container == host")
    rec = rablock.decompress_ra(host.body, rdata.shape, engine="jax",
                                n_devices=nd)
    check(bits_equal(rec, rablock.decompress_ra(host.body, rdata.shape)),
          "four: rablock mesh decode == host")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run the four-GPU sharded path only")
    args = ap.parse_args()
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        smi = None
    if smi is None or smi.returncode != 0:
        print("no GPU: nvidia-smi is not available", file=sys.stderr)
        return 2
    for line in smi.stdout.strip().splitlines():
        log(f"card: {line.strip()}")
    if not args.four:
        gpu_tests()

    import jax
    devs = jax.devices()
    dev = devs[0]
    if dev.platform != "gpu":
        print(f"no GPU: JAX reports platform {dev.platform}",
              file=sys.stderr)
        return 2
    log(f"jax {jax.__version__} devices {len(devs)} x {dev.device_kind}")
    if args.four:
        if len(devs) < 4:
            print(f"--four needs 4 GPUs, JAX sees {len(devs)}",
                  file=sys.stderr)
            return 2
        guard("four", four)
        count = 4
    else:
        res = guard("a", phase_a)
        if res is not None:
            guard("e", phase_e, *res)
        del res
        guard("b", phase_b)
        guard("c", phase_c)
        guard("d", phase_d)
        count = 1
    stats = dev.memory_stats() or {}
    log(f"peak_bytes_in_use {stats.get('peak_bytes_in_use')}")
    if FAILURES:
        log(f"{len(FAILURES)} check(s) failed:")
        for f in FAILURES:
            log(f"  {f}")
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
