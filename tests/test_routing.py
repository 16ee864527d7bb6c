"""Routing policy (README "Runtime configuration").

The device Huffman decode follows the backend; the transfer-shape knobs
(SZ_TPU_DEVICE_BITPACK / SZ_TPU_PACKED_TYPES) do not.  On the GPU only
the Triton Pallas route is imported and no kernel runs in interpret
mode.  These tests pin the selection matrix so a refactor cannot
silently misroute a backend.
"""

import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest

from sz_tpu.tpu import engine

REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("backend,expect", [
    ("cpu", False), ("raw", False), ("gpu", True)])
def test_device_decode_auto_follows_backend(backend, expect):
    assert engine.device_decode_policy(backend) is expect


def test_transfer_knobs_are_backend_independent(monkeypatch):
    monkeypatch.delenv("SZ_TPU_DEVICE_BITPACK", raising=False)
    assert engine.device_bitpack_policy() is True
    monkeypatch.setenv("SZ_TPU_DEVICE_BITPACK", "0")
    assert engine.device_bitpack_policy() is False
    monkeypatch.delenv("SZ_TPU_PACKED_TYPES", raising=False)
    assert engine.packed_types_enabled() is True
    monkeypatch.setenv("SZ_TPU_PACKED_TYPES", "0")
    assert engine.packed_types_enabled() is False


def test_only_triton_pallas_and_no_interpret_in_package():
    """The package reaches Pallas only through its Triton route (no
    other Pallas dialect is imported), and no code path hard-wires
    interpret mode (kernels take interpret=False unless a test asks)."""
    for path in (REPO / "sz_tpu").rglob("*.py"):
        src = path.read_text()
        dialects = set(re.findall(
            r"pallas(?:\.|\s+import\s+)(\w+)", src))
        assert dialects <= {"triton"}, (path, dialects)
        assert "interpret=True" not in src, path


def test_gpu_backend_imports_only_triton_pallas():
    """Importing every engine with the backend reported as "gpu" loads
    no Pallas dialect module other than the GPU ones (Triton's, and
    Mosaic GPU, which JAX's Triton route imports itself)."""
    code = (
        "import sys, jax\n"
        "jax.default_backend = lambda: 'gpu'\n"
        "import sz_tpu, sz_tpu.api\n"
        "from sz_tpu.tpu import engine, classic_engine, msst19_engine, "
        "ra_engine, fsm_kernel\n"
        "from sz_tpu.parallel import slab\n"
        "import sz_tpu.temporal\n"
        "pre = 'jax.experimental.pallas.'\n"
        "bad = [m for m in sys.modules if m.startswith(pre) "
        "and m[len(pre):] not in ('triton', 'mosaic_gpu')]\n"
        "assert not bad, bad\n")
    env = {"JAX_PLATFORMS": "cpu", "PATH": "/usr/bin:/bin",
           "PYTHONPATH": str(REPO)}
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]


def test_gpu_decode_calls_kernel_without_interpret(monkeypatch):
    """On a "gpu" backend the regression decoder hands the coded stream
    to the Triton decode kernel, compiled (no interpret flag)."""
    from sz_tpu.core import regnd
    from sz_tpu.format import huffman
    from sz_tpu.tpu import fsm_kernel

    rng = np.random.default_rng(5)
    data = (np.sin(np.linspace(0, 9, 20 * 18 * 16, dtype=np.float32))
            + 0.05 * rng.standard_normal(20 * 18 * 16)
            ).astype(np.float32).reshape(20, 18, 16)
    kw = dict(max_range_radius=32768, sample_distance=100,
              pred_threshold=np.float32(0.99))
    res = regnd.compress(data, 1e-3, **kw)
    calls = []

    def spy(encoded, trans, n_sym, **kwargs):
        calls.append(kwargs)
        p = regnd.parse_body(res.body, data.shape, np.float32, 8,
                             raw_types=True)
        Lh, Rh, Ch, Th, _ = p.tree
        syms = huffman.decode(Lh, Rh, Ch, Th, encoded, n_sym)
        return engine.jnp.asarray(syms), engine.jnp.asarray(True)

    monkeypatch.setattr(engine.jax, "default_backend", lambda: "gpu")
    monkeypatch.setattr(fsm_kernel, "decode", spy)
    out = engine.decompress(res.body, data.shape, np.float32)
    assert calls and all(not c.get("interpret", False) for c in calls)
    oracle = regnd.decompress(res.body, data.shape, np.float32)
    np.testing.assert_array_equal(out.view(np.uint32),
                                  oracle.view(np.uint32))


def test_msst19_device_ok_policy():
    """The MSST19 engine's routing contract: never on for host-only
    requests, always honors explicit engine="jax" for 2/3-D."""
    from sz_tpu.tpu import msst19_engine as me
    assert me.device_ok("numpy", np.float32, 3, 1 << 20) is False
    assert me.device_ok("jax", np.float32, 3, 64) is True
    assert me.device_ok("jax", np.float64, 3, 64) is True
    assert me.device_ok("jax", np.float32, 1, 1 << 20) is False
    assert me.device_ok("jax", np.float32, 4, 1 << 20) is False


def test_msst19_device_size_envelope():
    """The float wavefront keeps its certified envelope
    (DEVICE_MAX_POINTS) with verify-and-fallback."""
    from sz_tpu.tpu import msst19_engine as me
    assert me.device_ok("jax", np.float32, 3, me.DEVICE_MAX_POINTS)
    assert not me.device_ok("jax", np.float32, 3,
                            me.DEVICE_MAX_POINTS + 1)
    assert not me.device_ok("jax", np.float32, 2,
                            me.DEVICE_MAX_POINTS + 1)


def test_msst19_auto_routing(monkeypatch):
    """engine="auto" keeps PW_REL on the host codec on every backend."""
    from sz_tpu.tpu import msst19_engine as me

    assert not me.device_ok("auto", np.float32, 3, 1 << 24)
    monkeypatch.setattr(me.jax, "default_backend", lambda: "gpu")
    assert not me.device_ok("auto", np.float32, 3, 1 << 20)
    assert not me.device_ok("auto", np.float32, 2, 1 << 22)
