"""Start-up contract of the GPU build: chip_smoke.py refuses to report
without a GPU, the compile cache follows JAX_COMPILATION_CACHE_DIR (else
a fixed directory inside the checkout), the native libraries build from
the committed sources, and the lossless stage needs no optional module.
"""

import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent


def _env(**extra):
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_COMPILATION_CACHE_DIR", "XLA_FLAGS")}
    env["JAX_PLATFORMS"] = "cpu"
    env.update(extra)
    return env


@pytest.mark.parametrize("where", ["checkout", "alone"])
def test_chip_smoke_refuses_without_gpu(tmp_path, where):
    """No GPU (or no repo beside the script): non-zero exit and no JSON
    result line."""
    script = REPO / "chip_smoke.py"
    cwd = REPO
    if where == "alone":
        shutil.copy(script, tmp_path / "chip_smoke.py")
        script, cwd = tmp_path / "chip_smoke.py", tmp_path
    env = _env(PATH=os.environ.get("PATH", "/usr/bin:/bin"))
    env.pop("PYTHONPATH", None)
    r = subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


@pytest.mark.parametrize("env_dir", [False, True])
def test_compile_cache_location(tmp_path, env_dir):
    """JAX_COMPILATION_CACHE_DIR wins when set; otherwise the engine
    keeps its cache in <checkout>/.jax_cache."""
    extra = {"PYTHONPATH": str(REPO)}
    if env_dir:
        extra["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path / "cc")
    code = ("import jax, sz_tpu.tpu.engine\n"
            "print(jax.config.jax_compilation_cache_dir)\n")
    r = subprocess.run([sys.executable, "-c", code], env=_env(**extra),
                       cwd=tmp_path, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    want = tmp_path / "cc" if env_dir else REPO / ".jax_cache"
    assert pathlib.Path(r.stdout.strip().splitlines()[-1]) == want


def test_vendored_zstd_builds_from_sources():
    """The zstd 1.3.5 library is built from sz_tpu/native/vendor (no
    binary is committed) and round-trips a frame."""
    from sz_tpu import native
    tracked = subprocess.run(
        ["git", "ls-files", "sz_tpu/native/*.so"], cwd=REPO,
        capture_output=True, text=True).stdout.split()
    assert tracked == []
    assert native.HAVE_ZSTD135
    raw = np.arange(50000, dtype=np.int32).tobytes()
    blob = native.zstd135_compress(raw, 3)
    assert native.zstd135_decompress(blob, len(raw)) == raw


def test_lossless_without_zstandard_module(monkeypatch):
    """The main path needs no `zstandard` module: frames are written and
    read by the vendored library, and a frame it cannot decode raises
    a clear error instead of reaching for the missing module."""
    from sz_tpu.config import Lossless
    from sz_tpu.format import lossless as ll
    monkeypatch.setattr(ll, "_zstd", None)
    monkeypatch.setattr(ll, "_HAS_ZSTD", False)
    raw = bytes(range(256)) * 400
    blob = ll.compress(raw, Lossless.ZSTD, 3)
    assert ll.decompress(blob, expected_size=len(raw)) == raw
    with pytest.raises(RuntimeError):
        ll.decompress(blob[:4] + b"\0" * 12)


def test_trace_counters_reset():
    """Counters sit beside the spans and clear with them."""
    from sz_tpu.utils import trace
    trace.reset()
    trace.count("fixpoint_sweeps", 7)
    trace.count("fixpoint_sweeps", 2)
    trace.count("host_fallback.huffman_decode")
    with trace.trace("stage"):
        pass
    assert trace.counters() == {"fixpoint_sweeps": 9,
                                "host_fallback.huffman_decode": 1}
    assert [n for n, _ in trace.last_spans()] == ["stage"]
    trace.reset()
    assert trace.counters() == {} and trace.last_spans() == []


def test_graft_entry_runs_on_the_live_backend():
    """__graft_entry__.entry() builds the fixpoint quantize for the
    backend it runs on; it converges and its histogram counts its own
    type stream."""
    sys.path.insert(0, str(REPO))
    import __graft_entry__ as ge
    from sz_tpu.tpu import engine
    fn, args = ge.entry()
    t_stream, hist, _esc, _R, iters = fn(*args)
    t = np.asarray(t_stream)
    assert t.shape == (64 ** 3,) and int(iters) > 0
    np.testing.assert_array_equal(
        np.asarray(hist), np.bincount(t, minlength=65536))
    assert engine.jax.default_backend() == "cpu"
