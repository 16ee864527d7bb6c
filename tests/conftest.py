"""Test env: force a virtual 8-device CPU mesh so sharding tests run
anywhere (the four-card path runs on GPUs through chip_smoke.py --four)."""

import os

# Force CPU for the whole test process (set the env var and the live jax
# config, in case jax was imported first).  Bit-exactness on the genuine
# XLA:CPU backend is handled inside the engine (_strict_jit disables the
# fusion pass that would FMA-contract mul+add).  SZ_TPU_TEST_PLATFORM=gpu
# runs the `gpu`-marked tests on a card (tests/test_hw.py).
_plat = os.environ.get("SZ_TPU_TEST_PLATFORM", "cpu")
if _plat == "gpu":
    _plat = "cuda"      # JAX's platform name for an NVIDIA card
os.environ["JAX_PLATFORMS"] = _plat

# Some sandbox VMs reclaim freed large allocations and re-fault pages
# extremely slowly (~7 MB/s measured); keep big malloc'd buffers on the
# heap so only the first touch pays.  Env vars are too late for this
# process — use mallopt directly (M_TRIM_THRESHOLD=-1, M_MMAP_THRESHOLD=-3).
try:
    import ctypes as _ct
    _libc = _ct.CDLL("libc.so.6", use_errno=True)
    _libc.mallopt(_ct.c_int(-1), _ct.c_int(2**31 - 1))  # M_TRIM_THRESHOLD
    _libc.mallopt(_ct.c_int(-3), _ct.c_int(2**31 - 1))  # M_MMAP_THRESHOLD
except Exception:  # pragma: no cover - non-glibc
    pass

import jax

jax.config.update("jax_platforms", _plat)
flags = os.environ.get("XLA_FLAGS", "")
if _plat == "cpu" and "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import pathlib
import subprocess

import numpy as np
import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent

# Every XLA:CPU executable keeps its JIT code pages mapped for the life
# of the process; the full suite compiles thousands of shape-specialized
# engine functions, and the process hits vm.max_map_count (65530) around
# the 85% mark — mmap() then fails inside LLVM's JIT and the compile
# SEGFAULTs.  Raise the limit when we can (root VM); either way, drop
# all live executables whenever the map count nears the limit — freed
# JIT regions are reused, so the count plateaus and in-use shapes just
# recompile on demand.
try:
    with open("/proc/sys/vm/max_map_count", "r+") as _f:
        _map_limit = int(_f.read())
        if _map_limit < 262144:
            try:
                _f.seek(0)
                _f.write("262144")
                _map_limit = 262144
            except OSError:
                pass
except OSError:  # pragma: no cover - non-linux
    _map_limit = 65530
_MAPS_CLEAR_AT = int(_map_limit * 0.6)


@pytest.fixture(autouse=True)
def _jit_map_pressure_guard():
    yield
    try:
        with open("/proc/self/maps", "rb") as f:
            n_maps = sum(1 for _ in f)
    except OSError:  # pragma: no cover - non-linux
        return
    if n_maps > _MAPS_CLEAR_AT:
        jax.clear_caches()
GOLDEN = REPO / "tests" / "golden"
REF_BIN = pathlib.Path("/tmp/szref/build/bin/sz")
REF_DATA = pathlib.Path("/root/reference/example/testdata/x86")


@pytest.fixture(scope="session")
def testfloat_888128():
    return np.fromfile(REF_DATA / "testfloat_8_8_128.dat",
                       dtype="<f4")


@pytest.fixture(scope="session")
def testdouble_888128():
    return np.fromfile(REF_DATA / "testdouble_8_8_128.dat",
                       dtype="<f8")


@pytest.fixture(scope="session")
def testdouble_8888128():
    return np.fromfile(REF_DATA / "testdouble_8_8_8_128.dat",
                       dtype="<f8")


def have_ref() -> bool:
    return REF_BIN.exists()


def ref_compress(datafile, dims, mode_args, out, ftype="-f"):
    """Run the reference CLI: sz -z ..."""
    dimflag = {1: "-1", 2: "-2", 3: "-3", 4: "-4"}[len(dims)]
    cmd = [str(REF_BIN), "-z", str(out), ftype, "-i", str(datafile),
           *mode_args, dimflag, *[str(d) for d in dims]]
    subprocess.run(cmd, check=True, capture_output=True)
    return pathlib.Path(out).read_bytes()


def ref_decompress(szfile, dims, out, ftype="-f"):
    dimflag = {1: "-1", 2: "-2", 3: "-3", 4: "-4"}[len(dims)]
    cmd = [str(REF_BIN), "-x", str(out), ftype, "-s", str(szfile),
           dimflag, *[str(d) for d in dims]]
    subprocess.run(cmd, check=True, capture_output=True)
    return pathlib.Path(out).read_bytes()


@pytest.fixture
def device_decode_interpret(monkeypatch):
    """Route the engines' Huffman decode through the Triton FSM kernel
    in interpret mode (small chunks keep it fast on the CPU); returns
    a list that records, per device decode, whether it succeeded."""
    from sz_tpu.tpu import engine as eng
    from sz_tpu.tpu import fsm_kernel

    monkeypatch.setattr(eng, "device_decode_policy", lambda be: True)
    real = fsm_kernel.decode

    def decode(encoded, trans, n_sym, p_bits=1024, **kw):
        return real(encoded, trans, n_sym, f_bits=4096,
                    p_bits=min(p_bits, 4096), interpret=True)

    monkeypatch.setattr(fsm_kernel, "decode", decode)
    used = []
    orig = eng._device_decode_stream

    def spy(tree, encoded, n):
        r = orig(tree, encoded, n)
        used.append(r is not None)
        return r

    monkeypatch.setattr(eng, "_device_decode_stream", spy)
    return used
