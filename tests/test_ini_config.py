"""sz.config INI loading (SZ_ReadConf, conf.c:74-391) + CLI -c/-q."""

import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest

import sz_tpu
from sz_tpu.config import SZConfig, ErrorBoundMode, SZMode, Lossless
from sz_tpu.format import lossless as ll

REF_BIN = pathlib.Path("/tmp/szref/build/bin/sz")
REF_CONF = pathlib.Path("/root/reference/example/sz.config")
need_ref = pytest.mark.skipif(not REF_BIN.exists(),
                              reason="reference binary not built")


def synth(shape, seed=5):
    rng = np.random.default_rng(seed)
    axes = [np.linspace(0, 4 * np.pi, n) for n in shape]
    grids = np.meshgrid(*axes, indexing="ij")
    field = np.sin(grids[0])
    for g in grids[1:]:
        field = field * np.cos(g)
    return (field + 0.5
            + 0.05 * rng.standard_normal(shape)).astype(np.float32)


def test_from_file_example_config(tmp_path):
    if not REF_CONF.exists():
        pytest.skip(f"reference example config {REF_CONF} not present")
    conf = REF_CONF.read_text()
    conf = re.sub(r"errorBoundMode = .*", "errorBoundMode = ABS", conf)
    p = tmp_path / "sz.config"
    p.write_text(conf)
    cfg = SZConfig.from_file(p)
    assert cfg.error_bound_mode == ErrorBoundMode.ABS
    assert cfg.sz_mode == SZMode.BEST_COMPRESSION
    assert cfg.lossless == Lossless.ZSTD
    # config-file-path iniparser defaults differ from no-file defaults
    assert cfg.segment_size == 0 or "segment_size" in conf
    assert cfg.plus_bits == 3


def test_from_file_missing_bound_mode(tmp_path):
    p = tmp_path / "bad.config"
    p.write_text("[PARAMETER]\nabsErrBound = 1E-3\n")
    with pytest.raises(ValueError):
        SZConfig.from_file(p)


@need_ref
def test_cli_config_golden(tmp_path):
    shape = (33, 20, 17)
    data = synth(shape)
    dpath = tmp_path / "t.dat"
    data.tofile(dpath)
    conf = REF_CONF.read_text()
    conf = re.sub(r"errorBoundMode = .*", "errorBoundMode = ABS", conf)
    conf = re.sub(r"absErrBound = .*", "absErrBound = 1E-3", conf)
    cpath = tmp_path / "sz.config"
    cpath.write_text(conf)
    subprocess.run(
        [str(REF_BIN), "-z", "-f", "-c", str(cpath), "-i", str(dpath),
         "-3", "17", "20", "33"], check=True, capture_output=True)
    golden = (tmp_path / "t.dat.sz").read_bytes()
    r = subprocess.run(
        [sys.executable, "-m", "sz_tpu.cli", "-z",
         str(tmp_path / "ours.sz"), "-f", "-c", str(cpath), "-i",
         str(dpath), "-3", "17", "20", "33", "-q"],
        capture_output=True, text=True)
    assert r.returncode == 0, r.stderr
    assert "compression ratio" in r.stdout  # -q stats report
    ours = (tmp_path / "ours.sz").read_bytes()

    def norm(inner):
        b = bytearray(inner)
        b[19] = 0  # params[15]: uninitialized in config-file runs
        return bytes(b)

    assert norm(ll.decompress(golden)) == norm(ll.decompress(ours))


def test_cli_tucker_gate(tmp_path):
    data = synth((8, 8, 8))
    dpath = tmp_path / "t.dat"
    data.tofile(dpath)
    r = subprocess.run(
        [sys.executable, "-m", "sz_tpu.cli", "-z", "-f", "-T", "-i",
         str(dpath), "-3", "8", "8", "8", "-M", "ABS", "-A", "1e-3"],
        capture_output=True, text=True)
    assert r.returncode != 0
    assert "Tucker" in r.stderr or "Tucker" in r.stdout
