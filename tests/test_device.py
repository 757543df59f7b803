"""Device-facing plumbing that the CPU can check: the peak-bandwidth table,
the compile-cache location, and chip_smoke.py's gate, result line and
phases (at tiny sizes, with the GPU gate bypassed)."""

import json
import os
import subprocess
import sys
import types

import jax
import pytest

import icde2019_gpu_join
from icde2019_gpu_join.utils.timing import peak_hbm_gbps

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _dev(platform, kind):
    return types.SimpleNamespace(platform=platform, device_kind=kind)


@pytest.mark.parametrize("kind,gbps", [("NVIDIA H100 80GB HBM3", 3350.0),
                                       ("NVIDIA H100 PCIe", 2000.0)])
def test_peak_table_h100(kind, gbps):
    assert peak_hbm_gbps(_dev("gpu", kind)) == gbps


def test_peak_table_unknown_gpu_raises():
    with pytest.raises(ValueError, match="NVIDIA A100"):
        peak_hbm_gbps(_dev("gpu", "NVIDIA A100-SXM4-80GB"))


def test_peak_table_cpu_has_no_roofline():
    assert peak_hbm_gbps(jax.devices()[0]) is None
    assert peak_hbm_gbps() is None


def test_compile_cache_honours_env():
    env = {"JAX_COMPILATION_CACHE_DIR": "/somewhere/jax-cache"}
    assert icde2019_gpu_join.compile_cache_dir(env) == "/somewhere/jax-cache"


def test_compile_cache_default_in_checkout():
    path = icde2019_gpu_join.compile_cache_dir({})
    assert path == os.path.join(REPO, ".jax_cache")
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()
    # the process uses the same directory (JAX reads the variable itself)
    assert jax.config.jax_compilation_cache_dir == \
        icde2019_gpu_join.compile_cache_dir()


@pytest.mark.parametrize("args", [[], ["--multi"]])
def test_chip_smoke_refuses_cpu(args):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "chip_smoke.py", *args], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    assert "needs" in proc.stderr


def test_chip_smoke_last_line_contract():
    sys.path.insert(0, REPO)
    import chip_smoke

    line = chip_smoke.last_line([_dev("gpu", "NVIDIA H100 80GB HBM3")] * 4)
    assert json.loads(json.dumps(line)) == {
        "ok": True,
        "device": {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3",
                   "count": 4}}


_TINY = dict(compare_chunk=256, config1=(10_000, 160_000), big_log2=15,
             mat_log2=13, ring_log2=14, fpg_r_log2=13, fpg_s_log2=15,
             exchange_log2=14, multi_per_card_log2=13,
             multi_mat_per_card_log2=11)


@pytest.mark.parametrize("multi", [False, True])
def test_chip_smoke_phases_tiny(multi, tmp_path, monkeypatch, capsys):
    """Every phase's code path, checks included, at tiny sizes on the CPU
    (four virtual devices stand in for four cards)."""
    sys.path.insert(0, REPO)
    import chip_smoke

    monkeypatch.setenv("JOIN_DATA_DIR", str(tmp_path))
    sz = chip_smoke.Sizes(**_TINY)
    devices = jax.devices()[:4 if multi else 1]
    (chip_smoke.run_multi if multi else chip_smoke.run_single)(sz, devices)
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == (3 if multi else 9)
    assert all(" ok " in ln for ln in lines)
