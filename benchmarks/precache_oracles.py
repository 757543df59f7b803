"""Pre-compute the config-gate host-oracle values OFF the device window.

The run_configs.py correctness gates at --full scale (2^29 groupby,
2^30 Zipf, 2^31 streaming) each cost many minutes of host time; computed
ahead, they stay out of the device run. This script builds
the EXACT datasets the config legs build (cache keys include a content
fingerprint, so any recipe drift is a cache miss, never a wrong gate) and
populates data/oracle_*.json so the device run only measures.

Usage: python benchmarks/precache_oracles.py [--full]
(without --full: only the small-scale variants; with: 2^29/2^30/2^31)
Runs no jax — pure numpy + the native C++ oracle.
"""

import argparse
import importlib.util
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np

_spec = importlib.util.spec_from_file_location(
    "run_configs", os.path.join(ROOT, "benchmarks", "run_configs.py"))
rc = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(rc)


def log(msg):
    print(f"[precache {time.strftime('%H:%M:%S')}] {msg}", flush=True)


def c3(scale):
    groups = 64
    n_r, n_s = 1 << 24, 1 << scale
    log(f"c3 s{scale}: dataset")
    rng = np.random.default_rng(42)
    rk = rng.permutation(n_r).astype(np.int32)
    rp = rng.integers(1, 100, n_r).astype(np.int32)
    sk = rk[rng.integers(0, n_r, n_s)].astype(np.int32)
    s_filter = rng.integers(0, 1000, n_s).astype(np.int32)
    s_gid = rng.integers(0, groups, n_s).astype(np.int32)
    log(f"c3 s{scale}: oracle")
    rc._oracle_groupby_cached(f"c3_s{scale}_seed42", rk, rp, sk,
                              s_filter, s_gid, 100, 600, groups)
    log(f"c3 s{scale}: done")


def c4(scale):
    from icde2019_gpu_join.utils import datasets
    n = 1 << scale
    log(f"c4 s{scale}: dataset (zipf 1.05)")
    rk, sk = datasets.make_pk_fk(n, n, skew=1.05, seed=12345)
    log(f"c4 s{scale}: oracle")
    rc._oracle_agg_cached(f"c4_pkfk_s{scale}_z1.05_seed12345", rk, sk)
    log(f"c4 s{scale}: done")


def c6(scale_s):
    from icde2019_gpu_join.utils import datasets
    n_r, n_s = min(1 << 29, 1 << (scale_s - 2)), 1 << scale_s
    log(f"c6 s{scale_s}: dataset")
    rk, sk = datasets.make_pk_fk(n_r, n_s, seed=12345)
    log(f"c6 s{scale_s}: oracle")
    rc._oracle_agg_cached(f"c6_r{n_r}_s{n_s}_seed12345", rk, sk)
    log(f"c6 s{scale_s}: done")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true")
    args = ap.parse_args()
    # small -> large so a partial run still helps
    c3(26)
    c4(26)
    c6(26)
    if args.full:
        c3(29)
        c4(30)
        c6(31)
    log("ALL DONE")


if __name__ == "__main__":
    main()
