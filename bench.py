"""Benchmark driver: one JSON line with the headline metric.

Headline: join throughput (M rows/s) of ClusteredJoin.aggregate on the
reference's config 2 (BASELINE.json) scaled by BENCH_SCALE: uniform PK-FK
join, generator_ETHZ-semantics datasets, ones payloads. The result is gated
bit-exactly against the independent host oracle and names the device, the
card and its power limit.

Env knobs: BENCH_SCALE (default 27 -> 2^27 = 134M rows/side), BENCH_SKEW
(zipf z, default 0 = uniform), BENCH_REPS (default 3).
"""

import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np


def card() -> str:
    """`name, power.limit` of the first card as nvidia-smi reports them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout
    return out.strip().splitlines()[0]


def main():
    import jax
    import jax.numpy as jnp

    from icde2019_gpu_join.models import ClusteredJoin
    from icde2019_gpu_join.relation import Relation
    from icde2019_gpu_join.utils import datasets

    if jax.devices()[0].platform != "gpu":
        sys.exit("bench.py: needs a GPU")
    scale = int(os.environ.get("BENCH_SCALE", "27"))
    skew = float(os.environ.get("BENCH_SKEW", "0"))
    n_r = n_s = 1 << scale

    rk, sk = datasets.make_pk_fk(n_r, n_s, skew=skew, seed=12345)
    rp = np.ones(n_r, np.int32)
    sp = np.ones(n_s, np.int32)

    r = Relation(jnp.asarray(rk), jnp.asarray(rp))
    s = Relation(jnp.asarray(sk), jnp.asarray(sp))
    engine = ClusteredJoin()

    # Warm-up (compile), then best of BENCH_REPS measured runs — the
    # reference also re-runs each phase (outOfGPU_Join1_payload,
    # hash_join_clustered_probe.cu:802-994).
    res = engine.aggregate(r, s)
    elapsed = float("inf")
    for _ in range(int(os.environ.get("BENCH_REPS", "3"))):
        t0 = time.perf_counter()
        res = engine.aggregate(r, s)
        t1 = time.perf_counter()
        elapsed = min(elapsed, t1 - t0)

    # Correctness gate vs the HOST oracle (C++ partitioned hash join, numpy
    # fallback) — an independent implementation sharing nothing with the
    # device path. Disk-cached, keyed by the deterministic dataset config.
    expect = datasets.pkfk_oracle_count(rk, sk, scale, skew)
    ok = res.aggregate == expect

    mrows = (n_r + n_s) / elapsed / 1e6
    print(json.dumps({
        "metric": f"join_throughput_{n_r>>20}Mx{n_s>>20}M"
                  + (f"_zipf{skew}" if skew else ""),
        "value": mrows,
        "unit": "Mrows/s",
        "correct": ok,
        "aggregate": res.aggregate,
        "elapsed_s": elapsed,
        "phases": {p.name: p.seconds for p in res.timer.phases},
        "sort_impl": os.environ.get("JOIN_SORT_IMPL", "lax"),
        "device": {"platform": jax.devices()[0].platform,
                   "kind": jax.devices()[0].device_kind,
                   "count": len(jax.devices())},
        "card": card(),
    }))


if __name__ == "__main__":
    main()
