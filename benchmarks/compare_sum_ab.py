"""A/B of the probe's "mul" chunk step on the GPU: XLA's fusion of the plain
version (ops.band_join.chunk_compare_sum) against the hand-written
Pallas/Triton kernel (ops.band_compare_triton) that the engine uses there.

    python benchmarks/compare_sum_ab.py [--reps 5]

First checks the kernel bit-exactly against the plain version on real
chunk shapes, then times, at 2^27 x 2^27 uniform and Zipf z=1.05 (ones
payloads), the banded_probe alone on pre-sorted inputs and the whole
ClusteredJoin.aggregate, in blocks ordered xla, triton, triton, xla.
Prints the median and quartiles of each (variant, workload, metric) and
the card's name and power limit. Refuses to run without a GPU.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    import jax
    import jax.numpy as jnp

    if jax.devices()[0].platform != "gpu":
        sys.exit("compare_sum_ab: needs a GPU")
    from icde2019_gpu_join.models import ClusteredJoin
    from icde2019_gpu_join.ops import band_join as bj
    from icde2019_gpu_join.ops.band_compare_triton import (
        chunk_compare_sum_triton)
    from icde2019_gpu_join.relation import Relation
    from icde2019_gpu_join.utils import datasets

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0])
    variants = {"xla": bj.chunk_compare_sum,
                "triton": chunk_compare_sum_triton}

    # exactness at a real chunk: 2048 S blocks against W-block windows
    r = np.random.default_rng(0)
    for w in (1, 2):
        nsb, nrb, ch = 4096, 4096, 2048
        s_svb = r.integers(0, 5000, (nsb, 128)).astype(np.int32)
        s_payb = r.integers(-2**31, 2**31, (nsb, 128)).astype(np.int32)
        r_svb = np.sort(r.integers(0, 5000, nrb * 128)).reshape(
            nrb, 128).astype(np.int32)
        r_payb = r.integers(-2**31, 2**31, (nrb, 128)).astype(np.int32)
        ids = r.integers(0, nsb, ch).astype(np.int32)
        base = r.integers(-1, nrb, ch).astype(np.int32)
        his = (base + r.integers(0, 4, ch)).astype(np.int32)
        act = r.random(ch) < 0.9
        a = [jnp.asarray(x) for x in (s_svb, s_payb, r_svb, r_payb, ids,
                                       base, his, act)]
        want = int(jax.jit(bj.chunk_compare_sum, static_argnums=8)(*a, w))
        got = int(chunk_compare_sum_triton(*a, window_blocks=w))
        print(f"exactness W={w}: xla={want} triton={got} "
              f"{'ok' if want == got else 'MISMATCH'}", flush=True)
        if want != got:
            sys.exit(1)

    n = 1 << 27
    ones = jnp.ones(n, jnp.int32)
    work = {}
    for skew in (0.0, 1.05):
        rk, sk = datasets.make_pk_fk(n, n, skew=skew, seed=12345)
        expect = datasets.pkfk_oracle_count(rk, sk, 27, skew)
        rkd, skd = jnp.asarray(rk), jnp.asarray(sk)
        r_sv, r_p = jax.jit(bj.sort_by_key)(rkd, ones)
        s_sv, s_p = jax.jit(bj.sort_by_key)(skd, ones)
        work[f"z{skew}"] = (rkd, skd, r_sv, r_p, s_sv, s_p, expect)

    times = {}
    for variant in ("xla", "triton", "triton", "xla"):
        bj._chunk_sum_impl = lambda: variants[variant]
        jax.clear_caches()
        for tag, (rkd, skd, r_sv, r_p, s_sv, s_p, expect) in work.items():
            rel = (Relation(rkd, ones), Relation(skd, ones))
            for metric, fn in (
                    ("banded_probe", lambda: bj.banded_probe(
                        r_sv, r_p, s_sv, s_p, 1, "mul")),
                    ("aggregate", lambda: ClusteredJoin().aggregate(
                        *rel).aggregate)):
                t0 = time.perf_counter()
                got = int(jax.block_until_ready(fn()))
                first = time.perf_counter() - t0
                if got != expect:
                    sys.exit(f"{variant} {tag} {metric}: {got} != {expect}")
                ts = times.setdefault((variant, tag, metric), [])
                for _ in range(args.reps):
                    t0 = time.perf_counter()
                    jax.block_until_ready(fn())
                    ts.append(time.perf_counter() - t0)
                print(f"block {variant} {tag} {metric}: first {first:.3f}s "
                      f"reps {[round(t * 1e3, 3) for t in ts[-args.reps:]]} ms",
                      flush=True)
    for (variant, tag, metric), ts in sorted(times.items()):
        q1, med, q3 = np.percentile(np.asarray(ts) * 1e3, [25, 50, 75])
        print(f"{metric:<13} {tag:<6} {variant:<7} median {med:.3f} ms "
              f"(q1 {q1:.3f}, q3 {q3:.3f}, n={len(ts)})")


if __name__ == "__main__":
    main()
