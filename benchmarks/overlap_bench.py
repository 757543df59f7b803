"""Measure transfer/compute OVERLAP in the streaming-probe pipeline.

Overlap from async dispatch is a claim until measured; this harness
measures it directly:

  t_transfer : device_put all segments, sync (no compute)
  t_compute  : probe all segments pre-staged on device, sync (no transfer)
  t_pipe     : the real pipeline (put k+1 in flight while probing k)

  overlap_fraction = (t_transfer + t_compute - t_pipe)
                     / min(t_transfer, t_compute)

1.0 = the smaller phase fully hidden; 0 = fully serialized.

The overlap fraction is the portable signal; the absolute times depend
on the host link.

Usage: python benchmarks/overlap_bench.py [log2_nR log2_nS n_segments]
"""

import json
import sys
import time

sys.path.insert(0, __file__.rsplit("/", 2)[0])

import numpy as np


def main():
    import jax
    import jax.numpy as jnp

    from icde2019_gpu_join.models.streaming import (
        _segment_probe, _sort_side)
    from icde2019_gpu_join.utils import datasets, oracle

    lg_r = int(sys.argv[1]) if len(sys.argv) > 1 else 20
    lg_s = int(sys.argv[2]) if len(sys.argv) > 2 else 24
    nseg = int(sys.argv[3]) if len(sys.argv) > 3 else 8
    n_r, n_s = 1 << lg_r, 1 << lg_s
    seg = n_s // nseg
    W = 2

    rk, sk = datasets.make_pk_fk(n_r, n_s, seed=11)
    rp = np.ones(n_r, np.int32)
    sp = np.ones(n_s, np.int32)

    r_sv, r_p = _sort_side(jnp.asarray(rk), jnp.asarray(rp), 'lax')

    def sync(x):
        return float(jnp.sum(x.astype(jnp.uint32)))

    segs = [(sk[i * seg:(i + 1) * seg], sp[i * seg:(i + 1) * seg])
            for i in range(nseg)]

    # warm the jit caches
    d0 = (jax.device_put(segs[0][0]), jax.device_put(segs[0][1]))
    t = _segment_probe(r_sv, r_p, d0[0], d0[1], jnp.uint32(0), W, 'lax')
    sync(t)

    # Each leg gets FRESH host copies: jax dedupes repeat transfers of the
    # same host array, which silently deflates later legs (observed:
    # "pipeline" 11x faster than "transfer" before this fix).
    def fresh():
        return [(np.array(a, copy=True), np.array(b, copy=True))
                for a, b in segs]

    # t_transfer: puts only, then force materialization via a trivial use
    @jax.jit
    def consume(bufs):
        return sum(jnp.sum(x[:128].astype(jnp.uint32)) for pair in bufs
                   for x in pair)

    warm = [(jax.device_put(segs[0][0]), jax.device_put(segs[0][1]))] * nseg
    float(consume(warm))  # compile the consumer before timing

    legA = fresh()
    t0 = time.perf_counter()
    put = [(jax.device_put(a), jax.device_put(b)) for a, b in legA]
    float(consume(put))
    t_transfer = time.perf_counter() - t0
    staged = put  # keep on device for the compute-only leg

    # t_compute: all segments already on device
    t0 = time.perf_counter()
    total = jnp.uint32(0)
    for a, b in staged:
        total = _segment_probe(r_sv, r_p, a, b, total, W, 'lax')
    sync(total)
    t_compute = time.perf_counter() - t0
    agg_compute = int(np.int32(np.uint32(int(sync(total)))))

    # t_pipe: the real pipeline
    legC = fresh()
    t0 = time.perf_counter()
    total = jnp.uint32(0)
    nxt = (jax.device_put(legC[0][0]), jax.device_put(legC[0][1]))
    for i in range(nseg):
        a, b = nxt
        if i + 1 < nseg:
            nxt = (jax.device_put(legC[i + 1][0]),
                   jax.device_put(legC[i + 1][1]))
        total = _segment_probe(r_sv, r_p, a, b, total, W, 'lax')
    sync(total)
    t_pipe = time.perf_counter() - t0

    expect = oracle.join_count(rk, sk)
    got = int(np.uint32(int(sync(total)) & 0xFFFFFFFF))
    overlap = min(1.0, max(0.0, (t_transfer + t_compute - t_pipe) / max(
        1e-9, min(t_transfer, t_compute))))
    print(json.dumps({
        "pipeline": "streaming",
        "n_r": n_r, "n_s": n_s, "segments": nseg,
        "t_transfer_s": round(t_transfer, 4),
        "t_compute_s": round(t_compute, 4),
        "t_pipeline_s": round(t_pipe, 4),
        "overlap_fraction": round(overlap, 3),
        "correct": got == (expect & 0xFFFFFFFF),
    }))


def coprocess_leg():
    """Same three-way isolation for the CO-PROCESS loop (round-2 VERDICT:
    'the coprocess leg has no overlap structure at all' — it now
    double-buffers pair uploads and stages R per knapsack batch; this
    measures the result).

      t_transfer : device_put every (R_p, S_p) quantized pair, sync
      t_compute  : join every pair pre-staged on device, sync
      t_pipe     : coprocess_join_aggregate's real loop (minus the host
                   partition phases, reported separately)
    """
    import jax
    import jax.numpy as jnp

    from icde2019_gpu_join import datagen
    from icde2019_gpu_join.config import EngineConfig
    from icde2019_gpu_join.models import coprocess as cp
    from icde2019_gpu_join.ops.band_join import banded_join_aggregate
    from icde2019_gpu_join.relation import Relation
    from icde2019_gpu_join.utils import datasets, oracle

    lg = int(sys.argv[2]) if len(sys.argv) > 2 else 22
    n = 1 << lg
    rk, sk = datasets.make_pk_fk(n, n, seed=13)
    rp = np.ones(n, np.int32)
    sp = np.ones(n, np.int32)

    rk_p, rp_p, cnt_r, off_r = datagen.host_partition(rk, rp, cp.OUTER_BITS, 0)
    sk_p, sp_p, cnt_s, off_s = datagen.host_partition(sk, sp, cp.OUTER_BITS, 0)
    nparts = 1 << cp.OUTER_BITS

    def host_pairs():
        return [
            (cp._quantize_host(rk_p, rp_p, int(off_r[p]), int(off_r[p + 1])),
             cp._quantize_host(sk_p, sp_p, int(off_s[p]), int(off_s[p + 1])))
            for p in range(nparts)
            if off_r[p + 1] > off_r[p] and off_s[p + 1] > off_s[p]
        ]

    def sync(x):
        return float(jnp.sum(x.astype(jnp.uint32)))

    # warm jit
    pairs0 = host_pairs()
    (a, b), (c, d) = pairs0[0]
    sync(banded_join_aggregate(jax.device_put(a), jax.device_put(b),
                               jax.device_put(c), jax.device_put(d)))

    @jax.jit
    def consume(bufs):
        return sum(jnp.sum(x[:128].astype(jnp.uint32)) for quad in bufs
                   for pair in quad for x in pair)

    warm = [tuple(tuple(jax.device_put(x) for x in pr) for pr in quad)
            for quad in pairs0[0:1] * 2]
    float(consume(warm))

    legA = host_pairs()  # fresh host arrays (dedupe gotcha)
    t0 = time.perf_counter()
    put = [tuple(tuple(jax.device_put(x) for x in pr) for pr in quad)
           for quad in legA]
    float(consume(put))
    t_transfer = time.perf_counter() - t0

    t0 = time.perf_counter()
    total = jnp.int32(0)
    for (ka, va), (kb, vb) in put:
        total = total + banded_join_aggregate(ka, va, kb, vb)
    sync(total)
    t_compute = time.perf_counter() - t0

    # real pipeline, host partitions pre-done: time only the staged loop
    res = cp.coprocess_join_aggregate(
        Relation(rk, rp), Relation(sk, sp),
        EngineConfig(resident_limit_rows=1))
    t_pipe = res.timer.seconds("pairs")
    t_hostR = res.timer.seconds("host_partition_R")
    t_hostS = res.timer.seconds("host_partition_S")
    ok = res.aggregate == oracle.join_count(rk, sk)
    overlap = min(1.0, max(0.0, (t_transfer + t_compute - t_pipe) / max(
        1e-9, min(t_transfer, t_compute))))
    print(json.dumps({
        "pipeline": "coprocess",
        "n": n, "pairs": len(put),
        "t_transfer_s": round(t_transfer, 4),
        "t_compute_s": round(t_compute, 4),
        "t_pipeline_s": round(t_pipe, 4),
        "t_host_partition_s": round(t_hostR + t_hostS, 4),
        "overlap_fraction": round(overlap, 3),
        "lower_bound_ratio": round(t_pipe / max(t_transfer, t_compute, 1e-9), 3),
        "correct": bool(ok),
    }))


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "coprocess":
        coprocess_leg()
    else:
        main()
