"""Host+device co-processing join: build side exceeds device memory.

Analog of outOfGPU_Join2_payload (reference
src/hash_join_clustered_probe.cu:1000-1680): the host CPU pre-partitions both
relations into 2^OUTER_BITS coarse partitions (reference LOG_PARTS_OUTER=4 ->
16, src/partition-primitives.cuh:38-42) with the native OpenMP partitioner,
a knapsack scheduler groups build partitions into device-resident batches
(groupOptimal2, src/partition-primitives.cu:381-469), and each (R_p, S_p)
pair is refined + joined on device with the radix field shifted past the
outer bits. Partial aggregates sum with int32 wraparound, so batching order
is irrelevant.

Pipeline structure (the reference's 3-stream event-chained pipeline,
src/hash_join_clustered_probe.cu:1400-1622, re-expressed with JAX async
dispatch — nothing below blocks until the single final pull):

  * R batch staging: all of batch b's R partitions are device_put as a
    group; batch b+1's uploads are issued while batch b's joins run, so
    R transfer rides behind compute (the PARTS_RESIDENT slot analog —
    at most two batches of R are alive on device at once).
  * The S host partition runs AFTER batch 0's R uploads are issued: the
    host partitioning of the probe side overlaps the build side's
    transfers (reference: CPU partitions S segments while the GPU works
    on the previous batch, :1503-1508).
  * S pair double buffering: pair k+1's device_put is issued before pair
    k's join is dispatched (the event_id%2 S-slot analog, :1559-1609).
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from icde2019_gpu_join import datagen
from icde2019_gpu_join.config import EngineConfig
from icde2019_gpu_join.models.joins import JoinResult
from icde2019_gpu_join.relation import Relation
from icde2019_gpu_join.utils.timing import PhaseTimer

OUTER_BITS = 4          # LOG_PARTS_OUTER analog
PARTS_RESIDENT = 5      # device-resident build slots (partition-primitives.cuh:42)


def _quantize_host(arr_k, arr_p, lo, hi):
    """Pad a partition slice to the next power of two with engine sentinels
    (key -1, payload 0 — contribute nothing), so every pair hits one of a
    handful of jit shapes instead of recompiling per partition. Host-side
    numpy only."""
    n = hi - lo
    cap = 1 << max(10, (n - 1).bit_length())
    k = np.full(cap, -1, np.int32)
    v = np.zeros(cap, np.int32)
    k[:n] = arr_k[lo:hi]
    v[:n] = arr_p[lo:hi]
    return k, v


def _put_pair(arr_k, arr_p, lo, hi):
    k, v = _quantize_host(arr_k, arr_p, lo, hi)
    return jax.device_put(k), jax.device_put(v)


def coprocess_join_aggregate(
    r: Relation, s: Relation, config: Optional[EngineConfig] = None
) -> JoinResult:
    """SUM(Pr*Ps); r/s hold host numpy arrays (the oversized case)."""
    config = config or EngineConfig()
    timer = PhaseTimer()
    fb = config.radix.first_bit
    parts_host = 1 << OUTER_BITS

    rk = np.asarray(r.keys, dtype=np.int32)
    rp = np.asarray(r.payload, dtype=np.int32)
    sk = np.asarray(s.keys, dtype=np.int32)
    sp = np.asarray(s.payload, dtype=np.int32)

    with timer.phase("host_partition_R", bytes_moved=16 * rk.size,
                     rows=rk.size):
        rk_p, rp_p, cnt_r, off_r = datagen.host_partition(rk, rp, OUTER_BITS, fb)

    # Knapsack batches over build-partition gains (fraction of resident
    # capacity each consumes), as in groupOptimal2.
    avg = max(1, rk.size // parts_host)
    gains = cnt_r.astype(np.float64) / avg  # ~1.0 per uniform partition
    batch_of = datagen.knapsack_batches(gains, PARTS_RESIDENT)
    num_batches = int(batch_of.max()) + 1 if batch_of.size else 0

    def stage_R(b):
        """Issue async uploads for batch b's R partitions (no blocking)."""
        staged = {}
        for p in np.nonzero(batch_of == b)[0]:
            r_lo, r_hi = int(off_r[p]), int(off_r[p + 1])
            if r_hi > r_lo:
                staged[int(p)] = _put_pair(rk_p, rp_p, r_lo, r_hi)
        return staged

    # Batch 0's R transfers go in flight BEFORE the S host partition runs:
    # host partitioning overlaps the build side's uploads.
    r_staged_cur = stage_R(0) if num_batches else {}

    with timer.phase("host_partition_S", bytes_moved=16 * sk.size,
                     rows=sk.size):
        sk_p, sp_p, cnt_s, off_s = datagen.host_partition(sk, sp, OUTER_BITS, fb)

    # Per-pair aggregates stay ON DEVICE and accumulate there (int32
    # wraparound add is associative); ONE host pull at the very end. Pulling
    # per pair would serialize the pipeline on a full device round-trip per
    # partition pair.
    from icde2019_gpu_join.ops.band_join import (banded_join_aggregate,
                                                 resolve_sort_impl)
    sort_impl = resolve_sort_impl(config.sort_impl)

    # Flat pair schedule (batch-ordered) for S-side double buffering.
    schedule = []
    for b in range(num_batches):
        for p in np.nonzero(batch_of == b)[0]:
            r_lo, r_hi = int(off_r[p]), int(off_r[p + 1])
            s_lo, s_hi = int(off_s[p]), int(off_s[p + 1])
            if r_hi > r_lo and s_hi > s_lo:
                schedule.append((b, int(p), s_lo, s_hi))

    total_dev = jnp.int32(0)
    with timer.phase("pairs", rows=rk.size + sk.size,
                     bytes_moved=8 * (rk.size + sk.size)) as out:
        r_staged = {0: r_staged_cur} if num_batches else {}
        staged_upto = 0
        s_next = (_put_pair(sk_p, sp_p, schedule[0][2], schedule[0][3])
                  if schedule else None)
        for i, (b, p, s_lo, s_hi) in enumerate(schedule):
            # entering batch b: put batch b+1's R uploads in flight so they
            # ride behind ALL of batch b's joins (two batches alive max),
            # and drop older batches' buffers (freed once their joins ran).
            # The while covers batches with no schedulable pairs (empty S):
            # staging must still advance past them to reach batch b itself.
            while staged_upto < min(b + 1, num_batches - 1):
                staged_upto += 1
                r_staged[staged_upto] = stage_R(staged_upto)
                r_staged.pop(staged_upto - 2, None)
            ss = s_next
            # issue pair k+1's S upload before dispatching join k
            if i + 1 < len(schedule):
                _, _, nlo, nhi = schedule[i + 1]
                s_next = _put_pair(sk_p, sp_p, nlo, nhi)
            rr = r_staged[b].get(p)
            if rr is None:  # R partition empty after staging filter
                continue
            total_dev = total_dev + banded_join_aggregate(
                rr[0], rr[1], ss[0], ss[1],
                window_blocks=config.band_window_blocks,
                sort_impl=sort_impl)
        total = int(np.asarray(total_dev))   # the single sync point
        out["result"] = total
    return JoinResult(aggregate=int(np.int32(np.uint32(total & 0xFFFFFFFF))),
                      timer=timer)
