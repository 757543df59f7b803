"""Streaming-probe join: build side resident, probe side streamed from host.

Analog of outOfGPU_Join3_payload (reference
src/hash_join_clustered_probe.cu:1684-1984): R is sorted once and stays
device-resident; S lives in host memory and is cut into segments
(S_segment_size = min(CHUNK_SIZE, n/4), :1697) that flow through a
double-buffered H2D -> sort -> banded-probe pipeline. The reference builds
the overlap with 3 CUDA streams + events; here JAX's async dispatch provides
it: the next segment's device_put is issued before the current segment's
probe is consumed, so transfer (k+1) overlaps compute (k).

Segment results accumulate on device (int32/uint32 wraparound is associative
and commutative, so segmentation does not change the aggregate — the same
argument the reference relies on for its per-segment atomicAdds).
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from icde2019_gpu_join import datagen
from icde2019_gpu_join.config import EngineConfig
from icde2019_gpu_join.models.joins import JoinResult
from icde2019_gpu_join.ops.band_join import banded_probe, sort_by_key
from icde2019_gpu_join.relation import Relation
from icde2019_gpu_join.utils.timing import PhaseTimer


@partial(jax.jit, static_argnames=("sort_impl",))
def _sort_side(keys, pay, sort_impl):
    return sort_by_key(keys, pay, sort_impl)


@partial(jax.jit, static_argnames=("window_blocks", "sort_impl"))
def _segment_probe(r_sv, r_p, s_keys, s_pay, total, window_blocks,
                   sort_impl):
    s_sv, s_p = sort_by_key(s_keys, s_pay, sort_impl)
    agg = banded_probe(r_sv, r_p, s_sv, s_p, window_blocks, "mul")
    return total + agg.astype(jnp.uint32)


def streaming_join_aggregate(
    r: Relation, s: Relation, config: Optional[EngineConfig] = None
) -> JoinResult:
    """SUM(Pr*Ps) with S streamed in segments. `s` may hold host numpy
    arrays (the oversized case) or device arrays."""
    from icde2019_gpu_join.ops.band_join import resolve_sort_impl

    config = config or EngineConfig()
    timer = PhaseTimer()
    n_s = s.num_rows
    seg = config.segment_rows or max(1, min(1 << 27, -(-n_s // 4)))
    W = config.band_window_blocks
    impl = resolve_sort_impl(config.sort_impl)

    with timer.phase("build_sort", bytes_moved=16 * r.num_rows,
                     rows=r.num_rows) as out:
        r_sv, r_p = _sort_side(jnp.asarray(r.keys), jnp.asarray(r.payload),
                               impl)
        out["result"] = r_sv

    s_keys_host = np.asarray(s.keys)
    s_pay_host = np.asarray(s.payload)

    # Reusable staging buffers, assembled with the threaded AVX2 streaming
    # copy (datagen.staging_copy / tj_staging_copy) — the analog of the
    # reference's NUMA staging gather into the pinned transfer buffer
    # (src/partition-primitives.cu:235-253). Two slots alternate because one
    # device_put is kept in flight while the next segment is staged; a short
    # tail is padded in place (sentinel key -1, payload 0 contribute
    # nothing) so every segment hits one jit cache.
    stage = [(np.empty(seg, np.int32), np.empty(seg, np.int32))
             for _ in range(2)]
    in_flight = [None, None]

    def put(lo, hi, slot):
        # a slot may only be restaged once its previous transfer has been
        # consumed — block_until_ready waits for the TRANSFER, not the probe,
        # and only ever blocks when the device is >= 2 segments behind (the
        # natural backpressure point; the reference's cudaEventSynchronize on
        # the S-slot event plays the same role, :1559-1575)
        if in_flight[slot] is not None:
            jax.block_until_ready(in_flight[slot])
        sk, sp = stage[slot]
        datagen.staging_copy(sk[: hi - lo], s_keys_host[lo:hi])
        datagen.staging_copy(sp[: hi - lo], s_pay_host[lo:hi])
        if hi - lo < seg:
            sk[hi - lo:] = -1
            sp[hi - lo:] = 0
        if jax.default_backend() == "cpu":
            # CPU device_put may ALIAS the numpy buffer (zero-copy) — a
            # restaged slot would mutate the "device" array. Real devices
            # always copy across PCIe, so reuse is safe there.
            sk, sp = sk.copy(), sp.copy()
        buf = (jax.device_put(sk), jax.device_put(sp))
        in_flight[slot] = buf
        return buf

    total = jnp.uint32(0)
    starts = list(range(0, n_s, seg))
    # Prefetch first segment, then keep one segment in flight (the analog of
    # the double-buffered S slots, reference :1559-1609). NOTHING inside the
    # loop blocks: device_put(k+1) is issued before probe(k) is dispatched,
    # and the single sync happens after the loop — so transfer(k+1) overlaps
    # probe(k) on the device timeline (benchmarks/overlap_bench.py measures
    # the overlap; not yet measured on the GPU, ROADMAP S8).
    with timer.phase("stream", bytes_moved=16 * n_s, rows=n_s) as out:
        next_buf = put(0, min(seg, n_s), 0)
        for i, lo in enumerate(starts):
            sk, sp = next_buf
            if i + 1 < len(starts):
                nlo = starts[i + 1]
                next_buf = put(nlo, min(nlo + seg, n_s), (i + 1) % 2)
            total = _segment_probe(r_sv, r_p, sk, sp, total, W, impl)
        out["result"] = total
    return JoinResult(aggregate=int(jnp.asarray(total).astype(jnp.int32)), timer=timer)
