"""Join execution strategies + the size-based dispatcher.

Analog of the reference's orchestrator layer (hash_join_clustered_probe.cu):
  * ClusteredJoin            <- outOfGPU_Join1_payload (:802-994), in-memory
  * models/streaming.py      <- outOfGPU_Join3_payload (:1684-1984)
  * models/coprocess.py      <- outOfGPU_Join2_payload (:1000-1680)
  * clustered_probe_join     <- hj_ClusteredProbe dispatcher (:1990-2011)

The in-memory pipeline is:
  radix-partition R  ->  radix-partition S  ->  host work plan from the
  histograms (decompose_chains analog)  ->  blocked-compare probe.

Execution is two-phase: partition runs under jit, the tiny histogram is
pulled to host to build the work-item table, then the probe runs under jit
with a static item count. This mirrors the reference's own structure (the
partition phase materializes chain metadata which decompose_chains reshapes
before the probe kernels launch).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from icde2019_gpu_join.config import EngineConfig, default_bits_for
from icde2019_gpu_join.ops import probe as probe_ops
from icde2019_gpu_join.ops.partition import radix_partition
from icde2019_gpu_join.ops.join_sorted import (
    sort_merge_aggregate,
    sort_merge_count,
)
from icde2019_gpu_join.relation import Relation
from icde2019_gpu_join.utils.timing import PhaseTimer


@dataclasses.dataclass
class JoinResult:
    aggregate: Optional[int] = None
    count: Optional[int] = None
    pairs: Optional[Tuple[jnp.ndarray, jnp.ndarray]] = None
    timer: Optional[PhaseTimer] = None


@partial(jax.jit, static_argnames=("total_bits", "first_bit", "sort_impl"))
def _partition_pair(r_keys, r_pay, s_keys, s_pay, total_bits, first_bit,
                    sort_impl):
    pr = radix_partition(r_keys, r_pay, total_bits, first_bit, sort_impl)
    ps = radix_partition(s_keys, s_pay, total_bits, first_bit, sort_impl)
    return pr, ps


class ClusteredJoin:
    """In-memory radix join on one chip (outOfGPU_Join1_payload analog)."""

    def __init__(self, config: Optional[EngineConfig] = None):
        self.config = config or EngineConfig()

    def _sort_impl(self) -> str:
        """config.sort_impl resolved against the process default at CALL
        time — fed to the jitted paths as a static argument, so engines
        with different impls never share or clobber compiled entries."""
        from icde2019_gpu_join.ops.band_join import resolve_sort_impl
        return resolve_sort_impl(self.config.sort_impl)

    def _bits(self, n_r: int, n_s: int) -> int:
        cfg = self.config
        if cfg.probe_mode == "blocked" or cfg.probe_mode == "auto":
            return default_bits_for(max(n_r, n_s), cfg.probe_tile_r)
        return cfg.radix.total_bits

    def _partition_and_plan(self, r: Relation, s: Relation, timer: PhaseTimer):
        cfg = self.config
        bits = self._bits(r.num_rows, s.num_rows)
        nbytes = 8 * (r.num_rows + s.num_rows)
        with timer.phase("partition", bytes_moved=2 * nbytes,
                         rows=r.num_rows + s.num_rows) as out:
            pr, ps = _partition_pair(
                r.keys, r.payload, s.keys, s.payload, bits,
                cfg.radix.first_bit, self._sort_impl()
            )
            out["result"] = (pr.keys, ps.keys)
        with timer.phase("plan"):
            counts_r = np.asarray(pr.counts)
            counts_s = np.asarray(ps.counts)
            offs_r = np.asarray(pr.offsets[:-1])
            offs_s = np.asarray(ps.offsets[:-1])
            plan = probe_ops.plan_probe(
                counts_r, offs_r, counts_s, offs_s,
                cfg.probe_tile_r, cfg.probe_tile_s,
            )
        return pr, ps, plan

    def aggregate(self, r: Relation, s: Relation) -> JoinResult:
        """SUM(Pr*Ps) over matches, int32 wraparound."""
        cfg = self.config
        timer = PhaseTimer()
        if cfg.probe_mode in ("auto", "banded"):
            return self._aggregate_banded(r, s, timer)
        if cfg.probe_mode == "sort_merge":
            with timer.phase("join", bytes_moved=8 * (r.num_rows + s.num_rows),
                             rows=r.num_rows + s.num_rows) as out:
                agg = sort_merge_aggregate(r.keys, r.payload, s.keys, s.payload)
                out["result"] = agg
            return JoinResult(aggregate=int(agg), timer=timer)
        pr, ps, plan = self._partition_and_plan(r, s, timer)
        dev_plan = plan.as_device()
        with timer.phase("join", bytes_moved=8 * (r.num_rows + s.num_rows),
                         rows=r.num_rows + s.num_rows) as out:
            agg = probe_ops.blocked_probe_aggregate(
                pr.keys, pr.payload, ps.keys, ps.payload, *dev_plan,
                tile_r=plan.tile_r, tile_s=plan.tile_s,
            )
            out["result"] = agg
        return JoinResult(aggregate=int(agg), timer=timer)

    def _aggregate_banded(self, r: Relation, s: Relation,
                          timer: PhaseTimer) -> JoinResult:
        """Hot path: banded sort-merge probe (ops/band_join.py) — sort both
        sides by rotated key (identical layout to the radix partition) and
        join with exact block-windowed gathers. One jit, no host planning."""
        from icde2019_gpu_join.ops.band_join import banded_join_aggregate

        nrows = r.num_rows + s.num_rows
        with timer.phase("join", bytes_moved=8 * nrows, rows=nrows) as out:
            agg = banded_join_aggregate(
                r.keys, r.payload, s.keys, s.payload,
                window_blocks=self.config.band_window_blocks,
                sort_impl=self._sort_impl(),
            )
            out["result"] = agg
        return JoinResult(aggregate=int(agg), timer=timer)

    def count(self, r: Relation, s: Relation) -> JoinResult:
        timer = PhaseTimer()
        if self.config.probe_mode in ("auto", "banded"):
            from icde2019_gpu_join.ops.band_join import banded_join_count

            with timer.phase("join") as out:
                c = banded_join_count(
                    r.keys, s.keys,
                    window_blocks=self.config.band_window_blocks,
                    sort_impl=self._sort_impl(),
                )
                out["result"] = c
            return JoinResult(count=int(np.uint32(np.int64(int(c)))), timer=timer)
        if self.config.probe_mode == "sort_merge":
            with timer.phase("join") as out:
                c = sort_merge_count(r.keys, s.keys)
                out["result"] = c
            return JoinResult(count=int(c), timer=timer)
        pr, ps, plan = self._partition_and_plan(r, s, timer)
        with timer.phase("join") as out:
            c = probe_ops.blocked_probe_count(
                pr.keys, ps.keys, *plan.as_device(),
                tile_r=plan.tile_r, tile_s=plan.tile_s,
            )
            out["result"] = c
        return JoinResult(count=int(c), timer=timer)

    def materialize(self, r: Relation, s: Relation,
                    capacity: Optional[int] = None) -> JoinResult:
        """Matched (Pr, Ps) pairs in a ring buffer of `capacity` pairs, plus
        the total match count (join_partitioned_results analog)."""
        cfg = self.config
        capacity = capacity or cfg.out_capacity
        timer = PhaseTimer()
        if cfg.probe_mode in ("auto", "banded"):
            from icde2019_gpu_join.ops.band_join import banded_materialize

            with timer.phase("join") as out:
                out_r, out_s, total = banded_materialize(
                    r.keys, r.payload, s.keys, s.payload, capacity=capacity,
                    window_blocks=cfg.band_window_blocks,
                    sort_impl=self._sort_impl(),
                )
                out["result"] = (out_r, out_s)
            return JoinResult(count=int(np.uint32(np.int64(int(total)))),
                              pairs=(out_r, out_s), timer=timer)
        pr, ps, plan = self._partition_and_plan(r, s, timer)
        dev_plan = plan.as_device()
        with timer.phase("join") as out:
            item_counts = probe_ops.blocked_probe_item_counts(
                pr.keys, ps.keys, *dev_plan,
                tile_r=plan.tile_r, tile_s=plan.tile_s,
            )
            base = jnp.concatenate(
                [jnp.zeros((1,), jnp.int32), jnp.cumsum(item_counts)[:-1]]
            )
            total = int(jnp.sum(item_counts.astype(jnp.int64)))
            out_r, out_s = probe_ops.blocked_probe_materialize(
                pr.keys, pr.payload, ps.keys, ps.payload, *dev_plan,
                base, capacity,
                tile_r=plan.tile_r, tile_s=plan.tile_s,
            )
            out["result"] = (out_r, out_s)
        return JoinResult(count=total, pairs=(out_r, out_s), timer=timer)

    def late_aggregate(self, r: Relation, s: Relation,
                       r_cols: jnp.ndarray, s_cols: jnp.ndarray) -> JoinResult:
        """Late materialization: payloads are row ids; extra columns are
        gathered post-match and summed (outOfGPU_Join_payload_var analog,
        src/hash_join_clustered_probe.cu:542-708)."""
        timer = PhaseTimer()
        if self.config.probe_mode in ("auto", "banded"):
            from icde2019_gpu_join.ops.band_join import (
                banded_join_late_aggregate,
            )

            with timer.phase("join") as out:
                # Row-id payloads -> per-row wide-column sums aligned with
                # the key order; the banded probe sums (Rc + Sc) on matches.
                r_colsum = jnp.sum(
                    r_cols.astype(jnp.uint32), axis=1
                )[r.payload].astype(jnp.int32) if r_cols.size else jnp.zeros_like(r.payload)
                s_colsum = jnp.sum(
                    s_cols.astype(jnp.uint32), axis=1
                )[s.payload].astype(jnp.int32) if s_cols.size else jnp.zeros_like(s.payload)
                agg = banded_join_late_aggregate(
                    r.keys, r_colsum, s.keys, s_colsum,
                    window_blocks=self.config.band_window_blocks,
                    sort_impl=self._sort_impl(),
                )
                out["result"] = agg
            return JoinResult(aggregate=int(agg), timer=timer)
        pr, ps, plan = self._partition_and_plan(r, s, timer)
        with timer.phase("join") as out:
            # Row-id payloads -> per-row wide-column sums, aligned to the
            # partitioned order (one gather per side, then the probe treats
            # them as the "payload" to add).
            r_colsum = jnp.sum(
                r_cols.astype(jnp.uint32), axis=1
            )[pr.payload].astype(jnp.int32) if r_cols.size else jnp.zeros_like(pr.payload)
            s_colsum = jnp.sum(
                s_cols.astype(jnp.uint32), axis=1
            )[ps.payload].astype(jnp.int32) if s_cols.size else jnp.zeros_like(ps.payload)
            agg = probe_ops.blocked_probe_late_aggregate(
                pr.keys, r_colsum, ps.keys, s_colsum, *plan.as_device(),
                tile_r=plan.tile_r, tile_s=plan.tile_s,
            )
            out["result"] = agg
        return JoinResult(aggregate=int(agg), timer=timer)


def dispatch_regime(n_r: int, n_s: int,
                    config: Optional[EngineConfig] = None) -> str:
    """Which regime the dispatcher will pick: 'join1' (in-memory),
    'streaming' (Join3 analog) or 'coprocess' (Join2 analog). Mirrors
    hj_ClusteredProbe's size test (src/hash_join_clustered_probe.cu:
    2001-2009) plus the placement policy (MEM_TYPE analog): a relation
    pinned to host memory routes through the streamed regimes even if it
    would fit in HBM."""
    config = config or EngineConfig()
    limit = config.resident_limit_rows
    host_kinds = ("host", "pinned_host", "unpinned_host")
    s_resident = n_s <= limit and config.probe_placement not in host_kinds
    r_resident = n_r <= limit and config.build_placement not in host_kinds
    if r_resident and s_resident:
        return "join1"
    if r_resident:
        return "streaming"
    return "coprocess"


def clustered_probe_join(
    r: Relation, s: Relation, config: Optional[EngineConfig] = None,
    materialize: bool = False,
) -> JoinResult:
    """Size-based dispatcher (hj_ClusteredProbe analog,
    src/hash_join_clustered_probe.cu:1990-2011): both sides resident ->
    in-memory join; probe side larger than resident limit -> streaming
    segments; build side larger -> host co-partitioning."""
    config = config or EngineConfig()
    regime = dispatch_regime(r.num_rows, s.num_rows, config)
    if regime == "join1":
        engine = ClusteredJoin(config)
        return engine.materialize(r, s) if materialize else engine.aggregate(r, s)
    if regime == "streaming":  # S oversized: stream probe side (Join3 analog)
        from icde2019_gpu_join.models.streaming import streaming_join_aggregate

        return streaming_join_aggregate(r, s, config)
    from icde2019_gpu_join.models.coprocess import coprocess_join_aggregate

    return coprocess_join_aggregate(r, s, config)
