"""Relation containers: raw columns and the partitioned CSR layout.

The reference stores partitioned relations as linked lists of 4096-row
buckets (`heads`/`chains`, src/join-primitives.cu:58-312, struct hj_bucket_2
src/join-primitives.cuh:31-36) because CUDA builds them with atomic
allocation. This engine partitions deterministically, so the natural
layout is dense CSR: rows stably reordered by partition id, plus a
counts/offsets table. `offsets` plays the role of the bucket chains and
`counts` of `out_cnts`.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp


@jax.tree_util.register_pytree_node_class
class Relation:
    """A (keys, payload) column pair. Keys are int32; payload int32.

    KEY-DOMAIN CONTRACT: keys must be >= 0. The engine reserves -1 (pad
    sentinel) and -2 (pipeline filter sentinel); a negative real key
    silently corrupts aggregates (deviation from the reference's full
    uint32 key support — recorded in PARITY.md; the ETHZ generator only
    emits non-negative keys, so all benchmark workloads comply). Validate
    with utils.debug.validate_key_domain or JOIN_DEBUG=1.

    Payload defaults to row ids (late-materialization mode: the reference's
    join_partitioned_varpayload carries row ids as payloads,
    src/join-primitives.cu:1420-1557)."""

    def __init__(self, keys: jnp.ndarray, payload: Optional[jnp.ndarray] = None):
        import os
        if os.environ.get("JOIN_DEBUG"):
            from icde2019_gpu_join.utils.debug import validate_key_domain
            validate_key_domain(keys)
        self.keys = keys
        if payload is None:
            payload = jnp.arange(keys.shape[0], dtype=jnp.int32)
        self.payload = payload

    @property
    def num_rows(self) -> int:
        return self.keys.shape[0]

    def tree_flatten(self):
        return (self.keys, self.payload), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        keys, payload = children
        obj = cls.__new__(cls)
        obj.keys = keys
        obj.payload = payload
        return obj

    def __repr__(self):
        return f"Relation(n={self.keys.shape[0]}, dtype={self.keys.dtype})"


@jax.tree_util.register_pytree_node_class
class PartitionedRelation:
    """CSR-partitioned relation.

    keys/payload: rows stably grouped by partition id (ascending).
    counts[p]:    rows in partition p.
    offsets[p]:   exclusive prefix sum of counts (offsets[parts] == n).
    total_bits/first_bit: the radix geometry that produced it.
    """

    def __init__(self, keys, payload, counts, offsets, total_bits: int, first_bit: int):
        self.keys = keys
        self.payload = payload
        self.counts = counts
        self.offsets = offsets
        self.total_bits = total_bits
        self.first_bit = first_bit

    @property
    def num_rows(self) -> int:
        return self.keys.shape[0]

    @property
    def num_partitions(self) -> int:
        return self.counts.shape[0]

    def tree_flatten(self):
        children = (self.keys, self.payload, self.counts, self.offsets)
        return children, (self.total_bits, self.first_bit)

    @classmethod
    def tree_unflatten(cls, aux, children):
        keys, payload, counts, offsets = children
        total_bits, first_bit = aux
        obj = cls.__new__(cls)
        obj.keys = keys
        obj.payload = payload
        obj.counts = counts
        obj.offsets = offsets
        obj.total_bits = total_bits
        obj.first_bit = first_bit
        return obj

    def __repr__(self):
        return (
            f"PartitionedRelation(n={self.keys.shape[0]}, "
            f"parts=2^{self.total_bits}, first_bit={self.first_bit})"
        )
