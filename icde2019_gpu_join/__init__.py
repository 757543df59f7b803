"""A vectorized equi-join engine in JAX.

A JAX/XLA implementation of the capability set of the ICDE 2019
"Hardware-conscious Hash-Joins on GPUs" artifact (psiul/ICDE2019-GPU-Join):
multi-pass radix partitioning, hash build + clustered probe, join
materialization (incl. late materialization), filter, hash aggregates, radix
sort, skew-aware heavy-hitter splitting, streaming out-of-memory execution,
and multi-device scaling via an all-to-all radix shuffle.

It is not a CUDA port: the reference's atomic scatter + lock-free bucket
chains (reference src/join-primitives.cu:58-618) are replaced by
sort-as-partition (deterministic histogram -> exclusive-scan -> permute into
a dense CSR layout), and the shared-memory hash-table probe (reference
src/join-primitives.cu:885-1416) by a banded, block-windowed sort-merge
probe (ops/band_join.py).
"""

import os as _os

import jax as _jax

_REPO_ROOT = _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__)))


def compile_cache_dir(environ=_os.environ) -> str:
    """Where the persistent XLA compilation cache lives: the directory that
    JAX_COMPILATION_CACHE_DIR names (JAX's own config reads the variable),
    else a fixed directory inside the checkout. A fixed path matters: the
    path is part of the cache key, so a moving directory never hits."""
    return (environ.get("JAX_COMPILATION_CACHE_DIR")
            or _os.path.join(_REPO_ROOT, ".jax_cache"))


if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    _jax.config.update("jax_compilation_cache_dir", compile_cache_dir())

from icde2019_gpu_join.config import RadixConfig, EngineConfig
from icde2019_gpu_join.relation import Relation, PartitionedRelation

__version__ = "0.1.0"

__all__ = [
    "RadixConfig",
    "EngineConfig",
    "Relation",
    "PartitionedRelation",
]
