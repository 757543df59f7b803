from icde2019_gpu_join.models.joins import (
    ClusteredJoin,
    JoinResult,
    clustered_probe_join,
)

__all__ = ["ClusteredJoin", "JoinResult", "clustered_probe_join"]
