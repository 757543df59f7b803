from icde2019_gpu_join.ops.bits import partition_ids
from icde2019_gpu_join.ops.partition import radix_partition, histogram
from icde2019_gpu_join.ops.join_sorted import (
    sort_merge_aggregate,
    sort_merge_count,
)
from icde2019_gpu_join.ops.perfect_hash import (
    perfect_hash_build,
    perfect_hash_probe_aggregate,
)
from icde2019_gpu_join.ops.filter import filter_compact
from icde2019_gpu_join.ops.groupby import groupby_count_sum
from icde2019_gpu_join.ops.sort import radix_sort
from icde2019_gpu_join.ops.band_join import (
    banded_join_aggregate,
    banded_join_count,
    banded_join_late_aggregate,
    banded_materialize,
    banded_probe,
    sort_by_key,
)

__all__ = [
    "partition_ids",
    "radix_partition",
    "histogram",
    "sort_merge_aggregate",
    "sort_merge_count",
    "perfect_hash_build",
    "perfect_hash_probe_aggregate",
    "filter_compact",
    "groupby_count_sum",
    "radix_sort",
    "banded_join_aggregate",
    "banded_join_count",
    "banded_join_late_aggregate",
    "banded_materialize",
    "banded_probe",
    "sort_by_key",
]
