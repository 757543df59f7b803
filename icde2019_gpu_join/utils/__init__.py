from icde2019_gpu_join.utils import oracle, timing, datasets  # noqa: F401
