"""Phase timing & throughput metrics (reference C21 analog).

The reference reports per-phase MB/s computed as 2*(|R|+|S|)*4B / t
(src/hash_join_clustered_probe.cu:937-940) via manual cpuSeconds() stamps
(src/common-host.cpp:26-30) and a RAII time_block (src/common-host.h:67-80).
Here: a PhaseTimer that block_until_ready()s JAX values, plus structured
JSON-line reports with rows/s, GB/s and, on a device with a published
peak, the memory-roofline fraction.
"""

from __future__ import annotations

import contextlib
import json
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import jax


# Published device-memory bandwidth in GB/s, keyed by jax `device_kind`
# (NVIDIA H100 data sheet: SXM5 3.35 TB/s, PCIe 2.0 TB/s).
PEAK_HBM_GBPS = {
    "NVIDIA H100 80GB HBM3": 3350.0,
    "NVIDIA H100 PCIe": 2000.0,
}


def peak_hbm_gbps(device=None) -> Optional[float]:
    """The device's published memory bandwidth (GB/s) for roofline shares.

    None on the CPU backend, which has no published peak to divide by. A GPU
    missing from PEAK_HBM_GBPS is an error, never a guessed default."""
    device = device or jax.devices()[0]
    if device.platform == "cpu":
        return None
    try:
        return PEAK_HBM_GBPS[device.device_kind]
    except KeyError:
        raise ValueError(
            f"no published memory bandwidth for device kind "
            f"{device.device_kind!r}; add it to PEAK_HBM_GBPS") from None


@dataclass
class Phase:
    name: str
    seconds: float
    bytes_moved: int = 0
    rows: int = 0


@dataclass
class PhaseTimer:
    """Collects named phases; `phase` blocks on device results."""

    phases: List[Phase] = field(default_factory=list)

    @contextlib.contextmanager
    def phase(self, name: str, bytes_moved: int = 0, rows: int = 0):
        t0 = time.perf_counter()
        out = {}
        try:
            # named span in jax.profiler device traces (utils/profiling.py)
            with jax.profiler.TraceAnnotation(f"join.{name}"):
                yield out
        finally:
            if "result" in out:
                jax.block_until_ready(out["result"])
            t1 = time.perf_counter()
            self.phases.append(Phase(name, t1 - t0, bytes_moved, rows))

    def seconds(self, name: str) -> float:
        return sum(p.seconds for p in self.phases if p.name == name)

    def total_seconds(self) -> float:
        return sum(p.seconds for p in self.phases)

    def report(self, extra: Optional[Dict] = None) -> Dict:
        hbm_gbps = peak_hbm_gbps()
        out = {"phases": {}, "hbm_gbps": hbm_gbps}
        for p in self.phases:
            d = out["phases"].setdefault(
                p.name, {"seconds": 0.0, "bytes": 0, "rows": 0}
            )
            d["seconds"] += p.seconds
            d["bytes"] += p.bytes_moved
            d["rows"] += p.rows
        for name, d in out["phases"].items():
            if d["seconds"] > 0:
                d["gbps"] = d["bytes"] / d["seconds"] / 1e9
                d["mrows_per_s"] = d["rows"] / d["seconds"] / 1e6
                if hbm_gbps:
                    d["roofline_frac"] = d["gbps"] / hbm_gbps
        if extra:
            out.update(extra)
        return out

    def print_report(self, extra: Optional[Dict] = None):
        print(json.dumps(self.report(extra)))


def ref_throughput_mbps(n_r: int, n_s: int, seconds: float) -> float:
    """The reference's headline metric: 2*(|R|+|S|)*4 bytes / t in MB/s
    (src/hash_join_clustered_probe.cu:938-940)."""
    if seconds <= 0:
        return float("inf")
    return 2.0 * (n_r + n_s) * 4.0 / seconds / 1e6
