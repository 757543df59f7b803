"""Where the device time goes in the engine's main jitted programs, from
one jax.profiler trace each, on the GPU.

    python benchmarks/trace_layers.py [--out chiprun_out/trace_layers]

Programs (all at chip_smoke.py's real sizes, ones payloads):
  aggregate    ClusteredJoin.aggregate's program, 2^27 x 2^27 uniform
  materialize  2^23 x 2^23 into a 2^24 ring (the block-windowed fast path)
  groupby      filter -> probe -> group-by, R 2^24, S 2^27, 64 groups

For each program it prints the host wall time of one warm call, the device
busy time (union of kernel intervals), the idle share of the window from the
first to the last kernel, the device time attributed to each per-chunk
compare/select helper (by its jax.named_scope in the optimized HLO) and to
sorts, the number of device-to-host copies, the top kernels, and how XLA
lowered every sort (a `sort` instruction or a library custom call). The
full reduction is written as JSON under --out. Refuses to run without a GPU.
"""

from __future__ import annotations

import argparse
import collections
import glob
import json
import os
import re
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

HELPERS = ("banded_compare_sum_triton", "banded_compare_sum",
           "banded_compare_per_s", "banded_compare_first",
           "banded_interval_select")

_INSTR = re.compile(r"^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=\s*(.*)$")
_OPNAME = re.compile(r'op_name="([^"]*)"')


def hlo_index(hlo_text: str):
    """instruction name -> (op_name metadata, instruction text), and the
    sort lowering lines."""
    index, sorts = {}, []
    for line in hlo_text.splitlines():
        m = _INSTR.match(line)
        if not m:
            continue
        name, rest = m.group(1), m.group(2)
        op = _OPNAME.search(rest)
        index[name] = (op.group(1) if op else "", rest)
        head = rest.split("metadata=")[0]
        if " sort(" in head or ("custom-call(" in head and (
                "sort" in head.lower() or "cub" in head.lower())):
            sorts.append(f"{name} = {head.strip()[:240]}")
    return index, sorts


def attribute(op_name: str) -> str:
    for h in HELPERS:
        if h in op_name:
            return h
    return ""


def reduce_trace(trace_dir: str, index) -> dict:
    import jax

    paths = glob.glob(os.path.join(trace_dir, "plugins", "profile", "*",
                                   "*.xplane.pb"))
    pd = jax.profiler.ProfileData.from_file(sorted(paths)[-1])
    events = []
    for plane in pd.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            for ev in line.events:
                stats = {k: v for k, v in ev.stats}
                events.append((line.name, ev.name, ev.start_ns,
                               ev.duration_ns, stats))
    kernels = [e for e in events if "memcpy" not in e[1].lower()
               and "memset" not in e[1].lower()]
    copies_d2h = sum(1 for e in events if "memcpy" in e[1].lower() and (
        "dtoh" in e[1].lower() or "d2h" in e[1].lower()))
    # busy = union of kernel intervals
    iv = sorted((s, s + d) for _, _, s, d, _ in kernels)
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in iv:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    window = (iv[-1][1] - iv[0][0]) if iv else 0.0
    per_scope = collections.Counter()
    per_kernel = collections.defaultdict(lambda: [0, 0.0, ""])
    for _, name, _, dur, stats in kernels:
        hlo_op = str(stats.get("hlo_op", name))
        op_name, text = index.get(hlo_op, ("", ""))
        scope = attribute(op_name) or attribute(name)
        if not scope and (" sort(" in text or "custom-call" in text
                          and "sort" in text.lower()):
            scope = "sort"
        per_scope[scope or "other"] += dur
        k = per_kernel[hlo_op]
        k[0] += 1
        k[1] += dur
        k[2] = scope or op_name[-80:]
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1][1])[:15]
    return {
        "kernels": len(kernels),
        "device_busy_ms": busy / 1e6,
        "window_ms": window / 1e6,
        "idle_share": (1 - busy / window) if window else None,
        "d2h_copies": copies_d2h,
        "per_scope_ms": {k: v / 1e6 for k, v in per_scope.items()},
        "top_kernels": [{"hlo_op": n, "count": c, "ms": d / 1e6,
                         "scope": s} for n, (c, d, s) in top],
        "event_stat_keys": sorted({k for *_, st in kernels for k in st}),
    }


def measure(tag, jitted, args, kwargs, out_dir):
    import jax

    compiled = jitted.lower(*args, **kwargs).compile()
    index, sorts = hlo_index(compiled.as_text())
    jax.block_until_ready(jitted(*args, **kwargs))          # warm
    t0 = time.perf_counter()
    jax.block_until_ready(jitted(*args, **kwargs))
    wall = time.perf_counter() - t0
    tdir = os.path.join(out_dir, tag)
    with jax.profiler.trace(tdir):
        jax.block_until_ready(jitted(*args, **kwargs))
    red = reduce_trace(tdir, index)
    red.update({"program": tag, "warm_wall_ms": wall * 1e3, "sorts": sorts})
    with open(os.path.join(out_dir, f"{tag}.json"), "w") as f:
        json.dump(red, f, indent=1)
    print(f"== {tag}: warm wall {wall * 1e3:.3f} ms; device busy "
          f"{red['device_busy_ms']:.3f} ms over a {red['window_ms']:.3f} ms "
          f"window (idle share {red['idle_share']}); {red['kernels']} "
          f"kernels; {red['d2h_copies']} D2H copies", flush=True)
    for k, v in sorted(red["per_scope_ms"].items(), key=lambda kv: -kv[1]):
        print(f"   scope {k:<24} {v:.3f} ms")
    for k in red["top_kernels"][:8]:
        print(f"   kernel {k['hlo_op']:<32} x{k['count']:<6} {k['ms']:.3f} ms "
              f"{k['scope']}")
    for s in sorts:
        print(f"   sort: {s}")
    return red


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="chiprun_out/trace_layers")
    args = ap.parse_args()
    import jax
    import jax.numpy as jnp

    if jax.devices()[0].platform != "gpu":
        sys.exit("trace_layers: needs a GPU")
    from icde2019_gpu_join.models import pipelines
    from icde2019_gpu_join.ops import band_join as bj
    from icde2019_gpu_join.utils import datasets

    os.makedirs(args.out, exist_ok=True)
    print(f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")
    n = 1 << 27
    rk, sk = datasets.make_pk_fk(n, n, seed=12345)
    ones = jnp.ones(n, jnp.int32)
    measure("aggregate", bj._banded_join_aggregate,
            (jnp.asarray(rk), ones, jnp.asarray(sk), ones),
            dict(window_blocks=1, sort_impl="lax"), args.out)

    m = 1 << 23
    mk, msk = datasets.make_pk_fk(m, m, seed=12345)
    r = np.random.default_rng(3)
    mp = [jnp.asarray(r.integers(-2**31, 2**31, m).astype(np.int32))
          for _ in range(2)]
    measure("materialize", bj._banded_materialize,
            (jnp.asarray(mk), mp[0], jnp.asarray(msk), mp[1]),
            dict(capacity=1 << 24, window_blocks=1, wrap=True,
                 debug_force=None, sort_impl="lax"), args.out)

    n_r, groups = 1 << 24, 64
    r = np.random.default_rng(42)
    fk = r.permutation(n_r).astype(np.int32)
    fp = r.integers(1, 100, n_r).astype(np.int32)
    fs = fk[r.integers(0, n_r, n)].astype(np.int32)
    ff = r.integers(0, 1000, n).astype(np.int32)
    fg = r.integers(0, groups, n).astype(np.int32)
    measure("groupby", pipelines._filter_probe_groupby,
            tuple(jnp.asarray(a) for a in (fk, fp, fs, ff, fg))
            + (jnp.int32(100), jnp.int32(600)),
            dict(num_groups=groups, window_blocks=1, sort_impl="lax"),
            args.out)


if __name__ == "__main__":
    main()
