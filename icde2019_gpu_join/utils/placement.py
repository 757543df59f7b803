"""Memory placement policies — the MEM_TYPE / UVA / UM analog.

The reference chooses at compile time where relations live (MEM_HOST pinned
mapped memory / MEM_DEVICE / MEM_MANAGED / mixed, src/common.h:74-86,
src/main.cu:162-184) and runs UVA/UM experiment matrices over the choices
(src/hash_join_clustered_probe.cu:84-172, 344-408). Here the analogous
axis is the jax memory kind of each array:

    "hbm"           device HBM (the default; MEM_DEVICE analog)
    "pinned_host"   host RAM addressable by the device over PCIe
                    (MEM_HOST cudaHostAlloc-mapped analog)
    "unpinned_host" plain host RAM (staging source; numpy arrays also count)
    "host"          leave as host numpy (streamed explicitly by the engine)

`place` moves an array to the policy's memory; `placement_sharding` builds
the SingleDeviceSharding with the right memory_kind for device_put.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

_KIND = {
    "hbm": "device",
    "device": "device",
    "pinned_host": "pinned_host",
    "unpinned_host": "unpinned_host",
}


def placement_sharding(policy: str, device=None):
    device = device or jax.devices()[0]
    kind = _KIND.get(policy)
    if kind is None:
        raise ValueError(f"unknown placement policy: {policy!r}")
    return jax.sharding.SingleDeviceSharding(device, memory_kind=kind)


def place(x, policy: str, device=None):
    """Place an array per policy. "host" keeps/returns host numpy."""
    if policy == "host":
        return np.asarray(x)
    device = device or jax.devices()[0]
    sharding = placement_sharding(policy, device)
    if device.platform != "cpu":
        # a GPU has both memory kinds: failing to place there is an error
        return jax.device_put(x, sharding)
    try:
        return jax.device_put(x, sharding)
    except (ValueError, KeyError, NotImplementedError):
        # The CPU backend lacks some memory kinds: fall back to default
        # placement — semantically equivalent.
        if policy == "hbm" or policy == "device":
            return jnp.asarray(x)
        return np.asarray(x)


def place_relation(rel, policy: str, device=None):
    """Place a Relation's columns per policy (returns a new Relation)."""
    from icde2019_gpu_join.relation import Relation

    return Relation(
        place(rel.keys, policy, device), place(rel.payload, policy, device)
    )
