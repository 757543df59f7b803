"""jax.profiler integration (the reference's nvprof/nvToolsExt analog,
Makefile:6,34 — dormant hooks there; first-class here).

Two surfaces:

  * `trace(logdir)` — context manager around `jax.profiler.trace`, emitting
    a TensorBoard/XProf trace of everything dispatched inside. Enabled
    implicitly by JOIN_PROFILE_DIR for any engine entry point that uses
    `maybe_trace`.
  * `annotate(name)` — `jax.profiler.TraceAnnotation` wrapper so engine
    phases (partition/plan/join/exchange) show up as named spans inside
    device traces.

Traces capture XLA op timelines on the device, the evidence mechanism for
pipeline-overlap claims (streaming/coprocess segment overlap): look for
transfer spans of segment k+1 overlapping compute spans of segment k.
"""

from __future__ import annotations

import contextlib
import os
from typing import Optional

import jax

ENV_VAR = "JOIN_PROFILE_DIR"


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a profiler trace of the enclosed block into `logdir`."""
    with jax.profiler.trace(logdir):
        yield


@contextlib.contextmanager
def maybe_trace(tag: str, logdir: Optional[str] = None):
    """Trace the block iff a log dir is given or JOIN_PROFILE_DIR is
    set; the trace lands in <dir>/<tag>/."""
    logdir = logdir or os.environ.get(ENV_VAR)
    if not logdir:
        yield
        return
    path = os.path.join(logdir, tag)
    os.makedirs(path, exist_ok=True)
    with jax.profiler.trace(path):
        yield


def annotate(name: str):
    """Named span inside a device trace (use as a context manager)."""
    return jax.profiler.TraceAnnotation(name)
