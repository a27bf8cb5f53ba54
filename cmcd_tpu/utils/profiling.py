"""Profiling hooks (new vs the reference, which has none — SURVEY.md §5).

Thin wrappers over jax.profiler so training/eval phases can be traced and
inspected with TensorBoard/Perfetto, and the device description every
measurement is reported with.
"""

from __future__ import annotations

import contextlib
import subprocess

import jax


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a device trace for the enclosed block."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def annotate(name: str):
    """Named region visible in traces: with annotate('evolve'): ..."""
    return jax.profiler.TraceAnnotation(name)


def device_summary() -> dict:
    """Platform, kind and count of the devices JAX uses, as JAX reports
    them."""
    dev = jax.devices()[0]
    return {
        "platform": dev.platform,
        "kind": dev.device_kind,
        "count": len(jax.devices()),
    }


def gpu_name_and_power_limit() -> str:
    """The first card's name and power limit, as
    `nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` prints
    them. nvidia-smi runs as a child process that does not open the card
    through JAX. A card may be set below its maximum power and then runs
    slower under load, so every timing is reported beside this line."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]
