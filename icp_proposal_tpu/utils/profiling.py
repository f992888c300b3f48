"""Profiling / tracing utilities.

The reference's tracing is wall-clock prints (``ICP-Timing: N sec``,
``IcpProposalRegistration.scala:41-46``; SURVEY §5.1).  Here: the same
coarse timers plus XLA-profiler trace capture and a samples/s counter —
per-kernel timing comes from the captured trace (view with TensorBoard or
xprof) — and the device checks of the entry points."""
from __future__ import annotations

import contextlib
import time


@contextlib.contextmanager
def wall_timer(tag: str = "ICP", verbose: bool = True):
    """Reference-style coarse timing print: ``ICP-Timing: N sec``."""
    t0 = time.perf_counter()
    holder = {}
    try:
        yield holder
    finally:
        holder["seconds"] = time.perf_counter() - t0
        if verbose:
            print(f"{tag}-Timing: {holder['seconds']} sec")


@contextlib.contextmanager
def xla_trace(log_dir: str):
    """Capture an XLA profiler trace around a block (per-kernel timings)."""
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


class ThroughputCounter:
    """Streaming samples/s/chip counter for chain drivers."""

    def __init__(self, n_devices: int = 1):
        self.n_devices = n_devices
        self.t0 = time.perf_counter()
        self.samples = 0

    def add(self, n: int):
        self.samples += n

    @property
    def samples_per_sec(self) -> float:
        return self.samples / max(time.perf_counter() - self.t0, 1e-9)

    @property
    def samples_per_sec_per_chip(self) -> float:
        return self.samples_per_sec / self.n_devices


def enable_compilation_cache() -> str:
    """Turn on JAX's persistent compilation cache; call before the first jit
    executes.  The cache lives in ``$JAX_COMPILATION_CACHE_DIR`` when that is
    set, else in ``.jax_cache`` at the root of this checkout (a fixed path:
    the path is part of the cache key).  Returns the directory."""
    import os

    import jax

    cache_dir = os.environ.get("JAX_COMPILATION_CACHE_DIR") or os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
        ".jax_cache",
    )
    os.makedirs(cache_dir, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", cache_dir)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 5.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    return cache_dir


def require_platform(platform: str):
    """Fail (SystemExit) unless JAX's devices are on ``platform`` ("gpu" or
    "cpu"); "cpu" first pins JAX to the CPU.  Call before other JAX work.
    Measurement and run entry points never fall back to the CPU silently.
    Returns the devices."""
    import jax

    if platform == "cpu":
        jax.config.update("jax_platforms", "cpu")
    devices = jax.devices()
    if devices[0].platform != platform:
        raise SystemExit(f"no {platform} device found; JAX has {devices}")
    return devices


def gpu_name_and_power_limit() -> str:
    """``nvidia-smi``'s name and power limit of each card, one per line."""
    import subprocess

    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
