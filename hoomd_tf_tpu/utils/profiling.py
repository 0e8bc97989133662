"""Profiling and benchmarking helpers.

The reference piggybacks on HOOMD's Profiler push/pop brackets and a CUDA
block-size Autotuner (SURVEY.md section 5); the equivalents here are
`jax.profiler` traces and in-scan wall timing (per-dispatch timing would
measure dispatch latency, not kernel time).
"""

import contextlib
import time

import jax
import numpy as np

__all__ = ["trace", "time_steps", "benchmark_simulation"]


@contextlib.contextmanager
def trace(log_dir):
    """Capture an XLA profiler trace (view with TensorBoard/Perfetto)."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def time_steps(sim, steps, reps=1):
    """Honest per-step wall time: compiles/warms the exact scan first, then
    times whole ``run(steps)`` dispatches.

    :return: dict with ``ms_per_step`` and ``steps_per_s``.
    """
    sim.run(steps)
    jax.block_until_ready(sim.state.positions)
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        sim.run(steps)
        jax.block_until_ready(sim.state.positions)
        times.append(time.perf_counter() - t0)
    best = min(times)
    return {"ms_per_step": best / steps * 1000.0,
            "steps_per_s": steps / best,
            "all_runs_s": times}


def benchmark_simulation(sim, steps=1000, equilibration=0, reps=3):
    """pytest-benchmark-style measurement (the reference's
    ``test-py/benchmark.py`` protocol: equilibrate, then time R rounds of
    K steps; report mean/min)."""
    if equilibration:
        sim.run(equilibration)
        jax.block_until_ready(sim.state.positions)
    r = time_steps(sim, steps, reps=reps)
    runs = np.asarray(r["all_runs_s"])
    return {
        "steps": steps,
        "rounds": reps,
        "mean_s": float(runs.mean()),
        "min_s": float(runs.min()),
        "stddev_s": float(runs.std()),
        "steps_per_s": steps / float(runs.min()),
    }
