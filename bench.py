#!/usr/bin/env python
"""Benchmark: MD steps/sec with a pair potential at 64k particles.

Prints ONE JSON line:
    {"metric": ..., "value": N, "unit": "steps/s", "vs_baseline": N,
     "device": {...}}

Baseline: the reference's committed pytest-benchmark result -- 451 steps/s
(LJ SimModel, N=256, NN=64, CPU Xeon; see BASELINE.md). The headline
config is the BASELINE.json target scale (64k particles) on the GPU; set
HTF_BENCH_N to override. With no GPU the script fails, unless
JAX_PLATFORMS=cpu asks for a CPU run (then at N=512, 50 steps).
"""

import dataclasses
import json
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

import hoomd_tf_tpu as htf
from hoomd_tf_tpu.utils.compile_cache import enable_compile_cache
from hoomd_tf_tpu.utils.device import (gpu_name_and_power_limit,
                                       require_accelerator)


class LJ(htf.PairModel):
    """Flagship model: LJ declared as a pair potential, which the engine
    evaluates on the analytic forward-only fast path in cellwise mode
    (ops/cellwise.analytic_pair_forces). Set HTF_BENCH_MODEL=simmodel for
    the generic SimModel route."""

    def pair_energy(self, r2):
        u = 1.0 / r2
        sr6 = u * u * u
        return 4.0 * (sr6 * sr6 - sr6)

    def pair_energy_and_slope(self, r2):
        # the slope shares sr6 with the energy
        u = 1.0 / r2
        sr6 = u * u * u
        return (4.0 * (sr6 * sr6 - sr6),
                -12.0 * (2.0 * sr6 - 1.0) * sr6 * u)


class LJSim(htf.SimModel):
    def compute(self, nlist, positions, box):
        rinv = htf.nlist_rinv(nlist)
        inv_r6 = rinv ** 6
        p_energy = 4.0 / 2.0 * (inv_r6 * inv_r6 - inv_r6)
        energy = jnp.sum(p_energy, axis=1)
        return htf.compute_nlist_forces(nlist, energy)


def equilibrated_fluid(n, model, nlist="cellwise", steps=1000, r_cut=3.0):
    """The benchmark protocol: a jittered LJ lattice at rho=0.4, quenched
    under a displacement cap, thermalized at kT=1.5 under NVT, and run
    until the cellwise plan settles. Returns ``(sim, tfc)``.

    The 0.3-sigma jitter creates overlapping pairs whose clamped forces
    overflow any dynamical integrator, hence the quench. kT=1.5 is
    supercritical (LJ Tc ~1.31): at kT=1.2 / rho=0.4 the fluid sits
    inside liquid-vapor coexistence and slowly phase-separates, so cell
    occupancy climbs without bound -- a worst case for the capacity-padded
    layout, not a steady state. The timed run must reuse a stable,
    already-compiled scan: the melt can overflow the planning-time
    capacity (run() self-heals with a rollback + replan) and the
    boundary auto-replan may tighten a stale plan."""
    sim = htf.Simulation(dt=0.005, integrator=htf.md.Minimize(max_disp=0.05),
                         seed=0)
    sim.scan_block = steps
    sim.init_lattice(n, density=0.4, kT_init=1.5)
    rng = np.random.RandomState(0)
    sim.state = dataclasses.replace(
        sim.state, positions=sim.state.positions +
        0.3 * jnp.asarray(rng.randn(n, 3).astype(np.float32)))
    tfc = htf.tfcompute(model)
    tfc.attach(sim, r_cut=r_cut, nlist=nlist)
    sim.run(60)
    sim.thermalize_velocities(1.5)
    sim.integrator = htf.md.NVT(kT=1.5, tau=0.5)
    sim.run(steps)
    jax.block_until_ready(sim.state.positions)
    for _ in range(4):
        plan_before = sim._layout.plan if sim._layout else None
        sim.run(steps)
        jax.block_until_ready(sim.state.positions)
        if sim._layout is None or sim._layout.plan == plan_before:
            break
    return sim, tfc


def main():
    enable_compile_cache()
    platform, kind, count = require_accelerator()
    on_gpu = platform == "gpu"
    n = int(os.environ.get("HTF_BENCH_N", 65536 if on_gpu else 512))
    nn = int(os.environ.get("HTF_BENCH_NN", 64))
    # 1000 steps matches the reference benchmark protocol
    # (htf/test-py/benchmark.py: 1000 LJ MD steps per round)
    steps = int(os.environ.get("HTF_BENCH_STEPS", 1000 if on_gpu else 50))
    model_cls = (LJSim if os.environ.get("HTF_BENCH_MODEL") == "simmodel"
                 else LJ)
    nlist_mode = os.environ.get("HTF_BENCH_NLIST",
                                "cellwise" if on_gpu else "auto")
    sim, tfc = equilibrated_fluid(n, model_cls(nn), nlist_mode, steps)

    # best of 3 rounds (reference protocol times rounds of 1000 steps;
    # the best round is the standard benchmark statistic)
    dt = None
    for _ in range(3 if on_gpu else 1):
        t0 = time.perf_counter()
        sim.run(steps)
        jax.block_until_ready(sim.state.positions)
        dt_i = time.perf_counter() - t0
        dt = dt_i if dt is None else min(dt, dt_i)
    th = sim.thermo()
    assert 1.1 < float(th["temperature"]) < 1.9, \
        f"benchmarked system is not a healthy kT=1.5 fluid: {th}"

    steps_per_s = steps / dt
    # reference baseline: 451 steps/s at N=256, NN=64 (committed
    # pytest-benchmark result, BASELINE.md) = 115,456 particle-steps/s.
    # vs_baseline compares particle-step throughput so different system
    # sizes are comparable.
    baseline_pps = 451.0 * 256.0
    if model_cls is LJ and nlist_mode == "cellwise":
        route = f"analytic PairModel fast path, stencil " \
                f"{tfc._pair_fast_stencil}"
    elif model_cls is LJ:
        route = "PairModel (generic route off-cellwise)"
    elif getattr(tfc, "_lane_fast_ok", False):
        route = ("generic SimModel, lane-fast analytic, stencil "
                 f"{tfc._lane_fast_stencil}")
    else:
        route = "generic SimModel vjp route"
    print(json.dumps({
        "metric": (f"LJ MD steps/s (N={n}, NN={nn}, "
                   f"model={model_cls.__name__} [{route}], "
                   f"nlist={nlist_mode}, fused jit step; "
                   f"vs_baseline = particle-step throughput ratio "
                   f"vs reference 451 steps/s @ N=256)"),
        "value": steps_per_s,
        "unit": "steps/s",
        "vs_baseline": steps_per_s * n / baseline_pps,
        "device": {"platform": platform, "kind": kind, "count": count,
                   "nvidia_smi": gpu_name_and_power_limit()},
    }))


if __name__ == "__main__":
    sys.exit(main())
