"""Single-GPU size scaling + plan-sweep fit of the planner's cost model.

Two jobs:

1. **Headline rows** (default): LJ NVT steps/s at 64k/131k/256k on the
   PairModel analytic fast path, each row timed on the
   occupancy-calibrated plan (explicit ``sim.replan()`` after
   equilibration).

2. **Plan sweep** (``--plansweep N``): pin several candidate
   (grid, capacity) plans at size N, time each with every analytic
   route, and fit the planner's four cost constants
   (``ops/cellwise.py``: per-lane cost of the XLA stencils and of the
   half-stencil kernel, per-slot repack cost, per-rebuild fixed cost)
   by least squares over all rows.

Every result line is one JSON object and names the device. Run on the
GPU: ``python benchmarks/scale.py [--plansweep 65536] [--quick]``.
"""

import argparse
import dataclasses
import json
import math
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp
import numpy as np

import hoomd_tf_tpu as htf
from hoomd_tf_tpu.utils.compile_cache import enable_compile_cache
from hoomd_tf_tpu.utils.device import (gpu_name_and_power_limit,
                                       require_accelerator)


class LJPair(htf.PairModel):
    def pair_energy(self, r2):
        u = 1.0 / r2
        sr6 = u * u * u
        return 4.0 * (sr6 * sr6 - sr6)

    def pair_energy_and_slope(self, r2):
        u = 1.0 / r2
        sr6 = u * u * u
        return (4.0 * (sr6 * sr6 - sr6),
                -12.0 * (2.0 * sr6 - 1.0) * sr6 * u)


def make_fluid(n, equil):
    """bench.py's protocol: quench -> thermalize -> kT=1.5."""
    sim = htf.Simulation(dt=0.005,
                         integrator=htf.md.Minimize(max_disp=0.05),
                         seed=0)
    sim.init_lattice(n, density=0.4, kT_init=1.5)
    rng = np.random.RandomState(0)
    sim.state = dataclasses.replace(
        sim.state, positions=sim.state.positions +
        0.3 * jnp.asarray(rng.randn(n, 3).astype(np.float32)))
    tfc = htf.tfcompute(LJPair(64))
    tfc.attach(sim, r_cut=3.0, nlist="cellwise")
    sim.run(60)
    sim.thermalize_velocities(1.5)
    sim.integrator = htf.md.NVT(kT=1.5, tau=0.5)
    sim.run(equil)
    jax.block_until_ready(sim.state.positions)
    th = sim.thermo()
    assert 1.1 < float(th["temperature"]) < 1.9, th
    return sim


def time_steps(sim, steps, rounds):
    times = []
    for _ in range(rounds):
        t0 = time.perf_counter()
        sim.run(steps)
        jax.block_until_ready(sim.state.positions)
        times.append(time.perf_counter() - t0)
    return min(times), times


def headline(quick, device):
    sizes = ([(65536, 300, 400, 3), (131072, 200, 300, 3),
              (262144, 100, 200, 3)] if not quick
             else [(4096, 100, 50, 2)])
    for n, steps, equil, rounds in sizes:
        sim = make_fluid(n, equil)
        # adopt the occupancy-calibrated plan, then settle + recompile
        sim.replan()
        sim.run(max(equil // 4, 20))
        jax.block_until_ready(sim.state.positions)
        plan = sim._layout.plan
        best, times = time_steps(sim, steps, rounds)
        print(json.dumps({
            "n_particles": n, "steps_per_s": steps / best,
            "plan_grid": list(plan.grid), "plan_capacity": plan.capacity,
            "route": sim.tfc._pair_fast_stencil, "times_s": times,
            "device": device}), flush=True)
        del sim


def _candidate_grids(lengths, r_cut):
    seen = set()
    for scale in np.linspace(1.0, 1.8, 9):
        dims = tuple(int(math.floor(L / (r_cut * scale))) for L in lengths)
        if any(d < 3 for d in dims):
            continue
        if min(L / d for L, d in zip(lengths, dims)) < r_cut:
            continue
        seen.add(dims)
    return sorted(seen, reverse=True)


def plan_sweep(n, device, routes=("pallas", "full"), margins=(6, 14)):
    """Time every (grid, capacity margin, route) candidate on one
    equilibrated configuration and fit the planner's constants."""
    from hoomd_tf_tpu.ops.cellwise import (CellwisePlan,
                                           _measured_occupancy, pair_lanes)

    sim = make_fluid(n, 300)
    lengths = np.asarray(htf.box_size(sim.state.box))
    lo = np.asarray(sim.state.box[0])
    fluid_state = sim.state
    rows = []
    for dims in _candidate_grids(lengths, 3.0):
        occ_max, _, _ = _measured_occupancy(
            np.asarray(fluid_state.positions), lo, lengths, dims)
        for margin in margins:
            plan = CellwisePlan(grid=dims, capacity=occ_max + margin,
                                lengths=tuple(float(v) for v in lengths),
                                r_cut=3.0)
            for route in routes:
                # pin the plan and the route; no boundary replans
                sim2 = htf.Simulation(dt=0.005,
                                      integrator=htf.md.NVT(kT=1.5, tau=0.5),
                                      seed=0, auto_replan=False)
                sim2.set_state(fluid_state)
                sim2.pair_stencil = route
                tfc2 = htf.tfcompute(LJPair(64))
                tfc2.attach(sim2, r_cut=3.0, nlist="cellwise")
                sim2._plan_from_current = lambda plan=plan: plan
                sim2._maybe_auto_replan = lambda layout: layout
                try:
                    sim2.run(30)   # compile + settle
                    jax.block_until_ready(sim2.state.positions)
                    best, _ = time_steps(sim2, 200, 2)
                except RuntimeError as e:
                    # a pinned plan the live fluid overflows: no row
                    print(json.dumps({"grid": list(dims),
                                      "capacity": plan.capacity,
                                      "route": route,
                                      "error": str(e)[:200]}), flush=True)
                    continue
                row = {"n_particles": n, "grid": list(dims),
                       "capacity": plan.capacity, "route": route,
                       "lanes": pair_lanes(n, plan.n_cells, plan.capacity,
                                           route),
                       "slots": plan.n_slots,
                       "static_K": sim2._static_K_last,
                       "ms_per_step": 1e3 * best / 200, "device": device}
                print(json.dumps(row), flush=True)
                rows.append(row)
                del sim2
    fit_costs(rows)
    return rows


def fit_costs(rows):
    """Least-squares fit of ``t = fixed[route] + lane[route] * lanes +
    (repack_slot * slots + segment) / K`` over all sweep rows; prints the
    constants in seconds."""
    routes = sorted({r["route"] for r in rows})
    nr = len(routes)
    X, y = [], []
    for r in rows:
        K = float(r["static_K"] or 1)
        one = [float(r["route"] == rt) for rt in routes]
        X.append(one + [o * r["lanes"] for o in one] +
                 [r["slots"] / K, 1.0 / K])
        y.append(r["ms_per_step"] * 1e-3)
    coef, *_ = np.linalg.lstsq(np.asarray(X), np.asarray(y), rcond=None)
    pred = np.asarray(X) @ coef
    fit = {"repack_slot_s": coef[-2], "segment_fixed_s": coef[-1],
           "max_rel_residual": float(np.max(np.abs(pred - y) / y))}
    for i, rt in enumerate(routes):
        fit[f"fixed_s_{rt}"] = coef[i]
        fit[f"lane_s_{rt}"] = coef[nr + i]
    print(json.dumps({"fit": {k: float(v) for k, v in fit.items()}}),
          flush=True)
    return fit


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--plansweep", type=int, default=None)
    p.add_argument("--quick", action="store_true")
    args = p.parse_args()
    enable_compile_cache()
    platform, kind, count = require_accelerator()
    device = {"platform": platform, "kind": kind, "count": count,
              "nvidia_smi": gpu_name_and_power_limit()}
    if args.plansweep:
        plan_sweep(args.plansweep, device)
    else:
        headline(args.quick, device)


if __name__ == "__main__":
    main()
