"""Benchmark harness mirroring the reference's pytest-benchmark protocol
(``test-py/benchmark.py`` + ``.benchmarks/``: equilibrate, then R timed
rounds of K steps).

Run on the GPU: python benchmarks/run_benchmarks.py [--quick] [--out F]
Prints one JSON line per configuration, each naming the device; with
``--out`` also writes them to F.
"""

import argparse
import json
import os
import platform
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp
import numpy as np

import hoomd_tf_tpu as htf
from hoomd_tf_tpu.utils.compile_cache import enable_compile_cache
from hoomd_tf_tpu.utils.device import (gpu_name_and_power_limit,
                                       require_accelerator)
from hoomd_tf_tpu.utils.profiling import benchmark_simulation


class LJ(htf.SimModel):
    def compute(self, nlist, positions, box):
        rinv = htf.nlist_rinv(nlist)
        inv_r6 = rinv ** 6
        energy = jnp.sum(4.0 / 2.0 * (inv_r6 ** 2 - inv_r6), axis=1)
        return htf.compute_nlist_forces(nlist, energy)


class LJPair(htf.PairModel):
    """The analytic-fast-path form of the same potential."""

    def pair_energy(self, r2):
        u = 1.0 / r2
        sr6 = u * u * u
        return 4.0 * (sr6 * sr6 - sr6)

    def pair_energy_and_slope(self, r2):
        u = 1.0 / r2
        sr6 = u * u * u
        return (4.0 * (sr6 * sr6 - sr6),
                -12.0 * (2.0 * sr6 - 1.0) * sr6 * u)


class LJHalf(LJ):
    """Half-strength model LJ for the combined-force protocol row."""

    def compute(self, nlist, positions, box):
        rinv = htf.nlist_rinv(nlist)
        inv_r6 = rinv ** 6
        energy = jnp.sum(0.5 * 4.0 / 2.0 * (inv_r6 ** 2 - inv_r6), axis=1)
        return htf.compute_nlist_forces(nlist, energy)


class LJPairHalf(htf.PairModel):
    def pair_energy(self, r2):
        u = 1.0 / r2
        sr6 = u * u * u
        return 2.0 * (sr6 * sr6 - sr6)

    def pair_energy_and_slope(self, r2):
        u = 1.0 / r2
        sr6 = u * u * u
        return (2.0 * (sr6 * sr6 - sr6),
                -6.0 * (2.0 * sr6 - 1.0) * sr6 * u)


class TrainableNN(htf.SimModel):
    """Online-learning flagship: small NN potential trained against
    built-in LJ labels every step (reference example 08 pattern)."""

    def setup(self):
        self.dense1 = htf.Dense(16)
        self.last = htf.Dense(1)

    def compute(self, nlist, positions, box):
        rinv = htf.nlist_rinv(nlist)
        x = jax.nn.tanh(self.dense1(rinv[..., None]))  # per-lane MLP
        e = jnp.sum(self.last(x)[..., 0], axis=1)
        # reference example 08 trains on forces[:, :3]: the energy
        # column's padded-lane offset would swamp the force signal
        return htf.compute_nlist_forces(nlist, e)[:, :3]


def bench_config(n, nn, steps, equil, rounds, nlist_mode=None,
                 model="simmodel", train=False, label=None,
                 lane_fast=True, combined_lj=False):
    import dataclasses
    # the lane-separability probe (ops/lane_fast) promotes separable
    # generic SimModels onto the analytic kernel; lane_fast=False pins
    # the generic planes+vjp route for the A/B rows below
    os.environ["HTF_LANE_FAST"] = "1" if lane_fast else "0"
    # honest protocol (bench.py rationale): displacement-capped quench
    # of the jitter overlaps, Maxwell-Boltzmann thermalization, then a
    # SUPERCRITICAL kT=1.5 NVT fluid (kT=1.2 at this density sits inside
    # liquid-vapor coexistence and slowly phase-separates)
    sim = htf.Simulation(dt=0.005,
                         integrator=htf.md.Minimize(max_disp=0.05),
                         seed=0)
    sim.init_lattice(n, density=0.4, kT_init=1.5)
    rng = np.random.RandomState(0)
    sim.state = dataclasses.replace(
        sim.state, positions=sim.state.positions +
        0.3 * jnp.asarray(rng.randn(n, 3).astype(np.float32)))
    if nlist_mode is None:
        nlist_mode = 'auto'
    if train:
        # labels + quench/equilibration force; the trainable model
        # attaches AFTER equilibration (north_star.py rationale: keep
        # the Adam state clear of the melt transient)
        sim.add_force(htf.md.LennardJones(r_cut=3.0))
    else:
        if combined_lj:
            # the reference's benchmark protocol runs the TF model WITH
            # hoomd.md.pair.lj simultaneously active
            # (/root/reference/htf/test-py/benchmark.py:25-48): both
            # force sources evaluated and summed every step. Half
            # epsilon each keeps the combined fluid at the same state
            # point as the single-force rows.
            sim.add_force(htf.md.LennardJones(epsilon=0.5, r_cut=3.0))
            cls = LJPairHalf if model == "pair" else LJHalf
        else:
            cls = LJPair if model == "pair" else LJ
        tfc = htf.tfcompute(cls(nn))
        tfc.attach(sim, r_cut=3.0, nlist=nlist_mode)
    sim.run(60)
    sim.thermalize_velocities(1.5)
    sim.integrator = htf.md.NVT(kT=1.5, tau=0.5)
    if nlist_mode == "cellwise":
        # equilibrate until the plan settles (auto-replan tightens the
        # cold-start capacity from the carried running occupancy)
        for _ in range(4):
            plan_before = sim._layout.plan if sim._layout else None
            sim.run(equil)
            jax.block_until_ready(sim.state.positions)
            if sim._layout is None or sim._layout.plan == plan_before:
                break
        equil = max(equil // 4, 10)
    if train:
        m = TrainableNN(nn, output_forces=False)
        m.compile(optimizer="adam", loss="mse", learning_rate=1e-2)
        tfc = htf.tfcompute(m)
        tfc.attach(sim, r_cut=3.0, nlist=nlist_mode, train=True)
    result = benchmark_simulation(sim, steps=steps,
                                  equilibration=equil, reps=rounds)
    th = sim.thermo()
    result["temperature"] = float(th["temperature"])
    result.update({"n_particles": n, "nn": nn, "model": model,
                   "train": train, "nlist_mode": nlist_mode,
                   "lane_fast": bool(lane_fast),
                   "combined_lj": bool(combined_lj)})
    if label:
        result["label"] = label
    return result


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--quick", action="store_true")
    parser.add_argument("--subset", default=None,
                        help="python slice over the config list, e.g. "
                             "'3:'")
    parser.add_argument("--out", default=None,
                        help="also write the result rows to this file")
    args = parser.parse_args()

    enable_compile_cache()
    platform_, kind, count = require_accelerator()
    device = {"platform": platform_, "kind": kind, "count": count,
              "nvidia_smi": gpu_name_and_power_limit()}
    if args.quick or platform_ != "gpu":
        configs = [dict(n=256, nn=64, steps=200, equil=100, rounds=2),
                   dict(n=4096, nn=64, steps=100, equil=50, rounds=2)]
    else:
        configs = [
            # the reference's config (its committed CPU number: 451/s)
            dict(n=256, nn=64, steps=1000, equil=4000, rounds=5),
            dict(n=4096, nn=64, steps=500, equil=500, rounds=3),
            # the BASELINE.json target scale, three engine modes
            dict(n=65536, nn=64, steps=200, equil=200, rounds=3,
                 nlist_mode="direct",
                 label="wide-direct, generic SimModel"),
            dict(n=65536, nn=64, steps=500, equil=1000, rounds=3,
                 nlist_mode="cellwise", lane_fast=False,
                 label="cellwise, generic SimModel (planes + vjp)"),
            dict(n=65536, nn=64, steps=500, equil=1000, rounds=3,
                 nlist_mode="cellwise",
                 label="cellwise, generic SimModel (lane-fast probe)"),
            dict(n=65536, nn=64, steps=500, equil=1000, rounds=3,
                 nlist_mode="cellwise", model="pair",
                 label="cellwise, PairModel analytic fast path"),
            # the reference's benchmark PROTOCOL: SimModel + built-in
            # LJ simultaneously active (test-py/benchmark.py:25-48),
            # at its config scale and the flagship scale
            dict(n=256, nn=64, steps=1000, equil=2000, rounds=3,
                 combined_lj=True,
                 label="combined model+builtin LJ (reference protocol)"),
            dict(n=65536, nn=64, steps=500, equil=1000, rounds=3,
                 nlist_mode="cellwise", combined_lj=True,
                 label="combined model+builtin LJ (reference protocol)"),
            # online learning: NN potential trained on built-in LJ
            # labels every step (reference example 08 pattern)
            dict(n=16384, nn=64, steps=100, equil=200, rounds=2,
                 nlist_mode="cellwise", train=True,
                 label="online training, NN model, analytic labels"),
            dict(n=65536, nn=64, steps=100, equil=200, rounds=2,
                 nlist_mode="cellwise", train=True,
                 label="online training, NN model, analytic labels"),
        ]

    if args.subset:
        a, _, b = args.subset.partition(":")
        configs = configs[int(a) if a else None:int(b) if b else None]

    results = []
    for cfg in configs:
        r = bench_config(**cfg)
        r["device"] = device
        print(json.dumps(r), flush=True)
        results.append(r)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"machine": platform.node(), "jax": jax.__version__,
                       "reference_baseline": {
                           "steps_per_s": 451, "n_particles": 256,
                           "source": "BASELINE.md (pytest-benchmark, "
                                     "Xeon 6140)"},
                       "results": results}, f, indent=1)


if __name__ == "__main__":
    main()
