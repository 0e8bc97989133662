"""North-star benchmark: end-to-end ONLINE CG force matching on one chip.

BASELINE.json's north-star row (end-to-end online CG force matching
against GPU HOOMD-TF) measured the way the reference does it in
example 08 (``08. Training Algorithms.ipynb`` /
``htf/test-py/test_examples.py``): a neural-network pair potential is
trained *during live MD* against per-step force labels from a built-in
potential, optimizer updates interleaved with integration inside the
one compiled step.

Protocol: equilibrate, then time R rounds of K fused MD+train steps at
64k particles (the BASELINE.json flagship scale) and at 16k. Each row
reports wall-seconds per 1,000 training steps -- the end-to-end unit a
force-matching user pays.

The GPU HOOMD-TF comparison point is an ESTIMATE, derived in the
artifact itself (the reference publishes no GPU training numbers; see
BASELINE.md): HOOMD-blue classical GPU throughput is a strict upper
bound on HOOMD-TF training throughput, because HOOMD-TF adds the TF
model forward+backward, the optimizer, and the GPU-GPU copy scheme on
top of every HOOMD step (reference ``tensorflowcompute.py`` +
``tfmanager.py`` round trip per period).

Run (GPU): python benchmarks/north_star.py  (one JSON line per row)
"""

import dataclasses
import json
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


class TrainableNN(htf.SimModel):
    """Example-08-pattern NN pair potential (per-lane MLP on 1/r).

    Following the reference's example 08 exactly, the trained output is
    ``forces[:, :3]`` -- the energy column is sliced off BEFORE the
    loss ("don't output last column of forces, pairwise energy, since
    it's meaningless here", reference notebook 08). Matching the [N,4]
    arrays directly trains against the energy column too, whose
    padded-lane offset swamps the force-matching signal (measured: the
    loss converges instantly to a config-tracking floor regardless of
    learning rate)."""

    def setup(self):
        self.dense1 = htf.Dense(16)
        self.last = htf.Dense(1)

    def compute(self, nlist, positions, box):
        rinv = htf.nlist_rinv(nlist)
        x = jax.nn.tanh(self.dense1(rinv[..., None]))
        e = jnp.sum(self.last(x)[..., 0], axis=1)
        return htf.compute_nlist_forces(nlist, e)[:, :3]


class TrainableNNPair(htf.PairModel):
    """The SAME NN pair potential declared through the framework's
    :class:`htf.PairModel` interface -- the idiomatic form a reference
    user migrating an example-08 model would write here
    (docs/migrating_from_hoomd_tf.md). Identical architecture (per-lane
    MLP on 1/r, same widths), identical training semantics; declaring
    the pair structure lets the engine skip the capture-replay
    reconstruction entirely: the per-lane slope comes from one jvp and
    the parameter gradient from the lane-contraction VJP
    (ops/pair_train.py)."""

    def setup(self):
        self.dense1 = htf.Dense(16)
        self.last = htf.Dense(1)

    def pair_energy(self, r2):
        rinv = jax.lax.rsqrt(r2)
        x = jax.nn.tanh(self.dense1(rinv[..., None]))
        return 2.0 * self.last(x)[..., 0]


def run_config(n, steps, equil, rounds, pair_decl=False, proxy=False):
    # quench the jittered lattice BEFORE any dynamics or training: the
    # clamped overlap forces of a violent start (~1e27) overflow both
    # the NVT kinetic-energy sum (latching the thermostat at T~0 until
    # the round-3 guard) and the f32 MSE of the force-matching loss
    sim = htf.Simulation(dt=0.005, integrator=htf.md.Minimize(max_disp=0.05),
                         seed=0)
    sim.init_lattice(n, density=0.4, kT_init=1.5)
    rng = np.random.RandomState(0)
    sim.state = dataclasses.replace(
        sim.state, positions=sim.state.positions +
        0.3 * jnp.asarray(rng.randn(n, 3).astype(np.float32)))
    # labels: built-in LJ (analytic route), the "known potential" the NN
    # learns online -- reference example 08's hoomd.md.pair.lj
    sim.add_force(htf.md.LennardJones(r_cut=3.0))
    sim.run(60)
    # supercritical state point (kT=1.5 > LJ Tc~1.31): single-phase,
    # stationary occupancy (see bench.py for the full rationale)
    sim.thermalize_velocities(1.5)
    sim.integrator = htf.md.NVT(kT=1.5, tau=0.5)
    sim.run(equil)
    jax.block_until_ready(sim.state.positions)
    th = sim.thermo()
    assert 1.1 < float(th["temperature"]) < 1.9, \
        f"training system is not a healthy kT=1.5 fluid: {th}"

    # now attach online training (reference example 08 trains during
    # live MD; attaching after equilibration keeps the Adam state clear
    # of the melt transient)
    if pair_decl:
        model = TrainableNNPair(64, output_forces=False,
                                proxy_degree=16 if proxy else None)
        # force-matching only, like the generic row: the analytic
        # route's f4 carries an exact per-particle energy column, but
        # the example-08 protocol trains on forces alone
        loss = lambda yt, yp: jnp.mean((yt[:, :3] - yp[:, :3]) ** 2)
    else:
        model = TrainableNN(64, output_forces=False)
        loss = "mse"
    # lr sized to a budget of a few hundred online steps: at 1e-4 the
    # NN barely moves and the before/after losses are pure
    # configuration-fluctuation noise
    model.compile(optimizer="adam", loss=loss, learning_rate=1e-2)
    tfc = htf.tfcompute(model)
    tfc.attach(sim, r_cut=3.0, nlist="cellwise", train=True)
    sim.run(max(equil // 4, 10))          # warm/compile the train scan
    # loss_before window: the UNTRAINED model, right after attach (the
    # warm/replan runs below keep training, so a later capture would
    # record an already-converged model as "before")
    hist = sim.tfc.loss_history
    w0 = min(50, max(len(hist) // 4, 1))
    loss0 = float(np.mean(hist[:w0])) if hist else None
    # adopt the occupancy-calibrated minimum-lane plan NOW (the
    # auto-replan's step-count throttle would otherwise land the
    # replan + recompile inside a timed round; production runs are
    # long enough not to care, benchmark rounds are not)
    # accumulate >= 300 steps of measured occupancy BEFORE replanning:
    # below that the planner falls back to a positions snapshot and the
    # plan it produces can sit 1.2-1.4x off the calibrated one -- which
    # the freeze below would then lock in for the timed rounds
    sim.run(max(300, steps))
    jax.block_until_ready(sim.state.positions)
    sim.replan()
    # warm with the TIMED round's own step count: scan programs are
    # cached per block length, so a shorter warm run leaves the timed
    # shape uncompiled and the first round pays the compile
    sim.run(steps)
    jax.block_until_ready(sim.state.positions)
    # freeze the plan for the timed rounds: a boundary auto-replan's
    # recompile must not land inside one. Overflow self-healing stays
    # armed -- correctness rollbacks are never disabled.
    sim.auto_replan = False

    # the instantaneous force-matching loss rides the density
    # fluctuations of the live fluid; windowed means (50 steps) measure
    # the training trend instead of two noisy samples
    times = []
    for _ in range(rounds):
        t0 = time.perf_counter()
        sim.run(steps)
        jax.block_until_ready(sim.state.positions)
        times.append(time.perf_counter() - t0)
    hist = sim.tfc.loss_history
    w = min(50, max(len(hist) // 4, 1))
    loss1 = float(np.mean(hist[-w:])) if hist else None
    best = min(times)
    return {
        "n_particles": n, "nn": 64, "train": True,
        "model": (("PairModel NN declaration, Chebyshev proxy K=16"
                   if proxy else "PairModel NN declaration (idiomatic)")
                  if pair_decl
                  else "generic SimModel (reference example-08 form)"),
        "temperature_pre_train": float(th["temperature"]),
        "nlist_mode": "cellwise", "steps": steps, "rounds": rounds,
        "mean_s": float(np.mean(times)), "min_s": best,
        "times_s": [round(t, 3) for t in times],
        "train_steps_per_s": steps / best,
        "wall_s_per_1000_train_steps": 1000.0 * best / steps,
        "loss_before": loss0, "loss_after": loss1,
    }


def main():
    enable_compile_cache()
    platform, kind, count = require_accelerator()
    device = {"platform": platform, "kind": kind, "count": count,
              "nvidia_smi": gpu_name_and_power_limit()}
    # flagship: the PairModel declaration of the NN (what a migrating
    # reference user writes here, per the migration guide); the generic
    # example-08 form is kept as the protocol-parity row
    configs = ([dict(n=65536, steps=200, equil=400, rounds=4,
                     pair_decl=True, proxy=True),
                dict(n=65536, steps=200, equil=400, rounds=4,
                     pair_decl=True),
                dict(n=65536, steps=200, equil=400, rounds=4),
                dict(n=16384, steps=300, equil=300, rounds=3,
                     pair_decl=True, proxy=True),
                dict(n=16384, steps=300, equil=300, rounds=3,
                     pair_decl=True),
                dict(n=16384, steps=300, equil=300, rounds=3)]
               if platform == "gpu" else
               [dict(n=4096, steps=50, equil=50, rounds=2)])
    for cfg in configs:
        row = run_config(**cfg)
        row["device"] = device
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
