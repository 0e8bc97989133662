#!/usr/bin/env python
"""Bring-up check of the MD engine on one NVIDIA GPU.

Drives the main paths through the entry points a user calls
(``Simulation`` / ``tfcompute.attach`` / ``Simulation.run``) at the
flagship width (65,536 particles), runs every kernel of those paths as
compiled for the card, compares each with the plain reference, and ends
with one JSON line ``{"ok": true, "device": {...}}``. Everything runs in
this one process (a second JAX process could not get the card's memory).

    python chip_smoke.py              # one GPU: phases 1-7
    python chip_smoke.py --multichip  # four GPUs: the sharded paths only
    JAX_PLATFORMS=cpu python chip_smoke.py --rehearse [--multichip]
        # CPU rehearsal at tiny sizes, Pallas kernels interpreted

Any failed check raises, so the process exits non-zero and prints no
result line. Without a GPU (and without ``--rehearse``) it exits 1.
Steps/s printed here are bring-up readings, not benchmark results.
"""

import argparse
import dataclasses
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

FULL = dict(eval=65536, block=500, timed=1000, oracle=4096, train=65536,
            train_generic=16384, train_steps=40, generic=65536,
            generic_steps=100, shard=262144, ring=16384, frame=4096)
REHEARSE = dict(eval=2000, block=20, timed=20, oracle=600, train=2000,
                train_generic=1000, train_steps=20, generic=2000,
                generic_steps=20, shard=4096, ring=2048, frame=512)

# force parity: the CPU tests' rtol/atol (tests/test_cellwise.py), with
# the absolute part scaled by the largest reference force magnitude
RTOL, ATOL_REL = 1e-4, 1e-4


def line(*parts):
    print(*parts, flush=True)


def check(ok, what):
    if not ok:
        raise AssertionError(what)


def compare(name, got, ref, rtol=RTOL, atol_rel=ATOL_REL):
    """Elementwise ``|got - ref| <= rtol * |ref| + atol_rel * max|ref|``
    (numpy's allclose rule, absolute part scaled to the largest reference
    magnitude). Prints the max abs error and the max relative error
    ``|got - ref| / |ref|`` over elements with ``|ref|`` above the absolute
    tolerance, each beside its tolerance; raises past the rule."""
    import numpy as np
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    scale = max(float(np.abs(ref).max()), 1.0)
    atol = atol_rel * scale
    err = np.abs(got - ref)
    big = np.abs(ref) > atol
    rel = float((err[big] / np.abs(ref[big])).max()) if big.any() else 0.0
    worst = float((err / (rtol * np.abs(ref) + atol)).max())
    line(f"  {name}: max abs err {float(err.max()):.3e} (abs tol "
         f"{atol:.3e} = {atol_rel:g} x max|ref| {scale:.4g}); max rel err "
         f"{rel:.3e} (rel tol {rtol:g}); worst err/(rtol|ref| + atol) "
         f"{worst:.3f} (must be <= 1)")
    check(worst <= 1.0, f"{name} parity out of tolerance")
    return float(err.max()), rel


def wrapped_max_diff(a, b, lengths):
    import numpy as np
    d = np.asarray(a) - np.asarray(b)
    L = np.asarray(lengths)
    return float(np.abs(d - np.round(d / L) * L).max())


def timed_steps(sim, steps):
    import jax
    t0 = time.perf_counter()
    sim.run(steps)
    jax.block_until_ready(sim.state.positions)
    return steps / (time.perf_counter() - t0)


def warm_timed(sim, steps, max_warm=4):
    """Runs of ``steps`` until one compiles nothing new (the repack
    interval K is re-chosen per run, and a new K is a new program), then
    one timed run. Returns steps/s; fails if the timed run compiled."""
    import jax
    for _ in range(max_warm):
        n0 = len(sim._scan_cache)
        sim.run(steps)
        jax.block_until_ready(sim.state.positions)
        if len(sim._scan_cache) == n0:
            break
    n0 = len(sim._scan_cache)
    sps = timed_steps(sim, steps)
    check(len(sim._scan_cache) == n0, "the timed run compiled a new step")
    return sps


def fluid_state(htf, n, jitter, seed=0):
    """Lattice at rho=0.4 with bounded uniform jitter (no deep overlaps,
    so two force paths can be compared step for step)."""
    import jax.numpy as jnp
    import numpy as np
    sim = htf.Simulation(dt=0.005, integrator=htf.md.NVT(kT=1.0, tau=0.5),
                         seed=seed)
    sim.init_lattice(n, density=0.4, kT_init=1.0)
    rng = np.random.RandomState(seed)
    return dataclasses.replace(
        sim.state, positions=sim.state.positions + jitter * jnp.asarray(
            rng.uniform(-1, 1, (n, 3)).astype(np.float32)))


def one_step_forces(htf, state, model, nlist, mesh=None, steps=1):
    sim = htf.Simulation(dt=0.005, integrator=htf.md.NVT(kT=1.0, tau=0.5),
                         seed=0, mesh=mesh)
    sim.set_state(state)
    tfc = htf.tfcompute(model)
    tfc.attach(sim, r_cut=3.0, nlist=nlist)
    sim.run(steps)
    return sim, tfc


# ----------------------------------------------------------------------
def phase_eval(htf, bench, S, kernel_route, label):
    import jax
    line("== phase 2: eval, LJ PairModel, cellwise, NVT kT=1.5 rho=0.4 "
         f"r_cut=3.0 NN=64, N={S['eval']}")
    t0 = time.perf_counter()
    sim, tfc = bench.equilibrated_fluid(S["eval"], bench.LJ(64), "cellwise",
                                        steps=S["block"])
    line(f"  equilibrated in {time.perf_counter() - t0:.1f} s; plan "
         f"grid {sim._layout.plan.grid} capacity "
         f"{sim._layout.plan.capacity}")
    route = tfc._pair_fast_stencil
    line(f"  route: tfc._pair_fast_stencil = {route!r} "
         f"(expected {kernel_route!r})")
    check(route == kernel_route, "the eval route is not the chosen kernel")
    sim.run(300)
    th = sim.thermo()
    line(f"  after 300 more steps: {th}")
    check(1.1 < th["temperature"] < 1.9, "unhealthy temperature")
    # compile time of the step: a fresh scan with the persistent cache
    # off, minus the same block's steady-state time
    sim._scan_cache.clear()
    cache_on = jax.config.jax_enable_compilation_cache
    jax.config.update("jax_enable_compilation_cache", False)
    t0 = time.perf_counter()
    sim.run(S["block"])
    jax.block_until_ready(sim.state.positions)
    t_first = time.perf_counter() - t0
    jax.config.update("jax_enable_compilation_cache", cache_on)
    t0 = time.perf_counter()
    sim.run(S["block"])
    jax.block_until_ready(sim.state.positions)
    t_steady = time.perf_counter() - t0
    line(f"  compile: first {S['block']}-step block {t_first:.2f} s "
         f"(persistent cache off), steady block {t_steady:.2f} s: "
         f"~{t_first - t_steady:.2f} s to trace and compile the step")
    fn, spec = sim._last_scan
    ma = fn.lower(spec).compile().memory_analysis()
    if ma is not None:
        line("  memory_analysis: " + ", ".join(
            f"{k}={getattr(ma, k)}" for k in (
                "argument_size_in_bytes", "output_size_in_bytes",
                "temp_size_in_bytes", "generated_code_size_in_bytes")
            if hasattr(ma, k)))
    sps = timed_steps(sim, S["timed"])
    stats = jax.devices()[0].memory_stats() or {}
    line(f"  peak_bytes_in_use: {stats.get('peak_bytes_in_use')}")
    line(f"  bring-up reading, not a benchmark: {sps:.2f} steps/s "
         f"({S['timed']} steps) on {label}")
    return sim


def phase_parity(htf, sim, S, kernel_route):
    import jax
    from hoomd_tf_tpu.ops import cellwise as cw
    line(f"== phase 3: kernel parity at the equilibrated N={S['eval']} "
         "slot state vs analytic_pair_forces(stencil='full'), highest "
         "precision")
    layout = sim._layout
    slot_state, aux, _ = layout.pack_jit(sim.state)
    pf = sim.tfc.model.pair_energy_and_slope
    args = (slot_state.positions, slot_state.types, aux["valid"],
            layout.plan, layout.lo, pf)
    with jax.default_matmul_precision("highest"):
        f_ref, w_ref = jax.jit(lambda: cw.analytic_pair_forces(
            *args, stencil="full", needs_virial=True))()
    f_k, w_k = jax.jit(lambda: cw.analytic_pair_forces(
        *args, stencil="pallas", needs_virial=True))()
    compare("half-stencil kernel forces", f_k[:, :3], f_ref[:, :3])
    compare("half-stencil kernel per-particle energy", f_k[:, 3],
            f_ref[:, 3])
    compare("half-stencil kernel virial", w_k, w_ref)

    line(f"  cellwise vs the O(N^2) oracle (nlist='n2', NN=128) at "
         f"N={S['oracle']}, forces after one NVT step")
    import bench
    state = fluid_state(htf, S["oracle"], 0.2)
    ref, _ = one_step_forces(htf, state, bench.LJ(128), "n2")
    cel, tfc = one_step_forces(htf, state, bench.LJ(128), "cellwise")
    line(f"  oracle-check route: {tfc._pair_fast_stencil!r}")
    check(tfc._pair_fast_stencil == kernel_route, "oracle-check route")
    # the CPU test's tolerance (test_forces_match_n2_one_step)
    compare("cellwise vs n2 forces", cel.state.forces[:, :3],
            ref.state.forces[:, :3], rtol=2e-4, atol_rel=2e-5)
    # a trajectory crossing several repacks (one every K steps)
    import numpy as np
    ref, _ = one_step_forces(htf, state, bench.LJ(128), "n2", steps=10)
    cel, _ = one_step_forces(htf, state, bench.LJ(128), "cellwise",
                             steps=10)
    err = wrapped_max_diff(ref.state.positions, cel.state.positions,
                           np.asarray(htf.box_size(state.box)))
    line(f"  positions after 10 NVT steps (repack interval "
         f"{cel._static_K_last}): max |cellwise - n2| = {err:.3e} "
         "(tol 1e-4)")
    check(err < 1e-4, "cellwise trajectory parity vs n2")


def phase_routes(sim, S, kernel_route, label):
    import jax
    line("== phase 4: full step with each force route forced, in turns "
         f"(N={S['eval']}, {S['timed']} steps each, plan pinned)")
    sim.auto_replan = False
    routes = ([kernel_route] if kernel_route != "full" else []) + \
        ["full", "half"]
    order = routes + routes[::-1]
    res = {r: [] for r in routes}
    for r in order:
        sim.pair_stencil = r
        t0 = time.perf_counter()
        sim.run(S["block"])            # compile (first time) + warm
        jax.block_until_ready(sim.state.positions)
        warm = time.perf_counter() - t0
        sps = timed_steps(sim, S["timed"])
        res[r].append(sps)
        line(f"  route {r:6s}: {sps:.2f} steps/s (warm-up block incl. "
             f"any compile {warm:.2f} s)")
    sim.pair_stencil = "auto"
    sim.auto_replan = True
    line("  bring-up readings on " + label + ": " + ", ".join(
        f"{r} {min(v):.2f}-{max(v):.2f} steps/s" for r, v in res.items()))
    return res


def _train_sim(htf, n, block, model, loss):
    import jax.numpy as jnp
    import numpy as np
    sim = htf.Simulation(dt=0.005, integrator=htf.md.Minimize(max_disp=0.05),
                         seed=0)
    sim.scan_block = block
    sim.init_lattice(n, density=0.4, kT_init=1.5)
    rng = np.random.RandomState(0)
    sim.state = dataclasses.replace(
        sim.state, positions=sim.state.positions +
        0.3 * jnp.asarray(rng.randn(n, 3).astype(np.float32)))
    # labels: built-in LJ on the analytic route (reference example 08)
    sim.add_force(htf.md.LennardJones(r_cut=3.0))
    sim.run(60)
    sim.thermalize_velocities(1.5)
    sim.integrator = htf.md.NVT(kT=1.5, tau=0.5)
    sim.run(block)
    model.compile(optimizer="adam", loss=loss, learning_rate=1e-2)
    tfc = htf.tfcompute(model)
    tfc.attach(sim, r_cut=3.0, nlist="cellwise", train=True)
    return sim, tfc


def _check_training(htf, sim, tfc, mv0, pair_fn_of_model, name):
    """Finite losses, and a force-matching error against the built-in LJ
    labels that falls from the initial to the trained weights at ONE
    fixed configuration (the online loss itself rides the fluid's
    fluctuations)."""
    import jax.numpy as jnp
    import numpy as np
    from hoomd_tf_tpu.models.module import get_state, set_state
    from hoomd_tf_tpu.ops import cellwise as cw
    hist = np.asarray(tfc.loss_history, dtype=np.float64)
    check(len(hist) > 0 and np.isfinite(hist).all(),
          f"{name}: non-finite loss")
    layout = sim._layout
    slot_state, aux, _ = layout.pack_jit(sim.state)
    geo = (slot_state.positions, slot_state.types, aux["valid"],
           layout.plan, layout.lo)
    lj = htf.md.LennardJones(r_cut=3.0).pair_energy_and_slope
    f_lab, _ = cw.analytic_pair_forces(*geo, lj, with_types=True,
                                       stencil="full")
    model = tfc.model
    mv1 = get_state(model)

    def error(mv):
        set_state(model, mv)
        f, _ = cw.analytic_pair_forces(*geo, pair_fn_of_model(slot_state),
                                       with_types=True, stencil="full")
        d = (f[:, :3] - f_lab[:, :3]) * aux["valid"][:, None]
        return float(jnp.sum(d * d) / (3.0 * jnp.sum(aux["valid"])))

    e0, e1 = error(mv0), error(mv1)
    set_state(model, mv1)
    line(f"  {name}: {len(hist)} train steps, online loss first "
         f"{hist[0]:.5g} last {hist[-1]:.5g}; force MSE vs LJ labels at "
         f"one fixed configuration: initial weights {e0:.5g} -> trained "
         f"{e1:.5g}")
    check(e1 < e0, f"{name}: training did not reduce the force error")


def phase_train(htf, S, kernel_route, label):
    import jax
    import jax.numpy as jnp
    import numpy as np
    import north_star
    from hoomd_tf_tpu.ops import cellwise as cw, routes
    from hoomd_tf_tpu.ops.pair_train import pair_train_forces
    forces_loss = lambda yt, yp: jnp.mean((yt[:, :3] - yp[:, :3]) ** 2)
    k = S["train_steps"]

    line(f"== phase 5a: online force matching, NN PairModel through the "
         f"Chebyshev proxy (K=16), built-in LJ labels, N={S['train']}")
    from hoomd_tf_tpu.models.module import get_state
    from hoomd_tf_tpu.ops.lane_fast import synthesize_pair_fn
    model = north_star.TrainableNNPair(64, output_forces=False,
                                       proxy_degree=16)
    sim, tfc = _train_sim(htf, S["train"], k, model, forces_loss)
    sim._warmup()                                # builds the weights
    mv0 = get_state(model)
    sps = warm_timed(sim, k)
    line(f"  primal route: {tfc._pair_fast_stencil!r} (expected "
         f"{kernel_route!r}); backward: XLA lane contraction")
    check(tfc._pair_fast_stencil == kernel_route, "train primal route")
    r_cut = sim._layout.plan.r_cut
    _check_training(htf, sim, tfc, mv0, lambda st: (
        lambda r2, ti, tj: model.proxy_pair_fn(r_cut)(r2)),
        "proxy PairModel")
    line(f"  bring-up reading, not a benchmark: {sps:.2f} train-steps/s "
         f"({k} steps) on {label}")

    # the XLA backward alone: forward vs forward+backward of the
    # custom-VJP route at this slot state
    layout = sim._layout
    slot_state, aux, _ = layout.pack_jit(sim.state)
    fit_, eval_ = model.proxy_parts(layout.plan.r_cut)
    coeffs = fit_(model.pair_energy_and_slope)
    labels = jnp.asarray(np.random.RandomState(1).randn(
        layout.plan.n_slots, 4).astype(np.float32))
    geo = (slot_state.positions, slot_state.types, aux["valid"],
           layout.plan, layout.lo)

    def loss_custom(c):
        f4 = pair_train_forces(c, eval_, *geo, needs_energy=False,
                               fwd_stencil=kernel_route)
        return jnp.mean((f4[:, :3] - labels[:, :3]) ** 2)

    fwd = jax.jit(loss_custom)
    both = jax.jit(jax.value_and_grad(loss_custom))
    for f in (fwd, both):
        jax.block_until_ready(f(coeffs))
    ms = {}
    for name, f in (("forward", fwd), ("forward+backward", both)):
        t0 = time.perf_counter()
        for _ in range(20):
            out = f(coeffs)
        jax.block_until_ready(out)
        ms[name] = (time.perf_counter() - t0) / 20 * 1e3
    line(f"  custom-VJP loss at N={S['train']}: forward {ms['forward']:.3f}"
         f" ms, forward+backward {ms['forward+backward']:.3f} ms "
         f"(XLA backward ~{ms['forward+backward'] - ms['forward']:.3f} ms)"
         f" on {label}")
    del sim, tfc

    line(f"== phase 5b: online force matching, generic example-08 SimModel "
         f"(per-lane MLP, trained on forces[:, :3]), N={S['train_generic']}")
    model = north_star.TrainableNN(64, output_forces=False)
    sim, tfc = _train_sim(htf, S["train_generic"], k, model, "mse")
    sim._warmup()
    mv0 = get_state(model)
    sps = warm_timed(sim, k)
    line(f"  lane-fast validated: {tfc._lane_fast_ok}; route "
         f"{getattr(tfc, '_lane_fast_stencil', None)!r}")
    check(tfc._lane_fast_ok, "example-08 model left the analytic route")
    _check_training(htf, sim, tfc, mv0,
                    lambda st: synthesize_pair_fn(model, st.box),
                    "example-08 SimModel")
    line(f"  bring-up reading, not a benchmark: {sps:.2f} train-steps/s "
         f"({k} steps) on {label}")

    line(f"  gradient parity at N={S['train_generic']}: proxy coefficient "
         "gradient of the custom VJP vs jax.grad through the plain forward")
    layout = sim._layout
    slot_state, aux, _ = layout.pack_jit(sim.state)
    from hoomd_tf_tpu.ops.chebyshev import make_pair_proxy
    r_cut = layout.plan.r_cut
    fit_, eval_ = make_pair_proxy(16, (0.25 * r_cut) ** 2, r_cut ** 2)
    coeffs = fit_(lambda r2: htf.md.LennardJones(r_cut=3.0)
                  .pair_energy_and_slope(r2, 0 * r2, 0 * r2))
    labels = jnp.asarray(np.random.RandomState(2).randn(
        layout.plan.n_slots, 4).astype(np.float32))
    geo = (slot_state.positions, slot_state.types, aux["valid"],
           layout.plan, layout.lo)
    stencil = routes.pair_stencil(lambda r2, ti, tj: eval_(coeffs, r2))

    def loss_c(c):
        f4 = pair_train_forces(c, eval_, *geo, fwd_stencil=stencil)
        return jnp.mean((f4 - labels) ** 2)

    def loss_p(c):
        f4, _ = cw.analytic_pair_forces(*geo, lambda r2: eval_(c, r2),
                                        stencil="full")
        return jnp.mean((f4 - labels) ** 2)

    with jax.default_matmul_precision("highest"):
        g_c = jax.jit(jax.grad(loss_c))(coeffs)
        g_p = jax.jit(jax.grad(loss_p))(coeffs)
    gc = np.asarray(jax.tree_util.tree_leaves(g_c))
    gp = np.asarray(jax.tree_util.tree_leaves(g_p))
    # the CPU test's tolerance (tests/test_pair_train.py TestProxyBackward)
    compare("proxy coefficient gradient", gc, gp, rtol=2e-4, atol_rel=2e-5)


def phase_generic(htf, bench, eval_sim, S, label):
    line(f"== phase 6: README quickstart LJ SimModel, nlist='auto' (packed "
         f"cell list, XLA sort selection), NN=128, N={S['generic']}")
    sim = htf.Simulation(dt=0.005, integrator=htf.md.NVT(kT=1.5, tau=0.5),
                         seed=0)
    sim.set_state(eval_sim.state)
    sim.scan_block = S["generic_steps"]
    tfc = htf.tfcompute(bench.LJSim(128))
    tfc.attach(sim, r_cut=3.0, nlist="auto")
    build = sim._make_nlist_builder()
    line(f"  neighbor build: cell list plan (grid, capacity) = "
         f"{getattr(build, 'plan', None)}")
    check(getattr(build, "plan", None) is not None,
          "nlist='auto' did not take the packed cell list")
    t0 = time.perf_counter()
    sim.run(S["generic_steps"])
    line(f"  first {S['generic_steps']} steps (with compile): "
         f"{time.perf_counter() - t0:.1f} s")
    sps = warm_timed(sim, S["generic_steps"])
    line(f"  bring-up reading, not a benchmark: {sps:.2f} steps/s on {label}")
    th = sim.thermo()
    check(1.1 < th["temperature"] < 1.9, f"unhealthy temperature {th}")
    gen, _ = one_step_forces(htf, sim.state, bench.LJSim(128), "auto")
    cel, _ = one_step_forces(htf, sim.state, bench.LJ(128), "cellwise")
    # the packed list takes displacements from absolute coordinates
    # (|x| <= L/2 = 27.8 here, f32 ulp ~2e-6), the cellwise route from
    # cell-relative ones, and the LJ force (~r^-13) amplifies that
    # rounding ~13x: the one-step CPU tolerance (2e-5 x max|F|, at
    # N=256) is replaced by the kernel-parity one
    compare("packed-list SimModel vs cellwise analytic forces",
            gen.state.forces[:, :3], cel.state.forces[:, :3],
            rtol=2e-4, atol_rel=1e-4)


def phase_chip_tests():
    import pytest
    line("== phase 7: the chip-marked tests, in this process")
    rc = pytest.main([os.path.join(ROOT, "tests", "test_chip.py"), "-q",
                      "-m", "chip", "-p", "no:cacheprovider",
                      "--on-device"])
    line(f"  pytest exit code {int(rc)}")
    check(int(rc) == 0, "chip tests failed")


# ----------------------------------------------------------------------
def multichip(htf, bench, S, kernel_route, n_dev):
    import jax
    import numpy as np
    from hoomd_tf_tpu.parallel import make_mesh
    line(f"== multichip: z-slab sharded cellwise engine on {n_dev} devices "
         f"vs one device, LJ PairModel, N={S['shard']}")
    check(len(jax.devices()) == n_dev, f"need {n_dev} devices")
    mesh = make_mesh(n_dev)
    state = fluid_state(htf, S["shard"], 0.08)

    def run5(mesh_):
        sim = htf.Simulation(dt=0.005, integrator=htf.md.NVT(kT=1.0, tau=0.5),
                             seed=0, mesh=mesh_)
        sim.set_state(state)
        tfc = htf.tfcompute(bench.LJ(64))
        tfc.attach(sim, r_cut=3.0, nlist="cellwise")
        sim.run(5)
        jax.block_until_ready(sim.state.positions)
        return sim, tfc

    ref, _ = run5(None)
    shd, tfc = run5(mesh)
    plan = shd._layout.plan
    line(f"  sharded plan grid {plan.grid} capacity {plan.capacity}; route "
         f"{tfc._pair_fast_stencil!r} (expected {kernel_route!r})")
    check(tfc._pair_fast_stencil == kernel_route, "sharded route")
    check(plan.grid[2] % n_dev == 0, "nz not divisible by the mesh")
    lengths = np.asarray(htf.box_size(ref.state.box))
    err = wrapped_max_diff(ref.state.positions, shd.state.positions, lengths)
    line(f"  positions after 5 steps: max |sharded - single| = {err:.3e} "
         "(tol 1e-4)")
    check(err < 1e-4, "sharded cellwise parity")
    slot = shd._packed_cache["vals"][0]
    for name, a in (("slot-state positions (carried between runs)",
                     slot.positions),
                    ("slot-state forces", slot.forces),
                    ("particle-order positions", shd.state.positions),
                    ("particle-order forces", shd.state.forces)):
        line(f"  {name}: {a.sharding}")
        check(len(a.sharding.device_set) == n_dev,
              f"{name} not spread over the mesh")

    line("== multichip: ShardedSimulation (default mesh over all devices)")
    from hoomd_tf_tpu.parallel import ShardedSimulation
    ssim = ShardedSimulation(dt=0.005, seed=1,
                             integrator=htf.md.NVT(kT=1.0, tau=0.5))
    ssim.set_state(state)
    ssim.attach(bench.LJ(64), r_cut=3.0)
    ssim.run(5)
    err = wrapped_max_diff(ref.state.positions, ssim.state.positions,
                           lengths)
    line(f"  {ssim.n_devices} devices; positions after 5 steps vs single "
         f"device: {err:.3e} (tol 1e-4); output sharding "
         f"{ssim.state.positions.sharding}")
    check(err < 1e-4, "ShardedSimulation parity")

    # the NN model's Dense layers would run in TF32 by default; both
    # sides of these comparisons run at full f32
    with jax.default_matmul_precision("highest"):
        _frame_dp_train(htf, S, mesh, n_dev)
        _halo_ring(htf, S, mesh, n_dev)


def _nn_model(htf, nn):
    import __graft_entry__
    return __graft_entry__._flagship(nn)


def _frame_dp_train(htf, S, mesh, n_dev):
    import jax
    import jax.numpy as jnp
    import numpy as np
    import optax
    from hoomd_tf_tpu.models.module import get_state
    from hoomd_tf_tpu.parallel import sharded_train_step
    n = S["frame"]
    line(f"== multichip: one frame-data-parallel sharded_train_step, "
         f"{n_dev} frames of N={n}, vs the same step on one device")
    model = _nn_model(htf, 48)
    rng = np.random.RandomState(0)
    base, lengths = htf.md.lattice_positions(n, density=0.4)
    box = htf.box_from_lengths(lengths)
    nls, p4s = [], []
    for _ in range(n_dev):
        pos = base + 0.05 * rng.randn(n, 3).astype(np.float32)
        p4 = jnp.asarray(np.concatenate(
            [pos, np.zeros((n, 1), np.float32)], axis=1))
        nls.append(htf.compute_nlist(p4, 2.5, 48, lengths, sorted=True,
                                     return_types=True))
        p4s.append(p4)
    nlist_b, pos4_b = jnp.stack(nls), jnp.stack(p4s)
    labels_b = jnp.asarray(rng.randn(n_dev, n, 4).astype(np.float32))
    model.ensure_built([nlist_b[0], pos4_b[0], box])
    values = get_state(model)
    idx = [i for i, v in enumerate(model.variables) if v.trainable]
    params = [values[i] for i in idx]
    opt = optax.adam(1e-3)
    from hoomd_tf_tpu.parallel import make_mesh
    out = {}
    for name, m in (("sharded", mesh), ("one device", make_mesh(1))):
        step = sharded_train_step(model, opt, m)
        loss, new_params, _ = jax.jit(step)(
            params, values, opt.init(params), nlist_b, pos4_b, box,
            labels_b)
        jax.block_until_ready(loss)
        out[name] = (float(loss), new_params)
        line(f"  {name}: loss {float(loss):.6g}; loss sharding "
             f"{loss.sharding}")
    d = abs(out["sharded"][0] - out["one device"][0])
    line(f"  loss difference {d:.3e} (tol 1e-5 x loss)")
    check(np.isfinite(out["sharded"][0]), "non-finite sharded loss")
    check(d <= 1e-5 * abs(out["one device"][0]), "frame-DP loss parity")
    for a, b in zip(jax.tree_util.tree_leaves(out["sharded"][1]),
                    jax.tree_util.tree_leaves(out["one device"][1])):
        compare("  updated parameter", a, b, rtol=1e-4, atol_rel=1e-4)


def _halo_ring(htf, S, mesh, n_dev):
    import jax
    import jax.numpy as jnp
    import numpy as np
    from hoomd_tf_tpu.models.module import functional_call, get_state
    from hoomd_tf_tpu.parallel import domain_decompose, halo_force_fn
    n = S["ring"]
    line(f"== multichip: halo_force_fn ppermute ring, N={n}, vs the "
         "O(N^2) single-device forces of the same model")
    st = fluid_state(htf, n, 0.08)
    hpos4, hbox = np.asarray(st.positions4), st.box
    perm, counts = domain_decompose(hpos4, hbox, n_dev, r_cut=2.5)
    cmax = int(counts.max())
    slabs, offs = [], 0
    hp = hpos4[perm]
    for c in counts:
        pad = np.full((cmax - c, 4), np.nan, np.float32)
        slabs.append(np.concatenate([hp[offs:offs + c], pad], axis=0))
        offs += c
    model = _nn_model(htf, 48)
    nlist0 = htf.compute_nlist(jnp.asarray(hpos4), 2.5, 48,
                               htf.box_size(hbox), sorted=True,
                               return_types=True)
    inputs = [nlist0, jnp.asarray(hpos4), hbox]
    model.ensure_built(inputs)
    halo_fn = halo_force_fn(model, 2.5, mesh,
                            halo_capacity=max(2048, n // 2))
    f_halo, ovf, _ = jax.jit(halo_fn)(
        get_state(model), jnp.asarray(np.concatenate(slabs, 0)), hbox)
    jax.block_until_ready(f_halo)
    line(f"  halo overflow {bool(ovf)}; output sharding {f_halo.sharding}")
    check(not bool(ovf), "halo overflow")
    (f_ref,), _ = functional_call(model, list(get_state(model)),
                                  lambda: model(inputs))
    rows = np.concatenate([np.arange(i * cmax, i * cmax + c)
                           for i, c in enumerate(counts)])
    compare("halo-ring forces vs single device",
            np.asarray(f_halo)[rows][:, :3],
            np.asarray(f_ref)[perm][:, :3])


# ----------------------------------------------------------------------
def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--multichip", action="store_true",
                   help="four devices: run only the sharded paths and "
                        "what they are compared with")
    p.add_argument("--rehearse", action="store_true",
                   help="CPU rehearsal at tiny sizes (never the default)")
    args = p.parse_args(argv)
    n_dev = 4 if args.multichip else 1
    if args.rehearse:
        os.environ.setdefault("JAX_PLATFORMS", "cpu")
        if args.multichip:
            os.environ["XLA_FLAGS"] = (
                os.environ.get("XLA_FLAGS", "") +
                " --xla_force_host_platform_device_count=4").strip()
    sys.path[:0] = [ROOT, os.path.join(ROOT, "benchmarks")]

    import jax
    import hoomd_tf_tpu as htf
    from hoomd_tf_tpu.utils.compile_cache import enable_compile_cache
    from hoomd_tf_tpu.utils.device import gpu_name_and_power_limit
    import bench

    # ---- phase 1: device --------------------------------------------
    devs = jax.devices()
    platform, kind = devs[0].platform, devs[0].device_kind
    line(f"== phase 1: device\n  jax {jax.__version__}; devices {devs}; "
         f"device_kind {kind!r}; count {len(devs)}")
    if platform != "gpu" and not args.rehearse:
        print(f"chip_smoke: no GPU found (platform {platform!r}); "
              "use --rehearse for a CPU rehearsal", file=sys.stderr)
        return 1
    smi = gpu_name_and_power_limit()
    line(f"  nvidia-smi name, power.limit: {smi}")
    if args.rehearse:
        line(f"  REHEARSAL on platform {platform!r}: tiny sizes, Pallas "
             "interpreted; no number here is a device measurement")
    label = smi or f"{platform} (rehearsal)"
    line(f"  compile cache: {enable_compile_cache()}")
    S = REHEARSE if args.rehearse else FULL
    kernel_route = "pallas"   # the half-stencil kernel is this PR's route
    if platform != "gpu":
        kernel_route = "full"  # routes.pair_stencil off the GPU

    if args.multichip:
        multichip(htf, bench, S, kernel_route, n_dev)
    else:
        sim = phase_eval(htf, bench, S, kernel_route, label)
        phase_parity(htf, sim, S, kernel_route)
        phase_routes(sim, S, kernel_route, label)
        phase_generic(htf, bench, sim, S, label)
        del sim
        phase_train(htf, S, kernel_route, label)
        phase_chip_tests()
    print(json.dumps({"ok": True, "device": {
        "platform": platform, "kind": kind, "count": len(devs)}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
