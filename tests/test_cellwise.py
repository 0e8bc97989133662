"""Slot-resident (cellwise) neighbor mode: plan, plane correctness vs the
O(N^2) oracle, trajectory parity, rebuilds, overflow, NVT dof, training.

Reference bar: the cell-list path must match the dense path exactly --
the analog of the reference's MPI-decomposition force-match test
(`test_mpi_tensorflow.py:57-79`: same forces under any decomposition).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import hoomd_tf_tpu as htf
from hoomd_tf_tpu.ops import cellwise as cw
from hoomd_tf_tpu.md.slots import SlotLayout
import zoo


def fluid_sim(n=512, density=0.25, seed=0, integrator=None, kT_init=1.0,
              jitter=0.2):
    """Jittered lattice with *bounded* jitter: unbounded Gaussian jitter
    creates deep LJ overlaps (|F| ~ 1e5) whose chaos amplifies f32
    rounding noise to full trajectory decorrelation within ~10 steps,
    which would make any two bitwise-different-but-correct force paths
    impossible to compare."""
    sim = htf.Simulation(dt=0.005,
                         integrator=integrator or htf.md.NVE(), seed=seed)
    sim.init_lattice(n, density=density, kT_init=kT_init)
    rng = np.random.RandomState(seed)
    sim.state = dataclasses.replace(
        sim.state, positions=sim.state.positions +
        jitter * jnp.asarray(rng.uniform(-1, 1, (n, 3)).astype(np.float32)))
    return sim


class LJ(htf.SimModel):
    def compute(self, nlist, positions, box):
        rinv = htf.nlist_rinv(nlist)
        inv_r6 = rinv ** 6
        p_energy = 4.0 / 2.0 * (inv_r6 * inv_r6 - inv_r6)
        energy = jnp.sum(p_energy, axis=1)
        return htf.compute_nlist_forces(nlist, energy)


class TrainablePlanes(htf.SimModel):
    """Trainable LJ written against the planes-compatible helpers (the
    cellwise mode hands the model NlistPlanes, not a packed array)."""

    def setup(self):
        self.lj = zoo.LJLayer(1.0, 1.0)

    def compute(self, nlist, positions, box):
        rinv = htf.nlist_rinv(nlist)
        r = htf.divide_no_nan(1.0, rinv)
        energy = jnp.sum(self.lj(r), axis=1)
        return htf.compute_nlist_forces(nlist, energy)


def assert_wrapped_close(a, b, lengths, atol):
    """Compare positions modulo the periodic box (a trajectory that ends
    epsilon before a boundary in one run and epsilon after it in the other
    differs by ~L in raw coordinates)."""
    d = np.asarray(a) - np.asarray(b)
    L = np.asarray(lengths)
    d = d - np.round(d / L) * L
    np.testing.assert_allclose(d, np.zeros_like(d), atol=atol)


class TestPlan:
    def test_plan_basics(self):
        plan = cw.plan_cellwise(512, [12.0, 12.0, 12.0], 3.0)
        assert plan is not None
        assert all(d >= 3 for d in plan.grid)
        assert min(plan.edges) >= 3.0
        assert plan.n_slots == plan.n_cells * plan.capacity
        assert plan.width == 27 * plan.capacity
        assert plan.skin >= 0

    def test_plan_too_small(self):
        assert cw.plan_cellwise(8, [5.0, 5.0, 5.0], 3.0) is None

    def test_plan_honors_config(self):
        cfg = htf.Cellwise(capacity=11, skin=0.5)
        plan = cw.plan_cellwise(512, [24.0, 24.0, 24.0], 3.0, config=cfg)
        assert plan.capacity == 11
        assert min(plan.edges) >= 3.5

    def test_plan_minimizes_work(self):
        """With measured positions the planner prefers the grid with the
        least pair work, not just the finest grid."""
        rng = np.random.RandomState(0)
        pos = rng.uniform(-12, 12, size=(2000, 3)).astype(np.float32)
        plan = cw.plan_cellwise(2000, [24.0] * 3, 3.0, positions=pos)
        assert plan is not None
        work = cw.pair_lanes(2000, plan.n_cells, plan.capacity, "full")
        # the finest grid (floor(24/3) = 8 cells/axis) is one candidate,
        # with the planner's capacity rule (measured max or fluctuation
        # estimate, + 3); whatever was picked must execute no more lanes
        occ_max, mean, _ = cw._measured_occupancy(
            pos, [-12.0] * 3, [24.0] * 3, (8, 8, 8))
        est = int(np.ceil(mean + np.sqrt(2.0 * np.log(8 ** 3 * 100.0)) *
                          np.sqrt(0.9 * mean)))
        fine_cap = max(occ_max, est) + 3
        assert work <= cw.pair_lanes(2000, 8 ** 3, fine_cap, "full")

    @pytest.mark.parametrize("stencil", ["full", "half", "pallas"])
    def test_plan_cost_follows_route(self, stencil):
        """Every route's cost model yields a valid plan whose capacity
        covers the measured occupancy."""
        rng = np.random.RandomState(0)
        pos = rng.uniform(-12, 12, size=(2000, 3)).astype(np.float32)
        plan = cw.plan_cellwise(2000, [24.0] * 3, 3.0, positions=pos,
                                stencil=stencil)
        assert plan is not None and all(d >= 3 for d in plan.grid)
        occ_max, _, _ = cw._measured_occupancy(
            pos, [-12.0] * 3, [24.0] * 3, plan.grid)
        assert plan.capacity >= occ_max

    def test_occ_observed_tightens_capacity(self):
        """A measured running max well below the statistical estimate
        shrinks the planned capacity (and never below the observation)."""
        rng = np.random.RandomState(1)
        pos = rng.uniform(-12, 12, size=(4096, 3)).astype(np.float32)
        blind = cw.plan_cellwise(4096, [24.0] * 3, 3.0, positions=pos)
        occ_max, _, _ = cw._measured_occupancy(
            pos, [-12.0] * 3, [24.0] * 3, blind.grid)
        cal = cw.plan_cellwise(4096, [24.0] * 3, 3.0, positions=pos,
                               occ_observed=(blind.grid, occ_max))
        assert cal.capacity <= blind.capacity
        # on the same grid the calibrated capacity still covers the
        # observation with margin
        if cal.grid == blind.grid:
            assert cal.capacity >= occ_max + 1


class TestPlanesCorrectness:
    @pytest.mark.slow
    def test_planes_match_oracle(self):
        """Per-particle neighbor distance multisets from the cellwise
        planes equal the dense O(N^2) oracle's."""
        n, r_cut = 256, 3.0
        sim = fluid_sim(n=n, density=0.3)
        state = sim.state
        lengths = np.asarray(htf.box_size(state.box))
        lo = np.asarray(state.box[0])
        plan = cw.plan_cellwise(n, lengths, r_cut,
                                positions=np.asarray(state.positions),
                                lo=lo)
        layout = SlotLayout(plan, n, lo)
        slot_state, aux, _ = layout.pack(state)
        planes = layout.planes(slot_state, aux)
        # oracle: dense nlist with plenty of neighbor room
        nl = htf.compute_nlist(state.positions4, r_cut, 128,
                               lengths, sorted=True, return_types=True)
        r_oracle = np.asarray(jnp.linalg.norm(nl[:, :, :3], axis=-1))
        r2p = np.asarray(planes.r2())
        orig = np.asarray(aux["orig"])
        for s in range(plan.n_slots):
            i = orig[s]
            if i >= n:
                assert not np.any(r2p[s] > 0)  # ghost rows all zero
                continue
            mine = np.sort(np.sqrt(r2p[s][r2p[s] > 0]))
            ref = np.sort(r_oracle[i][r_oracle[i] > 0])
            np.testing.assert_allclose(mine, ref, rtol=1e-5, atol=1e-5)

    def test_half_stencil_matches_full(self):
        """The Newton's-third-law half stencil (14 blocks, each pair
        evaluated once with dual-sided accumulation) reproduces the full
        27-block stencil: forces, per-particle energy and virial."""
        n, r_cut = 256, 2.5
        sim = fluid_sim(n=n, density=0.35, seed=7)
        state = sim.state
        types = jnp.asarray(np.arange(n) % 2, dtype=jnp.int32)
        state = dataclasses.replace(state, types=types)
        lengths = np.asarray(htf.box_size(state.box))
        lo = np.asarray(state.box[0])
        plan = cw.plan_cellwise(n, lengths, r_cut,
                                positions=np.asarray(state.positions),
                                lo=lo)
        layout = SlotLayout(plan, n, lo)
        slot_state, aux, _ = layout.pack(state)

        def lj(r2, ti, tj):
            u = 1.0 / r2
            sr6 = u * u * u
            eps = jnp.where((ti == 0) & (tj == 0), 1.0, 0.5)
            return (4.0 * eps * (sr6 * sr6 - sr6),
                    -12.0 * eps * (2.0 * sr6 - 1.0) * sr6 * u)

        for rc_matrix in (None,
                          np.array([[2.5, 1.8], [1.8, 2.2]],
                                   dtype=np.float32)):
            args = (slot_state.positions, slot_state.types, aux["valid"],
                    plan, layout.lo, lj)
            kw = dict(needs_virial=True, with_types=True,
                      rcut_matrix=rc_matrix)
            f_half, w_half = cw.analytic_pair_forces(
                *args, stencil="half", **kw)
            f_full, w_full = cw.analytic_pair_forces(
                *args, stencil="full", **kw)
            np.testing.assert_allclose(np.asarray(f_half),
                                       np.asarray(f_full),
                                       rtol=1e-4, atol=1e-4)
            np.testing.assert_allclose(np.asarray(w_half),
                                       np.asarray(w_full),
                                       rtol=1e-4, atol=1e-4)
            # ghost rows are exactly zero
            gh = np.asarray(aux["valid"]) == 0
            assert np.all(np.asarray(f_half)[gh] == 0)
            # Newton: net force cancels pairwise (bit-exact per pair, so
            # only the final summation rounding remains)
            net = np.abs(np.asarray(f_half)[:, :3].sum(axis=0)).max()
            assert net < 1e-2, net

    def test_ghost_forces_finite_for_steep_potentials(self):
        """Co-resident ghost slots must never NaN-poison force rows.

        A uniform FAR push placed every ghost of a cell at the same
        point, so ghost<->ghost lanes evaluated the pair function at the
        min_r2 clamp; a slope steeper than LJ overflows f32 to inf
        there and ``inf * (dx = 0) = NaN`` landed on ghost rows (masked
        to NaN, not zero, by the validity multiply). The rank-scaled
        FAR push (ops/cellwise._relative_coords) keeps every ghost pair
        distance-masked; this locks that in with an r^-24-class slope
        and a tiny clamp, for both the XLA forms and the kernel."""
        n, r_cut = 96, 2.5
        sim = fluid_sim(n=n, density=0.2, seed=3)
        state = sim.state
        lengths = np.asarray(htf.box_size(state.box))
        lo = np.asarray(state.box[0])
        plan = cw.plan_cellwise(n, lengths, r_cut,
                                positions=np.asarray(state.positions),
                                lo=lo)
        layout = SlotLayout(plan, n, lo)
        slot_state, aux, _ = layout.pack(state)
        # every cell has ghost slots; at least one has >= 2 (asserted)
        occ = np.asarray(aux["valid"]).reshape(plan.n_cells,
                                               plan.capacity).sum(axis=1)
        assert (plan.capacity - occ.max()) >= 2

        def steep(r2):
            u = 1.0 / r2
            s12 = (u * u * u) ** 4          # r^-24: overflows at tiny r2
            return s12, -12.0 * s12 * u

        args = (slot_state.positions, slot_state.types, aux["valid"],
                plan, layout.lo, steep)
        gh = np.asarray(aux["valid"]) == 0
        for stencil in ("full", "half", "pallas"):
            f, w = cw.analytic_pair_forces(
                *args, stencil=stencil, min_r2=1e-8, needs_virial=True)
            f = np.asarray(f)
            assert np.isfinite(f).all(), stencil
            assert np.all(f[gh] == 0), stencil
            assert np.isfinite(np.asarray(w)).all(), stencil

    def test_pallas_kernel_matches_xla(self):
        """The Triton-route half-stencil kernel (interpreter mode on
        CPU) reproduces the XLA full stencil: forces, energy, virial,
        typed cutoff matrix."""
        n, r_cut = 120, 2.5
        sim = fluid_sim(n=n, density=0.2, seed=11)
        state = dataclasses.replace(
            sim.state, types=jnp.asarray(np.arange(n) % 2, jnp.int32))
        lengths = np.asarray(htf.box_size(state.box))
        lo = np.asarray(state.box[0])
        plan = cw.plan_cellwise(n, lengths, r_cut,
                                positions=np.asarray(state.positions),
                                lo=lo)
        layout = SlotLayout(plan, n, lo)
        slot_state, aux, _ = layout.pack(state)

        def lj(r2, ti, tj):
            u = 1.0 / r2
            sr6 = u * u * u
            eps = jnp.where((ti == 0) & (tj == 0), 1.0, 0.5)
            return (4.0 * eps * (sr6 * sr6 - sr6),
                    -12.0 * eps * (2.0 * sr6 - 1.0) * sr6 * u)

        for rc_matrix in (None,
                          np.array([[2.5, 1.8], [1.8, 2.2]],
                                   dtype=np.float32)):
            args = (slot_state.positions, slot_state.types, aux["valid"],
                    plan, layout.lo, lj)
            kw = dict(needs_virial=True, with_types=True,
                      rcut_matrix=rc_matrix)
            f_ref, w_ref = cw.analytic_pair_forces(
                *args, stencil="full", **kw)
            from hoomd_tf_tpu.ops.cellwise_pallas import \
                half_stencil_pair_forces
            f_pl, w_pl = half_stencil_pair_forces(
                *args, interpret=True, **kw)
            np.testing.assert_allclose(np.asarray(f_pl),
                                       np.asarray(f_ref),
                                       rtol=1e-4, atol=1e-4)
            np.testing.assert_allclose(np.asarray(w_pl),
                                       np.asarray(w_ref),
                                       rtol=1e-4, atol=1e-4)

    @pytest.mark.slow
    def test_pack_unpack_roundtrip(self):
        n = 128
        sim = fluid_sim(n=n, density=0.3, kT_init=1.0)
        state = sim.state
        lengths = np.asarray(htf.box_size(state.box))
        lo = np.asarray(state.box[0])
        plan = cw.plan_cellwise(n, lengths, 2.0,
                                positions=np.asarray(state.positions),
                                lo=lo)
        layout = SlotLayout(plan, n, lo)
        extra = jnp.arange(n * 4, dtype=jnp.float32).reshape(n, 4)
        slot_state, aux, (pex,) = layout.pack(state, (extra,))
        # ghosts parked + inert
        valid = np.asarray(aux["valid"])
        sp = np.asarray(slot_state.positions)
        sv = np.asarray(slot_state.velocities)
        centers = np.asarray(layout.centers(jnp.float32))
        assert np.all(sv[valid == 0] == 0)
        np.testing.assert_allclose(sp[valid == 0], centers[valid == 0])
        back, (bex,) = layout.unpack(slot_state, aux, (pex,))
        np.testing.assert_allclose(np.asarray(back.positions),
                                   np.asarray(state.positions))
        np.testing.assert_allclose(np.asarray(back.velocities),
                                   np.asarray(state.velocities))
        np.testing.assert_array_equal(np.asarray(back.types),
                                      np.asarray(state.types))
        np.testing.assert_allclose(np.asarray(bex), np.asarray(extra))
        assert "dof" not in back.thermostat


class TestSimulationParity:
    @pytest.mark.slow
    def test_forces_match_n2_one_step(self):
        n = 256
        ref = fluid_sim(n=n)
        cwse = fluid_sim(n=n)
        m1, m2 = LJ(64), LJ(64)
        htf.tfcompute(m1).attach(ref, r_cut=3.0, nlist="n2")
        htf.tfcompute(m2).attach(cwse, r_cut=3.0, nlist="cellwise")
        ref.run(1)
        cwse.run(1)
        np.testing.assert_allclose(np.asarray(cwse.state.forces),
                                   np.asarray(ref.state.forces),
                                   rtol=2e-4, atol=2e-5)

    @pytest.mark.slow
    def test_trajectory_parity_with_rebuilds(self):
        """Multi-step NVE parity vs the dense path, crossing at least one
        repack (the analog of the reference's exact-match-under-
        decomposition bar, test_mpi_tensorflow.py:57-79)."""
        n = 256
        ref = fluid_sim(n=n, kT_init=0.8, seed=3)
        cwse = fluid_sim(n=n, kT_init=0.8, seed=3)
        htf.tfcompute(LJ(64)).attach(ref, r_cut=2.5, nlist="n2")
        tfc = htf.tfcompute(LJ(64))
        tfc.attach(cwse, r_cut=2.5,
                   nlist=htf.Cellwise(skin=0.3))
        # pin the static repack interval to 5 so the 15-step run crosses
        # two MID-RUN rebuilds deterministically. Kept short
        # deliberately: each rebuild reorders f32 summation
        # (physics-neutral, oracle-checked in TestPlanesCorrectness),
        # and LJ chaos amplifies that ~1e-7 seed by e^(lambda t) -- at
        # 25 steps it already exceeds any meaningful tolerance.
        cwse._choose_repack_interval = lambda layout: 5
        ref.run(15)
        cwse.run(15)
        assert_wrapped_close(cwse.state.positions, ref.state.positions,
                             htf.box_size(ref.state.box), atol=2e-3)
        np.testing.assert_allclose(np.asarray(cwse.state.velocities),
                                   np.asarray(ref.state.velocities),
                                   rtol=1e-2, atol=2e-3)

    def test_static_repack_moves_forces_with_particles(self):
        """A rebuild before every step (static interval 1): the first
        half-kick after a repack must read each particle's own force, so
        the velocities follow the dense path to rounding. (Forces left in
        the old slot order kick every particle that changed cell with
        another slot's force: ~1e-1 off here.)"""
        n = 256
        ref = fluid_sim(n=n, density=0.4, kT_init=1.5, seed=3)
        cwse = fluid_sim(n=n, density=0.4, kT_init=1.5, seed=3)
        htf.tfcompute(LJ(64)).attach(ref, r_cut=2.5, nlist="n2")
        htf.tfcompute(LJ(64)).attach(cwse, r_cut=2.5, nlist="cellwise")
        cwse._choose_repack_interval = lambda layout: 1
        ref.run(6)
        cwse.run(6)
        # rounding, amplified by six steps of a dense fluid: ~5e-5
        np.testing.assert_allclose(np.asarray(cwse.state.velocities),
                                   np.asarray(ref.state.velocities),
                                   atol=5e-4)

    @pytest.mark.slow
    def test_nvt_temperature_dof(self):
        """NVT thermostat must count only real degrees of freedom (ghost
        rows would otherwise dilute the temperature)."""
        n = 512
        sim = fluid_sim(n=n, integrator=htf.md.NVT(kT=1.1, tau=0.5),
                        kT_init=1.1, jitter=0.1)
        htf.tfcompute(LJ(48)).attach(sim, r_cut=2.5, nlist="cellwise")
        # 400 steps = 4 thermostat taus: the diluted-dof bug drives T
        # toward ~0.55 well within that (starts AT the 1.1 target, so
        # a correct run only has to hold it) -- 900 steps measured the
        # same verdict at 2x the single-core wall time
        sim.run(400)
        t = sim.thermo()["temperature"]
        # without the thermostat['dof'] fix the ghost rows dilute dof by
        # the slots/N ratio (~2x here) and T settles far from the target
        assert abs(t - 1.1) < 0.2, t

    @pytest.mark.slow
    def test_langevin_ghosts_inert(self):
        n = 256
        sim = fluid_sim(n=n, integrator=htf.md.Langevin(kT=1.0, gamma=1.0),
                        kT_init=1.0)
        htf.tfcompute(LJ(48)).attach(sim, r_cut=2.5, nlist="cellwise")
        sim.run(20)
        assert np.all(np.isfinite(np.asarray(sim.state.positions)))
        # velocities stay thermal, not inflated by phantom rows
        t = sim.thermo()["temperature"]
        assert 0.3 < t < 3.0, t

    @pytest.mark.slow
    def test_thermo_log_matches_n2(self):
        n = 256
        ref = fluid_sim(n=n, kT_init=0.7, seed=5)
        cwse = fluid_sim(n=n, kT_init=0.7, seed=5)
        htf.tfcompute(LJ(64)).attach(ref, r_cut=2.5, nlist="n2")
        htf.tfcompute(LJ(64)).attach(cwse, r_cut=2.5, nlist="cellwise")
        ref.run(6, log_period=2)
        cwse.run(6, log_period=2)
        for k in ("kinetic_energy", "potential_energy", "temperature",
                  "pressure"):
            np.testing.assert_allclose(cwse.log[k], ref.log[k],
                                       rtol=5e-4, atol=1e-4,
                                       err_msg=k)

    @pytest.mark.slow
    def test_overflow_raises(self):
        # with auto_replan off the overflow is a hard error; with it on
        # (the default) run() self-heals -- see
        # test_md.py::TestViolentStarts::test_capacity_overflow_self_heals
        n = 256
        sim = fluid_sim(n=n)
        sim.auto_replan = False
        tfc = htf.tfcompute(LJ(48))
        tfc.attach(sim, r_cut=2.5, nlist=htf.Cellwise(capacity=1))
        with pytest.raises(ValueError, match="capacity"):
            sim.run(2)

    def test_incompatible_with_batching(self):
        sim = fluid_sim(n=256)
        tfc = htf.tfcompute(LJ(48))
        with pytest.raises(ValueError, match="incompatible"):
            tfc.attach(sim, r_cut=2.5, nlist="cellwise", batch_size=64)

    @pytest.mark.slow
    def test_get_nlist_array(self):
        sim = fluid_sim(n=256)
        tfc = htf.tfcompute(LJ(48))
        tfc.attach(sim, r_cut=2.5, nlist="cellwise")
        sim.run(1)
        nl = tfc.get_nlist_array()
        assert nl.ndim == 3 and nl.shape[-1] == 4
        layout = sim._ensure_layout()
        assert nl.shape[0] == layout.plan.n_slots

    @pytest.mark.slow
    def test_model_forces_persist_through_period(self):
        """period > 1: stale model forces follow their particles through
        repacks (same physics as nlist='n2')."""
        n = 256
        ref = fluid_sim(n=n, kT_init=0.8, seed=7)
        cwse = fluid_sim(n=n, kT_init=0.8, seed=7)
        htf.tfcompute(LJ(64)).attach(ref, r_cut=2.5, nlist="n2", period=3)
        htf.tfcompute(LJ(64)).attach(cwse, r_cut=2.5,
                                     nlist=htf.Cellwise(skin=0.3),
                                     period=3)
        ref.run(20)
        cwse.run(20)
        assert_wrapped_close(cwse.state.positions, ref.state.positions,
                             htf.box_size(ref.state.box), atol=2e-3)


class TestTraining:
    @pytest.mark.slow
    def test_mapped_nlist_on_cellwise(self):
        """enable_mapped_nlist + nlist='cellwise' (VERDICT round-2 item
        3): the model sees particle-order planes, bead rows follow the
        mapping, and forces match the packed 'cell' mode."""
        import zoo

        class AAForces(htf.SimModel):
            def compute(self, nlist, positions, box):
                aa_nlist, cg_nlist = self.mapped_nlist(nlist)
                rinv = htf.nlist_rinv(aa_nlist)
                return htf.compute_nlist_forces(
                    aa_nlist, jnp.sum(rinv, axis=1))

        def build(nlist_mode, n=216):
            sim = htf.Simulation(dt=0.001, seed=9,
                                 integrator=htf.md.NVE())
            sim.init_lattice(n, a=1.5, kT_init=0.5)
            model = AAForces(24)
            tfc = htf.tfcompute(model)
            tfc.enable_mapped_nlist(sim, zoo.MappedNlist.my_map)
            tfc.attach(sim, r_cut=2.5, nlist=nlist_mode)
            sim.run(10)
            return sim, tfc

        s_cw, t_cw = build("cellwise")
        s_cell, t_cell = build("cell")
        n = 216
        # bead rows carry the mapping (bead 0 = AA centroid) and no force
        pos = np.asarray(s_cw.state.positions)
        np.testing.assert_allclose(pos[n], pos[:n].mean(axis=0),
                                   atol=1e-4)
        f_cw = t_cw.get_forces_array()
        np.testing.assert_allclose(f_cw[n:], 0.0)
        # trajectory parity with the packed mode
        lengths = np.asarray(htf.box_size(s_cell.state.box))
        assert_wrapped_close(s_cw.state.positions,
                             s_cell.state.positions, lengths, 2e-4)
        np.testing.assert_allclose(f_cw, t_cell.get_forces_array(),
                                   rtol=5e-4, atol=5e-4)

    def test_mapped_train_on_cellwise_raises(self):
        import zoo
        sim = fluid_sim(n=125, density=0.25)
        model = TrainablePlanes(16, output_forces=False)
        model.compile(optimizer="adam", loss="mse")
        tfc = htf.tfcompute(model)
        tfc.enable_mapped_nlist(sim, zoo.MappedNlist.my_map)
        lj = sim.add_force(htf.md.LennardJones(r_cut=2.0))
        tfc.attach(sim, r_cut=2.0, nlist="cellwise", train=True)
        with pytest.raises(ValueError, match="mapped"):
            sim.run(2)

    @pytest.mark.slow
    def test_pair_model_train_fast_converges(self):
        """Trainable PairModel parameters learn through the analytic
        training route (the differentiable XLA stencil; no
        capture-replay anywhere) -- a mistuned epsilon recovers the
        label potential's value."""
        class TrainLJ(htf.PairModel):
            def setup(self):
                self.log_eps = self.add_weight(
                    shape=(), initializer=float(np.log(0.5)))

            def pair_energy(self, r2):
                u = 1.0 / r2
                sr6 = u * u * u
                return (4.0 * jnp.exp(self.log_eps.value) *
                        (sr6 * sr6 - sr6))

        sim = fluid_sim(n=256, kT_init=1.0,
                        integrator=htf.md.NVT(kT=1.0, tau=0.5))
        lj = sim.add_force(htf.md.LennardJones(epsilon=1.0, sigma=1.0,
                                               r_cut=2.5))
        m = TrainLJ(32)
        m.compile(optimizer="adam", loss="mse", learning_rate=5e-2)
        tfc = htf.tfcompute(m)
        tfc.attach(sim, r_cut=2.5, nlist="cellwise", train=True)
        sim.run(80)
        losses = np.asarray(tfc.loss_history)
        eps = float(np.exp(np.asarray(m.log_eps.value)))
        assert np.mean(losses[-10:]) < 0.25 * np.mean(losses[:10])
        assert abs(eps - 1.0) < 0.15, eps

    @pytest.mark.slow
    def test_online_training_runs(self):
        """hoomd2tf (training) mode in cellwise: loss decreases while the
        built-in LJ drives the dynamics."""
        n = 256
        sim = fluid_sim(n=n, kT_init=0.8,
                        integrator=htf.md.Langevin(kT=0.8, gamma=1.0))
        lj = sim.add_force(htf.md.LennardJones(epsilon=1.0, sigma=1.0,
                                               r_cut=2.5))
        model = TrainablePlanes(48, output_forces=False)
        model.lj.w.assign(jnp.asarray([0.6, 1.3]))
        model.compile(optimizer="adam", loss="mse", learning_rate=5e-2)
        tfc = htf.tfcompute(model)
        tfc.attach(sim, r_cut=2.5, nlist="cellwise", train=True)
        tfc.set_reference_forces(lj)
        sim.run(60)
        losses = tfc.loss_history
        assert len(losses) == 60
        assert np.mean(losses[-10:]) < np.mean(losses[:10])
