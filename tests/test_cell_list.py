"""Cell-list neighbor build cross-checked against the dense O(N^2) build
(the reference's nlist cross-oracle pattern, test_utils.py:401-430)."""

import pytest
import jax.numpy as jnp
import numpy as np

import hoomd_tf_tpu as htf
import zoo


def random_system(n, L, seed=0, ntypes=2):
    rng = np.random.RandomState(seed)
    pos = (rng.rand(n, 3) * L - L / 2).astype(np.float32)
    types = (rng.randint(0, ntypes, n)).astype(np.float32)
    return np.concatenate([pos, types[:, None]], axis=1)


def sets_from_nlist(nlist):
    """Per-particle neighbor sets as (rounded displacement tuples)."""
    out = []
    for i in range(nlist.shape[0]):
        s = set()
        for k in range(nlist.shape[1]):
            row = nlist[i, k]
            if np.any(row[:3] != 0):
                s.add(tuple(np.round(row, 4)))
        out.append(s)
    return out


class TestCellListCrossCheck:
    def test_matches_n2(self):
        n, L, r_cut, NN = 400, 12.0, 3.0, 48
        pos4 = jnp.asarray(random_system(n, L))
        dense = np.asarray(htf.compute_nlist(
            pos4, r_cut, NN, [L, L, L], sorted=True, return_types=True))
        cell = np.asarray(htf.cell_list_nlist(
            pos4, r_cut, NN, jnp.asarray([L, L, L])))
        a = sets_from_nlist(dense)
        b = sets_from_nlist(cell)
        for i in range(n):
            assert a[i] == b[i], f"particle {i}"

    def test_sorted_ascending(self):
        # ordering is approximate to ~2^-13 relative (the sort key packs the
        # candidate slot into the distance's low mantissa bits); exact set
        # membership is covered by test_matches_n2
        n, L, r_cut, NN = 200, 10.0, 3.0, 32
        pos4 = jnp.asarray(random_system(n, L, seed=3))
        cell = np.asarray(htf.cell_list_nlist(
            pos4, r_cut, NN, jnp.asarray([L, L, L])))
        for i in range(n):
            rs = np.linalg.norm(cell[i, :, :3], axis=-1)
            rs = rs[rs > 0]
            assert np.all(np.diff(rs) >= -1e-3 * np.maximum(rs[1:], 1.0))

    @pytest.mark.slow
    def test_overflow_flag(self):
        n, L, r_cut, NN = 100, 9.0, 3.0, 32
        pos4 = jnp.asarray(random_system(n, L, seed=4))
        _, overflow = htf.cell_list_nlist(
            pos4, r_cut, NN, jnp.asarray([L, L, L]),
            config=htf.CellList(capacity=2), return_overflow=True)
        assert bool(overflow)
        _, overflow = htf.cell_list_nlist(
            pos4, r_cut, NN, jnp.asarray([L, L, L]),
            config=htf.CellList(capacity=128), return_overflow=True)
        assert not bool(overflow)

    def test_too_small_box_raises(self):
        pos4 = jnp.asarray(random_system(27, 4.0))
        import pytest
        with pytest.raises(ValueError):
            htf.cell_list_nlist(pos4, 3.0, 8, jnp.asarray([4.0, 4.0, 4.0]))


class TestDirectMode:
    def test_matches_n2_forces(self):
        """nlist='direct' (wide candidate planes) produces identical forces
        to the packed path on identical positions."""
        n = 600
        r_cut, NN = 3.0, 48

        def run(method):
            model = zoo.LJModel(NN)
            sim = htf.Simulation(dt=0.0, integrator=htf.md.NVE(), seed=5)
            sim.init_lattice(n, density=0.35, kT_init=1.0)
            tfc = htf.tfcompute(model)
            tfc.attach(sim, nlist=method, r_cut=r_cut)
            sim.run(1)
            return np.asarray(sim.state.forces)

        np.testing.assert_allclose(run("direct"), run("n2"), atol=1e-4)

    def test_virial_and_builtin_forces(self):
        """Built-in pair forces and virials work on the planes form."""
        n = 600
        sim = htf.Simulation(dt=0.001, seed=5)
        sim.init_lattice(n, density=0.35, kT_init=0.5)
        lj = sim.add_force(htf.md.LennardJones(r_cut=3.0))
        model = zoo.LJVirialModel(48, virial=True)
        tfc = htf.tfcompute(model)
        tfc.attach(sim, nlist="direct", r_cut=3.0)
        sim.run(2)
        # model LJ + builtin LJ -> double forces, but both finite/symmetric
        f = np.asarray(sim.state.forces)
        w = np.asarray(sim.state.virial)
        assert np.all(np.isfinite(f)) and np.all(np.isfinite(w))
        np.testing.assert_allclose(f[:, :3].sum(axis=0), 0.0, atol=2e-2)
        np.testing.assert_allclose(w, np.swapaxes(w, 1, 2), atol=1e-5)

    @pytest.mark.slow
    def test_direct_training(self):
        n = 300
        sim = htf.Simulation(dt=0.001,
                             integrator=htf.md.NVT(kT=1.0, tau=0.5),
                             seed=5)
        sim.init_lattice(n, density=0.35, kT_init=1.0)
        lj = sim.add_force(htf.md.LennardJones(r_cut=3.0))
        model = htf.TrainableLJ(48, epsilon=0.5, sigma=1.2,
                                output_forces=False)
        model.compile(optimizer="adam", loss="mse", learning_rate=1e-2)
        tfc = htf.tfcompute(model)
        tfc.attach(sim, nlist="direct", r_cut=3.0, train=True)
        tfc.set_reference_forces(lj)
        sim.run(30)
        assert tfc.loss_history[-1] < tfc.loss_history[0]

    def test_rdf_and_metrics_in_direct_mode(self):
        """Observable models (RDF + running metrics) work on the planes
        form."""
        n = 600
        model = zoo.LJTypedModel(48)  # helpers-only: planes-compatible
        sim = htf.Simulation(dt=0.001, seed=5)
        sim.init_lattice(n, density=0.35, kT_init=0.8)
        import dataclasses
        types = np.zeros(n, np.int32)
        types[n // 2:] = 1
        sim.state = dataclasses.replace(sim.state,
                                        types=jnp.asarray(types))
        tfc = htf.tfcompute(model)
        tfc.attach(sim, nlist="direct", r_cut=3.0)
        sim.run(5)
        rdfa = np.asarray(model.avg_rdfa.result())
        rdfb = np.asarray(model.avg_rdfb.result())
        assert rdfa.sum() > 0
        np.testing.assert_allclose(rdfa, rdfb, atol=1e-5)

    def test_incompatible_options_raise(self):
        import pytest
        sim = htf.Simulation()
        sim.init_lattice(64, a=1.5)
        model = zoo.LJModel(16)
        with pytest.raises(ValueError):
            htf.tfcompute(model).attach(sim, nlist="direct", r_cut=3.0,
                                        batch_size=4)


class TestCellListInSimulation:
    def test_forces_match_dense_path(self):
        """Same configuration with nlist='cell' vs nlist='n2' must produce
        the same forces. Compared after ONE step (identical positions): over
        longer trajectories fp-level summation-order differences amplify
        chaotically, which is physics, not a bug."""
        n = 600
        r_cut = 3.0
        NN = 48

        def run(method):
            model = zoo.LJModel(NN)
            sim = htf.Simulation(dt=0.0,
                                 integrator=htf.md.NVE(),
                                 seed=5)
            sim.init_lattice(n, density=0.35, kT_init=1.0)
            tfc = htf.tfcompute(model)
            tfc.attach(sim, nlist=method, r_cut=r_cut)
            sim.run(1)
            return (np.asarray(sim.state.positions),
                    np.asarray(sim.state.forces))

        p_cell, f_cell = run("cell")
        p_n2, f_n2 = run("n2")
        np.testing.assert_allclose(p_cell, p_n2, atol=1e-6)
        np.testing.assert_allclose(f_cell, f_n2, atol=1e-4)
