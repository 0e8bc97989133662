"""Triclinic (tilted) boxes: minimum image, cellwise/n2 forces vs a
27-image numpy oracle, sheared NVE conservation, and the guard surface.

This is a beyond-parity capability: the reference *rejects* skewed boxes
(``simmodel.py:195`` raises 'box is skewed' in ``compute_inputs``), so
trajectories with lattice angles != 90 deg could not be processed at
all. This engine supports HOOMD's tilt-factor convention
(|tilt| <= 0.5) end to end: binning and cell centers are a regular grid
in fractional space, stencil offsets pick up the tilt cross terms as
compile-time constants, and the Pallas kernel is unchanged.
"""

import jax.numpy as jnp
import numpy as np
import pytest

import hoomd_tf_tpu as htf
import zoo

TILT = (0.3, -0.2, 0.25)


def cell_matrix(lengths, tilt):
    Lx, Ly, Lz = lengths
    xy, xz, yz = tilt
    return np.array([[Lx, xy * Ly, xz * Lz],
                     [0., Ly, yz * Lz],
                     [0., 0., Lz]])


def tri_positions(n, lengths, tilt, seed=0, lo=None, jitter=0.15):
    """Positions on a jittered simple-cubic lattice in *fractional*
    space, mapped through the cell matrix -- dense but overlap-free, so
    force magnitudes stay integrable."""
    rng = np.random.RandomState(seed)
    h = cell_matrix(lengths, tilt)
    m = int(np.ceil(n ** (1 / 3)))
    g = (np.arange(m) + 0.5) / m
    frac = np.stack(np.meshgrid(g, g, g, indexing="ij"),
                    axis=-1).reshape(-1, 3)[:n]
    frac = frac + rng.uniform(-jitter, jitter, size=frac.shape) / m
    lo = (-np.asarray(lengths) / 2.0) if lo is None else np.asarray(lo)
    return (frac @ h.T + lo).astype(np.float32)


def min_image_27(r, h):
    """Exact minimum image of displacement(s) ``r`` by brute force over
    the 27 lattice translations (valid for |tilt| <= 0.5)."""
    combos = np.array([(i, j, k) for i in (-1, 0, 1)
                       for j in (-1, 0, 1) for k in (-1, 0, 1)])
    shifts = combos @ h.T                     # [27, 3]
    cand = r[..., None, :] + shifts           # [..., 27, 3]
    idx = np.argmin(np.sum(cand * cand, axis=-1), axis=-1)
    return np.take_along_axis(cand, idx[..., None, None], axis=-2)[..., 0, :]


def numpy_lj_tri(pos, lengths, tilt, r_cut):
    """Per-particle LJ forces+energy with the exact 27-image min image."""
    h = cell_matrix(lengths, tilt)
    d = pos[None, :, :] - pos[:, None, :]     # r_ij = x_j - x_i
    d = min_image_27(d, h)
    rd = np.linalg.norm(d, axis=-1)
    np.fill_diagonal(rd, np.inf)
    mask = rd <= r_cut
    inv6 = np.where(mask, rd, np.inf) ** -6.0
    energy = (0.5 * 4 * (inv6 ** 2 - inv6)).sum(axis=1)
    fmag = 24 * (2 * np.where(mask, rd, np.inf) ** -13
                 - np.where(mask, rd, np.inf) ** -7)
    forces = -(fmag / np.where(mask, rd, 1.0))[:, :, None] * d
    return np.where(mask[:, :, None], forces, 0.0).sum(axis=1), energy


class TestWrapVector:
    def test_matches_27_image_for_short_vectors(self):
        """For vectors shorter than half the min perpendicular width the
        sequential HOOMD wrap IS the exact minimum image."""
        lengths = np.array([6.0, 7.0, 8.0])
        h = cell_matrix(lengths, TILT)
        box = htf.make_box(-lengths / 2, lengths / 2, tilt=TILT)
        rng = np.random.RandomState(3)
        # short true displacements, shifted by random lattice vectors
        short = rng.randn(256, 3).astype(np.float32) * 0.8
        shifts = rng.randint(-2, 3, size=(256, 3)) @ h.T
        wrapped = np.asarray(htf.wrap_vector(
            jnp.asarray(short + shifts, jnp.float32), box))
        np.testing.assert_allclose(wrapped, short, atol=1e-4)

    def test_wrap_is_lattice_translation(self):
        """Any wrap result differs from the input by a lattice vector."""
        lengths = np.array([5.0, 6.0, 4.0])
        h = cell_matrix(lengths, TILT)
        box = htf.make_box(-lengths / 2, lengths / 2, tilt=TILT)
        rng = np.random.RandomState(5)
        r = (rng.randn(128, 3) * 6.0).astype(np.float32)
        wrapped = np.asarray(htf.wrap_vector(jnp.asarray(r), box))
        frac = np.linalg.solve(h, (wrapped - r).T).T
        np.testing.assert_allclose(frac, np.round(frac), atol=1e-3)

    def test_zero_tilt_reduces_to_orthorhombic(self):
        lengths = np.array([5.0, 6.0, 4.0])
        box = htf.make_box(-lengths / 2, lengths / 2)
        rng = np.random.RandomState(7)
        r = (rng.randn(64, 3) * 6.0).astype(np.float32)
        wrapped = np.asarray(htf.wrap_vector(jnp.asarray(r), box))
        expected = r - np.round(r / lengths) * lengths
        np.testing.assert_allclose(wrapped, expected, atol=1e-5)


class TestTriclinicForces:
    r_cut = 1.4

    def _make_sim(self, n=160, lengths=(6.0, 6.0, 6.0), tilt=TILT,
                  seed=0, **kwargs):
        pos = tri_positions(n, lengths, tilt, seed=seed)
        box = htf.make_box(-np.asarray(lengths) / 2,
                           np.asarray(lengths) / 2, tilt=tilt)
        sim = htf.Simulation(dt=0.001, seed=seed, **kwargs)
        sim.init_state(pos, box, kT_init=0.7)
        return sim

    def test_builtin_lj_cellwise_vs_oracle(self):
        """Built-in LJ on the slot-resident (cellwise) path in a tilted
        box matches the 27-image numpy oracle, step after step."""
        sim = self._make_sim()
        sim.add_force(htf.md.LennardJones(epsilon=1.0, sigma=0.9,
                                          r_cut=self.r_cut))
        assert sim._use_cellwise()
        sim.run(1)
        for _ in range(2):
            pos = np.asarray(sim.state.positions)
            f_ref = numpy_lj_sigma(pos, np.array([6.0] * 3), TILT,
                                   self.r_cut, sigma=0.9)
            got = np.asarray(sim.state.forces[:, :3])
            np.testing.assert_allclose(got, f_ref, rtol=2e-4, atol=2e-3)
            sim.run(5)

    def test_model_lj_n2_vs_oracle(self):
        """Generic SimModel path in a tilted box (auto -> dense n2 with
        the triclinic wrap) matches the oracle."""
        n = 96
        sim = self._make_sim(n=n, seed=2)
        model = zoo.LJModel(n - 1)
        tfc = htf.tfcompute(model)
        tfc.attach(sim, r_cut=self.r_cut)
        sim.run(2)
        pos = np.asarray(sim.state.positions)
        f_ref = numpy_lj_sigma(pos, np.array([6.0] * 3), TILT,
                               self.r_cut, sigma=1.0)
        got = tfc.get_forces_array()[:, :3]
        np.testing.assert_allclose(got, f_ref, rtol=2e-4, atol=2e-3)

    def test_pair_model_cellwise_vs_oracle(self):
        """PairModel analytic fast path (stencil offsets with tilt cross
        terms) in a tilted box matches the oracle."""
        n = 160

        class PairLJ(htf.PairModel):
            def pair_energy(self, r2):
                inv6 = (0.81 / r2) ** 3
                return 4.0 * (inv6 * inv6 - inv6)

        sim = self._make_sim(n=n, seed=4)
        tfc = htf.tfcompute(PairLJ(64))
        tfc.attach(sim, r_cut=self.r_cut, nlist="cellwise")
        sim.run(2)
        pos = np.asarray(sim.state.positions)
        f_ref = numpy_lj_sigma(pos, np.array([6.0] * 3), TILT,
                               self.r_cut, sigma=0.9)
        got = tfc.get_forces_array()[:, :3]
        np.testing.assert_allclose(got, f_ref, rtol=2e-4, atol=2e-3)

    def test_compute_nlist_full_box(self):
        """compute_nlist with a full tilted box finds exactly the oracle's
        neighbor distances."""
        n = 64
        lengths = np.array([6.0, 6.0, 6.0])
        pos = tri_positions(n, lengths, TILT, seed=9)
        box = htf.make_box(-lengths / 2, lengths / 2, tilt=TILT)
        pos4 = jnp.concatenate(
            [jnp.asarray(pos), jnp.zeros((n, 1), jnp.float32)], axis=1)
        nl = np.asarray(htf.compute_nlist(pos4, self.r_cut, 32, box,
                                          sorted=True))
        h = cell_matrix(lengths, TILT)
        d = min_image_27(pos[None] - pos[:, None], h)
        rd = np.linalg.norm(d, axis=-1)
        np.fill_diagonal(rd, np.inf)
        for i in range(n):
            want = np.sort(rd[i][rd[i] <= self.r_cut])
            got = np.linalg.norm(nl[i, :, :3], axis=-1)
            got = np.sort(got[got > 1e-6])
            np.testing.assert_allclose(got, want, atol=1e-4)


def numpy_lj_sigma(pos, lengths, tilt, r_cut, sigma=1.0):
    """LJ forces with sigma, via the 27-image oracle."""
    h = cell_matrix(lengths, tilt)
    d = min_image_27(pos[None, :, :] - pos[:, None, :], h)
    rd = np.linalg.norm(d, axis=-1)
    np.fill_diagonal(rd, np.inf)
    mask = rd <= r_cut
    rs = np.where(mask, rd, np.inf)
    s6 = sigma ** 6
    fmag = 24 * s6 * (2 * s6 * rs ** -13 - rs ** -7)
    forces = -(fmag / np.where(mask, rd, 1.0))[:, :, None] * d
    return np.where(mask[:, :, None], forces, 0.0).sum(axis=1)


class TestShearedNVE:
    @pytest.mark.slow
    def test_energy_conservation(self):
        """NVE in a sheared box: total energy drift stays tiny -- the
        triclinic wrap in the integrator plus the stencil cross terms
        are consistent (any geometry inconsistency shows up as drift)."""
        n = 128
        lengths = np.array([6.5, 6.5, 6.5])
        pos = tri_positions(n, lengths, TILT, seed=11)
        box = htf.make_box(-lengths / 2, lengths / 2, tilt=TILT)
        sim = htf.Simulation(dt=0.0005, seed=1,
                             integrator=htf.md.Minimize(max_disp=0.02))
        sim.init_state(pos, box)
        sim.add_force(htf.md.LennardJones(epsilon=1.0, sigma=0.85,
                                          r_cut=1.6))
        # relax the random packing before measuring conservation
        sim.run(400)
        sim.thermalize_velocities(0.3)
        sim.integrator = htf.md.NVE()
        sim.run(10)
        energies = []
        for _ in range(5):
            sim.run(100)
            t = sim.thermo()
            energies.append(t["kinetic_energy"] + t["potential_energy"])
        for a, b in zip(energies, energies[1:]):
            np.testing.assert_allclose(a, b, atol=5e-3 * max(
                1.0, abs(energies[0])))


class TestTiltedTrajectory:
    def test_gsd_roundtrip_iter_from_trajectory(self, tmp_path):
        """A tilted GSD trajectory round-trips: writer stores tilt
        factors, GSDUniverse converts them to lattice angles,
        iter_from_trajectory converts back and applies the triclinic
        minimum image -- the reference's workflow that used to die on
        its own 'box is skewed' assert."""
        n, r_cut = 48, 1.4
        lengths = np.array([6.0, 6.0, 6.0])
        pos = tri_positions(n, lengths, TILT, seed=21)
        # hoomd GSD boxes are centered at the origin
        path = str(tmp_path / "tilted.gsd")
        htf.write_gsd_frames(
            path, [{"positions": pos, "typeid": np.zeros(n, np.uint32)}],
            box=np.concatenate([lengths, np.asarray(TILT)]))
        u = htf.GSDUniverse(path)
        # angles survived the round trip
        np.testing.assert_allclose(
            u.dimensions[:3], lengths, atol=1e-5)
        got = list(htf.iter_from_trajectory(32, u, r_cut=r_cut))
        assert len(got) == 1
        nl = np.asarray(got[0][0][0])
        h = cell_matrix(lengths, TILT)
        d = min_image_27(pos[None] - pos[:, None], h)
        rd = np.linalg.norm(d, axis=-1)
        np.fill_diagonal(rd, np.inf)
        for i in range(n):
            want = np.sort(rd[i][rd[i] <= r_cut])
            dist = np.linalg.norm(nl[i, :, :3], axis=-1)
            dist = np.sort(dist[dist > 1e-6])
            np.testing.assert_allclose(dist, want, atol=1e-4)


class TestGuards:
    def test_overtilted_rejected(self):
        lengths = np.array([6.0, 6.0, 6.0])
        pos = tri_positions(32, lengths, (0.7, 0.0, 0.0), seed=1)
        box = htf.make_box(-lengths / 2, lengths / 2, tilt=(0.7, 0, 0))
        sim = htf.Simulation(dt=0.001)
        sim.init_state(pos, box)
        tfc = htf.tfcompute(zoo.LJModel(16))
        with pytest.raises(ValueError, match="tilt"):
            tfc.attach(sim, r_cut=1.2)

    def test_npt_tilted_raises(self):
        lengths = np.array([6.0, 6.0, 6.0])
        pos = tri_positions(64, lengths, TILT, seed=1)
        box = htf.make_box(-lengths / 2, lengths / 2, tilt=TILT)
        sim = htf.Simulation(dt=0.001,
                             integrator=htf.md.NPT(kT=1.0, tau=0.5,
                                                   P=1.0, tauP=1.0))
        sim.init_state(pos, box, kT_init=1.0)
        sim.add_force(htf.md.LennardJones(epsilon=1.0, sigma=0.9,
                                          r_cut=1.2))
        with pytest.raises((NotImplementedError, ValueError)):
            sim.run(2)

    def test_cell_tier_tilted_raises(self):
        lengths = np.array([6.0, 6.0, 6.0])
        pos = tri_positions(64, lengths, TILT, seed=1)
        box = htf.make_box(-lengths / 2, lengths / 2, tilt=TILT)
        sim = htf.Simulation(dt=0.001)
        sim.init_state(pos, box, kT_init=1.0)
        tfc = htf.tfcompute(zoo.LJModel(32))
        tfc.attach(sim, r_cut=1.2, nlist="cell")
        with pytest.raises(NotImplementedError, match="triclinic"):
            sim.run(2)
