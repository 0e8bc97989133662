"""Hand-written lane-contraction VJP for online training
(ops/pair_train.py).

Reference bar: the hoomd2tf online-training loop
(`/root/reference/htf/tensorflowcompute.py:346-370`) -- parameter
gradients through the fast analytic route must equal plain autodiff
through the analytic forward (which itself is tested against the
generic capture-replay route in test_cellwise.py).
"""

import pytest
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

import hoomd_tf_tpu as htf
from hoomd_tf_tpu.md.slots import SlotLayout
from hoomd_tf_tpu.ops import cellwise as cw
from hoomd_tf_tpu.ops.pair_train import pair_train_forces


def _slot_setup(n=256, r_cut=2.5, seed=3, typed=True):
    sim = htf.Simulation(dt=0.005, integrator=htf.md.NVE(), seed=seed)
    sim.init_lattice(n, density=0.35, kT_init=1.0)
    rng = np.random.RandomState(seed)
    state = dataclasses.replace(
        sim.state,
        positions=sim.state.positions + 0.2 * jnp.asarray(
            rng.uniform(-1, 1, (n, 3)).astype(np.float32)),
        types=(jnp.asarray(np.arange(n) % 2, jnp.int32) if typed
               else sim.state.types))
    lengths = np.asarray(htf.box_size(state.box))
    lo = np.asarray(state.box[0])
    plan = cw.plan_cellwise(n, lengths, r_cut,
                            positions=np.asarray(state.positions), lo=lo)
    layout = SlotLayout(plan, n, lo)
    slot_state, aux, _ = layout.pack(state)
    labels = jnp.asarray(
        rng.randn(plan.n_slots, 4).astype(np.float32))
    return plan, layout, slot_state, aux, labels


def _typed_lj(params, r2, ti, tj):
    eps, sig = params
    e = jnp.where((ti == 0) & (tj == 0), eps, 0.5 * eps)
    u = (sig * sig) / r2
    sr6 = u * u * u
    return (4.0 * e * (sr6 * sr6 - sr6),
            -12.0 * e * (2.0 * sr6 - 1.0) * sr6 / r2)


class TestGradientParity:
    """The custom VJP equals plain reverse-mode AD through the analytic
    forward -- every fwd stencil, with and without the energy column."""

    @pytest.mark.slow
    def test_matches_autodiff_full_and_half(self):
        plan, layout, slot_state, aux, labels = _slot_setup()
        params = [jnp.asarray(0.9), jnp.asarray(1.05)]
        rc_matrix = np.array([[2.5, 1.8], [1.8, 2.2]], dtype=np.float32)

        def loss_naive(p):
            f4, _ = cw.analytic_pair_forces(
                slot_state.positions, slot_state.types, aux["valid"],
                plan, layout.lo,
                lambda r2, ti, tj: _typed_lj(p, r2, ti, tj),
                with_types=True, rcut_matrix=rc_matrix, stencil="full")
            return jnp.mean((f4 - labels) ** 2)

        l0, g0 = jax.jit(jax.value_and_grad(loss_naive))(params)
        for st in ("full", "half"):
            def loss_custom(p, st=st):
                f4 = pair_train_forces(
                    p, _typed_lj, slot_state.positions, slot_state.types,
                    aux["valid"], plan, layout.lo, with_types=True,
                    rcut_matrix=rc_matrix, fwd_stencil=st)
                return jnp.mean((f4 - labels) ** 2)

            l1, g1 = jax.jit(jax.value_and_grad(loss_custom))(params)
            np.testing.assert_allclose(float(l0), float(l1), rtol=2e-5)
            for a, b in zip(g0, g1):
                np.testing.assert_allclose(float(a), float(b),
                                           rtol=2e-4, atol=1e-6)

    @pytest.mark.slow
    def test_three_column_cotangent(self):
        """Models trained on forces[:, :3] (reference example 08): zero
        energy-column cotangent, needs_energy=False."""
        plan, layout, slot_state, aux, labels = _slot_setup()
        params = [jnp.asarray(0.9), jnp.asarray(1.05)]

        def loss_naive(p):
            f4, _ = cw.analytic_pair_forces(
                slot_state.positions, slot_state.types, aux["valid"],
                plan, layout.lo,
                lambda r2, ti, tj: _typed_lj(p, r2, ti, tj),
                with_types=True, stencil="full", needs_energy=False)
            return jnp.mean((f4[:, :3] - labels[:, :3]) ** 2)

        def loss_custom(p):
            f4 = pair_train_forces(
                p, _typed_lj, slot_state.positions, slot_state.types,
                aux["valid"], plan, layout.lo, with_types=True,
                needs_energy=False)
            return jnp.mean((f4[:, :3] - labels[:, :3]) ** 2)

        l0, g0 = jax.jit(jax.value_and_grad(loss_naive))(params)
        l1, g1 = jax.jit(jax.value_and_grad(loss_custom))(params)
        np.testing.assert_allclose(float(l0), float(l1), rtol=2e-5)
        for a, b in zip(g0, g1):
            np.testing.assert_allclose(float(a), float(b),
                                       rtol=2e-4, atol=1e-6)

    @pytest.mark.slow
    def test_traced_geometry_under_scan(self):
        """Deployment shape: geometry inputs are scan-body tracers the
        custom_vjp closes over; params update across iterations."""
        plan, layout, slot_state, aux, labels = _slot_setup(typed=False)

        def pair_apply(params, r2):
            eps, = params
            u = 1.0 / r2
            sr6 = u * u * u
            return (4.0 * eps * (sr6 * sr6 - sr6),
                    -12.0 * eps * (2.0 * sr6 - 1.0) * sr6 * u)

        @jax.jit
        def scanned(eps0, positions, valid):
            def body(carry, _):
                p, = carry

                def loss_fn(pp):
                    f4 = pair_train_forces(
                        pp, pair_apply, positions, slot_state.types,
                        valid, plan, layout.lo, with_types=False)
                    return jnp.mean((f4 - labels) ** 2)

                l, g = jax.value_and_grad(loss_fn)([p])
                return (p - 0.01 * g[0],), l

            return jax.lax.scan(body, (eps0,), None, length=3)

        (pf,), losses = scanned(jnp.asarray(0.9), slot_state.positions,
                                aux["valid"])
        assert np.isfinite(float(pf))
        assert np.all(np.isfinite(np.asarray(losses)))
        # the loss sequence must actually respond to the updates
        assert len(set(np.asarray(losses).tolist())) == 3


class TrainableNN(htf.SimModel):
    """The north-star protocol's example-08 shape: per-lane MLP on 1/r,
    trained output ``forces[:, :3]``."""

    def setup(self):
        self.dense1 = htf.Dense(8)
        self.last = htf.Dense(1)

    def compute(self, nlist, positions, box):
        rinv = htf.nlist_rinv(nlist)
        x = jax.nn.tanh(self.dense1(rinv[..., None]))
        e = jnp.sum(self.last(x)[..., 0], axis=1)
        return htf.compute_nlist_forces(nlist, e)[:, :3]


def _train_run(lane_fast, steps, n=216, lr=1e-2, optimizer="adam"):
    """One online-training run with the fast path on or off; Dense init
    is pinned (module-level counter) so both arms start from identical
    weights."""
    import os

    from hoomd_tf_tpu.models import layers as _layers

    old = os.environ.get("HTF_LANE_FAST")
    os.environ["HTF_LANE_FAST"] = "1" if lane_fast else "0"
    _layers._INIT_SEED[0] = 0
    try:
        sim = htf.Simulation(dt=0.005, integrator=htf.md.NVE(), seed=5)
        sim.init_lattice(n, density=0.3, kT_init=0.8)
        rng = np.random.RandomState(5)
        sim.state = dataclasses.replace(
            sim.state,
            positions=sim.state.positions + 0.2 * jnp.asarray(
                rng.uniform(-1, 1, (n, 3)).astype(np.float32)))
        sim.add_force(htf.md.LennardJones(r_cut=2.5))
        model = TrainableNN(48, output_forces=False)
        model.compile(optimizer=optimizer, loss="mse", learning_rate=lr)
        tfc = htf.tfcompute(model)
        tfc.attach(sim, r_cut=2.5, nlist="cellwise", train=True)
        sim.run(steps)
        assert tfc._lane_fast_ok == lane_fast
        if lane_fast:
            assert getattr(tfc, "_lane_fast_cols", None) == 3
        return ([np.asarray(v.value) for v in model.trainable_variables],
                np.asarray(tfc.loss_history))
    finally:
        if old is None:
            os.environ.pop("HTF_LANE_FAST", None)
        else:
            os.environ["HTF_LANE_FAST"] = old


class TestGenericModelTrainFast:
    """End-to-end: a generic lane-separable NN SimModel (the north-star
    protocol's example-08 shape) is probed, validated and trained on
    the custom-VJP fast path -- and its whole training trajectory
    matches the generic capture-replay route from identical weights."""

    @pytest.mark.slow
    def test_one_sgd_step_matches_generic_route(self):
        """One SGD step: loss and updated weights equal the generic
        route's (the sharpest single-number gradient check)."""
        w_fast, h_fast = _train_run(True, 1, optimizer="sgd")
        w_gen, h_gen = _train_run(False, 1, optimizer="sgd")
        np.testing.assert_allclose(h_fast[0], h_gen[0], rtol=1e-4)
        for a, b in zip(w_fast, w_gen):
            np.testing.assert_allclose(a, b, rtol=5e-3, atol=1e-6)

    @pytest.mark.slow
    def test_loss_trace_matches_generic_route(self):
        """15 live-MD Adam steps: the fast path's loss trace tracks the
        generic route's -- compounding gradient errors would diverge
        the traces within a few optimizer steps."""
        w_fast, h_fast = _train_run(True, 15)
        w_gen, h_gen = _train_run(False, 15)
        assert np.isfinite(h_fast).all() and np.isfinite(h_gen).all()
        np.testing.assert_allclose(h_fast, h_gen, rtol=2e-2, atol=1e-4)
        for a, b in zip(w_fast, w_gen):
            np.testing.assert_allclose(a, b, rtol=2e-2, atol=2e-4)


def test_smoke_gradient_parity_untyped():
    """Fast subsystem smoke (full matrix is @slow): the custom VJP equals
    plain autodiff through the analytic forward on a tiny untyped system,
    one stencil."""
    plan, layout, slot_state, aux, labels = _slot_setup(n=128, typed=False)
    params = [jnp.asarray(0.9)]

    def pair_apply(p, r2):
        u = 1.0 / r2
        sr6 = u * u * u
        return (4.0 * p[0] * (sr6 * sr6 - sr6),
                -12.0 * p[0] * (2.0 * sr6 - 1.0) * sr6 * u)

    def loss_naive(p):
        f4, _ = cw.analytic_pair_forces(
            slot_state.positions, slot_state.types, aux["valid"],
            plan, layout.lo, lambda r2: pair_apply(p, r2),
            stencil="full")
        return jnp.mean((f4 - labels) ** 2)

    def loss_custom(p):
        f4 = pair_train_forces(
            p, pair_apply, slot_state.positions, slot_state.types,
            aux["valid"], plan, layout.lo)
        return jnp.mean((f4 - labels) ** 2)

    l0, g0 = jax.jit(jax.value_and_grad(loss_naive))(params)
    l1, g1 = jax.jit(jax.value_and_grad(loss_custom))(params)
    np.testing.assert_allclose(float(l0), float(l1), rtol=2e-5)
    np.testing.assert_allclose(float(g0[0]), float(g1[0]), rtol=2e-4)


class TestProxyBackward:
    """The custom-VJP backward (ops/pair_train.py, XLA lane contraction)
    equals jax.grad through the plain analytic forward for
    Chebyshev-proxy pair functions -- untyped, forces only, and typed
    (per-type-pair tables) -- for both backward lane sets."""

    def _grads(self, typed, needs_energy, bwd_stencil, rc_matrix=None):
        from hoomd_tf_tpu.ops.chebyshev import (make_pair_proxy,
                                                make_typed_pair_proxy)
        plan, layout, slot_state, aux, labels = _slot_setup(n=128,
                                                            typed=typed)
        r_cut = plan.r_cut
        r2_lo = (0.25 * r_cut) ** 2
        if typed:
            fit_, eval_ = make_typed_pair_proxy(8, r2_lo, r_cut ** 2, 2)
            coeffs = fit_(lambda r2, ti, tj: _typed_lj(
                [jnp.asarray(0.9), jnp.asarray(1.05)], r2, ti, tj))
        else:
            fit_, eval_ = make_pair_proxy(8, r2_lo, r_cut ** 2)
            coeffs = fit_(lambda r2: _typed_lj(
                [jnp.asarray(0.9), jnp.asarray(1.05)], r2,
                jnp.zeros_like(r2), jnp.zeros_like(r2)))
        cols = 4 if needs_energy else 3
        geo = (slot_state.positions, slot_state.types, aux["valid"], plan,
               layout.lo)

        def loss_custom(c):
            f4 = pair_train_forces(
                c, eval_, *geo, with_types=typed, rcut_matrix=rc_matrix,
                needs_energy=needs_energy, fwd_stencil="full",
                bwd_stencil=bwd_stencil)
            return jnp.mean((f4[:, :cols] - labels[:, :cols]) ** 2)

        def loss_plain(c):
            if typed:
                pair_fn = lambda r2, ti, tj: eval_(c, r2, ti, tj)
            else:
                pair_fn = lambda r2: eval_(c, r2)
            f4, _ = cw.analytic_pair_forces(
                *geo, pair_fn, with_types=typed, rcut_matrix=rc_matrix,
                needs_energy=needs_energy, stencil="full")
            return jnp.mean((f4[:, :cols] - labels[:, :cols]) ** 2)

        return (jax.jit(jax.value_and_grad(loss_custom))(coeffs),
                jax.jit(jax.value_and_grad(loss_plain))(coeffs))

    def _check(self, typed, needs_energy, bwd_stencil, rc_matrix=None):
        (l_c, g_c), (l_p, g_p) = self._grads(typed, needs_energy,
                                             bwd_stencil, rc_matrix)
        np.testing.assert_allclose(float(l_c), float(l_p), rtol=1e-6)
        lc = jax.tree_util.tree_leaves(g_c)
        lp = jax.tree_util.tree_leaves(g_p)
        assert len(lc) == len(lp)
        scale = max(float(np.max(np.abs(np.asarray(v)))) for v in lp)
        for a, b in zip(lc, lp):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       rtol=2e-4, atol=2e-5 * scale)

    @pytest.mark.parametrize("bwd_stencil", ["half", "full"])
    @pytest.mark.parametrize("typed,needs_energy", [
        (False, True), (False, False), (True, True)],
        ids=["untyped", "forces_only", "typed"])
    def test_matches_plain_autodiff(self, typed, needs_energy,
                                    bwd_stencil):
        self._check(typed, needs_energy, bwd_stencil)

    @pytest.mark.slow
    def test_typed_with_rcut_matrix(self):
        rc = np.array([[2.5, 1.8], [1.8, 2.2]], dtype=np.float32)
        self._check(typed=True, needs_energy=True, bwd_stencil="half",
                    rc_matrix=rc)
