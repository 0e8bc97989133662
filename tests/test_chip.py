"""Tests that need the GPU: the compiled half-stencil kernel and the
route choice on the card. They skip elsewhere; ``python chip_smoke.py``
runs them in-process on the GPU (phase 7)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import hoomd_tf_tpu as htf
from hoomd_tf_tpu.md.slots import SlotLayout
from hoomd_tf_tpu.ops import cellwise as cw
from hoomd_tf_tpu.ops import routes

pytestmark = pytest.mark.chip


@pytest.fixture
def gpu():
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU: run `python chip_smoke.py` on the card")


def _lj(r2, ti, tj):
    u = 1.0 / r2
    sr6 = u * u * u
    return 4.0 * (sr6 * sr6 - sr6), -12.0 * (2.0 * sr6 - 1.0) * sr6 * u


def test_routes_on_gpu(gpu):
    """On the GPU the kernel compiles (never interpreted) and is the
    route of a closed-form pair function."""
    assert routes.pallas_interpret() is False
    assert routes.pair_stencil(_lj) == "pallas"


@pytest.mark.parametrize("n,typed", [(4096, False), (4096, True)])
def test_compiled_kernel_matches_full_stencil(gpu, n, typed):
    """The compiled kernel reproduces the XLA full stencil (forces,
    energy, virial; typed cutoff matrix) on a jittered fluid."""
    sim = htf.Simulation(dt=0.005, integrator=htf.md.NVE(), seed=0)
    sim.init_lattice(n, density=0.4, kT_init=1.0)
    rng = np.random.RandomState(0)
    state = dataclasses.replace(
        sim.state,
        positions=sim.state.positions + 0.2 * jnp.asarray(
            rng.uniform(-1, 1, (n, 3)).astype(np.float32)),
        types=jnp.asarray(np.arange(n) % 2, jnp.int32))
    lengths = np.asarray(htf.box_size(state.box))
    lo = np.asarray(state.box[0])
    plan = cw.plan_cellwise(n, lengths, 3.0,
                            positions=np.asarray(state.positions), lo=lo)
    layout = SlotLayout(plan, n, lo)
    slot_state, aux, _ = layout.pack(state)
    rc = (np.array([[3.0, 2.2], [2.2, 2.6]], np.float32) if typed
          else None)
    args = (slot_state.positions, slot_state.types, aux["valid"], plan,
            layout.lo, _lj)
    kw = dict(needs_virial=True, with_types=True, rcut_matrix=rc)
    with jax.default_matmul_precision("highest"):
        f_ref, w_ref = cw.analytic_pair_forces(*args, stencil="full", **kw)
    f_k, w_k = cw.analytic_pair_forces(*args, stencil="pallas", **kw)
    scale = float(jnp.abs(f_ref).max())
    np.testing.assert_allclose(np.asarray(f_k), np.asarray(f_ref),
                               rtol=1e-4, atol=1e-4 * scale)
    np.testing.assert_allclose(np.asarray(w_k), np.asarray(w_ref),
                               rtol=1e-4, atol=1e-4 * scale)


def test_proxy_fit_is_full_precision(gpu):
    """The Chebyshev fit's matmuls run at full f32 on the card: a TF32
    product (the GPU default for f32 matmuls) would miss the CPU's f32
    coefficients by ~1e-3 relative."""
    from hoomd_tf_tpu.ops.chebyshev import make_pair_proxy
    fit, _ = make_pair_proxy(16, 0.6, 9.0)

    def lj(r2):
        return _lj(r2, 0, 0)

    c = np.asarray(jax.jit(lambda: fit(lj))()["c"])
    with jax.default_device(jax.devices("cpu")[0]):
        c_cpu = np.asarray(fit(lj)["c"])
    scale = np.abs(c_cpu).max()
    np.testing.assert_allclose(c, c_cpu, atol=1e-5 * scale)
