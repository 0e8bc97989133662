"""Route choice (ops/routes.py), the kernel wrapper's chunking of the
candidate width, nlist-mode validation and the compile-cache helper."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import hoomd_tf_tpu as htf
from hoomd_tf_tpu.ops import cellwise as cw
from hoomd_tf_tpu.ops import cellwise_pallas as cp
from hoomd_tf_tpu.ops import routes
from hoomd_tf_tpu.utils import compile_cache


def _lj(r2, ti, tj):
    u = 1.0 / r2
    sr6 = u * u * u
    return 4.0 * (sr6 * sr6 - sr6), -12.0 * (2.0 * sr6 - 1.0) * sr6 * u


def _mlp_pair(r2, ti, tj):
    # a per-lane hidden axis (MLP pair energy): rank-3 lanes
    w = jnp.linspace(0.1, 1.0, 16)
    h = jnp.tanh(r2[..., None] * w)
    return jnp.sum(h, -1), jnp.sum(w * (1 - h * h), -1)


def _table_pair(r2, ti, tj):
    # closes over a non-scalar array constant
    tab = jnp.asarray(np.linspace(1.0, 2.0, 6, dtype=np.float32))
    e = tab[(ti + tj).astype(jnp.int32)]
    return e / r2, -e / (r2 * r2)


class TestRouteChoice:
    def test_cpu_takes_xla(self):
        assert routes.pair_stencil(_lj, platform="cpu") == "full"

    def test_gpu_takes_kernel_for_closed_form(self):
        assert routes.pair_stencil(_lj, platform="gpu") == "pallas"

    @pytest.mark.parametrize("fn", [_mlp_pair, _table_pair],
                             ids=["hidden_axis", "array_constant"])
    def test_gpu_takes_xla_when_kernel_cannot_replay(self, fn):
        assert not cp.pair_fn_lowers(fn)
        assert routes.pair_stencil(fn, platform="gpu") == "full"

    def test_proxy_lowers(self):
        from hoomd_tf_tpu.ops.chebyshev import pair_proxy
        pf = pair_proxy(lambda r2: _lj(r2, 0, 0), 16, 0.5, 9.0)
        assert cp.pair_fn_lowers(lambda r2, ti, tj: pf(r2))

    @pytest.mark.parametrize("platform,interp", [("cpu", True),
                                                 ("gpu", False),
                                                 ("cuda", False)])
    def test_interpret_only_on_cpu(self, platform, interp):
        assert routes.pallas_interpret(platform) is interp

    def test_no_kernel_route_elsewhere(self):
        with pytest.raises(NotImplementedError):
            routes.pallas_interpret("rocm")

    def test_unknown_stencil_rejected(self):
        pos = jnp.zeros((27, 3))
        plan = cw.CellwisePlan(grid=(3, 3, 3), capacity=1,
                               lengths=(9.0, 9.0, 9.0), r_cut=2.5)
        with pytest.raises(ValueError, match="stencil"):
            cw.analytic_pair_forces(pos, jnp.zeros(27, jnp.int32),
                                    jnp.ones(27), plan, (-4.5,) * 3, _lj,
                                    stencil="mm")


class TestKernelPadding:
    @pytest.mark.parametrize("cap", [1, 9, 10, 40, 41, 64])
    def test_chunks_cover_width(self, cap):
        C = 14 * cap
        n, padded = cp.lane_chunks(C)
        assert padded == n * cp.CHUNK
        assert padded >= C > padded - cp.CHUNK
        assert cp.CHUNK & (cp.CHUNK - 1) == 0
        assert cp.ROW_TILE & (cp.ROW_TILE - 1) == 0

    def test_pair_lanes_per_route(self):
        n, cells, cap = 65536, 4096, 40
        assert cw.pair_lanes(n, cells, cap, "full") == cells * cap * 27 * cap
        assert cw.pair_lanes(n, cells, cap, "half") == cells * cap * 14 * cap
        rows = n / cells + cp.ROW_TILE / 2
        assert cw.pair_lanes(n, cells, cap, "pallas") == \
            cells * rows * cp.lane_chunks(14 * cap)[1]

    def test_kernel_output_shapes(self):
        """Interpreted kernel at a capacity whose width is not a whole
        number of chunks: outputs keep the slot layout."""
        sim = htf.Simulation(dt=0.005, seed=0)
        sim.init_lattice(64, density=0.1)
        lengths = np.asarray(htf.box_size(sim.state.box))
        lo = np.asarray(sim.state.box[0])
        plan = cw.CellwisePlan(grid=(3, 3, 3), capacity=5,
                               lengths=tuple(float(v) for v in lengths),
                               r_cut=float(min(lengths) / 3 - 0.1))
        from hoomd_tf_tpu.md.slots import SlotLayout
        layout = SlotLayout(plan, 64, lo)
        slot_state, aux, _ = layout.pack(sim.state)
        f4, w = cp.half_stencil_pair_forces(
            slot_state.positions, slot_state.types, aux["valid"], plan,
            layout.lo, lambda r2: _lj(r2, 0, 0), needs_virial=True,
            interpret=True)
        assert f4.shape == (plan.n_slots, 4)
        assert w.shape == (plan.n_slots, 3, 3)
        assert np.isfinite(np.asarray(f4)).all()


def test_nlist_pallas_rejected():
    sim = htf.Simulation(dt=0.005)
    sim.init_lattice(64, density=0.3)

    class LJ(htf.PairModel):
        def pair_energy(self, r2):
            return 1.0 / r2

    with pytest.raises(ValueError, match="cellwise"):
        htf.tfcompute(LJ(16)).attach(sim, r_cut=2.5, nlist="pallas")


class TestCompileCache:
    def test_env_var_honoured(self, monkeypatch, tmp_path):
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        before = jax.config.jax_compilation_cache_dir
        assert compile_cache.enable_compile_cache() == str(tmp_path)
        assert jax.config.jax_compilation_cache_dir == before

    def test_fixed_path_in_checkout(self, monkeypatch):
        import os
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        before = jax.config.jax_compilation_cache_dir
        try:
            d = compile_cache.enable_compile_cache()
            root = os.path.dirname(os.path.dirname(htf.__file__))
            assert d == os.path.join(root, ".jax_cache")
            assert jax.config.jax_compilation_cache_dir == d
        finally:
            jax.config.update("jax_compilation_cache_dir", before)
