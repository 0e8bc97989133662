"""The Simulation driver: one jitted XLA program per run.

This is the replacement for the whole reference coupling stack
(``tfcompute`` driver + ``TensorflowCompute`` C++ + custom ops + HOOMD's
integrator loop, SURVEY.md section 3.1): each MD step fuses

1. neighbor-list build (``[N, NN, 4]`` padded, minimum-image),
2. built-in pair forces (cross-oracle / training-label forces),
3. ``SimModel.compute`` force/virial evaluation every ``period`` steps
   (stale model forces persist in between, matching the reference's
   period gating, ``TensorflowCompute.cc:133``),
4. optional online training (optax update with reference forces as labels,
   the ``FORCE_MODE::hoomd2tf`` path),
5. integration (NVE/NVT/Langevin/Brownian),

into a single ``lax.scan`` body with zero host involvement. There are no
staging buffers, callbacks, or per-batch device syncs to manage -- the
boundary-crossing inventory of SURVEY.md section 3.1 is empty by design.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from . import integrators as _integrators
from .state import init_state, lattice_positions
from . import thermo as _thermo
from ..ops.nlist import compute_nlist
from ..ops.box import box_size
from ..models.module import get_state, set_state

__all__ = ["Simulation"]


def _pair_slope_fn(force):
    """``(r2, ti, tj) -> (U, dU/dr2)`` of a built-in pair force: its own
    shared-subexpression form when it has one, else a jvp of its
    energy."""
    if hasattr(force, "pair_energy_and_slope"):
        return force.pair_energy_and_slope
    pe = force.pair_energy

    def su(r2, ti, tj):
        return jax.jvp(lambda x: pe(x, ti, tj), (r2,), (jnp.ones_like(r2),))
    return su


@jax.tree_util.register_pytree_node_class
class _Cols:
    """A per-column (structure-of-arrays) representation of one
    ``[n, 3]`` / ``[n, 4]`` / ``[n, 3, 3]`` carry array on the scan wire.

    The columns ride the scan carry as separate ``[n]`` vectors and are
    stacked back at the top of the step body, where XLA fuses the stack
    into the consumers. This layout was chosen for tiled-memory padding
    of ``[n, 3]`` arrays; its effect on the GPU has not been measured
    (ROADMAP).
    """

    __slots__ = ("cols", "tail")

    def __init__(self, cols, tail):
        self.cols = tuple(cols)
        self.tail = tuple(tail)       # original trailing shape

    def tree_flatten(self):
        return self.cols, self.tail

    @classmethod
    def tree_unflatten(cls, tail, cols):
        return cls(cols, tail)

    @classmethod
    def split(cls, a, n_rows):
        # rank-3 ([n, 3, 3] virial) stays AoS: in the slim hot loop it is
        # loop-invariant and XLA aliases it in place, which beats a
        # split/join round-trip per iteration
        if (isinstance(a, jax.Array) and a.ndim == 2
                and a.shape[0] == n_rows and a.shape[1] in (3, 4)
                and jnp.issubdtype(a.dtype, jnp.floating)):
            return cls(tuple(a[:, i] for i in range(a.shape[1])),
                       a.shape[1:])
        return a

    def join(self):
        a = jnp.stack(self.cols, axis=-1)
        return a.reshape((a.shape[0],) + self.tail)


def _wire(carry, n_rows):
    """Carry pytree -> SoA wire form (see :class:`_Cols`)."""
    return jax.tree_util.tree_map(
        lambda a: _Cols.split(a, n_rows), carry)


def _unwire(carry):
    """SoA wire form -> standard carry pytree."""
    return jax.tree_util.tree_map(
        lambda a: a.join() if isinstance(a, _Cols) else a, carry,
        is_leaf=lambda a: isinstance(a, _Cols))


@functools.partial(jax.jit, static_argnums=1)
def _wire_jit(carry, n_rows):
    return _wire(carry, n_rows)


_unwire_jit = jax.jit(_unwire)


class Simulation:
    """An MD simulation owning state, integrator and force computes.

    :param dt: timestep.
    :param integrator: an integrator from :mod:`.integrators`
        (default :class:`.integrators.NVE`).
    :param seed: PRNG seed for stochastic integrators / initialization.
    :param mesh: optional :class:`jax.sharding.Mesh`. With a mesh and the
        cellwise neighbor mode, the slot-resident state is sharded along
        ``shard_axis`` -- a spatial domain decomposition along z (the slot
        layout is z-slab-major), replacing the reference's MPI
        decomposition (SURVEY.md section 2.3). The *same* compiled step
        runs SPMD: XLA partitions the elementwise physics by rows, turns
        the z-axis rolls of the candidate build into ring collective
        permutes between devices (the halo exchange -- the compiler-derived
        equivalent of :mod:`..parallel.domain`'s explicit ppermute ring),
        and all-reduces the thermo/thermostat sums.
    :param shard_axis: mesh axis name for the slot/particle dimension.

    Built-in forces are added with :meth:`add_force`; a :class:`..models.
    simmodel.SimModel` is attached through :class:`..driver.tfcompute`.
    """

    def __init__(self, dt=0.005, integrator=None, seed=0, mesh=None,
                 shard_axis="d", auto_replan=True):
        self.dt = float(dt)
        self._integrator = integrator or _integrators.NVE()
        self.mesh = mesh
        self.shard_axis = shard_axis
        self.seed = seed
        self.state = None
        self.forces = []
        self.tfc = None         # attached tfcompute driver (or None)
        self.log = None         # thermo history (run(log_period=...))
        # re-plan the cellwise geometry automatically at run() boundaries
        # when the current occupancy is far below the planned capacity
        # (HOOMD's own cell list re-sizes itself; users never tune it).
        # Set False to keep a stale plan and get a warning instead.
        self.auto_replan = bool(auto_replan)
        self._replan_check_step = -1
        # run(n) executes as ceil(n / scan_block) dispatches of one
        # compiled fixed-length scan (plus one remainder scan), so
        # run(1000) then run(500) share the same compiled block and
        # per-step host buffers stay O(scan_block) regardless of n.
        # The reference has no analog (HOOMD owns the loop); this kills
        # the per-run-length recompile a naive scan(length=n) would pay.
        self.scan_block = 100
        # stencil of the cellwise analytic pair routes: 'auto' lets
        # ops/routes.py choose from the platform and the pair function;
        # 'pallas' / 'half' / 'full' pin one route (A/B measurements)
        self.pair_stencil = "auto"
        self._scan_cache = {}
        self._layout = None     # cached SlotLayout (cellwise mode)
        self._layout_key = None

    # ------------------------------------------------------------------
    # state initialization
    # ------------------------------------------------------------------
    def init_lattice(self, n, density=None, a=None, kind="sc", types=None,
                     kT_init=None, masses=None, dtype=jnp.float32):
        """Place ``n`` particles on a lattice in a centered cubic box.

        :param dtype: state dtype -- ``float64`` runs the whole engine
            in double precision (requires ``jax_enable_x64``), the
            analog of attaching to a double-precision HOOMD build
            (reference ``tensorflowcompute.py:166-168``).
        """
        pos, lengths = lattice_positions(n, density=density, a=a, kind=kind)
        self.state = init_state(pos, lengths, types=types, masses=masses,
                                kT_init=kT_init, seed=self.seed,
                                dtype=dtype)
        self._post_init()
        return self.state

    @property
    def integrator(self):
        return self._integrator

    @integrator.setter
    def integrator(self, integ):
        """Swapping integrators mid-simulation is supported (e.g. a
        :class:`.integrators.Minimize` quench before NVT production):
        the thermostat keys are re-initialized for the new integrator
        (values of keys both share, like a Nose-Hoover ``xi``, carry
        over) and the integrator identity in the scan cache key forces
        a recompile."""
        self._integrator = integ
        state = getattr(self, "state", None)
        if state is not None:
            fresh = integ.init(state)
            current = dict(state.thermostat or {})
            if set(current) != set(fresh):
                merged = dict(fresh)
                merged.update({k: current[k] for k in current
                               if k in fresh})
                self.state = dataclasses.replace(state, thermostat=merged)

    def init_state(self, positions, box, **kwargs):
        kwargs.setdefault("seed", self.seed)
        self.state = init_state(positions, box, **kwargs)
        self._post_init()
        return self.state

    def set_state(self, state):
        self.state = state
        self._post_init()
        return self.state

    def _post_init(self):
        # initialize integrator state only when absent/mismatched: a
        # checkpoint-restored state (set_state) must keep its thermostat
        # degrees of freedom for exact resume
        fresh = self.integrator.init(self.state)
        current = self.state.thermostat or {}
        if set(current) != set(fresh):
            self.state = dataclasses.replace(self.state, thermostat=fresh)
        self._scan_cache.clear()
        self._layout = None

    def thermalize_velocities(self, kT):
        """Draw fresh Maxwell-Boltzmann velocities at ``kT`` with zero
        net momentum (the analog of HOOMD's
        ``state.thermalize_particle_momenta``); use after a
        :class:`.integrators.Minimize` quench, which zeroes velocities."""
        state = self.state
        rng, sub = jax.random.split(state.rng)
        dtype = state.positions.dtype
        v = (jax.random.normal(sub, state.velocities.shape, dtype=dtype)
             * jnp.sqrt(jnp.asarray(kT, dtype) / state.masses)[:, None])
        v = v - jnp.mean(v, axis=0, keepdims=True)
        self.state = dataclasses.replace(state, velocities=v, rng=rng)
        return self.state

    # ------------------------------------------------------------------
    def replan(self):
        """Re-derive the neighbor-build plan from the *current* positions
        and recompile the step.

        Plans are made once at first run from measured cell occupancy.
        A cold start (e.g. a jittered lattice) measures inflated
        occupancy, and the resulting capacity padding widens the
        candidate planes -- the dominant per-step cost at scale. Calling
        ``replan()`` after equilibration re-measures and typically
        shrinks the pair work 1.5-2x. Costs one recompile; overflow of a
        tighter plan is still detected every repack and raised.
        """
        self._layout = None
        self._layout_key = None
        self._scan_cache.clear()
        self._static_K_cap = None   # staleness cap was per-plan (skin)
        self._static_K_last = None  # hysteresis anchor likewise
        self._replan_check_step = self._host_step() \
            if self.state is not None else -1
        if self.tfc is not None:
            self.tfc._warmup_cache = None

    # ------------------------------------------------------------------
    def _max_occupancy_now(self, layout):
        """Max particles-per-cell of the current positions on the
        CURRENT grid, computed on-device (one jitted reduction + one
        scalar readback). A host-side probe would ship the whole
        position array to the host."""
        from ..ops.cellwise import bin_cells
        fn = getattr(layout, "_occ_probe", None)
        if fn is None:
            plan, lo = layout.plan, layout.lo

            @jax.jit
            def fn(pos3):
                cell = bin_cells(pos3, lo, plan)
                counts = jnp.zeros((plan.n_cells,), jnp.int32).at[cell] \
                    .add(1, mode="drop")
                return jnp.max(counts)
            layout._occ_probe = fn
        return int(np.asarray(fn(self.state.positions)))

    def _maybe_auto_replan(self, layout):
        """Plan tightening at run() boundaries: when the measured cell
        occupancy is well below the planned capacity (pair work scales
        with capacity^2, so a stale cold-start plan quietly costs
        1.5-2x), re-plan automatically -- like HOOMD's self-resizing
        cell list. With ``auto_replan=False`` only a warning is emitted.
        The occupancy comes FREE from the scan carry's running max
        (``_occ_hist``) when available -- the device-probe fallback
        costs a device round trip -- and the check is throttled with
        exponential backoff (500 steps doubling to 8000) while the plan
        keeps measuring tight."""
        step = self._host_step()
        if step < 100:
            return layout  # too early to judge (still equilibrating)
        throttle = getattr(layout, "_replan_throttle", 500)
        if 0 <= self._replan_check_step and \
                step - self._replan_check_step < throttle:
            return layout
        self._replan_check_step = step
        hist = [h for h in getattr(self, "_occ_hist", [])
                if h[0][0] == layout.plan.grid]
        occ = (max(h[1] for h in hist) if hist
               else self._max_occupancy_now(layout))
        have_hist = bool(hist)
        # a fresh plan would size capacity ~ occ + 15% + 3 (ops/cellwise
        # plan margin); only consider replanning when the active
        # capacity is clearly beyond that
        # a self-heal capacity floor set during a transient (the melt of
        # a jittered start) must not pin capacity forever -- but the
        # boundary snapshot UNDERSELLS the running max the plan must
        # cover (the max over ~100 repack snapshots of 4k cells sits
        # several sigma above one snapshot's max; resetting on a 15%
        # dip was measured to thrash overflow-rollback-replan cycles
        # into the timed run). Only drop the floor when occupancy
        # indicates a genuinely different phase/density.
        floor = getattr(self, "_capacity_floor", 0)
        if floor and floor > int(np.ceil(occ * 1.5)) + 5:
            self._capacity_floor = 0
        cap = layout.plan.capacity
        # with no measured history, a fresh plan costs a host position
        # pull -- gate it behind the capacity heuristic. WITH history,
        # planning is host-side arithmetic (the calibrated estimate
        # replaces the snapshot), and capacity alone cannot judge the
        # plan: the honest-fluid running max can make the CURRENT grid
        # look tight while a coarser grid is a full padded tile cheaper.
        if not have_hist and \
                cap <= 1.1 * (occ + max(3, int(np.ceil(0.15 * occ)))):
            layout._replan_throttle = min(throttle * 2, 8000)
            return layout
        from ..ops.cellwise import pair_lanes
        fresh = self._plan_from_current()
        if fresh is None:
            return layout
        stencil = self._hot_stencil()
        n = self.state.n_particles

        def lanes(p):
            return pair_lanes(n, p.n_cells, p.capacity, stencil)

        cur, new = lanes(layout.plan), lanes(fresh)
        # 1.1: a 10% lane gap is worth the one recompile; the throttle's
        # exponential backoff bounds churn
        if cur <= 1.1 * new:
            layout._replan_throttle = min(throttle * 2, 8000)
            return layout
        if not self.auto_replan:
            import warnings
            warnings.warn(
                f"the active cellwise plan (grid {layout.plan.grid}, "
                f"capacity {layout.plan.capacity}) carries "
                f"{cur / new:.1f}x the pair work a fresh plan would: "
                "sim.replan() would recompile once and run faster",
                stacklevel=3)
            return layout
        self.replan()
        return self._ensure_layout()

    # ------------------------------------------------------------------
    def add_force(self, force):
        """Register a built-in force compute
        (``force(state, nlist) -> (forces [N,4], virial [N,3,3])``)."""
        self.forces.append(force)
        self._scan_cache.clear()
        return force

    def thermo(self):
        """Current thermodynamic quantities (dict of scalars)."""
        return {k: float(v) for k, v in _thermo.thermo(self.state).items()}

    # ------------------------------------------------------------------
    def _choose_pair_route(self, layout):
        """Route of a declared PairModel's analytic forces, kept visible
        as ``tfc._pair_fast_stencil``: ``sim.pair_stencil`` when it is
        set, else :func:`..ops.routes.pair_stencil` of the model's lane
        function (the half-stencil kernel on the GPU when the function
        can be replayed inside it, the XLA full stencil otherwise)."""
        from ..ops import routes
        tfc = self.tfc
        model = tfc.model
        if model.proxy_degree:
            pf = model.proxy_pair_fn(layout.plan.r_cut)
            if model.pair_with_types:
                pair_fn = pf
            else:
                pair_fn = lambda r2, ti, tj: pf(r2)
        elif model.pair_with_types:
            pair_fn = model.pair_energy_and_slope
        else:
            pair_fn = lambda r2, ti, tj: model.pair_energy_and_slope(r2)
        stencil = (self.pair_stencil if self.pair_stencil != "auto" else
                   routes.pair_stencil(pair_fn, True,
                                       self.state.positions.dtype))
        if stencil != getattr(tfc, "_pair_fast_stencil", None):
            tfc._pair_fast_stencil = stencil
            # the route sets the planner's cost model: re-judge the plan
            # at the next boundary
            self._replan_check_step = -1
            layout._replan_throttle = 500

    def _probe_lane_fast(self, layout, n_extras):
        """Probe a generic :class:`..models.simmodel.SimModel` for
        lane-separability and cache the verdict on the driver
        (``tfc._lane_fast_ok``). See :mod:`..ops.lane_fast` for the
        synthesis + validation scheme. One jitted comparison per attach
        configuration / plan / model trace-version; disabled with
        ``HTF_LANE_FAST=0``.
        """
        import os as _os

        from ..models.pair import PairModel

        tfc = self.tfc
        model = tfc.model
        # in train mode the probe also serves models that emit
        # forces[:, :3] as their trained output (reference example 08):
        # validation compares the synthesized analytic forces to the
        # model's own output, so a non-force output simply disqualifies.
        # A validated train-mode model rides the hand-written
        # lane-contraction VJP (ops/pair_train.py) -- the synthesized
        # route WITHOUT that VJP was measured SLOWER than capture-replay
        # (third-order autodiff through the lane reductions); with it,
        # the backward is one weighted lane pass.
        train_ok = tfc.train and n_extras + tfc.output_offset == 1
        eval_ok = (not tfc.train and model.output_forces and
                   n_extras == 0)
        if isinstance(model, PairModel):
            tfc._lane_fast_ok = False
            if tfc.batch_size or tfc.map_enabled:
                # batched/mapped attachments never take the pair fast
                # route (fast_route/_hot_stencil exclude them)
                tfc._pair_fast_stencil = None
            else:
                self._choose_pair_route(layout)
            return
        if (not (train_ok or eval_ok) or
                tfc.batch_size or tfc.map_enabled or
                _os.environ.get("HTF_LANE_FAST", "1") == "0"):
            tfc._lane_fast_ok = False
            return
        key = (tfc.config_key, layout.plan, model._trace_version,
               self.pair_stencil)
        cache = getattr(tfc, "_lane_fast_cache", None)
        if cache is not None and cache[0] == key:
            tfc._lane_fast_ok = cache[1]
            return

        from ..ops import cellwise as _cw
        from ..ops.lane_fast import synthesize_pair_fn, validate_pair_fn

        slot_state, aux, _ = layout.pack_jit(self.state)
        pair_fn = synthesize_pair_fn(model, slot_state.box)
        ok = validate_pair_fn(model, pair_fn, slot_state, aux, layout)
        if ok:
            # trained-output column count (3 for reference-example-08
            # models emitting forces[:, :3], 4 with an energy column):
            # the train fast path slices the analytic f4 to match.
            # Abstract call only -- zero device compute.
            out_sh = _eval_silent(
                model,
                [jax.eval_shape(lambda: layout.planes(slot_state, aux)),
                 jax.eval_shape(lambda: slot_state.positions4),
                 slot_state.box], train=False)
            tfc._lane_fast_cols = min(int(out_sh[0].shape[-1]), 4)
        stencil = None
        if ok:
            from ..ops import routes
            # the synthesized pair_fn runs the user's whole compute per
            # lane: on the GPU it rides the half-stencil kernel when the
            # kernel can replay it, else the XLA full stencil
            stencil = (self.pair_stencil if self.pair_stencil != "auto"
                       else routes.pair_stencil(
                           pair_fn, True, self.state.positions.dtype))
        tfc._lane_fast_ok = ok
        tfc._lane_fast_stencil = stencil
        tfc._lane_fast_cache = (key, ok)
        if ok:
            self._scan_cache.clear()
            # the probe just changed the plan's cost picture (the
            # per-lane cost scale, and possibly the kernel width): undo
            # any replan-throttle backoff taken under the scale-1
            # assumption so the NEXT run() boundary re-judges the plan
            self._replan_check_step = -1
            layout._replan_throttle = 500

    # ------------------------------------------------------------------
    # neighbor list
    # ------------------------------------------------------------------
    def _nlist_params(self):
        """Neighbor-build parameters ``(r_cut, rc_matrix, method, NN)``.

        From the attached driver when one is attached; with no driver,
        derived from the built-in forces' own cutoffs -- so pure
        built-in MD (``sim.add_force(htf.md.LennardJones(...));
        sim.run(...)``) runs with the full neighbor machinery instead of
        silently computing zero forces. (The reference's host engine is
        HOOMD, which obviously runs standalone -- SURVEY.md L0.)
        Returns ``None`` when nothing needs neighbors.
        """
        tfc = self.tfc
        if tfc is not None and tfc.nneighbor_cutoff > 0:
            return (tfc.r_cut, tfc.r_cut_matrix,
                    getattr(tfc, "nlist_method", None) or "auto",
                    max(1, tfc.nneighbor_cutoff))
        if tfc is not None or not self.forces or self.state is None:
            return None
        r = max((float(getattr(f, "r_cut", 0.0) or 0.0)
                 for f in self.forces), default=0.0)
        if r <= 0.0:
            return None
        n = self.state.n_particles
        vol = float(np.prod(self._box_geometry()[0]))
        mean_nbrs = 4.19 * r ** 3 * (n / vol)
        NN = int(min(n - 1, max(8, np.ceil(2.0 * mean_nbrs))))
        return (r, None, "auto", NN)

    def _use_cellwise(self):
        """Slot-resident ('cellwise') mode selected? (ops/cellwise.py)"""
        from ..ops.cellwise import Cellwise
        p = self._nlist_params()
        if p is None:
            return False
        r_cut, _, method, _ = p
        if self.tfc is None:
            # built-in-only runs: slot-resident mode whenever the box
            # can host the grid (>= 3 cells per axis); small boxes fall
            # through to the dense builder below. For a tilted box the
            # relevant widths are the perpendicular layer widths.
            lengths = self._box_geometry()[0]
            tilt = self._box_tilt()
            if any(tilt):
                from ..ops.cellwise import _perp_widths
                lengths = np.asarray(_perp_widths(lengths, tilt))
            return bool(np.all(lengths // r_cut >= 3))
        return method == "cellwise" or isinstance(method, Cellwise)

    def _ensure_layout(self):
        """Plan (once) and cache the slot-resident layout. The plan is
        static geometry closed over by the compiled scan, so it must stay
        identical across run() calls for the cache to be reusable;
        capacity headroom (15% + 3 over measured occupancy) covers later
        density fluctuations, and repack-time overflow is still detected
        every step."""
        from ..ops.cellwise import Cellwise, plan_cellwise
        from .slots import SlotLayout
        r_cut, rc_matrix, _, _ = self._nlist_params()
        # box-changing integrators (NPT) get a DYNAMIC layout: static
        # grid/capacity, geometry derived from the current box per step
        # (a barostat rescale is affine, so slot assignment is preserved
        # in fractional space -- see md/slots.py)
        dynamic = bool(getattr(self.integrator, "changes_box", False))
        lengths, lo = self._box_geometry()
        z_div = self.mesh.shape[self.shard_axis] if self.mesh else 1
        key = (float(r_cut),
               rc_matrix.tobytes() if rc_matrix is not None else None,
               self.state.n_particles, self.dt, z_div, dynamic,
               self._box_tilt(),
               # under a barostat the lengths drift between run() calls;
               # the geometry is dynamic anyway, so the plan is keyed on
               # the initial planning only
               None if dynamic else tuple(float(v) for v in lengths))
        if self._layout is not None and self._layout_key == key:
            return self._layout
        plan = self._plan_from_current()
        if plan is None:
            extra = (f" with nz divisible by the {z_div}-device mesh"
                     if z_div > 1 else "")
            raise ValueError(
                f"Box {lengths} too small for the cellwise mode at "
                f"r_cut={r_cut} (needs >= 3 cells per axis{extra}); "
                "use nlist='n2' instead")
        self._layout = SlotLayout(plan, self.state.n_particles, lo,
                                  rc_matrix=rc_matrix,
                                  dynamic_box=dynamic)
        self._layout_key = key
        return self._layout

    def _vmax_now(self):
        """Max particle speed, computed ON DEVICE with one scalar
        readback instead of shipping the whole velocity array to the host
        (as ``_max_occupancy_now``); this runs at every run() start.

        Warm path: the previous run()'s carried running max (fetched in
        the same packed readback as the overflow flags) is cached on the
        state object it produced -- back-to-back runs skip even the
        scalar round trip. The running
        max bounds the instantaneous max, so every consumer (repack
        interval, planner drift term) errs conservative."""
        c = getattr(self, "_vmax_cache", None)
        if c is not None and c[0] is self.state:
            return c[1]
        fn = getattr(self, "_vmax_fn", None)
        if fn is None:
            @jax.jit
            def fn(v):
                return jnp.sqrt(jnp.max(jnp.sum(v * v, axis=-1)))
            self._vmax_fn = fn
        if self.state.velocities.size == 0:
            return 0.0
        v = float(np.asarray(fn(self.state.velocities)))
        self._vmax_cache = (self.state, v)
        return v

    def _box_geometry(self):
        """``(lengths, lo)`` of the current box with at most ONE device
        readback, cached on the box array's identity. run() re-points
        the cache across static-box scans (the carried box is
        value-identical), so warm back-to-back runs never fetch; a
        barostat (or a user box replacement) makes a new array object
        and re-fetches. Every separate ``np.asarray`` here is a full
        device round trip."""
        box = self.state.box
        c = getattr(self, "_geom_cache", None)
        if c is not None and c[0] is box:
            return c[1], c[2]
        b = np.asarray(box)
        lengths, lo = b[1] - b[0], b[0]
        self._geom_cache = (box, lengths, lo,
                            tuple(float(t) for t in b[2]))
        return lengths, lo

    def _box_tilt(self):
        """Static tilt factors ``(xy, xz, yz)`` of the current box (host
        floats; same identity cache as :meth:`_box_geometry`)."""
        self._box_geometry()
        return self._geom_cache[3]

    def _host_step(self):
        """The current timestep as a host int without a device fetch on
        the warm path: run() knows the committed step arithmetically
        (start + steps run), so only a user-replaced state pays the
        round trip."""
        c = getattr(self, "_step_cache", None)
        if c is not None and c[0] is self.state:
            return c[1]
        v = int(np.asarray(self.state.step))
        self._step_cache = (self.state, v)
        return v

    def _fetch_run_scalars(self, flags, aux):
        """One packed device->host readback for every run()-boundary
        scalar: the overflow/staleness flags plus the carried running
        max occupancy and speed. Fetching them separately costs one
        device round trip EACH; packed (vmax bitcast into the int lane)
        they cost one."""
        if aux is None or "occ_max" not in aux or "vmax" not in aux:
            return int(np.asarray(flags)), None, None
        fn = getattr(self, "_scalar_pack_fn", None)
        if fn is None:
            @jax.jit
            def fn(flags, occ, vmax):
                return jnp.stack([
                    flags.astype(jnp.int32), occ.astype(jnp.int32),
                    jax.lax.bitcast_convert_type(
                        vmax.astype(jnp.float32), jnp.int32)])
            self._scalar_pack_fn = fn
        packed = np.asarray(fn(flags, aux["occ_max"], aux["vmax"]))
        return (int(packed[0]), int(packed[1]),
                float(packed[2:3].view(np.float32)[0]))

    def _drift_estimate(self):
        """Per-step displacement bound for the planner's repack-
        frequency term: dt times the max speed over the 0.8 safety
        factor -- the SAME quantity :meth:`_choose_repack_interval`
        divides the half-skin by, so the grid the planner picks is
        costed with the interval the engine will actually run."""
        vmax = self._vmax_now()
        return self.dt * vmax / 0.8 if vmax > 0 else None

    # static repack intervals are quantized so per-run velocity jitter
    # does not mint a new compiled scan per run() call
    _K_GRID = (1, 2, 3, 4, 5, 6, 8, 10, 12, 14, 16, 20, 24, 32, 48, 64,
               96, 128)

    def _choose_repack_interval(self, layout):
        """Fixed rebuild interval K for the static repack schedule: the
        Verlet bound (skin/2 over the fastest particle's per-step
        displacement) with a 0.8 safety factor (velocities fluctuate up,
        and the rebuild lands one pre_force drift before the first force
        that uses it). Staleness is still checked every step and
        self-heals by halving K (run()). Returns None (use the per-step
        lax.cond) when no displacement bound is derivable.

        Dynamic-box (NPT) layouts take the same schedule: the skin is
        measured from the LIVE box at the run() boundary (one tiny [3,3]
        readback) with half the margin -- the barostat drifts the box
        during the segment, eroding the absolute skin in a way no
        boundary snapshot can bound. The per-step staleness bit plus the
        rollback self-heal (halve K, re-run) make an optimistic interval
        safe: forces are never computed from a stale assignment past
        skin/2."""
        skin = float(layout.plan.skin)
        if layout.dynamic_box:
            lengths = np.asarray(self._box_geometry()[0], dtype=float)
            edges = lengths / np.asarray(layout.plan.grid, dtype=float)
            skin = (float(np.min(edges)) - float(layout.plan.r_cut)) * 0.5
        if skin <= 0:
            return None
        half = 0.98 * skin / 2.0
        per = getattr(self.integrator, "max_disp", None)
        if not per:
            vmax = self._vmax_now()
            # the scan carries the RUNNING max speed (md/slots.py
            # aux['vmax']): the Maxwell tail over thousands of steps
            # sits well above any run()-start snapshot, and an interval
            # sized to the snapshot fires a staleness rollback of the
            # whole segment
            vmax = max([vmax] + [h[0] for h in
                                 getattr(self, "_vmax_hist", [])])
            # zero velocities (cold start): any bound appears after the
            # first kick; start mid-grid and let self-healing correct
            per = self.dt * vmax if vmax > 0 else half / 16.0
        K_est = max(int(half / float(per) * 0.8), 1)
        K = max(g for g in self._K_GRID if g <= K_est)
        if layout.dynamic_box and K == 1:
            # a compressed live box (min(edge) near r_cut) leaves no
            # skin to amortize: the static schedule at K=1 rebuilds
            # every step like the per-step cond, but additionally turns
            # any one-step drift past half-skin into a whole-segment
            # rollback (and, after retries, a hard error) in a regime
            # the cond path handles by just rebuilding. Fall back.
            self._static_K_last = None
            return None
        # hysteresis: per-run velocity jitter flapping K across a grid
        # boundary mints a fresh compiled scan per run() call. Keep the
        # previous K while it is still on the SAFE side (<= the fresh
        # bound) and within one grid notch of it -- a much smaller K
        # (e.g. a quench-phase interval leaking into production) must
        # NOT stick: it costs a rebuild every K steps forever.
        last = getattr(self, "_static_K_last", None)
        if last is not None and last <= K and \
                last >= max(g for g in self._K_GRID if g <= max(K - 1, 1)):
            K = last
        cap = getattr(self, "_static_K_cap", None)
        if cap:
            K = min(K, cap)
        self._static_K_last = K
        return K

    def _hot_stencil(self):
        """Stencil of the analytic pair loop that dominates the step, for
        the planner's cost model: the model's chosen route (set by the
        run()-time route choice, so the first plan may be made before it
        is known; the auto-replan boundary then re-judges), else the
        built-ins' route, else ``'full'``."""
        from ..models.pair import PairModel
        from ..ops import routes
        tfc = self.tfc
        if tfc is not None:
            if tfc.batch_size or tfc.map_enabled:
                return "full"
            if isinstance(tfc.model, PairModel):
                return getattr(tfc, "_pair_fast_stencil", None) or "full"
            if getattr(tfc, "_lane_fast_ok", False):
                return getattr(tfc, "_lane_fast_stencil", None) or "full"
            return "full"
        if not self.forces or not all(hasattr(f, "pair_energy")
                                      for f in self.forces):
            return "full"
        if self.pair_stencil != "auto":
            return self.pair_stencil
        return routes.pair_stencil(_pair_slope_fn(self.forces[0]), True,
                                   self.state.positions.dtype)

    def _model_lane_cost_scale(self):
        """Relative per-lane cost of the hot pair evaluation vs the
        built-in LJ the planner's ``_PAIR_LANE_COST`` was measured on
        (~10 jaxpr primitives). Estimated by tracing the active fast
        pair function and counting primitives -- crude, but the planner
        only needs the ORDER of magnitude: an NN pair potential costs
        10-40x an LJ lane, which flips the grid/repack tradeoff to
        minimum-lane plans (see plan_cellwise lane_cost_scale)."""
        tfc = self.tfc
        if tfc is None or self.state is None:
            return 1.0
        from ..models.pair import PairModel
        model = tfc.model
        ver = getattr(model, "_trace_version", 0)
        key = (ver, bool(getattr(tfc, "_lane_fast_ok", False)))
        cached = getattr(tfc, "_lane_cost_scale_cache", None)
        if cached is not None and cached[0] == key:
            return cached[1]
        fn = None
        if isinstance(model, PairModel):
            if model.proxy_degree:
                # the lane cost the planner should see is the Clenshaw
                # proxy, not the (possibly NN) underlying pair function
                # (built lazily inside the traced probe: the node eval
                # needs built weights)
                r_cut = self._nlist_params()[0] or 3.0
                if model.pair_with_types:
                    fn = lambda r2, t: model.proxy_pair_fn(r_cut)(
                        r2, t, t)
                else:
                    fn = lambda r2, t: model.proxy_pair_fn(r_cut)(r2)
            elif model.pair_with_types:
                fn = lambda r2, t: model.pair_energy_and_slope(r2, t, t)
            else:
                fn = lambda r2, t: model.pair_energy_and_slope(r2)
        elif getattr(tfc, "_lane_fast_ok", False):
            from ..ops.lane_fast import synthesize_pair_fn
            pf = synthesize_pair_fn(model, self.state.box)
            fn = lambda r2, t: pf(r2, t, t)
        scale = 1.0
        if fn is not None:
            try:
                sds = jax.ShapeDtypeStruct((8, 8), jnp.float32)
                jaxpr = jax.make_jaxpr(fn)(sds, sds)
                scale = max(1.0, _count_jaxpr_eqns(jaxpr.jaxpr) / 10.0)
            except Exception:
                scale = 1.0
            if tfc.train and scale > 1.0:
                # a train step runs the pair function ~3x more than an
                # eval step (loss forward + the lane-contraction VJP's
                # forward and backward, ops/pair_train.py)
                scale *= 3.0
        tfc._lane_cost_scale_cache = (key, scale)
        return scale

    def _plan_from_current(self):
        """A fresh cellwise plan from the *current* positions/velocities
        (used by :meth:`_ensure_layout` and the replan hint)."""
        from ..ops.cellwise import Cellwise, plan_cellwise
        tfc = self.tfc
        r_cut, _, method, _ = self._nlist_params()
        lengths, lo = self._box_geometry()
        tilt = self._box_tilt()
        z_div = self.mesh.shape[self.shard_axis] if self.mesh else 1
        if any(tilt) and self.mesh is not None:
            raise NotImplementedError(
                "tilted (triclinic) boxes are not supported with a "
                "device mesh yet; run single-device or untilt the box")
        config = method if isinstance(method, Cellwise) else None
        # typical per-step drift for the planner's repack-frequency term
        drift = self._drift_estimate()
        dynamic = bool(getattr(self.integrator, "changes_box", False))
        if dynamic:
            if any(tilt):
                raise NotImplementedError(
                    "tilted (triclinic) boxes do not support "
                    "box-changing integrators (NPT) yet")
            # barostat headroom: extra minimum skin so ~10% compression
            # keeps a positive Verlet margin before geometry failure
            base = config or Cellwise()
            config = Cellwise(capacity=base.capacity,
                              skin=max(base.skin, 0.15 * r_cut))
        # measured-occupancy calibration: the running max carried by the
        # scan (md/slots.py aux['occ_max']) replaces the planner's blind
        # fluctuation formula once ~300+ steps have been observed at the
        # current box/size (the history is windowed, so transients age
        # out; overflow of a tighter plan still self-heals in run())
        occ_observed = None
        hist = getattr(self, "_occ_hist", [])
        if hist and not dynamic:
            okey = hist[-1][0]
            if okey[1] == tuple(float(v) for v in lengths) and \
                    okey[2] == self.state.n_particles and \
                    sum(h[2] for h in hist) >= 300:
                occ_observed = (okey[0], max(h[1] for h in hist))
        # with a measured running max in hand, the planning-time
        # occupancy snapshot adds nothing (the running max bounds it) --
        # and skipping it skips shipping the position array to the host
        plan = plan_cellwise(
            self.state.n_particles, lengths, r_cut, config=config,
            positions=(None if occ_observed is not None
                       else np.asarray(self.state.positions)), lo=lo,
            drift_per_step=drift, z_divisor=z_div,
            stencil=self._hot_stencil(),
            occ_observed=occ_observed,
            lane_cost_scale=self._model_lane_cost_scale(),
            tilt=tilt)
        # overflow self-healing (run()): a prior capacity overflow sets
        # a floor that every later plan honors -- occupancy measured at
        # planning time can undersell the running fluid's fluctuations
        floor = getattr(self, "_capacity_floor", 0)
        if plan is not None and plan.capacity < floor:
            import dataclasses as _dc
            plan = _dc.replace(plan, capacity=floor)
        if plan is not None and dynamic and \
                (config is None or config.capacity is None):
            # compression densifies cells; 15% extra slots before the
            # repack-overflow error fires
            import dataclasses as _dc
            plan = _dc.replace(
                plan, capacity=int(np.ceil(plan.capacity * 1.15)))
        return plan

    def _make_nlist_builder(self):
        """Resolve the neighbor-list strategy into a ``build(state)``
        closure. The cell list needs static grid geometry, planned here from
        the concrete box (constant under NVE/NVT); small or mapped systems
        use the dense O(N^2) build."""
        from ..ops import cell_list as _cl

        params = self._nlist_params()
        if params is None:
            raise RuntimeError(
                "No neighbor configuration: attach a model with r_cut, "
                "or add built-in forces that declare their own r_cut")
        # per-type-pair rc_matrix covers the mapped AA<->CG exclusion
        # uniformly on every path (reference rcut() matrix,
        # tensorflowcompute.py:284-305)
        r_cut, rc_matrix, method, NN = params
        lengths = self._box_geometry()[0]
        n = self.state.n_particles
        tilted = any(self._box_tilt())
        if tilted and (method in ("cell", "direct") or
                       isinstance(method, _cl.CellList)):
            raise NotImplementedError(
                "tilted (triclinic) boxes support nlist='cellwise' "
                "(slot-resident, the fast path) and 'n2'; the packed "
                f"cell-list tier ({method!r}) is orthorhombic-only")
        if getattr(self.integrator, "changes_box", False) and \
                method != "n2":
            if method != "auto":
                raise ValueError(
                    "Static-geometry neighbor modes (cell/direct) plan "
                    "their grid from the initial box; box-changing "
                    "integrators (NPT) need attach(nlist='n2')")
            method = "n2"  # auto: fall back to the dynamic dense build

        config = method if isinstance(method, _cl.CellList) else \
            _cl.CellList()
        if method == "direct":
            # wide-direct mode: hand the model the masked candidate planes
            # (ops/direct.py) -- zero selection cost
            from ..ops.direct import direct_cell_planes
            grid, capacity = _cl.plan(n, lengths, r_cut, config)
            if grid is None:
                raise ValueError(
                    f"Box {lengths} too small for the direct mode at "
                    f"r_cut={r_cut}")
            if config.capacity is None:
                occ = _cl.max_occupancy(
                    np.asarray(self.state.positions), lengths, grid)
                capacity = max(capacity, int(np.ceil(occ * 1.3)) + 1)
            capacity = max(capacity,
                           getattr(self, "_cl_capacity_floor", 0))

            def build(state):
                return direct_cell_planes(
                    state.positions4, r_cut, grid, capacity,
                    box_size(state.box), rcut_matrix=rc_matrix)
            build.plan = (grid, capacity)
            self._last_cl_capacity = capacity
            return build

        want_cell = isinstance(method, _cl.CellList) or method == "cell"
        if method == "auto":
            want_cell = (n >= 512 and not tilted and
                         config.usable(lengths, r_cut))
        if want_cell:
            grid, capacity = _cl.plan(n, lengths, r_cut, config)
            if grid is None:
                raise ValueError(
                    f"Box {lengths} too small for a cell list at "
                    f"r_cut={r_cut}")
            if config.capacity is None:
                # statistical headroom can still lose to structured initial
                # conditions (an aligned lattice packs ceil(edge/a)^3 into
                # one cell); size from the *measured* occupancy too
                occ = _cl.max_occupancy(
                    np.asarray(self.state.positions), lengths, grid)
                capacity = max(capacity, int(np.ceil(occ * 1.3)) + 1)
            # overflow self-heal floor beats even an explicit capacity
            # on retry (matching the cellwise layout's behavior)
            capacity = max(capacity,
                           getattr(self, "_cl_capacity_floor", 0))

            def build(state):
                return _cl.cell_list_nlist(
                    state.positions4, r_cut, NN, state.box,
                    grid=grid, capacity=capacity, return_overflow=True,
                    rcut_matrix=rc_matrix)
            build.plan = (grid, capacity)
            self._last_cl_capacity = capacity
            return build

        def build(state):
            # full box (not just lengths) when tilted: compute_nlist
            # applies the triclinic minimum image from the tilt row
            nl = compute_nlist(state.positions4, r_cut, NN,
                               state.box if tilted
                               else box_size(state.box),
                               sorted=True, return_types=True,
                               r_cut_matrix=rc_matrix)
            return nl, jnp.asarray(False)
        build.plan = None
        return build

    def _apply_mesh(self, tree, rows):
        """Place every array whose leading dim is the particle/slot axis
        with ``P(shard_axis)`` row sharding; replicate the rest. Sharding
        then propagates through the jitted scan -- the only multi-chip
        machinery needed (XLA inserts the halo collective permutes for the
        z-rolls and all-reduces for the thermo sums)."""
        if self.mesh is None:
            return tree
        from jax.sharding import NamedSharding, PartitionSpec
        mesh, axis = self.mesh, self.shard_axis
        ndev = mesh.shape[axis]
        if rows % ndev:
            raise ValueError(
                f"{rows} rows not divisible by the {ndev}-device mesh")
        rep = NamedSharding(mesh, PartitionSpec())

        def place(x):
            x = jnp.asarray(x)
            if x.ndim >= 1 and x.shape[0] == rows:
                spec = PartitionSpec(axis, *([None] * (x.ndim - 1)))
                return jax.device_put(x, NamedSharding(mesh, spec))
            return jax.device_put(x, rep)

        return jax.tree_util.tree_map(place, tree)

    def _build_nlist(self, state):
        """One-off neighbor build on the current state (host accessors)."""
        if self._use_cellwise():
            layout = self._ensure_layout()
            slot_state, aux, _ = layout.pack_jit(state, ())
            planes = layout.planes(slot_state, aux)
            if self.tfc is not None and self.tfc.map_enabled:
                # accessors see particle-order rows, like the model
                from ..ops.direct import NlistPlanes
                inv = jnp.zeros((layout.n,), jnp.int32) \
                    .at[aux["orig"]].set(
                        jnp.arange(layout.plan.n_slots, dtype=jnp.int32),
                        mode="drop")
                planes = NlistPlanes(*(c[inv] for c in planes))
            return planes
        return self._make_nlist_builder()(state)[0]

    # ------------------------------------------------------------------
    # the fused step
    # ------------------------------------------------------------------
    def _builtin_forces(self, state, nlist, subset=None):
        n = state.n_particles
        dtype = state.positions.dtype
        f = jnp.zeros((n, 4), dtype=dtype)
        w = jnp.zeros((n, 3, 3), dtype=dtype)
        for force in (subset if subset is not None else self.forces):
            fi, wi = force(state, nlist)
            f = f + fi
            w = w + wi
        return f, w

    def _step_flags(self, log):
        """Static per-run decisions that let the compiled step drop dead
        weight from the scan carry:

        - ``always_eval``: with ``period == 1`` the model runs every step,
          so the period ``lax.cond`` and the persisted model-force carry
          disappear (a cond re-writes every carried array each iteration
          even on the pass-through branch -- measurable at 64k).
        - ``needs_virial``: the ``[N, 3, 3]`` virial is only formed and
          written back when something consumes it (thermo logging, a
          virial-outputting model, or built-in forces); otherwise the
          carried array stays loop-invariant and XLA aliases it in place.
        - ``carry_mf`` / ``carry_mvir``: whether stale model forces /
          virials must actually ride the carry (and be permuted through
          cellwise repacks).
        """
        tfc = self.tfc
        always_eval = tfc is None or tfc.period == 1
        needs_virial = bool(log or self.forces or
                            getattr(self.integrator, "needs_virial",
                                    False) or
                            (tfc is not None and tfc.model.virial))
        carry_mf = (tfc is not None and not tfc.train and not always_eval)
        carry_mvir = carry_mf and needs_virial
        return always_eval, needs_virial, carry_mf, carry_mvir

    def _make_step(self, n_extras, extras_shapes, nlist_builder=None,
                   log=False, layout=None, log_period=1,
                   static_repack=False):
        """Build the scan body. Static configuration is closed over.

        The returned function carries a ``refresh`` attribute: ``None``,
        or a jitted one-shot full force evaluation ``carry -> carry``
        for the slim-step mode (see ``slim`` below), which ``run()``
        applies once after the scan so ``sim.thermo()`` / force
        accessors observe exactly what an ungated loop would have left.

        :param static_repack: drop the per-step ``lax.cond`` rebuild from
            the body; ``run()`` instead rebuilds UNCONDITIONALLY between
            fixed-length inner scans (``step.rebuild_carry``), sparing
            the cond's pass-through rewrite of the whole carried state on
            every step. The Verlet criterion
            still runs each step, as a carried STALENESS bit (flags bit
            1): a particle outrunning skin/2 between scheduled rebuilds
            rolls the segment back and halves K (run() self-heal).

        :param layout: a :class:`.slots.SlotLayout` when the cellwise
            (slot-resident) neighbor mode is active; the carried state is
            then in slot order with an ``aux`` dict alongside.
        """
        tfc = self.tfc
        model = tfc.model if tfc else None
        dt = self.dt
        integ = self.integrator
        period = tfc.period if tfc else 1
        train = tfc.train if tfc else False
        # Ghost re-pinning looks elidable for deterministic integrators
        # (zero force -> zero kick -> zero drift), and with the
        # rank-scaled FAR push (ops/cellwise._relative_coords) ghost
        # forces are now exactly zero rather than NaN. Enabling the
        # elision made the COMPILED
        # scan (and only the compiled scan: the identical step, rebuild
        # and wire sequence run eagerly or under a single jit stays
        # finite) produce NaN positions within one Minimize step at
        # N=512 on the CPU backend. Until that compiled-only numerics
        # interaction is understood, the pins stay unconditional; the
        # `stochastic` integrator attribute records which integrators
        # would qualify.
        ghost_pin_needed = layout is not None

        from ..models.pair import PairModel
        from ..ops import cellwise as _cw
        # analytic fast path: pair potentials in the cellwise mode are
        # evaluated forward-only (dU/dr^2 via jvp) -- no vjp replay, no
        # candidate-plane rematerialization (ops/cellwise.
        # analytic_pair_forces). Two ways in:
        # a declared PairModel, or a generic SimModel that the
        # lane-separability probe validated (ops/lane_fast; the
        # validated marker lives on the driver, set by run()).
        fast_route = (layout is not None and tfc is not None and
                      not train and model is not None and
                      model.output_forces and n_extras == 0 and
                      not tfc.batch_size and not tfc.map_enabled)
        if fast_route and isinstance(model, PairModel):
            if model.proxy_degree:
                # Chebyshev proxy (ops/chebyshev.py): node fit happens
                # inside the traced step; the lane function is a
                # Clenshaw recurrence (replayable inside the half-stencil
                # kernel even for NN pair energies)
                rc_static = layout.plan.r_cut
                fast_pair_fn = \
                    lambda state: model.proxy_pair_fn(rc_static)
            else:
                fast_pair_fn = lambda state: model.pair_energy_and_slope
            fast_with_types = model.pair_with_types
            fast_min_r2 = model.min_r2
        elif fast_route and getattr(tfc, "_lane_fast_ok", False):
            from ..ops.lane_fast import synthesize_pair_fn
            fast_pair_fn = lambda state: synthesize_pair_fn(
                model, state.box)
            fast_with_types = True
            fast_min_r2 = 1e-4
        else:
            fast_pair_fn = None
        pair_fast = fast_pair_fn is not None
        mapped_slots = (layout is not None and tfc is not None and
                        tfc.map_enabled)
        if mapped_slots and train:
            raise ValueError(
                "train=True with a mapped neighbor list is not supported "
                "in the cellwise mode; use nlist='cell' or 'n2'")

        def inv_slots(aux):
            """[n_real] slot index of each original particle (the inverse
            of aux['orig']); recomputed per step because repacks permute
            the slots. One small scatter -- the mapped-model row gathers
            built on it are contiguous-row gathers (the fast kind)."""
            n_slots = layout.plan.n_slots
            return jnp.zeros((layout.n,), jnp.int32).at[aux["orig"]].set(
                jnp.arange(n_slots, dtype=jnp.int32), mode="drop")

        def mapped_apply_slots(state, aux):
            """CG mapped-position write-back in slot order (the reference
            precompute, simmodel.py:289-339): gather the all-atom rows
            back to original order, run the mapping, scatter the bead
            positions into their slot rows. Bead rows are virtual -- they
            are repositioned here each step and never integrated."""
            inv = inv_slots(aux)
            aan = tfc.model._map_i
            pos4_p = state.positions4[inv]
            bs = box_size(state.box)
            cg = tfc._map_fxn(pos4_p[:aan], bs)
            cg3 = jnp.asarray(cg)[:, :3].astype(state.positions.dtype)
            positions = state.positions.at[inv[aan:]].set(cg3)
            return dataclasses.replace(state, positions=positions)
        # built-in pair potentials (LJ/WCA) also take the analytic route
        # in cellwise mode -- this speeds both plain built-in runs and
        # the per-step training labels of the online-learning path.
        # Typed per-pair cutoff matrices apply inside the analytic kernel
        # (rcut_matrix below), so neither fast path is gated on them.
        builtin_fast = (layout is not None and bool(self.forces) and
                        all(hasattr(f, "pair_energy")
                            for f in self.forces))
        # under a mesh the half-stencil kernel is shard_map-wrapped on the
        # z-slab cell sharding (ops/cellwise_pallas.py), so meshed runs
        # take the same routes as one device. The built-ins' route is
        # chosen per force inside analytic_pair_forces ('auto'); the
        # model's route was chosen at run() time and may differ (a
        # model's pair function may not replay inside the kernel).
        stencil_choice = self.pair_stencil
        model_stencil = stencil_choice
        if tfc is not None and isinstance(model, PairModel):
            model_stencil = getattr(tfc, "_pair_fast_stencil", None) \
                or stencil_choice
        elif pair_fast or (train and
                           getattr(tfc, "_lane_fast_ok", False)):
            model_stencil = getattr(tfc, "_lane_fast_stencil", None) \
                or stencil_choice

        def model_inputs(state, nlist, with_labels=False, labels=None):
            # optimization_barrier: without it XLA occasionally fuses the
            # neighbor build into the model's vjp and rematerializes the
            # whole build inside the backward pass (observed as a large
            # step-time blowup for NVT + cell-list + autodiff forces).
            # The barrier pins the built nlist as a materialized
            # value. stop_gradient reflects the physics: neighbor
            # *membership* is piecewise constant.
            #
            # The cellwise mode is the exact opposite case: its plane
            # production is cheap elementwise math (rolls + subtraction),
            # so rematerializing it into the model's forward/backward is
            # the *point* -- the [n_slots, 27*cap] planes never reach
            # device memory.
            nlist = jax.lax.stop_gradient(nlist)
            # ...except in TRAIN mode, where the planes are consumed
            # several times (loss forward, parameter backward, capture
            # replay): pinning them once saves the recomputation.
            if layout is None or train:
                nlist = jax.lax.optimization_barrier(nlist)
            inputs = [nlist, state.positions4, state.box]
            if with_labels:
                inputs.append(labels)
            return inputs

        batch_size = tfc.batch_size if tfc else 0

        def _chunk_inputs(state, nlist):
            """Split per-particle arrays into fixed batches (the reference's
            attach(batch_size=k) particle batching,
            ``TensorflowCompute.cc:141-212``). Zero-pads the last chunk."""
            n = state.n_particles
            k = batch_size
            n_chunks = -(-n // k)
            pad = n_chunks * k - n
            pos4 = jnp.pad(state.positions4, ((0, pad), (0, 0)))
            nl = jnp.pad(nlist, ((0, pad), (0, 0), (0, 0)))
            return (pos4.reshape(n_chunks, k, 4),
                    nl.reshape(n_chunks, k, nlist.shape[1], 4), pad)

        def eval_model(mv, state, nlist, aux=None):
            """One model force evaluation (the reference's _finish_update,
            tf2hoomd branch), optionally chunked over particle batches.

            Mapped + cellwise: the model contract is particle-order rows
            (mapped_nlist slices by row index), so the slot-order planes
            and positions are gathered into particle order for the call
            and the returned forces/virial scattered back to slot rows.
            The gathers are contiguous-row gathers on [rows, C] arrays --
            the same access pattern the wide-direct mode uses every step.
            """
            offset = tfc.output_offset
            n = state.n_particles
            dtype = state.positions.dtype

            if mapped_slots:
                from ..ops.direct import NlistPlanes
                inv = inv_slots(aux)
                n_real = layout.n
                nlist_p = NlistPlanes(*(jax.lax.stop_gradient(c)[inv]
                                        for c in nlist))
                pos4_p = state.positions4[inv]
                out, new_mv = _functional(
                    model, mv,
                    lambda: model([nlist_p, pos4_p, state.box],
                                  training=False))
                f_p = jnp.zeros((n_real, 4), dtype=dtype)
                w_p = jnp.zeros((n_real, 3, 3), dtype=dtype)
                if model.output_forces:
                    f = out[0]
                    if f.shape[-1] == 3:
                        f = jnp.concatenate(
                            [f, jnp.zeros_like(f[:, :1])], axis=-1)
                    if f.shape[0] < n_real:
                        f = jnp.pad(f, ((0, n_real - f.shape[0]), (0, 0)))
                    f_p = f
                    if model.virial and len(out) > 1:
                        w = out[1]
                        if w.shape[0] < n_real:
                            w = jnp.pad(
                                w, ((0, n_real - w.shape[0]),
                                    (0, 0), (0, 0)))
                        w_p = w
                n_slots = layout.plan.n_slots
                forces4 = jnp.zeros((n_slots, 4), dtype=dtype) \
                    .at[inv].set(f_p)
                virial = jnp.zeros((n_slots, 3, 3), dtype=dtype) \
                    .at[inv].set(w_p)
                return forces4, virial, tuple(out[offset:]), new_mv

            def postprocess(out, rows):
                forces4 = jnp.zeros((rows, 4), dtype=dtype)
                virial = jnp.zeros((rows, 3, 3), dtype=dtype)
                if model.output_forces:
                    f = out[0]
                    if f.shape[-1] == 3:
                        f = jnp.concatenate(
                            [f, jnp.zeros_like(f[:, :1])], axis=-1)
                    if f.shape[0] < rows:
                        # mapped models may emit forces for the all-atom
                        # rows only; CG bead rows are zero (they are
                        # virtual and repositioned by the mapping)
                        f = jnp.pad(f, ((0, rows - f.shape[0]), (0, 0)))
                    forces4 = f
                    if model.virial and len(out) > 1:
                        w = out[1]
                        if w.shape[0] < rows:
                            w = jnp.pad(
                                w, ((0, rows - w.shape[0]), (0, 0), (0, 0)))
                        virial = w
                return forces4, virial, tuple(out[offset:])

            if not batch_size:
                out, new_mv = _functional(
                    model, mv,
                    lambda: model(model_inputs(state, nlist),
                                  training=False))
                forces4, virial, extras = postprocess(out, n)
                return forces4, virial, extras, new_mv

            pos_c, nl_c, pad = _chunk_inputs(state, nlist)

            def chunk_body(mv, xs):
                pos_k, nl_k = xs
                out, new_mv = _functional(
                    model, mv,
                    lambda: model([nl_k, pos_k, state.box],
                                  training=False))
                return new_mv, postprocess(out, batch_size)

            new_mv, (f_c, w_c, extras_c) = jax.lax.scan(
                chunk_body, mv, (pos_c, nl_c))
            forces4 = f_c.reshape(-1, 4)[:n]
            virial = w_c.reshape(-1, 3, 3)[:n]
            # batched extras keep their leading chunk axis; the driver
            # flattens it into the capture axis like the reference's
            # per-batch output appends (tensorflowcompute.py:331-339)
            return forces4, virial, extras_c, new_mv

        def slot_geometry(state):
            """(lo, lengths) for the analytic kernels: traced from the
            current box in dynamic-box (NPT) mode, static otherwise."""
            if layout.dynamic_box:
                return state.box[0], box_size(state.box)
            return layout.lo, None

        def builtin_forces(state, aux, nlist, subset=None,
                           needs_energy=True, want_virial=True):
            """Built-in force sum; analytic route on slot state when
            every selected force declares pair_energy. ``needs_energy`` /
            ``want_virial`` feed the slim-step gating (the returned
            virial is a zeros array when skipped, keeping cond-branch
            pytrees congruent)."""
            lst = subset if subset is not None else self.forces
            if (builtin_fast and aux is not None and
                    all(hasattr(f, "pair_energy") for f in lst)):
                n = state.n_particles
                dtype = state.positions.dtype
                f = jnp.zeros((n, 4), dtype=dtype)
                w = jnp.zeros((n, 3, 3), dtype=dtype)
                geo_lo, geo_len = slot_geometry(state)
                for force in lst:
                    fi, wi = _cw.analytic_pair_forces(
                        state.positions, state.types, aux["valid"],
                        layout.plan, geo_lo, _pair_slope_fn(force),
                        needs_virial=want_virial, with_types=True,
                        rcut_matrix=layout.rc_matrix,
                        stencil=stencil_choice, lengths=geo_len,
                        needs_energy=needs_energy,
                        mesh=self.mesh, shard_axis=self.shard_axis)
                    f = f + fi
                    if want_virial:
                        w = w + wi
                return f, w
            return self._builtin_forces(state, nlist, subset=subset)

        def fast_eval(mv, state, aux, needs_energy=True,
                      want_virial=None):
            """Analytic pair-force evaluation on slot state (the
            PairModel fast path; replaces eval_model + plane build)."""
            dtype = state.positions.dtype
            if want_virial is None:
                want_virial = self._step_flags(log)[1]
            # parity with eval_model: a model contributes a virial only
            # when it DECLARES one (reference simmodel.py virial flag;
            # the barostat/pressure read zeros from forces-only models
            # on every other route)
            want_virial = want_virial and model.virial

            def run():
                geo_lo, geo_len = slot_geometry(state)
                return _cw.analytic_pair_forces(
                    state.positions, state.types, aux["valid"],
                    layout.plan, geo_lo, fast_pair_fn(state),
                    needs_virial=want_virial,
                    min_r2=fast_min_r2,
                    with_types=fast_with_types,
                    rcut_matrix=layout.rc_matrix,
                    stencil=model_stencil, lengths=geo_len,
                    needs_energy=needs_energy,
                    mesh=self.mesh, shard_axis=self.shard_axis)

            (f4, w), new_mv = _functional(model, mv, run)
            if w is None:
                w = jnp.zeros((state.n_particles, 3, 3), dtype=dtype)
            return f4, w, (), new_mv

        def train_update(mv, opt_state, inputs, labels):
            """One optimizer step on one (batch of) inputs."""
            import optax
            variables = model.variables
            trainable_idx = tfc.trainable_idx

            def loss_fn(params, mv):
                vals = list(mv)
                for i, p in zip(trainable_idx, params):
                    vals[i] = p
                def fn():
                    out = model(inputs, training=True)
                    return model.compute_loss(out, labels), out
                (loss_out, new_vals) = _functional(model, vals, fn)
                loss, out = loss_out
                return loss, (new_vals, out)

            params = [mv[i] for i in trainable_idx]
            (loss, (new_vals, out)), grads = jax.value_and_grad(
                loss_fn, has_aux=True)(params, mv)
            updates, opt_state = tfc.optimizer.update(grads, opt_state,
                                                      params)
            params = optax.apply_updates(params, updates)
            params = [variables[i].constraint(p) if variables[i].constraint
                      else p for i, p in zip(trainable_idx, params)]
            for j, i in enumerate(trainable_idx):
                new_vals[i] = params[j]
            extras = tuple(out[tfc.output_offset:])
            return loss, extras, new_vals, opt_state

        # analytic-route training: for a declared PairModel (the
        # reference's example-06 force-matching shape) or a lane-fast-
        # validated generic SimModel (example 08's NN pair potential),
        # the training forces come from the analytic forward with the
        # HAND-WRITTEN lane-contraction VJP (ops/pair_train.py): the
        # parameter gradient is the loss cotangent contracted against
        # dU'/dtheta in one weighted lane pass, so nothing about the
        # stencil rolls or dual reductions is ever differentiated and
        # the primal can run on the Pallas half-stencil kernel.
        # Plain autodiff through the analytic forward pays the mixed
        # second derivative over the 27-wide lanes, and the synthesized
        # route without the custom VJP pays third-order autodiff; the
        # custom VJP avoids both.
        train_fast = (train and layout is not None and
                      not tfc.batch_size and not tfc.map_enabled and
                      n_extras + tfc.output_offset == 1 and
                      (isinstance(model, PairModel) or
                       getattr(tfc, "_lane_fast_ok", False)))
        train_is_pair_model = isinstance(model, PairModel)
        train_fast_cols = (4 if train_is_pair_model
                           else getattr(tfc, "_lane_fast_cols", 4))
        # the energy column's lanes cost work in the train primal and
        # backward, yet the canonical force-matching loss never reads
        # it. Probe the user's loss once (gradient w.r.t. prediction
        # column 3 at two random points): when it is identically zero
        # AND nothing saves per-step outputs (save_output_period), the
        # train route skips the energy lanes; the prediction keeps its
        # 4-column shape with a zero column, so extras/cond pytrees are
        # unchanged.
        train_energy = train_fast and train_fast_cols == 4
        if train_energy and not (tfc.save_output_period and
                                 tfc.output_offset == 0):
            train_energy = _loss_consumes_energy(model)
        train_fwd_stencil = model_stencil

        def train_fast_update(mv, opt_state, state, aux, labels):
            """One optimizer step through the analytic forward with the
            custom lane-contraction VJP."""
            import optax
            from ..ops.pair_train import pair_train_forces
            variables = model.variables
            trainable_idx = tfc.trainable_idx
            geo_lo, geo_len = slot_geometry(state)

            def rebind(params):
                vals = list(mv)
                for i, p in zip(trainable_idx, params):
                    vals[i] = p
                return vals

            proxy_parts = None
            if train_is_pair_model:
                wt, mr2 = model.pair_with_types, model.min_r2
                if model.proxy_degree:
                    # Chebyshev proxy: the differentiable params of the
                    # lane contraction become the K-node COEFFICIENTS
                    # (computed below inside loss_fn, under the rebound
                    # model params, so grads chain through the fit and
                    # the model-at-nodes -- both K-sized); the kernel-
                    # traced pair function is pure Clenshaw arithmetic.
                    # Typed models use the per-type-pair table variant
                    # (with_types stays on: the masks select the lane's
                    # coefficient set).
                    proxy_parts = model.proxy_parts(layout.plan.r_cut)

                def pair_apply(params, r2, ti=None, tj=None):
                    def fn():
                        if wt:
                            return model.pair_energy_and_slope(r2, ti, tj)
                        return model.pair_energy_and_slope(r2)
                    out, _ = _functional(model, rebind(params), fn)
                    return out
            else:
                from ..ops.lane_fast import synthesize_pair_fn
                wt, mr2 = True, 1e-4

                def pair_apply(params, r2, ti, tj):
                    out, _ = _functional(
                        model, rebind(params),
                        lambda: synthesize_pair_fn(
                            model, state.box)(r2, ti, tj))
                    return out

            def loss_fn(params):
                def fn():
                    if proxy_parts is not None:
                        fit_, eval_ = proxy_parts
                        coeffs = fit_(model.pair_energy_and_slope)
                        f4 = pair_train_forces(
                            coeffs, eval_, state.positions,
                            state.types, aux["valid"], layout.plan,
                            geo_lo, min_r2=mr2, with_types=wt,
                            rcut_matrix=layout.rc_matrix,
                            lengths=geo_len,
                            needs_energy=train_energy,
                            fwd_stencil=train_fwd_stencil,
                            mesh=self.mesh, shard_axis=self.shard_axis)
                    else:
                        f4 = pair_train_forces(
                            params, pair_apply, state.positions,
                            state.types, aux["valid"], layout.plan,
                            geo_lo, min_r2=mr2, with_types=wt,
                            rcut_matrix=layout.rc_matrix,
                            lengths=geo_len,
                            needs_energy=train_energy,
                            fwd_stencil=train_fwd_stencil,
                            mesh=self.mesh, shard_axis=self.shard_axis)
                    out0 = f4[:, :train_fast_cols]
                    return model.compute_loss([out0], labels), (out0,)

                (loss_out, new_vals) = _functional(model, rebind(params),
                                                   fn)
                loss, out = loss_out
                return loss, (new_vals, out)

            params = [mv[i] for i in trainable_idx]
            (loss, (new_vals, out)), grads = jax.value_and_grad(
                loss_fn, has_aux=True)(params)
            updates, opt_state = tfc.optimizer.update(grads, opt_state,
                                                      params)
            params = optax.apply_updates(params, updates)
            params = [variables[i].constraint(p)
                      if variables[i].constraint else p
                      for i, p in zip(trainable_idx, params)]
            for j, i in enumerate(trainable_idx):
                new_vals[i] = params[j]
            # with output_offset 0 (single-loss models) the prediction
            # doubles as the saved extra, exactly like the generic path
            extras = tuple(out[tfc.output_offset:])
            return loss, extras, new_vals, opt_state

        def train_model(mv, opt_state, state, nlist, labels, aux=None):
            """One online training step (the reference's hoomd2tf branch,
            ``tensorflowcompute.py:346-370``), optionally per particle
            batch."""
            if train_fast:
                return train_fast_update(mv, opt_state, state, aux,
                                         labels)
            if not batch_size:
                return train_update(mv, opt_state,
                                    model_inputs(state, nlist), labels)
            n = state.n_particles
            k = batch_size
            pos_c, nl_c, pad = _chunk_inputs(state, nlist)
            lab = jnp.pad(labels, ((0, pad), (0, 0)))
            lab_c = lab.reshape(-1, k, labels.shape[-1])

            def chunk_body(carry, xs):
                mv, opt_state = carry
                pos_k, nl_k, lab_k = xs
                loss, extras, mv, opt_state = train_update(
                    mv, opt_state, [nl_k, pos_k, state.box], lab_k)
                return (mv, opt_state), (loss, extras)

            (mv, opt_state), (losses, extras_c) = jax.lax.scan(
                chunk_body, (mv, opt_state), (pos_c, nl_c, lab_c))
            return jnp.mean(losses), extras_c, mv, opt_state

        always_eval, needs_virial, carry_mf, carry_mvir = \
            self._step_flags(log)
        # slim-step mode: in the hot (always-eval, no-log, no-train)
        # loop the analytic kernels drop the per-particle energy -- and
        # the virial when nothing in the loop consumes it -- on EVERY
        # step; run() then applies one full evaluation (``refresh``)
        # after the scan, so post-run observable state is identical to
        # the ungated form at ~zero amortized cost. (A per-step
        # last-iteration lax.cond was measured SLOWER than not gating at
        # all: the cond pins both branches' [N,4]/[N,3,3] outputs as
        # materialized values and breaks the kernel->integrator fusion.)
        virial_in_loop = bool(log or
                              getattr(self.integrator, "needs_virial",
                                      False) or
                              (tfc is not None and tfc.model.virial))
        slim = (not log and not train and always_eval and
                layout is not None and (pair_fast or builtin_fast))
        # train-mode analog: the online-training loop's built-in
        # evaluation (labels + driving forces) skips the virial (6 extra
        # dual channels) on every step when nothing in the loop consumes
        # it -- and run()'s
        # refresh restores full post-run observable state exactly like
        # eval-mode slim. The energy column stays on: labels feed the
        # user's loss, which may consume column 4.
        slim_train = (not log and train and always_eval and
                      layout is not None and builtin_fast)

        def step(carry, it):
            (state, aux, mv, opt_state, model_forces, model_virial,
             overflow) = carry
            stale_now = None
            state = integ.pre_force(state, dt)
            if layout is not None:
                # ghosts must stay inert through any integrator substep.
                # Stochastic integrators kick every row, so their ghosts
                # need an explicit re-pin; deterministic ones provably
                # leave ghosts fixed (zero force -> zero kick, zero
                # velocity -> zero drift; the drift's wrap is a no-op at
                # a cell center), EXCEPT under a dynamic box where the
                # barostat rescale moves the cell centers themselves.
                if ghost_pin_needed:
                    state = layout.ghost_pin(state, aux)
                if mapped_slots:
                    # reposition CG bead rows BEFORE the rebuild check so
                    # a mapping-induced bead move triggers the repack
                    state = mapped_apply_slots(state, aux)
                if static_repack:
                    # no in-body rebuild: run() repacks unconditionally
                    # between inner scans (step.rebuild_carry). The
                    # Verlet check still runs -- as a cheap carried bit,
                    # not a cond: staleness rolls the segment back.
                    stale_now = layout.needs_rebuild(state, aux)
                else:
                    # carried stale model forces must follow their
                    # particles through the repack permutation. NOTE a
                    # narrower cond (argsort under the cond, the state
                    # gather applied unconditionally with an identity
                    # permutation) pays eight per-step [n_slots] state
                    # gathers; it was slower than the cond's pass-through
                    # rewrite before the GPU port (not re-measured).
                    perm_in = ((model_forces,) if carry_mf else ()) + \
                        ((model_virial,) if carry_mvir else ())

                    def do_rebuild(args):
                        st, ax, ex = layout.rebuild(args[0], args[1],
                                                    args[2:])
                        return (st, ax) + tuple(ex)

                    out = jax.lax.cond(
                        layout.needs_rebuild(state, aux), do_rebuild,
                        lambda args: args, (state, aux) + perm_in)
                    state, aux = out[0], out[1]
                    if carry_mf:
                        model_forces = out[2]
                    if carry_mvir:
                        model_virial = out[3 if carry_mf else 2]
                model_needs_planes = (tfc is not None and
                                      ((train and not train_fast) or
                                       (not train and not pair_fast)))
                builtins_need_planes = bool(self.forces) and \
                    not builtin_fast
                if model_needs_planes or builtins_need_planes:
                    nlist = layout.planes(state, aux)
                else:
                    nlist = None
                cell_overflow = aux["overflow"]
                if layout.dynamic_box:
                    cell_overflow = jnp.logical_or(
                        cell_overflow, layout.geometry_bad(state))
            else:
                # CG mapped positions write-back (reference precompute,
                # simmodel.py:289-339) happens before the nlist build
                if tfc is not None and tfc.map_enabled:
                    state = tfc.apply_mapping(state)
                if nlist_builder is not None:
                    nlist, cell_overflow = nlist_builder(state)
                else:
                    nlist = jnp.zeros(
                        (state.n_particles, 1, 4),
                        dtype=state.positions.dtype)
                    cell_overflow = jnp.asarray(False)

            loss = jnp.asarray(0.0, dtype=state.positions.dtype)
            extras = tuple(
                jnp.zeros(s, dtype=state.positions.dtype)
                for s in extras_shapes)
            if tfc is not None:
                if not train:
                    if always_eval:
                        if pair_fast and slim:
                            f_now, w_now, extras, mv = fast_eval(
                                mv, state, aux, needs_energy=False,
                                want_virial=virial_in_loop)
                        else:
                            f_now, w_now, extras, mv = (
                                fast_eval(mv, state, aux) if pair_fast
                                else eval_model(mv, state, nlist, aux))
                    else:
                        recompute = (state.step % period) == 0

                        def do_eval(args):
                            mv, mf, mvir = args
                            f, w, ex, new_mv = (
                                fast_eval(mv, state, aux) if pair_fast
                                else eval_model(mv, state, nlist, aux))
                            return (new_mv, f,
                                    w if carry_mvir else mvir, ex)

                        def keep(args):
                            mv, mf, mvir = args
                            return mv, mf, mvir, extras

                        mv, model_forces, model_virial, extras = \
                            jax.lax.cond(recompute, do_eval, keep,
                                         (mv, model_forces, model_virial))
                        f_now, w_now = model_forces, model_virial
                    if builtin_fast and slim:
                        f_b, w_b = builtin_forces(
                            state, aux, nlist, needs_energy=False,
                            want_virial=virial_in_loop)
                    else:
                        f_b, w_b = builtin_forces(state, aux, nlist)
                    net_f = f_b + f_now
                    net_w = (w_b + w_now) if needs_virial else None
                else:
                    # labels: selected reference forces, or all
                    # built-ins. When the label set IS the full
                    # built-in set (the common online-learning shape,
                    # reference example 08), ONE evaluation serves both
                    # the labels and the driving forces instead of
                    # paying the label evaluation twice. The reference
                    # computes them once too: its labels
                    # tensor is the HOOMD net force
                    # (tensorflowcompute.py:346-370).
                    lab_subset = tfc.reference_forces or None
                    want_w = (virial_in_loop if slim_train else True)
                    if lab_subset is None:
                        f_b, w_b = builtin_forces(
                            state, aux, nlist, want_virial=want_w)
                        f_ref = f_b
                    else:
                        f_ref, _ = builtin_forces(
                            state, aux, nlist, subset=lab_subset,
                            want_virial=False)
                        f_b, w_b = builtin_forces(
                            state, aux, nlist, want_virial=want_w)
                    if always_eval:
                        loss, extras, mv, opt_state = train_model(
                            mv, opt_state, state, nlist, f_ref, aux=aux)
                    else:
                        recompute = (state.step % period) == 0

                        def do_train(args):
                            mv, opt_state = args
                            l, ex, new_mv, new_opt = train_model(
                                mv, opt_state, state, nlist, f_ref,
                                aux=aux)
                            return new_mv, new_opt, l, ex

                        def keep(args):
                            mv, opt_state = args
                            return mv, opt_state, loss, extras

                        mv, opt_state, loss, extras = jax.lax.cond(
                            recompute, do_train, keep, (mv, opt_state))
                    net_f = f_b
                    net_w = w_b if needs_virial else None
            else:
                f_b, w_b = builtin_forces(state, aux, nlist)
                net_f = f_b
                net_w = w_b if needs_virial else None

            if tfc is not None and tfc.map_enabled:
                # CG beads are virtual: they exert no direct force and are
                # repositioned by the mapping each step (reference: only
                # the aa_group is integrated). In slot layout the bead
                # rows are identified by their original index.
                if layout is not None:
                    keep_rows = (aux["orig"] <
                                 tfc.model._map_i).astype(net_f.dtype)
                else:
                    keep_rows = (jnp.arange(state.n_particles) <
                                 tfc.model._map_i).astype(net_f.dtype)
                net_f = net_f * keep_rows[:, None]
            # slim mode leaves the carried virial untouched (stale) in
            # the loop; refresh() writes the real one once post-scan
            write_virial = needs_virial and (
                not (slim or slim_train) or virial_in_loop)
            if layout is not None:
                # ghost rows carry no force, energy or virial
                valid = aux["valid"]
                net_f = net_f * valid[:, None]
                if write_virial:
                    net_w = net_w * valid[:, None, None]
            if write_virial:
                state = dataclasses.replace(state, forces=net_f,
                                            virial=net_w)
            else:
                # leave the carried virial loop-invariant (XLA aliases it
                # in place instead of re-writing [N, 3, 3] every step)
                state = dataclasses.replace(state, forces=net_f)
            state = integ.post_force(state, dt)
            if layout is not None and ghost_pin_needed:
                state = layout.ghost_pin(state, aux)
            log_now = ((state.step % log_period) == 0) if log else None
            state = dataclasses.replace(state, step=state.step + 1)
            # thermo reductions only on logged steps: at log_period > 1
            # the KE/PE/pressure sums are dead weight in the hot loop
            # (the host filter drops the other rows anyway)
            if log and log_period > 1:
                dt_ = state.positions.dtype
                thermo_y = jax.lax.cond(
                    log_now,
                    lambda: _thermo.thermo(state),
                    lambda: {k: jnp.zeros((), dtype=dt_)
                             for k in ("kinetic_energy", "potential_energy",
                                       "temperature", "pressure")})
            elif log:
                thermo_y = _thermo.thermo(state)
            else:
                thermo_y = {}
            # failure flags ride the carry (OR-accumulated) instead of
            # the per-step ys: one int checked once at the end of the
            # run. Bit 0 = capacity overflow; bit 1 = Verlet staleness
            # under the static repack schedule.
            overflow = overflow | cell_overflow.astype(jnp.int32)
            if stale_now is not None:
                overflow = overflow | (stale_now.astype(jnp.int32) << 1)
            ys = ((loss, extras, thermo_y) if (train or n_extras)
                  else (loss, (), thermo_y))
            return (state, aux, mv, opt_state, model_forces,
                    model_virial, overflow), ys

        if slim or slim_train:
            def refresh(carry):
                """One full-flag force evaluation at the carry's current
                positions (identical forces; adds the energy column and,
                when ``needs_virial``, the virial the slim loop skipped).
                In train mode the net force is the built-ins alone (the
                step's own convention: the trained model does not drive
                the dynamics)."""
                (state, aux, mv, opt_state, model_forces, model_virial,
                 overflow) = carry
                need_planes = ((tfc is not None and not train and
                                not pair_fast) or
                               (bool(self.forces) and not builtin_fast))
                nlist = layout.planes(state, aux) if need_planes else None
                if tfc is None or train:
                    dtype = state.positions.dtype
                    f_now = jnp.zeros((state.n_particles, 4), dtype)
                    w_now = jnp.zeros((state.n_particles, 3, 3), dtype)
                elif pair_fast:
                    f_now, w_now, _, mv = fast_eval(
                        mv, state, aux, needs_energy=True,
                        want_virial=needs_virial)
                else:
                    f_now, w_now, _, mv = eval_model(mv, state, nlist,
                                                     aux)
                f_b, w_b = builtin_forces(state, aux, nlist)
                net_f = f_b + f_now
                net_w = (w_b + w_now) if needs_virial else None
                if tfc is not None and tfc.map_enabled:
                    keep_rows = (aux["orig"] <
                                 tfc.model._map_i).astype(net_f.dtype)
                    net_f = net_f * keep_rows[:, None]
                valid = aux["valid"]
                net_f = net_f * valid[:, None]
                if needs_virial:
                    net_w = net_w * valid[:, None, None]
                    state = dataclasses.replace(state, forces=net_f,
                                                virial=net_w)
                else:
                    state = dataclasses.replace(state, forces=net_f)
                return (state, aux, mv, opt_state, model_forces,
                        model_virial, overflow)

            step.refresh = jax.jit(refresh)
        else:
            step.refresh = None

        if static_repack and layout is not None:
            def rebuild_carry(carry):
                """Unconditional repack of the full carry (run() calls
                this between the fixed-length inner scans)."""
                (state, aux, mv, opt_state, model_forces, model_virial,
                 overflow) = carry
                perm_in = ((model_forces,) if carry_mf else ()) + \
                    ((model_virial,) if carry_mvir else ())
                state, aux, ex = layout.rebuild(state, aux, perm_in)
                if carry_mf:
                    model_forces = ex[0]
                if carry_mvir:
                    model_virial = ex[1 if carry_mf else 0]
                return (state, aux, mv, opt_state, model_forces,
                        model_virial, overflow)

            step.rebuild_carry = rebuild_carry
        else:
            step.rebuild_carry = None

        return step

    # ------------------------------------------------------------------
    def _warmup(self):
        """One eager model call to build lazy variables and discover the
        extra-output shapes before functionalizing for the scan. Cached per
        attach configuration: the eager call is host-dispatch heavy, and
        shapes are static per config."""
        tfc = self.tfc
        if tfc is None:
            return 0, ()
        key = (tfc.config_key, self.state.n_particles)
        cached = getattr(tfc, "_warmup_cache", None)
        if cached is not None and cached[0] == key:
            return cached[1]
        result = self._warmup_impl()
        tfc._warmup_cache = (key, result)
        return result

    def _warmup_impl(self):
        """Discover the extra-output count/shapes and build lazy model
        variables -- entirely *abstractly* (ShapeDtypeStruct inputs +
        jax.eval_shape): no neighbor build, no model FLOPs, no device
        dispatch."""
        tfc = self.tfc
        n = self.state.n_particles
        dt = self.state.positions.dtype
        sds = jax.ShapeDtypeStruct
        box = sds((3, 3), dt)
        if self._use_cellwise():
            # the model sees slot-order rows (candidate planes) here --
            # except in mapped mode, where the engine gathers them back
            # to particle order (mapped_nlist slices by row index)
            from ..ops.direct import NlistPlanes
            layout = self._ensure_layout()
            ns, C = layout.plan.n_slots, layout.plan.width
            if tfc.map_enabled:
                ns = layout.n
            planes = NlistPlanes(dx=sds((ns, C), dt), dy=sds((ns, C), dt),
                                 dz=sds((ns, C), dt),
                                 type=sds((ns, C), dt))
            inputs = [planes, sds((ns, 4), dt), box]
            tfc.model.ensure_built(inputs, training=tfc.train)
            out = _eval_silent(tfc.model, inputs, tfc.train)
            extras = out[tfc.output_offset:]
            return len(extras), tuple(tuple(e.shape) for e in extras)
        NN = max(1, tfc.nneighbor_cutoff)
        builder = (self._make_nlist_builder()
                   if tfc.nneighbor_cutoff > 0 else None)
        if builder is not None and getattr(builder, "plan", None) and \
                getattr(tfc, "nlist_method", None) == "direct":
            from ..ops.direct import NlistPlanes
            grid, capacity = builder.plan
            C = 27 * capacity
            nlist = NlistPlanes(dx=sds((n, C), dt), dy=sds((n, C), dt),
                                dz=sds((n, C), dt), type=sds((n, C), dt))
        else:
            nlist = sds((n, NN, 4), dt)
        if tfc.batch_size:
            # batched: the model sees one particle chunk per call and the
            # scan stacks extras with a leading chunk axis
            k = tfc.batch_size
            n_chunks = -(-n // k)
            nl = sds((k,) + nlist.shape[1:], dt)
            inputs = [nl, sds((k, 4), dt), box]
            tfc.model.ensure_built(inputs, training=tfc.train)
            out = _eval_silent(tfc.model, inputs, tfc.train)
            extras = out[tfc.output_offset:]
            return len(extras), tuple((n_chunks,) + tuple(e.shape)
                                      for e in extras)
        inputs = [nlist, sds((n, 4), dt), box]
        tfc.model.ensure_built(inputs, training=tfc.train)
        out = _eval_silent(tfc.model, inputs, tfc.train)
        extras = out[tfc.output_offset:]
        return len(extras), tuple(tuple(e.shape) for e in extras)

    def run(self, n, log_period=None):
        """Advance the simulation ``n`` steps.

        Executes as ``ceil(n / scan_block)`` dispatches of one compiled
        fixed-length scan (plus a remainder scan), so the compiled program
        is reused across different ``n`` and host/device buffers for
        logging stay bounded by ``scan_block`` instead of ``n``.

        Self-healing capacity (HOOMD's cell list resizes itself on
        overflow): if a cellwise run overflows its planned per-cell
        capacity (e.g. the melt of a jittered start packs cells harder
        than the planning-time configuration), the run is rolled back to
        its starting state, the plan is rebuilt with a larger capacity
        floor, and the segment re-runs -- nothing of the overflowing
        attempt (state, logs, outputs) is committed. Disable with
        ``auto_replan=False`` to get the hard error instead.

        :param log_period: if set, record thermodynamic quantities every
            this many steps into ``self.log`` (dict of numpy arrays, the
            analog of the reference's hoomd ``analyze.log`` integration).
        """
        if self.state is None:
            raise RuntimeError("Initialize the simulation state first "
                               "(init_lattice / init_state)")
        n = int(n)
        if n <= 0:
            return
        for attempt in range(5):
            if self._run_once(n, log_period, allow_retry=attempt < 4):
                return

    def _run_once(self, n, log_period, allow_retry=False):
        """One attempt at :meth:`run`; returns False to request a
        retry after a capacity-overflow rollback."""
        tfc = self.tfc
        n_extras, extras_shapes = self._warmup() if tfc else (0, ())
        log = log_period is not None
        layout = self._ensure_layout() if self._use_cellwise() else None

        if layout is not None:
            layout = self._maybe_auto_replan(layout)
            if tfc is not None:
                self._probe_lane_fast(layout, n_extras)

        # static repack schedule: rebuild unconditionally every K steps
        # instead of a per-step lax.cond (see _make_step static_repack)
        integ_id = id(self.integrator)
        if getattr(self, "_static_K_integ", None) != integ_id:
            # integrator swap (e.g. Minimize quench -> NVT production):
            # the old regime's interval and speed history must not
            # anchor the new one's
            self._static_K_last = None
            self._vmax_hist = []
            self._static_K_integ = integ_id
        static_K = (self._choose_repack_interval(layout)
                    if layout is not None else None)

        block = int(self.scan_block) if self.scan_block else n
        segments = [block] * (n // block)
        if n % block:
            segments.append(n % block)

        # integrator identity is part of the cache key: swapping
        # sim.integrator (e.g. Minimize quench -> NVT production) must
        # recompile the step, not reuse the old integrator's scan
        integ_key = (type(self.integrator).__name__,
                     tuple(sorted((k, v) for k, v in
                           vars(self.integrator).items()
                           if isinstance(v, (int, float, bool, str)))))
        base_key = (n_extras, extras_shapes,
                    tfc.config_key if tfc else None,
                    len(self.forces), log, log_period,
                    layout.plan if layout else None,
                    getattr(tfc, "_lane_fast_ok", False),
                    getattr(tfc, "_lane_fast_stencil", None),
                    getattr(tfc, "_pair_fast_stencil", None),
                    self.pair_stencil, integ_key)

        # the scan carry rides the wire in SoA column form (_Cols), a
        # layout chosen before the GPU port and not re-measured here
        # (ROADMAP):
        # - per-step-cond path: every inner iteration;
        # - static-repack path: ONLY the outer (rebuild) boundaries
        #   (re-splitting inside the inner loop blocks in-loop fusion).
        wire_rows = (layout.plan.n_slots if layout is not None
                     else self.state.n_particles)

        def w(c):
            return _wire(c, wire_rows)

        def scan_for(length):
            cache_key = (length, static_K) + base_key
            if cache_key not in self._scan_cache:
                nlist_builder = (self._make_nlist_builder()
                                 if (layout is None and
                                     self._nlist_params() is not None)
                                 else None)
                step = self._make_step(n_extras, extras_shapes,
                                       nlist_builder, log=log,
                                       layout=layout,
                                       log_period=log_period or 1,
                                       static_repack=bool(static_K))

                def wire_step(c, x):
                    c2, ys = step(_unwire(c), x)
                    return w(c2), ys

                if static_K and step.rebuild_carry is not None:
                    # outer scan over repack periods; each outer step
                    # repacks unconditionally then runs K cond-free
                    # inner steps (sparing the cond's whole-carry
                    # pass-through rewrite on every step)
                    base_rebuild = step.rebuild_carry

                    n_outer, rem = divmod(length, static_K)

                    def outer_body(c, x):
                        c2 = base_rebuild(_unwire(c))
                        c2, ys = jax.lax.scan(step, c2, None,
                                              length=static_K)
                        return w(c2), ys

                    @jax.jit
                    def scan_n(carry):
                        ys_parts = []
                        if n_outer:
                            carry, ys = jax.lax.scan(
                                outer_body, carry, None, length=n_outer)
                            ys = jax.tree_util.tree_map(
                                lambda a: a.reshape(
                                    (n_outer * static_K,) + a.shape[2:]),
                                ys)
                            ys_parts.append(ys)
                        if rem:
                            c2 = base_rebuild(_unwire(carry))
                            c2, ys2 = jax.lax.scan(
                                step, c2, None, length=rem)
                            carry = w(c2)
                            ys_parts.append(ys2)
                        ys = (ys_parts[0] if len(ys_parts) == 1 else
                              jax.tree_util.tree_map(
                                  lambda *xs: jnp.concatenate(xs, 0),
                                  *ys_parts))
                        return carry, ys
                else:
                    @jax.jit
                    def scan_n(carry):
                        return jax.lax.scan(wire_step, carry, None,
                                            length=length)

                if step.refresh is not None:
                    base_refresh = step.refresh

                    @jax.jit
                    def refresh_w(c):
                        return w(base_refresh(_unwire(c)))
                else:
                    refresh_w = None
                self._scan_cache[cache_key] = (scan_n, refresh_w)
            return self._scan_cache[cache_key]

        mv = get_state(tfc.model) if tfc else []
        opt_state = tfc.ensure_opt_state(mv) if (tfc and tfc.train) else ()
        dtype = self.state.positions.dtype
        nparticles = self.state.n_particles
        always_eval, needs_virial, carry_mf, carry_mvir = \
            self._step_flags(log)
        # model forces persist across run() calls (the reference's staging
        # buffer persists between period-gated evaluations); they only
        # ride the carry when the period cond actually needs them
        if carry_mf:
            mf0, mvir0 = tfc.persisted_model_forces(nparticles, dtype)
            if not carry_mvir:
                mvir0 = jnp.zeros((0, 3, 3), dtype=dtype)
        else:
            mf0 = jnp.zeros((0, 4), dtype=dtype)
            mvir0 = jnp.zeros((0, 3, 3), dtype=dtype)
        if layout is not None:
            # pack cache: back-to-back run() calls on the state object
            # the previous run produced skip the repack (and its host
            # dispatch round trips). Any user replacement of sim.state is
            # a new object and misses.
            cached = getattr(self, "_packed_cache", None)
            if cached is not None and \
                    cached["state_ref"] is self.state and \
                    cached["layout"] is layout and \
                    cached["flags"] == (carry_mf, carry_mvir):
                start_state, aux0, mf0, mvir0 = cached["vals"]
                if "vmax" in aux0:
                    # the carried running-max speed is a PER-RUN
                    # statistic (its history is windowed); reusing the
                    # previous run's ratchet would make the repack
                    # interval shrink monotonically forever
                    aux0 = {**aux0, "vmax": jnp.sqrt(jnp.max(jnp.sum(
                        start_state.velocities ** 2, axis=-1)))}
            else:
                to_pack = ((mf0,) if carry_mf else ()) + \
                    ((mvir0,) if carry_mvir else ())
                start_state, aux0, packed = layout.pack_jit(
                    self.state, to_pack)
                if carry_mf:
                    mf0 = packed[0]
                if carry_mvir:
                    mvir0 = packed[1]
                if self.mesh is not None:
                    start_state, aux0, mf0, mvir0 = self._apply_mesh(
                        (start_state, aux0, mf0, mvir0),
                        layout.plan.n_slots)
        else:
            start_state, aux0 = self.state, {}
            if self.mesh is not None:
                start_state, mf0, mvir0 = self._apply_mesh(
                    (start_state, mf0, mvir0), self.state.n_particles)
        carry = (start_state, aux0, mv, opt_state, mf0, mvir0,
                 jnp.asarray(0, jnp.int32))
        carry = _wire_jit(carry, wire_rows)
        box_before = self.state.box
        start_step = self._host_step()
        seg_start = start_step
        log_entries = []
        collect_buf = []
        # the compiled block and the shapes it takes, for introspection
        # (compile time, memory analysis) without holding any buffer
        self._last_scan = (scan_for(segments[0])[0], jax.tree_util.tree_map(
            lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype), carry))
        for length in segments:
            carry, ys = scan_for(length)[0](carry)
            if log:
                steps = np.arange(seg_start, seg_start + length)
                keep = (steps % log_period) == 0
                if keep.any():
                    entry = {k: np.asarray(v)[keep]
                             for k, v in ys[2].items()}
                    entry["step"] = steps[keep]
                    log_entries.append(entry)
            if tfc:
                collect_buf.append((seg_start, length, ys[:2]))
            seg_start += length
        refresh = scan_for(segments[-1])[1]
        if refresh is not None:
            # slim-step loops skip the energy column (and sometimes the
            # virial); one full evaluation at the final positions makes
            # post-run state bit-identical to an ungated loop
            carry = refresh(carry)
        state, aux, mv, opt_state, mf, mvir, flags = \
            _unwire_jit(carry)
        flags_now, occ_max_now, vmax_now = self._fetch_run_scalars(
            flags, aux if layout is not None else None)
        overflow_now = bool(flags_now & 1)
        stale_now = bool(flags_now & 2)
        if overflow_now and allow_retry and self.auto_replan and \
                layout is not None and not layout.dynamic_box:
            # roll back and self-heal (HOOMD's cell list resizes itself
            # on overflow): nothing from this attempt is committed --
            # self.state still holds the attempt's starting state -- and
            # the next attempt replans with a larger capacity floor
            import warnings
            # growth: 1.3x the failed capacity, but at least what the
            # rollback state's occupancy measures right now (an absurdly
            # undersized explicit capacity converges in one retry)
            floor = max(
                int(np.ceil(layout.plan.capacity * 1.3)) + 1,
                int(np.ceil(self._max_occupancy_now(layout) * 1.15)) + 3)
            self._capacity_floor = max(
                getattr(self, "_capacity_floor", 0), floor)
            self._layout = None
            warnings.warn(
                f"cell capacity {layout.plan.capacity} exceeded; "
                f"replanning with capacity >= {floor} and re-running "
                f"these {sum(segments)} steps from their start")
            return False
        if overflow_now and allow_retry and self.auto_replan and \
                layout is None and \
                getattr(self, "_last_cl_capacity", 0):
            # the packed/direct cell builders size their capacity once
            # from planning-time occupancy; the same rollback self-heal
            # as the cellwise layout applies (HOOMD's cell list resizes
            # itself on overflow)
            import warnings
            cap_used = self._last_cl_capacity
            self._cl_capacity_floor = max(
                getattr(self, "_cl_capacity_floor", 0),
                int(np.ceil(cap_used * 1.3)) + 1)
            self._scan_cache.clear()
            warnings.warn(
                f"cell capacity {cap_used} exceeded; rebuilding the "
                f"neighbor plan with capacity >= "
                f"{self._cl_capacity_floor} and re-running these "
                f"{sum(segments)} steps from their start")
            return False
        if stale_now and not overflow_now and static_K and allow_retry:
            # a particle outran skin/2 between two scheduled rebuilds:
            # some force evaluations may have missed an incoming
            # neighbor. Roll back (nothing committed) and re-run one
            # grid notch shorter -- but if this same segment keeps
            # failing (pathological estimate), fall to quartering so
            # the retry budget still converges. The cap DECAYS back up
            # after consecutive clean runs (_static_K_clean below): one
            # rare fast particle must not pin a short interval forever.
            import warnings
            notch = max([g for g in self._K_GRID if g < static_K],
                        default=1)
            prev_cap = getattr(self, "_static_K_cap", None)
            self._static_K_cap = (max(1, static_K // 4)
                                  if prev_cap == static_K else notch)
            self._static_K_clean = 0
            warnings.warn(
                f"Verlet staleness under the static repack schedule "
                f"(interval {static_K}); re-running these "
                f"{sum(segments)} steps with interval "
                f"{self._static_K_cap}")
            return False
        if static_K and not overflow_now and not stale_now and \
                getattr(self, "_static_K_cap", None):
            # decay the staleness cap back up: after two consecutive
            # clean runs of substance, allow one grid notch more --
            # costs at most one more rollback if it was still too long
            self._static_K_clean = \
                getattr(self, "_static_K_clean", 0) + 1
            if self._static_K_clean >= 2 and sum(segments) >= 200:
                self._static_K_cap = min(
                    [g for g in self._K_GRID if g > self._static_K_cap],
                    default=self._static_K_cap)
                self._static_K_clean = 0
        if layout is not None and occ_max_now is not None and \
                not overflow_now and not stale_now:
            # measured running max cell occupancy (carried through every
            # repack for free): feeds replan() capacity calibration
            # (ops/cellwise.plan_cellwise occ_observed). Windowed so a
            # cold-start transient (the melt) ages out of the statistic.
            # Recorded only for COMMITTED attempts -- statistics from a
            # rolled-back stale/overflow run would key occupancy measured
            # under a drifted live box to the static plan geometry.
            okey = (layout.plan.grid, layout.plan.lengths,
                    self.state.n_particles)
            hist = [h for h in getattr(self, "_occ_hist", [])
                    if h[0] == okey]
            hist.append((okey, occ_max_now, sum(segments)))
            while len(hist) > 1 and \
                    sum(h[2] for h in hist[:-1]) > 2000:
                hist.pop(0)
            self._occ_hist = hist
            # running max speed, same windowing: feeds the static
            # repack interval (the Maxwell tail over a whole run sits
            # well above any snapshot; an undersized interval costs a
            # staleness rollback of the whole segment)
            vhist = getattr(self, "_vmax_hist", [])
            vhist.append((vmax_now, sum(segments)))
            while len(vhist) > 1 and \
                    sum(h[1] for h in vhist[:-1]) > 3000:
                vhist.pop(0)
            self._vmax_hist = vhist
        if layout is not None:
            slot_vals = (state, aux, mf, mvir)
            to_unpack = ((mf,) if carry_mf else ()) + \
                ((mvir,) if carry_mvir else ())
            state, unpacked = layout.unpack_jit(state, aux, to_unpack)
            if carry_mf:
                mf = unpacked[0]
            if carry_mvir:
                mvir = unpacked[1]
        self.state = state
        # warm-path host caches: the committed step is arithmetic, the
        # running-max speed came in the packed flags fetch, and a
        # static-box scan carries the box value-identically -- so the
        # next run() boundary costs ZERO extra device round trips
        self._step_cache = (self.state, start_step + sum(segments))
        if vmax_now is not None:
            self._vmax_cache = (self.state, vmax_now)
        g = getattr(self, "_geom_cache", None)
        if g is not None and g[0] is box_before and \
                not getattr(self.integrator, "changes_box", False):
            self._geom_cache = (self.state.box,) + tuple(g[1:])
        if layout is not None:
            # the strong state_ref makes the identity check safe against
            # id() reuse after garbage collection
            self._packed_cache = {"state_ref": self.state,
                                  "layout": layout,
                                  "flags": (carry_mf, carry_mvir),
                                  "vals": slot_vals}
        if log_entries:
            entry = {k: np.concatenate([e[k] for e in log_entries])
                     for k in log_entries[0]}
            if not hasattr(self, "log") or self.log is None:
                self.log = entry
            else:
                self.log = {k: np.concatenate([self.log[k], entry[k]])
                            for k in entry}
        for args in collect_buf:
            tfc.collect_outputs(*args)
        if overflow_now:
            raise ValueError(
                "Cell capacity exceeded during the run (a cell held "
                "more particles than planned, or -- under a barostat -- "
                "the box shrank until min(edge) < r_cut or went "
                "non-finite). Increase CellList(capacity=) / "
                "Cellwise(capacity=) or attach with nlist='n2'.")
        if stale_now and static_K:
            raise ValueError(
                f"A particle moved more than skin/2 between two "
                f"scheduled neighbor rebuilds even at repack interval "
                f"{static_K} -- the integration is likely diverging "
                f"(forces too large for dt={self.dt}).")
        if tfc:
            set_state(tfc.model, mv)
            tfc._model_forces = mf if carry_mf else None
            tfc._model_virial = mvir if carry_mvir else None
            if tfc.train:
                tfc.opt_state = opt_state
            tfc.check_overflow()
        return True


def _loss_consumes_energy(model):
    """Does ``model.compute_loss`` read prediction column 3 (the
    per-particle energy)?  Probed by evaluating the loss gradient
    w.r.t. the prediction at two random points on tiny arrays: the
    canonical force-matching losses slice ``[:, :3]`` and probe
    identically zero, letting the train route skip the energy lanes
    (primal AND proxy-backward moment sums).  Any probe failure --
    shape-sensitive losses, exotic structures -- conservatively keeps
    the energy on."""
    import numpy as _np
    try:
        for seed in (0, 1):
            rng = _np.random.RandomState(seed)
            y = jnp.asarray(rng.randn(8, 4).astype(_np.float32))
            lab = jnp.asarray(rng.randn(8, 4).astype(_np.float32))
            g = jax.grad(lambda o: jnp.asarray(
                model.compute_loss([o], lab)).sum())(y)
            if bool(np.any(np.asarray(g[:, 3]) != 0)):
                return True
        return False
    except Exception:
        return True


def _count_jaxpr_eqns(jaxpr):
    """Total primitive count including nested jaxprs (pjit bodies,
    custom-call branches) -- the planner's per-lane cost proxy."""
    n = 0
    for eq in jaxpr.eqns:
        n += 1
        for v in eq.params.values():
            inner = getattr(v, "jaxpr", None)
            if inner is not None and hasattr(inner, "eqns"):
                n += _count_jaxpr_eqns(inner)
            elif hasattr(v, "eqns"):
                n += _count_jaxpr_eqns(v)
    return n


def _functional(model, values, fn):
    """Run ``fn`` with the model's variables set to ``values``; return
    ``(fn(), new_values)`` and restore prior state."""
    old = get_state(model)
    set_state(model, values)
    try:
        out = fn()
        new_values = get_state(model)
    finally:
        set_state(model, old)
    return out, new_values


def _eval_silent(model, inputs, train):
    """Abstract warmup call: output *shapes* only (that is all the
    callers need), zero device compute, variable state untouched."""
    snap = get_state(model)
    try:
        out = jax.eval_shape(lambda xs: model(xs, training=train), inputs)
    finally:
        set_state(model, snap)
    return out
