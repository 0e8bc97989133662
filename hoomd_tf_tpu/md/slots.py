"""SlotLayout: the engine adapter for the slot-resident ("cellwise")
neighbor mode (see :mod:`..ops.cellwise` for the design rationale).

The :class:`..md.simulation.Simulation` step stays a single
implementation for every neighbor mode; when a layout is active it
threads a slot-layout :class:`.state.SimState` (rows = cell slots,
ghosts parked at cell centers) plus a small ``aux`` dict through the
scan instead of the particle-order state:

- ``pack`` / ``unpack`` convert at ``run()`` boundaries (one scatter /
  gather per array per run -- never inside the hot loop);
- ``needs_rebuild`` + ``rebuild`` implement the Verlet-skin criterion as
  a ``lax.cond`` inside the scan: both branches are compiled once, the
  repack argsort only *executes* when the max drift since the last
  repack exceeds ``skin / 2``;
- ``ghost_pin`` keeps ghost slots inert under any integrator (zero
  velocity, parked at the cell center) so stochastic kicks (Langevin /
  Brownian noise) cannot move them;
- ``mask_rows`` zeroes force/energy/virial rows of ghosts after the
  model runs.

The thermostat degrees of freedom are those of the *real* particles;
``pack`` records them in ``state.thermostat['dof']``, which
:class:`.integrators.NVT` and :func:`.thermo.temperature` honor.

**Dynamic-box mode** (``dynamic_box=True``, used for NPT): the grid and
capacity stay static but every geometric quantity (cell centers, edges,
binning, stencil offsets) derives from the CURRENT ``state.box`` inside
the step. A barostat rescale is affine, so fractional coordinates -- and
therefore the slot assignment -- are preserved by construction; only the
physical cell edge changes. The Verlet criterion then runs in fractional
space scaled by the current box (``ref`` stores fractional coordinates),
and a shrink that leaves ``min(edge) < r_cut`` (geometry can no longer
cover the cutoff) is surfaced through the overflow flag.
"""

import dataclasses

import jax
import jax.numpy as jnp

from ..ops import cellwise as cw
from ..ops.box import box_size

__all__ = ["SlotLayout"]


class SlotLayout:
    """Slot-resident layout for ``n_real`` particles under a
    :class:`..ops.cellwise.CellwisePlan`.

    :param plan: static geometry (grid, capacity, box lengths, r_cut).
    :param n_real: number of real particles.
    :param lo: box lower corner (concrete ``[3]``; in dynamic-box mode
        only used as the planning-time value).
    :param rc_matrix: per-type-pair cutoffs (or None).
    :param dynamic_box: derive geometry from ``state.box`` per step.
    """

    def __init__(self, plan, n_real, lo, rc_matrix=None,
                 dynamic_box=False):
        self.plan = plan
        self.n = int(n_real)
        self.lo = tuple(float(v) for v in lo)
        self.rc_matrix = rc_matrix  # per-type-pair cutoffs (or None)
        self.dynamic_box = bool(dynamic_box)
        # jitted run()-boundary converters (eager op-by-op dispatch is
        # latency-bound); cached on the layout so
        # repeat runs hit the compile cache
        import jax
        self.pack_jit = jax.jit(self.pack)
        self.unpack_jit = jax.jit(self.unpack)

    # ------------------------------------------------------------------
    def _geom(self, state):
        """(lo, lengths) -- static plan values, or traced from the
        state's box in dynamic-box mode."""
        if self.dynamic_box:
            return state.box[0], box_size(state.box)
        return self.lo, None

    def centers(self, dtype, state=None):
        lo, lengths = self._geom(state) if (
            self.dynamic_box and state is not None) else (self.lo, None)
        return cw.slot_cell_centers(self.plan, lo, dtype, lengths=lengths)

    def _frac(self, positions, lo, lengths, dtype):
        L = jnp.asarray(lengths if lengths is not None
                        else self.plan.lengths, dtype=dtype)
        f = (positions - jnp.asarray(lo, dtype=dtype)) / L
        return f - jnp.floor(f)

    # ------------------------------------------------------------------
    def _take(self, src, has):
        """``put(vals, default)`` applying the repack as ONE clipped
        gather + select (see :func:`..ops.cellwise.repack_src`)."""
        def put(vals, default):
            sel = has.reshape((-1,) + (1,) * (vals.ndim - 1))
            return jnp.where(sel, vals[jnp.minimum(src, vals.shape[0] - 1)],
                             default)
        return put

    def pack(self, state, extra_rows=()):
        """Particle-order ``SimState`` -> (slot-order state, aux, packed
        extras). ``extra_rows`` are ``[n, ...]`` arrays permuted alongside
        (e.g. persisted model forces)."""
        plan = self.plan
        n_slots = plan.n_slots
        dtype = state.positions.dtype
        lo, lengths = self._geom(state)
        valid_n = jnp.ones((self.n,), dtype=dtype)
        src, overflow, occ = cw.repack_src(
            state.positions, valid_n, lo, plan, lengths=lengths,
            with_occ=True)
        has = src < self.n
        put = self._take(src, has)

        centers = self.centers(dtype, state)
        positions = put(state.positions, centers)
        velocities = put(state.velocities, jnp.zeros((), dtype=dtype))
        types = put(state.types, jnp.zeros((), jnp.int32))
        masses = put(state.masses, jnp.ones((), dtype=dtype))
        forces = put(state.forces, jnp.zeros((), dtype=dtype))
        virial = put(state.virial, jnp.zeros((), dtype=dtype))
        valid = has.astype(dtype)
        orig = jnp.where(has, jnp.minimum(src, self.n), self.n) \
            .astype(jnp.int32)
        thermostat = dict(state.thermostat or {})
        thermostat["dof"] = jnp.asarray(3 * self.n - 3, dtype=dtype)
        slot_state = dataclasses.replace(
            state, positions=positions, velocities=velocities, types=types,
            masses=masses, forces=forces, virial=virial,
            thermostat=thermostat)
        aux = {"valid": valid, "orig": orig,
               "ref": (self._frac(positions, lo, lengths, dtype)
                       if self.dynamic_box else positions),
               "overflow": overflow,
               # running max cell occupancy over the run (updated at
               # every repack): calibrates replan() capacity against
               # what the fluid actually does, instead of the planner's
               # conservative fluctuation formula
               "occ_max": occ,
               # running max particle speed (updated at every repack):
               # calibrates the static repack interval against the
               # running tail -- a run()-start snapshot undersells the
               # max over thousands of steps of a big system's Maxwell
               # tail, and an underestimated interval costs a staleness
               # rollback of the whole segment
               "vmax": jnp.sqrt(jnp.max(jnp.sum(
                   velocities * velocities, axis=-1)))}
        packed = tuple(put(e, jnp.zeros((), e.dtype)) for e in extra_rows)
        return slot_state, aux, packed

    # ------------------------------------------------------------------
    def unpack(self, slot_state, aux, extra_rows=()):
        """Slot-order state -> particle-order ``SimState`` (original
        indexing restored; the layout-internal thermostat key removed)."""
        orig = aux["orig"]  # ghost rows hold self.n -> dropped

        def back(vals):
            out = jnp.zeros((self.n,) + vals.shape[1:], vals.dtype)
            return out.at[orig].set(vals, mode="drop")

        thermostat = dict(slot_state.thermostat or {})
        thermostat.pop("dof", None)
        return dataclasses.replace(
            slot_state,
            positions=back(slot_state.positions),
            velocities=back(slot_state.velocities),
            types=back(slot_state.types),
            masses=back(slot_state.masses),
            forces=back(slot_state.forces),
            virial=back(slot_state.virial),
            thermostat=thermostat), tuple(back(e) for e in extra_rows)

    # ------------------------------------------------------------------
    def needs_rebuild(self, slot_state, aux):
        """Verlet criterion: any particle drifted more than ``skin / 2``
        since the last repack (ghosts are pinned, so they contribute 0).

        Dynamic-box mode: drift is fractional-displacement times the
        CURRENT box (slot assignment is fractional, and an affine box
        rescale moves no particle in fractional space), and the skin is
        the current ``min(edge) - r_cut``."""
        plan = self.plan
        dtype = slot_state.positions.dtype
        if self.dynamic_box:
            lo, lengths = self._geom(slot_state)
            L = jnp.asarray(lengths, dtype=dtype)
            d = self._frac(slot_state.positions, lo, lengths,
                           dtype) - aux["ref"]
            d = (d - jnp.round(d)) * L
            d2 = jnp.sum(d * d, axis=-1)
            edges = L / jnp.asarray(plan.grid, dtype=dtype)
            half_skin = jnp.maximum(jnp.min(edges) - plan.r_cut, 0.0) / 2.0
            return jnp.max(d2) >= (half_skin * 0.98) ** 2
        d = slot_state.positions - aux["ref"]
        if any(plan.tilt):
            # a boundary crossing jumps the position by a *lattice*
            # vector (with tilt cross terms); the triclinic wrap removes
            # it so the measured drift is the physical displacement
            d = cw._wrap_tri(d, plan.lengths, plan.tilt)
        else:
            lengths = jnp.asarray(plan.lengths, dtype=dtype)
            d = d - jnp.round(d / lengths) * lengths
        d2 = jnp.sum(d * d, axis=-1)
        half_skin = max(plan.skin, 0.0) / 2.0
        return jnp.max(d2) >= jnp.asarray((half_skin * 0.98) ** 2,
                                          dtype=dtype)

    # ------------------------------------------------------------------
    def rebuild(self, slot_state, aux, extra_rows=()):
        """Repack the slot assignment from current positions (runs in
        the engine's hot loop every K steps; all static shapes).

        The permutation is applied as ONE block row-gather of a
        ``[rows, 13]`` block that moves all thirteen state columns,
        instead of one dynamic gather per column. Integer columns ride as
        bitcast f32 (exact round trip). The forces move with their
        particles: under the static repack schedule the rebuild lands
        before the integrator's first half-kick, which reads them. (The
        virial is only ever summed over particles.)"""
        plan = self.plan
        n_slots = plan.n_slots
        dtype = slot_state.positions.dtype
        lo, lengths = self._geom(slot_state)
        src, overflow, occ = cw.repack_src(
            slot_state.positions, aux["valid"], lo, plan, lengths=lengths,
            with_occ=True)
        # only valid rows survive repack_src (ghosts sort to the end and
        # are dropped), so every sourced row is a real particle
        has = src < n_slots
        put = self._take(src, has)

        centers = self.centers(dtype, slot_state)
        if dtype == jnp.float32:
            f32 = lambda a: jax.lax.bitcast_convert_type(a, jnp.float32)
            i32 = lambda a: jax.lax.bitcast_convert_type(a, jnp.int32)
            blk = jnp.concatenate([
                slot_state.positions, slot_state.velocities,
                f32(aux["orig"])[:, None], slot_state.masses[:, None],
                f32(slot_state.types)[:, None], slot_state.forces],
                axis=1)
            g = blk[jnp.clip(src, 0, n_slots - 1)]
            has_c = has[:, None]
            positions = jnp.where(has_c, g[:, :3], centers)
            velocities = jnp.where(has_c, g[:, 3:6], 0.0)
            orig = jnp.where(has, i32(g[:, 6]),
                             jnp.asarray(self.n, jnp.int32))
            masses = jnp.where(has, g[:, 7], jnp.ones((), dtype=dtype))
            types = jnp.where(has, i32(g[:, 8]),
                              jnp.zeros((), jnp.int32))
            forces = jnp.where(has_c, g[:, 9:13], 0.0)
        else:
            # bitcast packing assumes 32-bit lanes; other dtypes take
            # the per-column gathers
            positions = put(slot_state.positions, centers)
            velocities = put(slot_state.velocities,
                             jnp.zeros((), dtype=dtype))
            types = put(slot_state.types, jnp.zeros((), jnp.int32))
            masses = put(slot_state.masses, jnp.ones((), dtype=dtype))
            orig = put(aux["orig"], jnp.asarray(self.n, jnp.int32))
            forces = put(slot_state.forces, jnp.zeros((), dtype=dtype))
        valid = has.astype(dtype)
        new_state = dataclasses.replace(
            slot_state, positions=positions, velocities=velocities,
            types=types, masses=masses, forces=forces)
        vm = jnp.sqrt(jnp.max(jnp.sum(velocities * velocities, axis=-1)))
        new_aux = {"valid": valid, "orig": orig,
                   "ref": (self._frac(positions, lo, lengths, dtype)
                           if self.dynamic_box else positions),
                   "overflow": jnp.logical_or(aux["overflow"], overflow),
                   "occ_max": jnp.maximum(aux.get("occ_max", occ), occ),
                   "vmax": jnp.maximum(aux.get("vmax", vm), vm)}
        packed = tuple(put(e, jnp.zeros((), e.dtype)) for e in extra_rows)
        return new_state, new_aux, packed

    # ------------------------------------------------------------------
    def planes(self, slot_state, aux):
        """Masked :class:`..ops.direct.NlistPlanes` for the current slot
        positions (rolls; fully fusable, see ops/cellwise.py)."""
        _, lengths = self._geom(slot_state)
        return cw.cellwise_planes(slot_state.positions, slot_state.types,
                                  aux["valid"], self.plan,
                                  rcut_matrix=self.rc_matrix,
                                  lengths=lengths)

    # ------------------------------------------------------------------
    def ghost_pin(self, slot_state, aux):
        """Re-pin ghosts after an integrator substep: zero velocity,
        parked at the cell center (stochastic integrators add noise to
        every row; ghosts must not move)."""
        dtype = slot_state.positions.dtype
        valid = aux["valid"][:, None]
        centers = self.centers(dtype, slot_state)
        return dataclasses.replace(
            slot_state,
            positions=jnp.where(valid > 0, slot_state.positions, centers),
            velocities=slot_state.velocities * valid)

    def geometry_bad(self, slot_state):
        """Dynamic-box failure check, evaluated every step: a box shrunk
        until ``min(edge) < r_cut`` can no longer cover the cutoff with
        the 27-stencil (repacking cannot fix it -- the grid is static),
        and a non-finite box means the integrator diverged. Written as
        ``not (edge >= r_cut)`` so NaN propagates to True."""
        dtype = slot_state.positions.dtype
        L = box_size(slot_state.box).astype(dtype)
        edges = L / jnp.asarray(self.plan.grid, dtype=dtype)
        return jnp.logical_not(jnp.min(edges) >= self.plan.r_cut)

    def mask_rows(self, forces4, virial, aux):
        """Zero force/energy/virial rows of ghost slots."""
        valid = aux["valid"]
        return (forces4 * valid[:, None],
                virial * valid[:, None, None])
