"""Integrators: NVE velocity-Verlet, Nose-Hoover NVT, NPT, Langevin,
Brownian.

The reference delegates integration to HOOMD (``IntegratorTwoStep``); in the
single-engine design the integrator is part of the jitted step. Each
integrator splits into ``pre_force`` (kick+drift given current forces) and
``post_force`` (kick with fresh forces), so the Simulation can interleave
the force evaluation exactly like HOOMD's two-step integrators do.

All integrators are stateless Python objects; their mutable state (e.g. the
thermostat degree of freedom) lives in ``SimState.thermostat``.
"""

import jax
import jax.numpy as jnp

from ..ops.box import box_size

__all__ = ["NVE", "NVT", "NPT", "Langevin", "Brownian", "Minimize"]


def _wrap_positions(positions, box):
    """Wrap positions into the (possibly triclinic) box: to fractional
    coordinates via the upper-triangular cell-matrix solve, ``mod 1``,
    and back. With zero tilt this is exactly ``lo + mod(x - lo, L)``."""
    lo = box[0]
    bs = box_size(box).astype(positions.dtype)
    xy, xz, yz = (box[2, i].astype(positions.dtype) for i in range(3))
    r = positions - lo
    fz = r[..., 2] / bs[2]
    fy = (r[..., 1] - yz * bs[2] * fz) / bs[1]
    fx = (r[..., 0] - xy * bs[1] * fy - xz * bs[2] * fz) / bs[0]
    fx, fy, fz = jnp.mod(fx, 1.0), jnp.mod(fy, 1.0), jnp.mod(fz, 1.0)
    return lo + jnp.stack([
        bs[0] * fx + xy * bs[1] * fy + xz * bs[2] * fz,
        bs[1] * fy + yz * bs[2] * fz,
        bs[2] * fz], axis=-1)


def _kick(state, dt_half):
    v = state.velocities + dt_half * state.forces[:, :3] / \
        state.masses[:, None]
    return v


def _drift(state, dt):
    x = state.positions + dt * state.velocities
    return _wrap_positions(x, state.box)


class NVE:
    """Velocity-Verlet microcanonical integrator."""

    #: stochastic integrators add noise to every row each substep; the
    #: cellwise engine must then re-pin ghost slots (zero velocity,
    #: parked at cell centers) after every substep. Deterministic
    #: integrators provably leave ghosts fixed (zero force -> zero kick,
    #: zero velocity -> zero drift), so the engine skips the two
    #: per-step ghost_pin passes for them (md/simulation.py).
    stochastic = False

    def init(self, state):
        return {}

    def pre_force(self, state, dt):
        import dataclasses
        v = _kick(state, dt / 2)
        state = dataclasses.replace(state, velocities=v)
        x = _drift(state, dt)
        return dataclasses.replace(state, positions=x)

    def post_force(self, state, dt):
        import dataclasses
        v = _kick(state, dt / 2)
        return dataclasses.replace(state, velocities=v)


class NVT:
    """Nose-Hoover thermostat (single chain, MTK-style symmetric splitting).

    :param kT: target temperature.
    :param tau: thermostat coupling time.
    """

    stochastic = False

    def __init__(self, kT, tau):
        self.kT = kT
        self.tau = tau

    def init(self, state):
        return {"xi": jnp.asarray(0.0, dtype=state.positions.dtype)}

    def _thermo_half(self, state, dt):
        import dataclasses
        # slot-resident layouts carry ghost rows; they record the real
        # degrees of freedom in thermostat['dof'] (md/slots.py). Ghosts
        # have zero velocity, so the kinetic sum itself needs no mask.
        dof = state.thermostat.get("dof")
        if dof is None:
            dof = 3 * state.n_particles - 3
        ke2 = jnp.sum(state.masses[:, None] * state.velocities ** 2)
        t_inst = ke2 / dof
        # overflow guard: a violent start (overlapping pairs -> ~1e29
        # forces -> ke2 past f32 max) must not LATCH the thermostat.
        # Unguarded, t_inst = inf makes xi = inf, exp(-inf) zeroes the
        # velocities every half step, and xi never recovers (inf plus
        # any finite decrement stays inf) -- the system freezes at T = 0
        # and silently stops being a fluid. Clamping the measured
        # temperature keeps xi huge-but-finite: it still damps the
        # transient at the maximum rate, then relaxes back once the
        # overlap resolves.
        t_inst = jnp.where(jnp.isfinite(t_inst), t_inst,
                           jnp.asarray(1e30, dtype=t_inst.dtype))
        xi = state.thermostat["xi"]
        xi = xi + dt / 2 * (t_inst / self.kT - 1.0) / self.tau ** 2
        # two-sided recovery scheme around the clamp above: damp at full
        # strength while the system is hot (cap only where exp() has
        # long underflowed), then geometrically unwind the unphysical
        # xi overshoot once T is back within an order of magnitude of
        # target -- linear Nose-Hoover relaxation from a transient-
        # inflated xi would take ~xi*tau^2/dt steps (a de-facto
        # permanent freeze). Healthy runs keep |xi| ~ 1/tau, far below
        # the unwind threshold, so equilibrium dynamics are untouched.
        xi = jnp.clip(xi, -50.0 / dt, 50.0 / dt)
        xi = jnp.where((t_inst < 10.0 * self.kT) &
                       (jnp.abs(xi) > 10.0 / self.tau),
                       xi * 0.8, xi)
        v = state.velocities * jnp.exp(-xi * dt / 2)
        th = dict(state.thermostat)
        th["xi"] = xi
        return dataclasses.replace(state, velocities=v, thermostat=th)

    def pre_force(self, state, dt):
        import dataclasses
        state = self._thermo_half(state, dt)
        v = _kick(state, dt / 2)
        state = dataclasses.replace(state, velocities=v)
        x = _drift(state, dt)
        return dataclasses.replace(state, positions=x)

    def post_force(self, state, dt):
        import dataclasses
        v = _kick(state, dt / 2)
        state = dataclasses.replace(state, velocities=v)
        return self._thermo_half(state, dt)


class NPT(NVT):
    """Isothermal-isobaric ensemble: Nose-Hoover thermostat + Berendsen
    barostat (weak coupling; box stays cubic-orthorhombic).

    Beyond the reference's scope (it inherits whatever integrator HOOMD
    runs) but natural in the single-engine design -- the box is part of
    the carried state, so rescaling it is just another array op in the
    jitted step.

    Works with ``nlist='n2'`` (the dense build reads the box
    dynamically) and with ``nlist='cellwise'``, where the engine builds
    a DYNAMIC slot layout: the grid/capacity stay static but all
    geometry (cell centers, edges, stencil offsets, binning) derives
    from the current box each step -- a barostat rescale is affine, so
    the fractional slot assignment is preserved (md/slots.py). The
    remaining static-geometry modes (cell/direct) raise a clear error.

    :param kT: target temperature.
    :param tau: thermostat coupling time.
    :param P: target pressure.
    :param tauP: barostat coupling time.
    :param kappa: isothermal compressibility used by the weak-coupling
        scale factor (1.0 in LJ units is customary).
    """

    changes_box = True
    needs_virial = True

    def __init__(self, kT, tau, P, tauP=1.0, kappa=1.0):
        super().__init__(kT, tau)
        self.P = P
        self.tauP = tauP
        self.kappa = kappa

    def post_force(self, state, dt):
        import dataclasses
        state = super().post_force(state, dt)
        # instantaneous pressure from the fresh virial (the engine sets
        # needs_virial for box-changing integrators)
        bs = box_size(state.box)
        vol = jnp.prod(bs)
        ke2 = jnp.sum(state.masses[:, None] * state.velocities ** 2)
        w = jnp.sum(jnp.trace(state.virial, axis1=-2, axis2=-1))
        p_inst = (ke2 + w) / (3.0 * vol)
        mu3 = 1.0 - self.kappa * dt / self.tauP * (self.P - p_inst)
        mu = jnp.clip(mu3, 0.9, 1.1) ** (1.0 / 3.0)
        center = 0.5 * (state.box[0] + state.box[1])
        positions = center + mu * (state.positions - center)
        box = jnp.stack([center + mu * (state.box[0] - center),
                         center + mu * (state.box[1] - center),
                         state.box[2]])
        return dataclasses.replace(state, positions=positions, box=box)


class Langevin:
    stochastic = True
    """Langevin dynamics via BAOAB splitting.

    :param kT: temperature.
    :param gamma: friction coefficient.
    """

    def __init__(self, kT, gamma=1.0):
        self.kT = kT
        self.gamma = gamma

    def init(self, state):
        return {}

    def pre_force(self, state, dt):
        import dataclasses
        v = _kick(state, dt / 2)                      # B
        state = dataclasses.replace(state, velocities=v)
        x = _drift(state, dt / 2)                     # A
        state = dataclasses.replace(state, positions=x)
        # O: exact Ornstein-Uhlenbeck
        rng, sub = jax.random.split(state.rng)
        c1 = jnp.exp(-self.gamma * dt)
        c2 = jnp.sqrt((1 - c1 ** 2) * self.kT / state.masses)[:, None]
        noise = jax.random.normal(sub, state.velocities.shape,
                                  dtype=state.velocities.dtype)
        v = c1 * state.velocities + c2 * noise
        state = dataclasses.replace(state, velocities=v, rng=rng)
        x = _drift(state, dt / 2)                     # A
        return dataclasses.replace(state, positions=x)

    def post_force(self, state, dt):
        import dataclasses
        v = _kick(state, dt / 2)                      # B
        return dataclasses.replace(state, velocities=v)


class Minimize:
    """Displacement-capped steepest-descent quench.

    Each step moves every particle along its force by
    ``min(alpha * |F|, max_disp)`` and keeps velocities at zero. Immune
    to the astronomically large clamped-overlap forces of a violent
    start (random/jittered initial configurations), which break every
    dynamical integrator: a single overlapping pair produces ~1e27
    forces, one Verlet kick overflows the kinetic energy, and even a
    Langevin friction needs thousands of steps to damp it. A few dozen
    quench steps resolve the overlaps; switch to the production
    integrator afterwards (``sim.integrator = htf.md.NVT(...)`` -- the
    engine recompiles the step on an integrator change).

    The energy-minimization role of the reference stack's
    ``hoomd.md.integrate.mode_minimize_fire``
    (used to relax initial configurations before TF-coupled runs).

    :param max_disp: displacement cap per step (in distance units).
    :param alpha: step scale multiplying the force.
    """

    stochastic = False

    def __init__(self, max_disp=0.1, alpha=1e-3):
        self.max_disp = float(max_disp)
        self.alpha = float(alpha)

    def init(self, state):
        return {}

    def pre_force(self, state, dt):
        return state

    def post_force(self, state, dt):
        import dataclasses
        f = state.forces[:, :3]
        f = jnp.where(jnp.isfinite(f), f, 0.0)
        # overflow-proof normalization: clamped-overlap forces reach
        # ~1e27, whose SQUARE overflows f32 -- a naive sqrt(sum(f^2))
        # norm goes inf, and any fallback there effectively uncaps the
        # step (measured: particles flung to f32-quantized garbage
        # positions, including exact coincidences). Scale by the max
        # component first; every intermediate stays finite.
        m = jnp.max(jnp.abs(f), axis=-1, keepdims=True)
        dirn = f / jnp.maximum(m, 1e-30)          # components in [-1, 1]
        norm = jnp.sqrt(jnp.sum(dirn * dirn, axis=-1, keepdims=True))
        unit = dirn / jnp.maximum(norm, 1e-30)
        step = jnp.minimum((self.alpha * m) * norm, self.max_disp)
        x = _wrap_positions(state.positions + unit * step, state.box)
        return dataclasses.replace(
            state, positions=x, velocities=jnp.zeros_like(state.velocities))


class Brownian:
    stochastic = True
    """Overdamped (Brownian) dynamics.

    :param kT: temperature.
    :param gamma: friction coefficient.
    """

    def __init__(self, kT, gamma=1.0):
        self.kT = kT
        self.gamma = gamma

    def init(self, state):
        return {}

    def pre_force(self, state, dt):
        return state

    def post_force(self, state, dt):
        import dataclasses
        rng, sub = jax.random.split(state.rng)
        mob = dt / (self.gamma * state.masses)[:, None]
        noise = jax.random.normal(sub, state.positions.shape,
                                  dtype=state.positions.dtype)
        x = (state.positions + mob * state.forces[:, :3] +
             jnp.sqrt(2 * self.kT * mob) * noise)
        x = _wrap_positions(x, state.box)
        return dataclasses.replace(state, positions=x, rng=rng)
