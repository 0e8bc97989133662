"""Forces (and virial) from energies via autodiff.

API parity with the reference (``simmodel.py:492-578``):

- ``compute_nlist_forces(nlist, energy, virial=False)`` -- pairwise forces
  ``F_i = 2 * sum_j dE/dnlist_ij`` (the x2 compensates the full, double-counted
  neighbor list; no minus sign because nlist vectors point *away* from the
  particle, see the derivation in the reference docs).
- ``compute_positions_forces(positions, energy)`` -- ``F = -dE/dpos``.
- Both pack per-particle energy into column 4 of the returned ``[N, 4]``
  forces array (``_add_energy``).

The reference relies on ``tf.gradients(energy, nlist)`` -- a gradient with
respect to an *intermediate* tensor of an already-built graph. JAX has no
graph to walk backwards, so the same user-facing call is implemented with a
**capture-and-replay** scheme: when ``SimModel`` invokes the user's
``compute``, it installs a capture context holding a closure that can re-run
``compute`` with the nlist (or positions) input substituted. A value-based
``compute_nlist_forces(nlist, energy)`` call then evaluates
``jax.vjp`` of that closure, seeding a ones cotangent on the recorded energy.
The forward computation appears twice in the traced program, but XLA CSE
collapses the duplicates, so the compiled cost is the same as a
single-pass ``jax.grad``.

Both functions also accept an ``energy`` **callable** (``f(nlist) -> energy``)
which is the idiomatic-JAX form and works outside any model.
"""

import contextvars

import jax
import jax.numpy as jnp

__all__ = ["compute_nlist_forces", "compute_positions_forces"]

_CAPTURE = contextvars.ContextVar("htf_force_capture", default=None)


class ForceCapture:
    """Context installed by ``SimModel.__call__`` around the user ``compute``.

    :param compute: callable re-running the user compute, signature
        ``compute(*args)`` where ``args`` are the positional inputs.
    :param args: the concrete argument tuple of the in-flight call.
    :param nlist_index: index of the nlist argument in ``args`` (or None).
    :param positions_index: index of the positions argument (or None).
    :param snapshot: callable returning a snapshot of mutable model state
        (variable values at the *start* of the call), or None.
    :param restore: callable restoring model state from a snapshot, or None.
    """

    def __init__(self, compute, args, nlist_index=None, positions_index=None,
                 snapshot=None, restore=None):
        self.compute = compute
        self.args = tuple(args)
        self.nlist_index = nlist_index
        self.positions_index = positions_index
        self.snapshot = snapshot
        self.restore = restore
        self.phase = "record"   # or "replay"
        self.counter = 0
        self.replay_energies = None
        # registry of derived tensors -> (root_kind, slice) for gradient
        # routing, e.g. mapped_nlist splits (simmodel.py:257-287)
        self.slices = {}
        self._start_state = None
        self._token = None

    # -- context manager ---------------------------------------------------
    def __enter__(self):
        if self.snapshot is not None:
            self._start_state = self.snapshot()
        self._token = _CAPTURE.set(self)
        return self

    def __exit__(self, *exc):
        _CAPTURE.reset(self._token)
        return False

    # -- slice registry -----------------------------------------------------
    def register_slice(self, tensor, kind, start, stop):
        """Record that ``tensor`` is ``root[start:stop]`` of input ``kind``."""
        self.slices[id(tensor)] = (kind, start, stop)

    def _resolve(self, value, kind):
        """Map a user-passed tensor to (root index, row-slice or None)."""
        index = self.nlist_index if kind == "nlist" else self.positions_index
        if index is None:
            raise ValueError(
                f"Model compute does not take a {kind} argument, so "
                f"compute_{kind}_forces cannot identify the gradient root. "
                "Pass a callable energy function instead.")
        root = self.args[index]
        reg = self.slices.get(id(value))
        if reg is not None and reg[0] == kind:
            return index, (reg[1], reg[2])
        if value.shape == root.shape:
            return index, None
        raise ValueError(
            f"The {kind} passed to compute_{kind}_forces (shape {value.shape}) "
            f"is neither the model {kind} input (shape {root.shape}) nor a "
            "framework-produced slice of it. Differentiating w.r.t. an "
            "arbitrary intermediate tensor is not possible in JAX -- pass a "
            "callable energy function instead: "
            "compute_nlist_forces(nlist, lambda nl: my_energy(nl)).")

    # -- replay --------------------------------------------------------------
    def grad_wrt_input(self, kind, value, energy):
        """d(sum-like of recorded energy)/d(root input), restricted to value's slice."""
        index, row_slice = self._resolve(value, kind)
        call_idx = self.counter
        self.counter += 1

        def replay(root_sub):
            args = list(self.args)
            args[index] = root_sub
            sub = ForceCapture(self.compute, args,
                               nlist_index=self.nlist_index,
                               positions_index=self.positions_index)
            sub.phase = "replay"
            sub.replay_energies = []
            # restore start-of-call variable state so the replay is a
            # faithful re-execution (stateful layers like EDS mutate state
            # mid-call; see models/simmodel.py)
            mid = None
            if self.restore is not None:
                mid = self.snapshot()
                self.restore(self._start_state)
            try:
                with sub:
                    self.compute(*args)
            finally:
                if mid is not None:
                    self.restore(mid)
            if call_idx >= len(sub.replay_energies):
                raise RuntimeError(
                    "Force-capture replay diverged from the recorded call: "
                    "your compute() must be deterministic in its sequence of "
                    "compute_*_forces calls.")
            return sub.replay_energies[call_idx]

        root = self.args[index]
        e_replay, vjp_fn = jax.vjp(replay, root)
        grad = vjp_fn(jnp.ones_like(e_replay))[0]
        if row_slice is not None:
            # pytree-aware row slicing (the root may be NlistPlanes)
            grad = jax.tree_util.tree_map(
                lambda g: g[row_slice[0]:row_slice[1]], grad)
        return grad


def _add_energy(forces, energy):
    """Pack (per-particle) energy into column 4 of the forces array.

    Mirrors reference ``simmodel.py:558-578``: scalar energy is broadcast to
    every row; rank >= 2 energies are summed over trailing axes.
    """
    forces = jnp.asarray(forces)
    energy = jnp.asarray(energy)
    n = forces.shape[0]
    if energy.ndim > 1:
        energy = jnp.sum(energy, axis=tuple(range(1, energy.ndim)))
        col = jnp.reshape(energy, (n, 1))
    elif energy.ndim == 0:
        col = jnp.broadcast_to(jnp.reshape(energy, (1, 1)), (n, 1))
    else:
        col = jnp.reshape(energy, (n, 1))
    return jnp.concatenate([forces[:, :3], col.astype(forces.dtype)], axis=-1)


def _compute_virial(nlist, nlist_forces):
    """Pairwise virial from per-neighbor energy gradients.

    ``W_i = -1/2 sum_j sym(f_ij (x) r_ij)`` with ``f_ij = 2 dE/dnlist_ij``.
    Returns ``[N, 3, 3]``; HOOMD sign convention (positive for repulsion), so
    pressure is ``P = (2 KE + sum_i tr W_i) / (3 V)``.

    Deviation from the reference (``simmodel.py:509-523``): the reference
    uses ``|F_ij| / (2 r)`` -- a norm-based approximation that drops the
    force *sign* and is only correct for attractive pairs (its own pressure
    test tolerates the resulting 1e-3 error, ``test_tensorflow.py:619-624``).
    Deriving the virial directly from the autodiff gradient is exact for any
    pair force, so this framework's model virial matches its built-in pair
    potentials to float precision.
    """
    nlist3 = nlist[:, :, :3]
    f = nlist_forces[..., :3]
    outer = jnp.einsum("ijk,ijl->ikl", f, nlist3,
                       precision=jax.lax.Precision.HIGHEST)
    return -0.25 * (outer + jnp.swapaxes(outer, -1, -2))


def _sanitize(grad):
    """Zero out non-finite gradient elements (pytree-aware).

    Padded (all-zero) neighbor rows produce NaN through ``norm``-at-zero
    gradients in natural energy formulations (e.g. ``divide_no_nan(1,
    norm(nlist)**6)``). TensorFlow's norm gradient is internally
    div-no-nan-guarded so the reference silently gets zeros there; JAX's is
    not, so the same guard lives here -- a padded row must contribute
    exactly zero force.
    """
    return jax.tree_util.tree_map(
        lambda g: jnp.where(jnp.isfinite(g), g, jnp.zeros_like(g)), grad)


def _energy_grad(kind, value, energy):
    """Dispatch between callable-energy and value-energy (capture) forms.

    Returns ``(energy_value, grad, placeholder)`` where ``placeholder`` is
    True when running inside a replay (gradient is a dummy zeros array).
    """
    if callable(energy):
        e_val, vjp_fn = jax.vjp(energy, value)
        grad = vjp_fn(jnp.ones_like(e_val))[0]
        return e_val, _sanitize(grad), False
    ctx = _CAPTURE.get()
    if ctx is None:
        raise ValueError(
            f"compute_{kind}_forces was called with an energy *value* outside "
            "of a SimModel compute. Outside a model, pass a callable: "
            f"compute_{kind}_forces(x, lambda x: energy_fn(x)).")
    if ctx.phase == "replay":
        ctx.replay_energies.append(jnp.asarray(energy))
        return energy, None, True
    grad = ctx.grad_wrt_input(kind, value, energy)
    return energy, _sanitize(grad), False


def compute_nlist_forces(nlist, energy, virial=False):
    """Pairwise forces (and optionally virial) from a neighbor-list energy.

    Matches reference ``simmodel.py:526-555``: returns ``[N, 4]`` forces with
    per-particle energy in the last column; with ``virial=True`` returns a
    ``(forces, virial)`` tuple where virial is ``[N, 3, 3]``.

    :param nlist: ``[N, NN, 4]`` (or ``[N, NN, 3]``) neighbor list, or the
        wide-direct :class:`..ops.direct.NlistPlanes`. Must be the model's
        nlist input or a framework-produced slice of it.
    :param energy: the potential energy -- size ``1``, ``N`` or ``N x L`` --
        computed from ``nlist``; or a callable ``f(nlist) -> energy``.
    :param virial: also return the pairwise virial contribution.
    """
    from .direct import NlistPlanes
    if isinstance(nlist, NlistPlanes):
        e_val, grad, placeholder = _energy_grad("nlist", nlist, energy)
        n = nlist.dx.shape[0]
        dtype = nlist.dx.dtype
        if placeholder:
            forces = jnp.zeros((n, 4), dtype=dtype)
            return (forces, jnp.zeros((n, 3, 3), dtype=dtype)) if virial \
                else forces
        # f_ij components = 2 dE/d(dx_ij) etc.
        fx, fy, fz = 2.0 * grad.dx, 2.0 * grad.dy, 2.0 * grad.dz
        reduce3 = jnp.stack([jnp.sum(fx, axis=1), jnp.sum(fy, axis=1),
                             jnp.sum(fz, axis=1)], axis=-1)
        forces = _add_energy(
            jnp.concatenate([reduce3, jnp.zeros((n, 1), dtype)], axis=-1),
            e_val)
        if virial:
            f = (fx, fy, fz)
            r = (nlist.dx, nlist.dy, nlist.dz)
            w = jnp.stack(
                [jnp.stack(
                    [-0.25 * jnp.sum(f[a] * r[b] + f[b] * r[a], axis=1)
                     for b in range(3)], axis=-1)
                 for a in range(3)], axis=-2)
            return forces, w
        return forces

    nlist = jnp.asarray(nlist)
    e_val, grad, placeholder = _energy_grad("nlist", nlist, energy)
    if placeholder:
        n = nlist.shape[0]
        forces = jnp.zeros((n, 4), dtype=nlist.dtype)
        if virial:
            return forces, jnp.zeros((n, 3, 3), dtype=nlist.dtype)
        return forces
    # x2 for the double-counted full neighbor list; NaNs in padded rows were
    # already prevented upstream (nlist_rinv / divide_no_nan)
    nlist_forces = 2.0 * grad
    nlist_reduce = jnp.sum(nlist_forces, axis=1)
    forces = _add_energy(nlist_reduce, e_val)
    if virial:
        return forces, _compute_virial(nlist, nlist_forces)
    return forces


def compute_positions_forces(positions, energy):
    """Position-dependent forces ``F = -dE/dpos``.

    Matches reference ``simmodel.py:492-506``: returns ``[N, 4]`` forces with
    per-particle energy in the last column.

    :param positions: ``[N, 4]`` or ``[N, 3]`` positions. Must be the model's
        positions input or a framework-produced slice of it.
    :param energy: the potential energy (value computed from ``positions``
        inside a model compute, or a callable ``f(positions) -> energy``).
    """
    positions = jnp.asarray(positions)
    e_val, grad, placeholder = _energy_grad("positions", positions, energy)
    if placeholder:
        return jnp.zeros((positions.shape[0], 4), dtype=positions.dtype)
    forces = -grad
    return _add_energy(forces, e_val)
