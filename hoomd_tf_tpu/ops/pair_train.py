"""Hand-written VJP for the analytic pair route: online-training
parameter gradients in ONE weighted lane pass.

The online-training step (the reference's hoomd2tf branch,
``/root/reference/htf/tensorflowcompute.py:346-370``) needs
``d loss / d theta`` where the loss compares predicted forces against
per-step labels. Differentiating the analytic pair forward
(:func:`.cellwise.analytic_pair_forces`) with plain reverse-mode AD
rematerializes the whole ``[n_cells, cap, 27*cap]`` lane structure --
the 27 stencil rolls, the displacement planes, the dual reductions --
through the backward pass, storing or recomputing several
hundred-MB-scale intermediates per step.

The pairwise structure makes the parameter gradient analytic. With
``F_i = 2 * sum_j U'(r2_ij; theta) * d_ij`` and
``E_i = 0.5 * sum_j U(r2_ij; theta)``, the chain rule contracts the
incoming cotangent ``ct`` (shape ``[n_slots, 4]``) against the lanes
as

    <ct, dF4/dtheta> = sum_lanes ok_ij * [ wF_ij * dU'(r2_ij)/dtheta
                                         + wE_ij * dU(r2_ij)/dtheta ]
    wF_ij = 2 * valid_i * (ct_i[:3] . d_ij)
    wE_ij = 0.5 * valid_i * ct_i[3]

-- the per-lane weights are pure data (no autodiff), and the whole
backward collapses to the gradient of ONE weighted scalar sum of the
user's pair function over the lanes. Nothing about the stencil rolls
or reductions is ever differentiated, and the forward pass can run on
the fastest primal available (the Pallas half-stencil kernel included:
``custom_vjp`` never differentiates through the primal).

Geometry inputs (positions / box / validity) get zero cotangents by
construction: neighbor membership is piecewise constant and the
training loop never differentiates the state (it is ``stop_gradient``
-ed physics). This matches the generic route, which also stops
gradients at the neighbor list.
"""

import jax
import jax.numpy as jnp

from .cellwise import _HALF_OFFS, _OFFS, _relative_coords, _roll_offs

__all__ = ["pair_train_forces"]


def pair_train_forces(params, pair_apply, positions, types, valid, plan,
                      lo, *, min_r2=1e-4, with_types=False,
                      rcut_matrix=None, lengths=None, needs_energy=True,
                      fwd_stencil="full", bwd_stencil="half",
                      mesh=None, shard_axis=None):
    """Analytic pair forces, differentiable in ``params`` only, with the
    hand-written lane-contraction VJP described in the module docstring.

    :param params: pytree (typically a list) of parameter arrays. The
        ONLY differentiable input; everything else gets a zero
        cotangent.
    :param pair_apply: ``pair_apply(params, r2[, ti, tj]) -> (U, dU)``
        -- the pair function as an explicit function of ``params``
        (same ``(U, dU/dr2)`` contract as
        :func:`.cellwise.analytic_pair_forces`'s ``pair_fn``; must be
        symmetric under ``(ti, tj)`` swap, like every pair function in
        this package).
    :param positions: ``[n_slots, 3]`` slot positions (constants).
    :param types: ``[n_slots]`` integer types.
    :param valid: ``[n_slots]`` 1.0 real / 0.0 ghost.
    :param plan: the :class:`.cellwise.CellwisePlan`.
    :param lo: box lower corner (may be traced).
    :param min_r2: overlap clamp, as in ``analytic_pair_forces``.
    :param with_types: pass type lanes to ``pair_apply``.
    :param rcut_matrix: per-type-pair cutoffs (optional).
    :param lengths: dynamic box lengths (traced; NPT), else None.
    :param needs_energy: compute (and differentiate) the energy column.
    :param fwd_stencil: stencil for the PRIMAL evaluation -- 'full',
        'half', 'pallas' or 'auto' (:mod:`.routes`). Any choice is
        correct for any ``bwd_stencil``: all stencils compute the same
        function.
    :param bwd_stencil: lane set for the backward contraction.
        ``'half'`` (default) evaluates each unordered pair once with
        the Newton-combined weight ``wF = 2 (ct_i - ct_j) . d_ij`` and
        ``wE = 0.5 (cte_i + cte_j)`` -- 14/27 of the padded lanes, the
        dominant cost for expensive (NN) pair functions. Unlike the
        primal half stencil (whose dual-axis reduction XLA does not
        fuse, see ops/cellwise_pallas.py), the contraction is ONE
        scalar reduction, so the half lane set fuses cleanly in XLA.
        Requires ``pair_apply`` symmetric under ``(ti, tj)`` swap (the
        package-wide pair-function contract); ``'full'`` lifts even
        that, evaluating both directions independently.
    :returns: ``forces4 [n_slots, 4]`` with energy in column 4.
    """
    from . import cellwise as _cw

    def bind(p):
        if with_types:
            return lambda r2, ti, tj: pair_apply(p, r2, ti, tj)
        return lambda r2: pair_apply(p, r2)

    @jax.custom_vjp
    def f(params):
        f4, _ = _cw.analytic_pair_forces(
            positions, types, valid, plan, lo, bind(params),
            needs_virial=False, min_r2=min_r2, with_types=with_types,
            rcut_matrix=rcut_matrix, stencil=fwd_stencil,
            lengths=lengths, needs_energy=needs_energy,
            mesh=mesh, shard_axis=shard_axis)
        return f4

    def fwd(params):
        return f(params), params

    def bwd(params, ct):
        dtype = positions.dtype
        n_cells, cap = plan.n_cells, plan.capacity
        half = bwd_stencil == "half"
        offs_list = _HALF_OFFS if half else _OFFS
        C = len(offs_list) * cap
        rc2 = jnp.asarray(plan.r_cut * plan.r_cut, dtype=dtype)
        qx, qy, qz, gx, gy, gz = _relative_coords(
            positions, valid, plan, lo, offs_list, lengths)
        qxr = qx.reshape(n_cells, cap)
        qyr = qy.reshape(n_cells, cap)
        qzr = qz.reshape(n_cells, cap)
        dx = gx[:, None, :] - qxr[:, :, None]
        dy = gy[:, None, :] - qyr[:, :, None]
        dz = gz[:, None, :] - qzr[:, :, None]
        d2 = dx * dx + dy * dy + dz * dz
        row = jnp.arange(cap)[:, None]
        col = jnp.arange(C)[None, :]
        if half:
            # the self cell is block 0; exclude its diagonal
            not_self = jnp.logical_not((col < cap) & (col == row))[None]
        else:
            not_self = (col != 13 * cap + row)[None, :, :]
        ok = (d2 <= rc2) & not_self
        ti = tj = None
        if with_types or rcut_matrix is not None:
            tt = types.astype(dtype)
            gt = _roll_offs(tt, plan, offs_list)
            ti = tt.reshape(n_cells, cap)[:, :, None]
            tj = gt[:, None, :]
        if rcut_matrix is not None:
            from .nlist import pair_rc2
            ok = ok & (d2 <= pair_rc2(ti, tj, rcut_matrix, dtype))
        r2_eval = jnp.maximum(d2, jnp.asarray(min_r2, dtype=dtype))

        # the primal ends with `* valid[:, None]`; fold that into the
        # cotangent so ghost rows contribute nothing
        ctv = ct * valid[:, None]
        ctf = ctv[:, :3].reshape(n_cells, cap, 3)
        zero = jnp.zeros((), dtype=dtype)
        wF = (ctf[:, :, 0:1] * dx + ctf[:, :, 1:2] * dy +
              ctf[:, :, 2:3] * dz)
        wE = ctv[:, 3].reshape(n_cells, cap, 1) if needs_energy else None
        if half:
            # Newton-combined weights: lane (i, j) of a DIRECTED block
            # carries both ordered pairs' contributions (the primal
            # accumulates +F to row i and -F to candidate j, 0.5 U to
            # each); the self block (0) is evaluated from both rows in
            # every stencil, so only the row side applies there.
            cgx = _roll_offs(ctv[:, 0], plan, offs_list)[:, None, :]
            cgy = _roll_offs(ctv[:, 1], plan, offs_list)[:, None, :]
            cgz = _roll_offs(ctv[:, 2], plan, offs_list)[:, None, :]
            directed = (jnp.arange(C) >= cap).astype(dtype)[None, None, :]
            wF = wF - directed * (cgx * dx + cgy * dy + cgz * dz)
            if needs_energy:
                cge = _roll_offs(ctv[:, 3], plan, offs_list)[:, None, :]
                wE = wE + directed * cge
        wF = jnp.where(ok, 2.0 * wF, zero)
        if needs_energy:
            wE = jnp.where(ok, 0.5 * wE, zero)
        else:
            wE = None

        def contracted(p):
            if with_types:
                U, dU = pair_apply(p, r2_eval, ti, tj)
            else:
                U, dU = pair_apply(p, r2_eval)
            tot = jnp.sum(wF * dU)
            if wE is not None:
                tot = tot + jnp.sum(wE * U)
            return tot.astype(dtype)

        return (jax.grad(contracted)(params),)

    f.defvjp(fwd, bwd)
    return f(params)
