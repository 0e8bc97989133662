"""Pallas kernel (Triton route) for the Newton half-stencil analytic
pair forces of the cellwise neighbor mode.

Why a kernel: the half stencil evaluates each pair once and accumulates
BOTH sides -- a row-side sum over the candidate axis and a
candidate-side sum over the row axis of the *same* product array. XLA
does not fuse two reductions over different axes of one intermediate
into one pass, so the pure-XLA ``stencil='half'`` either writes the
``[n_cells, cap, 14*cap]`` products to memory or evaluates the pair
math twice. Here both sums accumulate in registers in one pass, so the
14/27 lane saving of the half stencil is kept.

Division of labor:

- XLA builds the candidate planes (14 static rolls + per-direction
  offsets -- contiguous data movement);
- the kernel runs one program per ``(cell, lane chunk)``. It loops over
  the cell's OCCUPIED rows in tiles of :data:`ROW_TILE` (the loop bound
  is that cell's own occupancy: real particles fill a prefix of a cell's
  slots), evaluates the pair function on a ``[ROW_TILE, CHUNK]`` tile,
  stores each tile's row-side partial sums, and keeps the
  candidate-side sums of its chunk in registers across the whole row
  loop, writing them once;
- XLA adds the row-side partials over chunks, applies the 13 inverse
  rolls that push each candidate-side block back onto its home cell,
  and sums everything.

Triton blocks must be powers of two and the candidate width
``C = 14 * cap`` is not (560 at cap 40). ``C`` is therefore CHUNKED into
``ceil(C / CHUNK)`` chunks with masked loads and stores: arrays in
device memory keep their true width, and the only padding is the
compute on the last chunk's ``ceil(C / CHUNK) * CHUNK - C`` lanes
(:func:`lane_chunks`), plus the row tile's rounding of each cell's
occupancy up to a multiple of ``ROW_TILE``.

The user's ``pair_fn`` is replayed inside the kernel from its jaxpr,
with every closed-over constant hoisted into one operand;
:func:`pair_fn_lowers` says whether a pair function can be replayed
here at all.

Replaces the reference's CSR-reshape + per-pair force CUDA kernels
(``TensorflowCompute.cu:80-209``) as the hot kernel of the framework.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from .cellwise import _HALF_OFFS, _relative_coords, _roll_back, _roll_offs

__all__ = ["half_stencil_pair_forces", "lane_chunks", "pair_fn_lowers",
           "ROW_TILE", "CHUNK"]

# rows per tile and lanes per chunk (powers of two, Triton's rule)
ROW_TILE = 8
CHUNK = 128


def lane_chunks(C, chunk=None):
    """``(n_chunks, padded_lanes)`` for a ``C``-wide candidate row."""
    chunk = chunk or CHUNK
    n = -(-int(C) // chunk)
    return n, n * chunk


def _trace_pair_fn(pair_fn, with_types, dtype):
    sds = lambda s: jax.ShapeDtypeStruct(s, dtype)
    args = ([sds((ROW_TILE, CHUNK)), sds((ROW_TILE, 1)), sds((1, CHUNK))]
            if with_types else [sds((ROW_TILE, CHUNK))])
    return jax.make_jaxpr(pair_fn)(*args)


def _jaxpr_lowers(jaxpr):
    from jax._src import core as _jcore
    from jax._src.pallas.triton.lowering import triton_lowering_rules
    for eqn in jaxpr.eqns:
        if eqn.primitive not in triton_lowering_rules:
            return False
        for v in eqn.outvars:
            shape = getattr(v.aval, "shape", ())
            size = int(np.prod(shape)) if shape else 1
            if len(shape) > 2 or size & (size - 1):
                return False
        for sub in _jcore.jaxprs_in_params(eqn.params):
            if not _jaxpr_lowers(sub):
                return False
    return True


def pair_fn_lowers(pair_fn, with_types=True, dtype=jnp.float32):
    """Can the kernel replay ``pair_fn``?  True when every constant it
    closes over is a scalar (they travel as one operand of scalars) and
    every primitive of its jaxpr has a Triton lowering and keeps the
    lanes a rank-2, power-of-two tile (a per-lane hidden axis, as in an
    MLP pair energy, does not). Decided from the traced jaxpr alone."""
    try:
        closed = _trace_pair_fn(pair_fn, with_types, dtype)
    except (TypeError, ValueError):
        return False
    if any(np.size(c) != 1 for c in closed.consts):
        return False
    return _jaxpr_lowers(closed.jaxpr)


def _kernel(pair_eval, const_dtypes, with_types, rcut_matrix, cap, C,
            rc2, min_r2, needs_virial, needs_energy, *refs):
    """One program: cell ``program_id(0)``, lane chunk ``program_id(1)``.
    Row tiles run up to the cell's occupancy; the candidate-side sums of
    the chunk stay in registers across them."""
    R, CH = ROW_TILE, CHUNK
    occ_ref, gx_ref, gy_ref, gz_ref = refs[:4]
    i = 4
    gt_ref = None
    if with_types or rcut_matrix is not None:
        gt_ref = refs[i]
        i += 1
    const_ref = None
    if const_dtypes:
        const_ref = refs[i]
        i += 1
    n_q = (1 if needs_energy else 0) + 3 + (6 if needs_virial else 0)
    back_refs = refs[i:i + n_q]
    fwd_refs = refs[i + n_q:i + 2 * n_q]

    cell, k = pl.program_id(0), pl.program_id(1)
    col = k * CH + jnp.arange(CH, dtype=jnp.int32)
    col_ok = col < C

    def lanes(ref):
        return plgpu.load(ref.at[cell, pl.ds(k * CH, CH)], mask=col_ok,
                          other=0.0)

    gx, gy, gz = lanes(gx_ref), lanes(gy_ref), lanes(gz_ref)
    dtype = gx.dtype
    tj = lanes(gt_ref)[None, :] if gt_ref is not None else None
    consts = [const_ref[j].astype(dt) for j, dt in enumerate(const_dtypes)]
    occ = occ_ref[cell]
    zero = jnp.zeros((), dtype=dtype)
    rows = jnp.arange(R, dtype=jnp.int32)

    def tile(g, acc):
        r = g * R + rows
        r_ok = r < occ

        def row(ref):
            return plgpu.load(ref.at[cell, pl.ds(g * R, R)], mask=r_ok,
                              other=0.0)

        qx, qy, qz = row(gx_ref), row(gy_ref), row(gz_ref)
        dx = gx[None, :] - qx[:, None]                     # [R, CH]
        dy = gy[None, :] - qy[:, None]
        dz = gz[None, :] - qz[:, None]
        d2 = dx * dx + dy * dy + dz * dz
        # the self pair sits on the diagonal of block 0 (col == row)
        ok = ((d2 <= rc2) & r_ok[:, None] & col_ok[None, :] &
              (col[None, :] != r[:, None]))
        ti = row(gt_ref)[:, None] if gt_ref is not None else None
        if rcut_matrix is not None:
            from .nlist import pair_rc2
            ok = ok & (d2 <= pair_rc2(ti, tj, rcut_matrix, dtype))
        r2 = jnp.maximum(d2, min_r2)
        if with_types:
            U, dU = pair_eval(consts, r2, ti, tj)
        else:
            U, dU = pair_eval(consts, r2)
        s = jnp.where(ok, dU, zero)
        # (product, row-side coefficient, candidate-side coefficient)
        prods = []
        if needs_energy:
            prods.append((jnp.where(ok, U, zero), 0.5, 0.5))
        prods += [(s * dx, 2.0, -2.0), (s * dy, 2.0, -2.0),
                  (s * dz, 2.0, -2.0)]
        if needs_virial:
            prods += [(s * a * b, -1.0, -1.0) for a, b in
                      ((dx, dx), (dy, dy), (dz, dz),
                       (dx, dy), (dx, dz), (dy, dz))]
        out = []
        for (p, fwd_c, back_c), fref, a in zip(prods, fwd_refs, acc):
            plgpu.store(fref.at[cell, k, pl.ds(g * R, R)],
                        fwd_c * jnp.sum(p, axis=1))
            out.append(a + back_c * jnp.sum(p, axis=0))
        return tuple(out)

    n_tiles = (occ + R - 1) // R
    acc = jax.lax.fori_loop(
        0, n_tiles, tile, tuple(jnp.zeros((CH,), dtype) for _ in range(n_q)))

    def zero_tile(g, carry):
        # outputs are not initialised: unoccupied tiles get zero partials
        for fref in fwd_refs:
            plgpu.store(fref.at[cell, k, pl.ds(g * R, R)],
                        jnp.zeros((R,), dtype))
        return carry

    jax.lax.fori_loop(n_tiles, -(-cap // R), zero_tile, 0)
    # block 0's candidate side is the self cell counted a second time,
    # already covered by the row side: only directed blocks are stored
    back_ok = col_ok & (col >= cap)
    for bref, a in zip(back_refs, acc):
        plgpu.store(bref.at[cell, pl.ds(k * CH, CH)], a, mask=back_ok)


def half_stencil_pair_forces(positions, types, valid, plan, lo, pair_fn,
                             needs_virial=False, min_r2=1e-4,
                             with_types=False, rcut_matrix=None,
                             lengths=None, needs_energy=True,
                             interpret=False, mesh=None, shard_axis=None):
    """Drop-in equivalent of :func:`.cellwise.analytic_pair_forces`
    computed by the half-stencil kernel (same contract, same returns;
    see that docstring for the physics and masking rules).

    :param interpret: run the kernel in the Pallas interpreter (CPU).
    :param mesh: optional :class:`jax.sharding.Mesh`: run the kernel
        SPMD over ``shard_axis``. The kernel's programs are independent
        over cells -- every cross-cell dependency (the 14 candidate
        gathers and the 13 Newton back-pushes) lives in the XLA rolls
        outside it, where sharding propagation turns the z-axis rolls
        into collective permutes. The halo exchange therefore happens in
        the candidate planes themselves, and the ``pallas_call`` -- the
        one op XLA cannot partition -- is wrapped in ``shard_map`` and
        runs on each device's contiguous z-slab block of cells (the cell
        order is z-major, so row sharding IS the spatial decomposition).
    """
    dtype = positions.dtype
    n_cells, cap = plan.n_cells, plan.capacity
    offs_list = _HALF_OFFS
    n_blocks = len(offs_list)
    C = n_blocks * cap
    n_chunks, _ = lane_chunks(C)
    rows_pad = -(-cap // ROW_TILE) * ROW_TILE
    _, _, _, gx, gy, gz = _relative_coords(
        positions, valid, plan, lo, offs_list, lengths)
    inputs = [gx, gy, gz]
    if with_types or rcut_matrix is not None:
        inputs.append(_roll_offs(types.astype(dtype), plan, offs_list))
    occ = valid.reshape(n_cells, cap).sum(axis=1).astype(jnp.int32)

    # hoist every constant pair_fn closed over (built-in epsilon/sigma,
    # proxy coefficients, outer-jit tracers) into one operand of
    # scalars; the jaxpr traced at the kernel's tile shapes is replayed
    # verbatim inside the kernel
    from jax._src import core as _jcore
    closed = _trace_pair_fn(pair_fn, with_types, dtype)
    consts = [jnp.asarray(c) for c in closed.consts]
    if any(c.size != 1 for c in consts):
        raise ValueError(
            "pair_fn closes over non-scalar arrays; the half-stencil "
            "kernel takes scalar constants only (see pair_fn_lowers)")
    const_dtypes = tuple(c.dtype for c in consts)
    const_shapes = tuple(c.shape for c in consts)
    small = []
    if consts:
        small = [jnp.stack([c.reshape(()).astype(jnp.float32)
                            for c in consts])]

    def pair_eval(cvals, r2, *args):
        cvals = [v.reshape(s) for v, s in zip(cvals, const_shapes)]
        return tuple(_jcore.eval_jaxpr(closed.jaxpr, cvals, r2, *args))

    n_q = (1 if needs_energy else 0) + 3 + (6 if needs_virial else 0)
    kernel = functools.partial(
        _kernel, pair_eval, const_dtypes, with_types,
        None if rcut_matrix is None else np.asarray(rcut_matrix),
        cap, C, float(plan.r_cut) ** 2, float(min_r2), needs_virial,
        needs_energy)
    n_in = len(inputs)

    def _call(occ_l, *ops):
        nloc = occ_l.shape[0]
        back_shape = jax.ShapeDtypeStruct((nloc, C), dtype)
        fwd_shape = jax.ShapeDtypeStruct((nloc, n_chunks, rows_pad), dtype)
        outs = pl.pallas_call(
            kernel,
            grid=(nloc, n_chunks),
            out_shape=[back_shape] * n_q + [fwd_shape] * n_q,
            compiler_params=plgpu.CompilerParams(num_warps=4,
                                                 num_stages=1),
            interpret=interpret,
            name="half_stencil_pair_forces",
        )(occ_l, *ops)
        return tuple(outs)

    if mesh is None:
        outs = _call(occ, *inputs, *small)
    else:
        from jax.sharding import PartitionSpec as P
        ndev = mesh.shape[shard_axis]
        if n_cells % ndev:
            raise ValueError(
                f"{n_cells} cells not divisible by the {ndev}-device "
                f"mesh (the plan must keep nz divisible by the mesh)")
        outs = jax.shard_map(
            _call, mesh=mesh,
            in_specs=(P(shard_axis), *([P(shard_axis)] * n_in),
                      *([P()] * len(small))),
            out_specs=(P(shard_axis),) * (2 * n_q),
            check_vma=False)(occ, *inputs, *small)

    def assemble(back, fwd):
        acc = jnp.sum(fwd, axis=1)[:, :cap]
        for t in range(1, n_blocks):
            acc = acc + _roll_back(back[:, t * cap:(t + 1) * cap], plan,
                                   offs_list[t])
        return acc.reshape(-1)

    sums = [assemble(b, f) for b, f in zip(outs[:n_q], outs[n_q:])]
    oi = 0
    if needs_energy:
        e = sums[0]
        oi = 1
    else:
        e = jnp.zeros((plan.n_slots,), dtype=dtype)
    fx, fy, fz = sums[oi:oi + 3]
    forces4 = jnp.stack([fx, fy, fz, e], axis=-1) * valid[:, None]
    virial = None
    if needs_virial:
        wxx, wyy, wzz, wxy, wxz, wyz = sums[oi + 3:]
        W = jnp.stack([
            jnp.stack([wxx, wxy, wxz], -1),
            jnp.stack([wxy, wyy, wyz], -1),
            jnp.stack([wxz, wyz, wzz], -1)], -2)
        virial = W * valid[:, None, None]
    return forces4, virial
