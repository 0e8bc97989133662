"""Wide-direct neighbor mode: component-separated candidate planes.

The packed ``[N, NN, 4]`` neighbor list costs a nearest-NN *selection*
(a sort -- the dominant cost of the standard build at scale) and
materializes an array with a trailing dimension of 4. This mode skips
both: the model receives the 27-cell *candidate planes*
directly --

    NlistPlanes(dx, dy, dz, type)    # each [N, C], C = 27 * cell capacity

with invalid slots exactly zero (the same padding contract as the packed
nlist, just wider). Per-particle work grows by ~C/NN, but the work is
trivially cheap VPU lanes on layout-perfect 2-D arrays; the selection cost
disappears entirely.

Models written against the helpers (:func:`..ops.numerics.nlist_rinv`,
:func:`..ops.forces.compute_nlist_forces`) work unchanged -- both accept
the planes form. Models indexing ``nlist[:, :, :3]`` directly need the
packed mode.
"""

from typing import NamedTuple

import jax
import jax.numpy as jnp

__all__ = ["NlistPlanes", "direct_cell_planes"]


class NlistPlanes(NamedTuple):
    """Component-separated neighbor candidates; a pytree, so it threads
    through jit/vjp like any array."""
    dx: jax.Array     # [N, C]
    dy: jax.Array
    dz: jax.Array
    type: jax.Array   # [N, C]; 0 for invalid slots

    @property
    def shape(self):
        return self.dx.shape

    def r2(self):
        return self.dx ** 2 + self.dy ** 2 + self.dz ** 2

    def stack(self):
        """Materialize the packed ``[N, C, 4]`` view (host/debug use)."""
        return jnp.stack([self.dx, self.dy, self.dz, self.type], axis=-1)


def direct_cell_planes(pos4, r_cut, grid, capacity, box_lengths,
                       rcut_matrix=None):
    """Build candidate planes in particle order (no selection).

    :param pos4: ``[N, 4]`` positions + type.
    :param r_cut: cutoff (slots beyond it are zeroed).
    :param grid, capacity: static plan from :func:`.cell_list.plan`.
    :param box_lengths: ``[3]`` (may be traced; grid must be static).
    :param rcut_matrix: per-type-pair ``[ntypes, ntypes]`` cutoffs
        (negative = never neighbors; ``r_cut`` must be its max).
    :return: ``(NlistPlanes [N, 27*capacity], overflow flag)``.
    """
    from .cell_list import _build_planes

    nx, ny, nz = grid
    n_cells = nx * ny * nz
    cap = capacity
    c27 = 27 * cap
    dtype = pos4.dtype
    lengths = jnp.asarray(box_lengths).astype(dtype)

    cx, cy, cz, ct, slot_of_particle, overflow = _build_planes(
        pos4, grid, cap, lengths)

    # 27-cell stencil as contiguous row gathers (same as the packed build)
    cz_, cy_, cx_ = jnp.meshgrid(jnp.arange(nz), jnp.arange(ny),
                                 jnp.arange(nx), indexing="ij")
    base_xyz = jnp.stack([cx_.ravel(), cy_.ravel(), cz_.ravel()],
                         axis=-1).astype(jnp.int32)
    dims = jnp.asarray(grid, dtype=jnp.int32)
    offs = jnp.asarray(
        [(a, b, c) for a in (-1, 0, 1) for b in (-1, 0, 1)
         for c in (-1, 0, 1)], dtype=jnp.int32)
    neigh_xyz = (base_xyz[:, None, :] + offs[None, :, :]) % dims
    neigh_id = (neigh_xyz[..., 0] +
                nx * (neigh_xyz[..., 1] + ny * neigh_xyz[..., 2]))

    def stencil(arr):
        return arr[neigh_id].reshape(n_cells, c27)

    gx, gy, gz, gt = stencil(cx), stencil(cy), stencil(cz), stencil(ct)

    def min_image(d, L):
        return d - jnp.round(d / L) * L

    # reorder candidate rows to particle order FIRST (row gathers of
    # [c27]-contiguous rows), then compute displacements against each
    # particle's own position -- everything stays [N, C] 2-D
    cell_of_particle = slot_of_particle // cap
    px = pos4[:, 0][:, None]
    py = pos4[:, 1][:, None]
    pz = pos4[:, 2][:, None]
    ddx = min_image(gx[cell_of_particle] - px, lengths[0])
    ddy = min_image(gy[cell_of_particle] - py, lengths[1])
    ddz = min_image(gz[cell_of_particle] - pz, lengths[2])
    d2 = ddx * ddx + ddy * ddy + ddz * ddz
    valid = (d2 <= r_cut * r_cut) & (d2 >= 25e-8)
    if rcut_matrix is not None:
        from .nlist import pair_rc2
        rc2 = pair_rc2(pos4[:, 3][:, None], gt[cell_of_particle],
                       rcut_matrix, dtype)
        valid = valid & (d2 <= rc2)
    zero = jnp.zeros_like(ddx)
    planes = NlistPlanes(
        dx=jnp.where(valid, ddx, zero),
        dy=jnp.where(valid, ddy, zero),
        dz=jnp.where(valid, ddz, zero),
        type=jnp.where(valid, gt[cell_of_particle], zero),
    )
    return planes, overflow
