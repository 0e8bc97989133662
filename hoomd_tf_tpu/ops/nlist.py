"""Neighbor-list construction.

Two implementations:

- :func:`compute_nlist` -- dense O(N^2) masked top-k, matching the reference
  (``utils.py:75-161``) semantics exactly. Used as the correctness oracle,
  for trajectory iteration, and for small systems.
- :func:`cell_list_nlist` (see :mod:`.cell_list`) -- O(N) binned build for
  large systems; the replacement for the reference's CSR->dense
  CUDA kernel (``TensorflowCompute.cu:80-209``).

All outputs use the reference convention: ``[N, NN, 4]`` where the last axis
is the minimum-image displacement ``(dx, dy, dz)`` from particle i to its
neighbor and the 4th component is the neighbor *type* (in-simulation) or
*index* (``compute_nlist`` default). Padded slots are all-zero.
"""

import jax
import jax.numpy as jnp

from .box import box_size as _box_size

__all__ = ["compute_nlist", "nlist_from_positions", "pair_rc2"]


def pair_rc2(type_i, type_j, r_cut_matrix, dtype):
    """Squared per-pair cutoff from an ``[ntypes, ntypes]`` matrix
    (reference parity: ``tensorflowcompute.py:284-305`` -- a negative
    entry means the pair never neighbors, mapped here to ``-1`` so
    ``d2 <= rc2`` is always False).

    Implemented as ``ntypes**2`` fused mask-multiply terms rather than a
    table gather, so it stays elementwise (and replays inside the
    half-stencil kernel); particle-type counts are small (the
    reference's systems use 2-6 types).

    :param type_i, type_j: broadcastable integer (or float-typed) arrays.
    :param r_cut_matrix: concrete ``[T, T]`` host matrix.
    """
    import numpy as np
    m = np.asarray(r_cut_matrix, dtype=np.float64)
    ti = type_i.astype(jnp.int32)
    tj = type_j.astype(jnp.int32)
    out = jnp.zeros(jnp.broadcast_shapes(ti.shape, tj.shape), dtype=dtype)
    for a in range(m.shape[0]):
        for b in range(m.shape[1]):
            v = float(m[a, b])
            v2 = -1.0 if v < 0 else v * v
            out = out + jnp.asarray(v2, dtype=dtype) * (
                (ti == a) & (tj == b)).astype(dtype)
    return out


def compute_nlist(positions, r_cut, NN, box_size, sorted=False,
                  return_types=False, exclusion_matrix=None,
                  r_cut_matrix=None):
    """Dense pairwise neighbor list (reference-parity O(N^2) build).

    Mirrors reference ``utils.py:75-161`` including its quirks: the unsorted
    branch keeps the NN *largest* in-cutoff distances on overflow, while
    ``sorted=True`` keeps the nearest NN, sorted ascending by distance.

    :param positions: ``[N, 4]`` or ``[N, 3]`` positions.
    :param r_cut: cutoff radius.
    :param NN: maximum number of neighbors per particle.
    :param box_size: ``[Lx, Ly, Lz]`` box edge lengths, or a full ``[3,3]``
        box (rows: low, high, tilt). A full box with nonzero tilt factors
        gets the triclinic minimum image (:func:`.box.wrap_vector`);
        lengths-only input is orthorhombic.
    :param sorted: sort each particle's neighbors ascending by distance.
    :param return_types: last nlist channel is the neighbor's type (requires
        ``[N, 4]`` positions) instead of its index.
    :param exclusion_matrix: ``[N, N]`` bool array, True = exclude pair.
    :param r_cut_matrix: per-type-pair ``[ntypes, ntypes]`` cutoffs
        (negative = never neighbors); requires ``[N, 4]`` positions.
        ``r_cut`` still bounds the candidate radius (pass the matrix max).
    :return: ``[N, NN, 4]`` neighbor list.
    """
    positions = jnp.asarray(positions)
    if return_types and positions.shape[1] == 3:
        raise ValueError(
            'Cannot return type if positions does not have type. '
            'Make sure positions is N x 4')
    if r_cut_matrix is not None and positions.shape[1] != 4:
        raise ValueError('per-type r_cut needs N x 4 positions (types)')

    box_size = jnp.asarray(box_size)
    full_box = box_size if box_size.ndim == 2 else None
    if box_size.ndim == 2:
        box_size = _box_size(box_size)

    pos3 = positions[:, :3]
    # displacement from i (row) to j (col): r_ij = x_j - x_i
    dist_mat = pos3[None, :, :] - pos3[:, None, :]
    if full_box is not None:
        from .box import wrap_vector
        dist_mat = wrap_vector(dist_mat, full_box)
    else:
        box = jnp.reshape(box_size, (1, 1, 3)).astype(dist_mat.dtype)
        dist_mat = dist_mat - jnp.round(dist_mat / box) * box
    dist = jnp.linalg.norm(dist_mat, axis=2)
    mask = (dist <= r_cut) & (dist >= 5e-4)
    if r_cut_matrix is not None:
        types = positions[:, 3]
        rc2 = pair_rc2(types[:, None], types[None, :], r_cut_matrix,
                       dist.dtype)
        mask = mask & (dist * dist <= rc2)
    if exclusion_matrix is not None:
        nem = jnp.logical_not(jnp.asarray(exclusion_matrix))
        mask = mask & nem & nem.T
    mask_cast = mask.astype(dist.dtype)
    # systems smaller than NN: take everything and zero-pad the columns
    k = min(NN, dist.shape[1])
    if sorted:
        # invalid -> huge distance -> never in top-k of negated distances
        dist_mat_r = dist * mask_cast + (1 - mask_cast) * 1e20
        _, idx = jax.lax.top_k(-dist_mat_r, k)
    else:
        # invalid -> 0 -> drops out of top-k of (positive) distances
        dist_mat_r = dist * mask_cast
        _, idx = jax.lax.top_k(dist_mat_r, k)

    nlist_pos = jnp.take_along_axis(dist_mat, idx[:, :, None], axis=1)
    nlist_mask = jnp.take_along_axis(mask_cast, idx, axis=1)[:, :, None]

    if return_types:
        nlist_type = positions[:, 3][idx][:, :, None]
        last = nlist_type.astype(nlist_pos.dtype)
    else:
        last = idx[:, :, None].astype(nlist_pos.dtype)
    out = jnp.concatenate([nlist_pos, last], axis=-1) * nlist_mask
    if k < NN:
        out = jnp.pad(out, ((0, 0), (0, NN - k), (0, 0)))
    return out


def nlist_from_positions(positions, types, r_cut, NN, box):
    """In-simulation neighbor list: ``[N, NN, 4]`` with neighbor *type* in
    the 4th channel, matching what the reference plugin stages for
    ``SimModel.compute`` (``TensorflowCompute.cc:303-374``).

    :param positions: ``[N, 3]`` positions.
    :param types: ``[N]`` integer types.
    :param r_cut: cutoff radius.
    :param NN: max neighbors.
    :param box: ``[3,3]`` box array.
    """
    pos4 = jnp.concatenate(
        [positions[:, :3], types.astype(positions.dtype)[:, None]], axis=-1)
    return compute_nlist(pos4, r_cut, NN, _box_size(box), sorted=True,
                         return_types=True)
