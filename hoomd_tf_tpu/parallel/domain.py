"""Spatial domain decomposition with ring halo exchange between devices.

The MD twin of ring attention (SURVEY.md section 2.3): the box is split
into slabs along x, one device per slab; each step every device sends the
particles within ``r_cut`` of its slab faces to its ring neighbors with
``ppermute`` (two hops: +1 and -1), then builds neighbor rows for its own
particles against [local + left halo + right halo]. Per-device traffic is
O(halo) instead of O(N).

**Status: manual-decomposition reference implementation.** The
PRODUCTION multi-chip path is ``Simulation(mesh=...)`` /
``ShardedSimulation``: the same compiled cellwise step run SPMD, where
XLA derives the equivalent halo ring from the z-axis rolls on its own
(md/simulation.py). This module keeps the halo exchange EXPLICIT --
useful as an independent oracle for validating the compiler-derived
collectives, for environments that need hand-placed ppermutes, and as
the documented recipe the sharding design is built on. It is exercised
by tests and the multi-chip dryrun, and is not wired into any front
end by design.

Static-shape contract (XLA): halo buffers have a fixed capacity; particles
are assigned to slabs when the function is built. A particle drifting
deeper than its slab interior invalidates the decomposition -- an overflow
flag is returned so the driver can re-shard (the same fail-fast philosophy
as the cell-list capacity and ``check_nlist``).
"""

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P

from ..models.module import get_state, set_state
from ..ops.box import box_size

__all__ = ["domain_decompose", "halo_force_fn"]


def domain_decompose(positions4, box, n_domains, r_cut=None):
    """Host-side setup: assign particles to x-slabs.

    :param r_cut: if given, validate that slabs are at least ``r_cut`` wide
        (the ring halo reaches one neighbor slab only).
    :return: ``(perm, counts)`` -- a permutation sorting particles by slab
        and per-slab counts. Pad to equal per-slab size before sharding
        (NaN coordinates make pad rows distance-invalid everywhere; a
        finite far coordinate would wrap back into the box).
    """
    pos = np.asarray(positions4)
    lengths = np.asarray(box_size(jnp.asarray(box)))
    if r_cut is not None and lengths[0] / n_domains < r_cut:
        raise ValueError(
            f"slab width {lengths[0] / n_domains:.3f} < r_cut {r_cut}: "
            "the ring halo exchange only reaches adjacent slabs; use "
            "fewer domains or the all-gather strategy")
    lo = -lengths[0] / 2
    frac = (pos[:, 0] - lo) / lengths[0]
    frac = frac - np.floor(frac)
    slab = np.minimum((frac * n_domains).astype(np.int64), n_domains - 1)
    perm = np.argsort(slab, kind="stable")
    counts = np.bincount(slab, minlength=n_domains)
    return perm, counts


def _two_set_rows(q3, qt, s3, st, r_cut, NN, lengths):
    """Neighbor rows for queries against sources (dense, per-device).
    NaN-coordinate sources (padding) are distance-invalid; masking is
    where-based so NaN never leaks through a multiply."""
    disp = s3[None, :, :] - q3[:, None, :]
    box = jnp.reshape(lengths, (1, 1, 3)).astype(disp.dtype)
    disp = disp - jnp.round(disp / box) * box
    dist = jnp.linalg.norm(disp, axis=2)
    mask = (dist <= r_cut) & (dist >= 5e-4)
    dist_masked = jnp.where(mask, dist, jnp.full_like(dist, 1e20))
    _, idx = jax.lax.top_k(-dist_masked, NN)
    nl_pos = jnp.take_along_axis(disp, idx[:, :, None], axis=1)
    nl_mask = jnp.take_along_axis(mask, idx, axis=1)[:, :, None]
    nl_type = st[idx][:, :, None].astype(nl_pos.dtype)
    vals = jnp.concatenate([nl_pos, nl_type], axis=-1)
    return jnp.where(nl_mask, vals, jnp.zeros_like(vals))


def halo_force_fn(model, r_cut, mesh, halo_capacity, axis="d"):
    """Particle-sharded force evaluation with ring halo exchange.

    :param model: a :class:`..models.simmodel.SimModel`.
    :param r_cut: cutoff radius (also the halo width).
    :param mesh: 1-D device mesh; the box is slab-decomposed along x with
        one slab per device.
    :param halo_capacity: max boundary particles per face per device
        (static; overflow is flagged).
    :return: ``fn(values, positions4_sharded, box) -> (forces [N,4],
        overflow, new_values)`` with ``positions4`` sharded by slab along
        the mesh axis (slab-sorted, equal per-device counts).
    """
    NN = max(1, model.nneighbor_cutoff)
    n_dev = mesh.shape[axis]

    def fn(values, positions4, box):
        def shard_body(values, pos_shard, box):
            me = jax.lax.axis_index(axis)
            lengths = box_size(box)
            lo = box[0, 0]
            slab_w = lengths[0] / n_dev
            slab_lo = lo + me.astype(pos_shard.dtype) * slab_w
            slab_hi = slab_lo + slab_w

            x = pos_shard[:, 0]
            near_lo = (x - slab_lo) <= r_cut
            near_hi = (slab_hi - x) <= r_cut

            def halo_buffer(mask):
                # pack up to halo_capacity boundary particles (order by
                # index; overflow flagged). far-sentinel padding makes
                # unused slots distance-invalid.
                cnt = jnp.cumsum(mask.astype(jnp.int32)) - 1
                slot = jnp.where(mask & (cnt < halo_capacity), cnt,
                                 halo_capacity)
                # capacity+1 rows: slot == halo_capacity is the trash row
                # for masked-out/overflow particles, sliced off below
                buf = jnp.full((halo_capacity + 1, 4), 1e30,
                               dtype=pos_shard.dtype)
                buf = buf.at[slot].set(pos_shard, mode="drop")
                overflow = jnp.sum(mask) > halo_capacity
                return buf[:halo_capacity], overflow

            lo_buf, of1 = halo_buffer(near_lo)
            hi_buf, of2 = halo_buffer(near_hi)

            # ring exchange: my low-face halo goes to the left neighbor,
            # my high-face halo to the right neighbor
            right = [(i, (i + 1) % n_dev) for i in range(n_dev)]
            left = [(i, (i - 1) % n_dev) for i in range(n_dev)]
            from_left = jax.lax.ppermute(hi_buf, axis, right)
            from_right = jax.lax.ppermute(lo_buf, axis, left)

            sources = jnp.concatenate(
                [pos_shard, from_left, from_right], axis=0)
            nlist = _two_set_rows(
                pos_shard[:, :3], pos_shard[:, 3], sources[:, :3],
                sources[:, 3], r_cut, NN, lengths)

            old = get_state(model)
            set_state(model, list(values))
            try:
                out = model([nlist, pos_shard, box])
                new_values = get_state(model)
            finally:
                set_state(model, old)
            forces = out[0]
            if forces.shape[-1] == 3:
                forces = jnp.concatenate(
                    [forces, jnp.zeros_like(forces[:, :1])], axis=-1)
            overflow = jax.lax.pmax(
                jnp.logical_or(of1, of2).astype(jnp.int32), axis) > 0
            return forces, overflow, tuple(new_values)

        return jax.shard_map(
            shard_body, mesh=mesh,
            in_specs=(P(), P(axis), P()),
            out_specs=(P(axis), P(), P()),
            check_vma=False)(tuple(values), positions4, box)

    return fn
