"""O(N) cell-list neighbor build -- the replacement for the reference's
CSR->dense CUDA reshape kernel (``TensorflowCompute.cu:80-209``) plus
HOOMD's cell list itself.

Everything is static-shape for XLA:

1. bin particles into an ``nx x ny x nz`` grid (cell edge >= r_cut),
2. sort particle indices by cell id (XLA sort; O(N log N)),
3. scatter sorted indices into a fixed-capacity ``[n_cells, capacity]``
   table (overflow counted, surfaced like ``check_nlist``),
4. per particle, gather the 27 neighboring cells' slots ->
   ``[N, 27*capacity]`` candidates, minimum-image distance filter,
   ``top_k`` the nearest NN.

Gradients flow through the displacement values (the gather of positions);
indices are integer and naturally non-differentiable, which matches the
physics (neighbor membership is piecewise constant).
"""

import math
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .box import box_size as _box_size

__all__ = ["CellList", "cell_list_nlist"]


class CellList:
    """Configuration for the cell-list neighbor build.

    :param capacity: max particles per cell (default: estimated from the
        mean density with 2x headroom at build time).
    :param skin: extra margin added to the cell edge (room for a future
        rebuild-every-k-steps optimization; the list itself is still exact
        for ``r_cut``).
    """

    def __init__(self, capacity=None, skin=0.0):
        self.capacity = capacity
        self.skin = float(skin)

    def grid_for(self, box_lengths, r_cut):
        edge = r_cut + self.skin
        dims = tuple(max(1, int(math.floor(L / edge)))
                     for L in box_lengths)
        return dims

    def usable(self, box_lengths, r_cut):
        """Cell lists need >= 3 cells per dimension so the 27-cell stencil
        covers the cutoff without double counting."""
        return all(d >= 3 for d in self.grid_for(box_lengths, r_cut))

    def default_capacity(self, n, box_lengths, r_cut):
        # 2x headroom over the mean occupancy: lattice initial conditions
        # and density fluctuations routinely reach ~2x the mean per cell.
        # Overflow is still detected at runtime (surfaced like check_nlist);
        # capacity drives the sort width, so power users can tighten it via
        # CellList(capacity=...) for equilibrated fluids.
        vol = float(np.prod(box_lengths))
        edge = r_cut + self.skin
        per_cell = n / vol * edge ** 3
        return max(4, int(math.ceil(per_cell * 2.0)) + 4)


def _build_planes(pos4, grid, capacity, lengths):
    """Shared prologue: bin particles and scatter them into dense per-cell
    coordinate/type planes ``[n_cells, cap]`` (empty slots hold a far
    sentinel). Returns the planes, each particle's flat slot, and the
    overflow flag."""
    n = pos4.shape[0]
    nx, ny, nz = grid
    n_cells = nx * ny * nz
    dtype = pos4.dtype
    cap = capacity
    pos3 = pos4[:, :3]

    frac = pos3 / lengths
    frac = frac - jnp.floor(frac)
    dims = jnp.asarray(grid, dtype=jnp.int32)
    cell_xyz = jnp.minimum((frac * dims.astype(dtype)).astype(jnp.int32),
                           dims - 1)
    # plane layout is [z, y, x] (slab-major for the Pallas kernel)
    cell_id = (cell_xyz[:, 0] +
               nx * (cell_xyz[:, 1] + ny * cell_xyz[:, 2]))

    order = jnp.argsort(cell_id)
    sorted_cells = cell_id[order]
    starts = jnp.searchsorted(sorted_cells, jnp.arange(n_cells),
                              side="left")
    rank_sorted = jnp.arange(n) - starts[sorted_cells]
    overflow = jnp.any(rank_sorted >= cap)
    rank_c = jnp.minimum(rank_sorted, cap - 1)
    slot_of_sorted = sorted_cells * cap + rank_c

    far = jnp.asarray(1e30, dtype=dtype)

    def to_cells(values, fill):
        flat = jnp.full((n_cells * cap,), fill, dtype=values.dtype)
        flat = flat.at[slot_of_sorted].set(values[order], mode="drop")
        return flat.reshape(n_cells, cap)

    cx = to_cells(pos3[:, 0], far)
    cy = to_cells(pos3[:, 1], far)
    cz = to_cells(pos3[:, 2], far)
    ct = to_cells(pos4[:, 3], jnp.asarray(0, dtype=dtype))
    slot_of_particle = jnp.zeros((n,), jnp.int32).at[order].set(
        slot_of_sorted.astype(jnp.int32))
    return cx, cy, cz, ct, slot_of_particle, overflow


@partial(jax.jit, static_argnames=("NN", "grid", "capacity", "r_cut",
                                   "rcut_matrix"))
def _cell_nlist_impl(pos4, r_cut, NN, grid, capacity, box_lengths,
                     rcut_matrix=None):
    """Cell-dense blocked build.

    Design notes (not yet measured on the GPU):

    - particle data is scattered once into dense per-cell arrays
      ``[n_cells, capacity]`` and every later access is a *row* gather of
      contiguous blocks (27 rows per cell), instead of a per-particle
      element gather of candidate positions;
    - all large intermediates are component-separated 2-D ``[rows, C]``
      arrays rather than arrays with a trailing size-3/4 axis;
    - work is organized per *cell block* (every particle of a cell shares
      the same 27-cell candidate set), so the distance math is dense
      ``[n_cells, capacity, 27*capacity]`` elementwise work.
    """
    nx, ny, nz = grid
    n_cells = nx * ny * nz
    dtype = pos4.dtype
    lengths = box_lengths.astype(dtype)
    cap = capacity
    c27 = 27 * cap

    cx, cy, cz, ct, slot_of_particle, overflow = _build_planes(
        pos4, grid, cap, lengths)

    # --- 27-cell stencil: row gathers of contiguous cell blocks -------------
    cz_, cy_, cx_ = jnp.meshgrid(jnp.arange(nz), jnp.arange(ny),
                                 jnp.arange(nx), indexing="ij")
    base_xyz = jnp.stack([cx_.ravel(), cy_.ravel(), cz_.ravel()],
                         axis=-1).astype(jnp.int32)        # [n_cells, 3]
    dims = jnp.asarray(grid, dtype=jnp.int32)
    offs = jnp.asarray(
        [(a, b, c) for a in (-1, 0, 1) for b in (-1, 0, 1)
         for c in (-1, 0, 1)], dtype=jnp.int32)            # [27, 3]
    neigh_xyz = (base_xyz[:, None, :] + offs[None, :, :]) % dims
    neigh_id = (neigh_xyz[..., 0] +
                nx * (neigh_xyz[..., 1] + ny * neigh_xyz[..., 2]))

    def stencil(arr):                                       # [n_cells, cap]
        return arr[neigh_id].reshape(n_cells, c27)          # row gathers

    gx, gy, gz = stencil(cx), stencil(cy), stencil(cz)
    gt = stencil(ct)

    # --- dense per-cell-block distances --------------------------------------
    def min_image(d, L):
        return d - jnp.round(d / L) * L

    # [n_cells, cap, c27]; query slots broadcast against the shared
    # candidate row of their cell. Empty slots sit at a far sentinel
    # coordinate, so the r_cut test handles them with no index plane.
    ddx = min_image(gx[:, None, :] - cx[:, :, None], lengths[0])
    ddy = min_image(gy[:, None, :] - cy[:, :, None], lengths[1])
    ddz = min_image(gz[:, None, :] - cz[:, :, None], lengths[2])
    d2 = ddx * ddx + ddy * ddy + ddz * ddz
    valid = (d2 <= r_cut * r_cut) & (d2 >= 25e-8)
    if rcut_matrix is not None:
        from .nlist import pair_rc2
        # per-type-pair cutoffs (reference rcut() matrix,
        # tensorflowcompute.py:284-305); ct is the per-slot type plane
        # (empty slots hold 0 but are already distance-invalid)
        rc2 = pair_rc2(ct[:, :, None], gt[:, None, :], rcut_matrix, dtype)
        valid = valid & (d2 <= rc2)

    # --- nearest-NN selection via a payload sort ------------------------------
    # one multi-operand sort carries the displacement/type payloads through
    # the comparator network, so no take_along_axis gathers follow it. The
    # key is the f32 distance bit pattern (monotonic for non-negative
    # floats).
    rows = n_cells * cap
    key = jax.lax.bitcast_convert_type(d2, jnp.uint32)
    key = jnp.where(valid, key, jnp.uint32(0xFFFFFFFF))
    valid8 = valid.astype(jnp.uint8)
    key_s, dx_s, dy_s, dz_s, ty_s, val_s = jax.lax.sort(
        (key.reshape(rows, c27), ddx.reshape(rows, c27),
         ddy.reshape(rows, c27), ddz.reshape(rows, c27),
         jnp.broadcast_to(gt[:, None, :],
                          (n_cells, cap, c27)).reshape(rows, c27),
         valid8.reshape(rows, c27)),
        dimension=1, num_keys=1)
    mask = val_s[:, :NN].astype(dtype)
    nl_dx = dx_s[:, :NN] * mask
    nl_dy = dy_s[:, :NN] * mask
    nl_dz = dz_s[:, :NN] * mask
    nl_ty = ty_s[:, :NN] * mask

    # --- back to original particle order (contiguous row gathers) -----------
    nlist = jnp.stack(
        [nl_dx[slot_of_particle], nl_dy[slot_of_particle],
         nl_dz[slot_of_particle], nl_ty[slot_of_particle]], axis=-1)
    return nlist, overflow


def max_occupancy(positions, box_lengths, grid):
    """Measured max particles-per-cell for concrete positions (host-side;
    used to size the capacity against structured initial conditions)."""
    positions = np.asarray(positions)[:, :3].astype(np.float64)
    lengths = np.asarray(box_lengths, dtype=np.float64)
    frac = positions / lengths
    frac = frac - np.floor(frac)
    dims = np.asarray(grid)
    xyz = np.minimum((frac * dims).astype(np.int64), dims - 1)
    cid = xyz[:, 0] + dims[0] * (xyz[:, 1] + dims[1] * xyz[:, 2])
    return int(np.bincount(cid, minlength=int(np.prod(dims))).max())


def plan(n, box_lengths, r_cut, config=None):
    """Static geometry for the build: ``(grid, capacity)``. Must be computed
    from *concrete* box lengths (outside any trace); the box is constant
    under NVE/NVT so the Simulation plans once per compiled scan."""
    config = config or CellList()
    np_lengths = np.asarray(box_lengths, dtype=np.float64)
    grid = config.grid_for(np_lengths, r_cut)
    if not all(d >= 3 for d in grid):
        return None, None  # caller falls back to O(N^2)
    capacity = config.capacity or config.default_capacity(
        n, np_lengths, r_cut)
    return tuple(grid), int(capacity)


def cell_list_nlist(pos4, r_cut, NN, box, config=None, return_overflow=False,
                    grid=None, capacity=None, rcut_matrix=None):
    """Padded ``[N, NN, 4]`` neighbor list (displacement + neighbor type)
    via a fixed-capacity cell list. Nearest-NN sorted ascending
    (approximately: slot-index tie-breaking perturbs the low mantissa bits).

    :param pos4: ``[N, 4]`` positions with type in the last column.
    :param r_cut: cutoff radius.
    :param NN: max neighbors per particle.
    :param box: ``[3, 3]`` box array (or ``[3]`` lengths).
    :param config: a :class:`CellList` (default constructed).
    :param return_overflow: also return a scalar bool flag set when any
        cell exceeded its capacity (neighbors may then be missing).
    :param grid, capacity: static plan from :func:`plan`; required when
        calling under a trace (the box must then be constant), otherwise
        derived from the concrete box.
    :param rcut_matrix: per-type-pair ``[ntypes, ntypes]`` cutoffs
        (negative = never neighbors; ``r_cut`` must be its max).
    """
    if rcut_matrix is not None:
        rcut_matrix = tuple(tuple(float(v) for v in row)
                            for row in np.asarray(rcut_matrix))
    box = jnp.asarray(box)
    lengths = _box_size(box) if box.ndim == 2 else box
    if grid is None or capacity is None:
        np_lengths = np.asarray(jax.lax.stop_gradient(lengths))
        grid, capacity = plan(pos4.shape[0], np_lengths, r_cut, config)
        if grid is None:
            raise ValueError(
                f"Box {np_lengths} too small for a cell list at "
                f"r_cut={r_cut}; use compute_nlist (O(N^2)) instead")
    nlist, overflow = _cell_nlist_impl(
        pos4, float(r_cut), int(NN), tuple(grid), int(capacity), lengths,
        rcut_matrix=rcut_matrix)
    if return_overflow:
        return nlist, overflow
    return nlist
