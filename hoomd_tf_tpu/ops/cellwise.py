"""Slot-resident ("cellwise") neighbor machinery -- the pair fast path.

Every other build in this package keeps the simulation state in particle
order and pays, per step, to convert between particle order and cell
order: binning scatters, a 27-cell stencil row gather, and a
per-particle candidate row gather.

The cellwise mode deletes the conversions instead of optimizing them: the
*state itself* lives in cell-slot layout. Arrays have ``n_slots =
n_cells * capacity`` rows; row ``cell * capacity + k`` holds the k-th
particle of that cell, and surplus rows are "ghosts" (``valid == 0``)
parked at their cell center with zero velocity and zero force. Then,
per MD step:

- candidate planes come from 27 static ``jnp.roll`` calls on the
  ``[nz, ny, nx, cap]`` view -- pure contiguous data movement, no gather;
- the model consumes ``NlistPlanes`` rows that are *already* aligned with
  the state rows -- no per-particle gather, and forces land directly in
  integrator layout;
- plane production is cheap elementwise math, so it is deliberately NOT
  pinned with an optimization barrier: XLA fuses (rematerializes) it into
  the model's forward and backward passes and the ``[n_slots, 27*cap]``
  planes never reach device memory.

Between rebuilds the slot assignment is *fixed*: the cell edge carries a
skin margin over ``r_cut`` (Verlet criterion), positions drift within
their slots, and a ``lax.cond``-gated repack re-sorts the state only when
``2 * max_drift >= min(edge) - r_cut``. The distance filter always uses
true positions, so the neighbor planes stay exact for ``r_cut``
regardless of the skin.

This replaces the reference's HOOMD cell list + CSR reshape kernel
(``TensorflowCompute.cu:80-209``). Whether the gather-free layout beats
a conventional Verlet list with per-step gathers on the GPU has not been
measured yet (ROADMAP).
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np

from .cell_list import CellList
from .direct import NlistPlanes

__all__ = ["Cellwise", "CellwisePlan", "plan_cellwise", "cellwise_planes",
           "analytic_pair_forces", "repack_order", "slot_cell_centers",
           "bin_cells", "pair_lanes"]


class Cellwise(CellList):
    """Configuration selecting the slot-resident neighbor mode
    (``tfc.attach(sim, nlist=Cellwise(...))``; the bare string
    ``nlist='cellwise'`` uses the defaults).

    :param capacity: slots per cell (default: measured occupancy + 15%
        + 3 margin, grid chosen to minimize pair work).
    :param skin: *minimum* Verlet margin; the planner may pick a larger
        one when a coarser grid is cheaper. Larger skins lengthen the
        repack interval but widen the candidate planes.
    """

# 27-cell stencil offsets in (ox, oy, oz) order
_OFFS = [(ox, oy, oz) for oz in (-1, 0, 1) for oy in (-1, 0, 1)
         for ox in (-1, 0, 1)]

# Half stencil for Newton's-third-law pair accumulation: the self cell
# plus the 13 offsets whose first nonzero component (z-major) is
# positive. Every unordered adjacent-cell pair {c, c+off} appears for
# exactly one of off/-off, so evaluating each directed block once and
# accumulating BOTH sides (row i gets +F, candidate j gets -F via a
# roll-back) covers all pairs with 14/27 of the candidate lanes.
_HALF_OFFS = [(0, 0, 0)] + [o for o in _OFFS
                            if (o[2], o[1], o[0]) > (0, 0, 0)]


def _perp_widths(lengths, tilt):
    """Perpendicular widths of a triclinic box: the distance between the
    two box faces spanned by the *other* two lattice vectors, per axis
    (``V / |b x c|`` etc.). These -- not the edge lengths -- are what a
    cell layer must cover for the 27-stencil to see every pair within
    ``r_cut``. For zero tilt they equal the edge lengths exactly."""
    Lx, Ly, Lz = (float(v) for v in lengths)
    xy, xz, yz = (float(v) for v in tilt)
    a = np.array([Lx, 0.0, 0.0])
    b = np.array([xy * Ly, Ly, 0.0])
    c = np.array([xz * Lz, yz * Lz, Lz])
    V = Lx * Ly * Lz
    return (V / float(np.linalg.norm(np.cross(b, c))),
            V / float(np.linalg.norm(np.cross(a, c))),
            V / float(np.linalg.norm(np.cross(a, b))))


def _wrap_tri(r, lengths, tilt):
    """Sequential (z, then y, then x) triclinic minimum-image wrap of
    ``[..., 3]`` displacement(s) with *static* lengths/tilt -- the same
    convention as :func:`.box.wrap_vector` (exact for HOOMD's supported
    tilt range, |tilt| <= 0.5)."""
    dtype = r.dtype
    Lx, Ly, Lz = (jnp.asarray(v, dtype=dtype) for v in lengths)
    xy, xz, yz = (jnp.asarray(t, dtype=dtype) for t in tilt)
    rx, ry, rz = r[..., 0], r[..., 1], r[..., 2]
    iz = jnp.round(rz / Lz)
    rx = rx - iz * xz * Lz
    ry = ry - iz * yz * Lz
    rz = rz - iz * Lz
    iy = jnp.round(ry / Ly)
    rx = rx - iy * xy * Ly
    ry = ry - iy * Ly
    rx = rx - jnp.round(rx / Lx) * Lx
    return jnp.stack([rx, ry, rz], axis=-1)


@dataclasses.dataclass(frozen=True)
class CellwisePlan:
    """Static geometry of the slot-resident layout (hashable; closed over
    by the compiled step).

    :param grid: cells per axis ``(nx, ny, nz)``.
    :param capacity: slots per cell.
    :param lengths: concrete box lengths ``(Lx, Ly, Lz)``.
    :param r_cut: cutoff radius the planes are exact for.
    :param tilt: dimensionless tilt factors ``(xy, xz, yz)`` (HOOMD
        convention; all zero = orthorhombic). Static like the lengths:
        cells are a regular grid in *fractional* space, and every
        geometry helper branches on ``any(tilt)`` at trace time so the
        orthorhombic programs are unchanged.
    """
    grid: tuple
    capacity: int
    lengths: tuple
    r_cut: float
    tilt: tuple = (0.0, 0.0, 0.0)

    @property
    def n_cells(self):
        nx, ny, nz = self.grid
        return nx * ny * nz

    @property
    def n_slots(self):
        return self.n_cells * self.capacity

    @property
    def width(self):
        """Candidate-plane width ``C = 27 * capacity``."""
        return 27 * self.capacity

    @property
    def edges(self):
        return tuple(L / d for L, d in zip(self.lengths, self.grid))

    @property
    def perp_cell_widths(self):
        """Per-axis perpendicular width of one cell layer -- the quantity
        the Verlet/stencil criterion actually bounds (equals ``edges``
        for an unskewed box)."""
        if not any(self.tilt):
            return self.edges
        return tuple(w / d for w, d in
                     zip(_perp_widths(self.lengths, self.tilt), self.grid))

    @property
    def skin(self):
        """Verlet margin: the slot assignment stays valid while the
        largest displacement since the last repack is below ``skin / 2``."""
        return min(self.perp_cell_widths) - self.r_cut


def _measured_occupancy(positions, lo, lengths, dims, tilt=(0., 0., 0.)):
    """Max, mean and std of particles-per-cell for concrete positions
    (host). Cells are a regular grid in *fractional* space, so a tilted
    box bins via the upper-triangular cell-matrix solve."""
    pos = np.asarray(positions)[:, :3].astype(np.float64)
    lengths = np.asarray(lengths, dtype=np.float64)
    r = pos - np.asarray(lo)
    if any(tilt):
        xy, xz, yz = (float(v) for v in tilt)
        fz = r[:, 2] / lengths[2]
        fy = (r[:, 1] - yz * lengths[2] * fz) / lengths[1]
        fx = (r[:, 0] - xy * lengths[1] * fy - xz * lengths[2] * fz) \
            / lengths[0]
        frac = np.stack([fx, fy, fz], axis=-1)
    else:
        frac = r / lengths
    frac = frac - np.floor(frac)
    dims = np.asarray(dims)
    xyz = np.minimum((frac * dims).astype(np.int64), dims - 1)
    cid = xyz[:, 0] + dims[0] * (xyz[:, 1] + dims[1] * xyz[:, 2])
    counts = np.bincount(cid, minlength=int(np.prod(dims)))
    return int(counts.max()), float(counts.mean()), float(counts.std())


# Planner cost model, in seconds: per executed pair lane of each route
# and per slot of one repack (amortized over the repack interval K).
# Least-squares fit of ms/step over a 64k-particle grid x capacity sweep
# (benchmarks/scale.py --plansweep 65536: 8 grids from 18^3 to 10^3, two
# capacities each, both routes) on one NVIDIA H100 80GB HBM3 at a
# 400 W power limit; PERF.md lists the rows. Kernel route:
# t = 1.40e-4 + 4.08e-12 * lanes + 9.75e-10 * slots / K, residuals
# <= 4%. The XLA full stencil's lane cost (8.5e-12) fits to only ~55%:
# its step time jumps at large capacity. A per-rebuild fixed cost was not
# resolved by the fit (-2.4e-5 s) and is not modelled.
_PAIR_LANE_COST = 8.5e-12         # XLA full / half stencil
_PAIR_LANE_COST_PALLAS = 4.08e-12  # half-stencil kernel (ops/cellwise_pallas)
_REPACK_SLOT_COST = 9.75e-10


def pair_lanes(n, n_cells, cap, stencil):
    """Pair-function lanes one analytic evaluation executes.

    The XLA stencils evaluate every slot against every candidate slot
    (``27`` or ``14`` blocks of ``cap``), with no padding. The
    half-stencil kernel runs each cell's occupied rows only, rounded up
    to its row tile (on average ``mean + ROW_TILE / 2`` rows), against
    ``14 * cap`` candidate lanes rounded up to whole lane chunks."""
    if stencil == "pallas":
        from .cellwise_pallas import ROW_TILE, lane_chunks
        rows = n / n_cells + ROW_TILE / 2.0
        return n_cells * rows * lane_chunks(14 * cap)[1]
    blocks = 14 if stencil == "half" else 27
    return n_cells * cap * blocks * cap


def plan_cellwise(n, box_lengths, r_cut, config=None, positions=None,
                  lo=None, drift_per_step=None, z_divisor=1,
                  stencil="full", occ_observed=None,
                  lane_cost_scale=1.0, tilt=(0.0, 0.0, 0.0)):
    """Choose ``(grid, capacity)`` minimizing amortized per-step cost.

    The fused pair loop costs ``27 * n_cells * capacity**2`` lanes;
    *larger* cells often win because per-cell occupancy fluctuations
    (which set the capacity padding) average out AND the bigger skin
    stretches the repack interval. The search scans cell-edge candidates
    from ``r_cut`` upward, sizes the capacity from the measured occupancy
    of ``positions`` plus an equilibrium-fluctuation estimate
    (repack-time overflow is still detected at runtime), and picks the
    grid minimizing ``pair_work + repack_cost / repack_interval`` with
    the interval from the Verlet criterion at ``drift_per_step``.

    :param config: an optional :class:`.cell_list.CellList`; its
        ``capacity`` overrides the occupancy estimate and its ``skin`` is
        a *minimum* skin for the grid.
    :param drift_per_step: typical per-step particle displacement (the
        engine passes ``dt * |v|_p99``); without it the rebuild term is
        dropped and the cheapest pair loop wins.
    :param z_divisor: force ``nz`` to a multiple of this. The slot layout
        is z-slab-major, so sharding the slot axis over a device mesh is
        a spatial domain decomposition along z; equal shards need
        ``nz % n_devices == 0`` (see md/simulation.py mesh support).
    :param stencil: route of the analytic pair loop that dominates the
        step (:mod:`.routes`); it sets the executed lane count
        (:func:`pair_lanes`) and the per-lane cost, which can shift the
        chosen grid.
    :param occ_observed: optional ``(grid, occ_running_max)`` measured by
        the engine over a previous run on ``grid`` (the scan carries the
        max snapshot occupancy across every repack, md/slots.py). When
        given, it replaces the conservative statistical fluctuation
        estimate: the observed max IS the quantity capacity must cover,
        so capacity = observed + a small extreme-value margin (scaled by
        ``sqrt(mean_ratio)`` when the candidate grid differs). Overflow of a
        tighter plan is still detected at every repack and self-healed.
    :param lane_cost_scale: relative per-lane cost of the hot pair
        evaluation vs the built-in LJ that ``_PAIR_LANE_COST`` was
        measured on. Expensive pair functions (per-lane NN potentials,
        ~10-40x LJ; training passes, ~3x more) shift the lane-vs-repack
        tradeoff toward minimum-lane grids: with the default 1.0 the
        planner buys a fatter lane count for a longer repack interval,
        which is wrong when each lane costs many times the model
        constant.
    :returns: a :class:`CellwisePlan`, or ``None`` if no valid grid (>= 3
        cells per axis) exists.
    """
    from .cell_list import CellList
    config = config if isinstance(config, CellList) else CellList()
    lengths = np.asarray(box_lengths, dtype=np.float64)
    tilt = tuple(float(t) for t in tilt)
    if lo is None:
        lo = -lengths / 2.0
    min_edge = r_cut + max(config.skin, 0.0)
    # grid sizing bounds the *perpendicular* width of a cell layer (the
    # quantity the 27-stencil criterion needs); for zero tilt these are
    # the edge lengths exactly
    widths = (np.asarray(_perp_widths(lengths, tilt)) if any(tilt)
              else lengths)
    best = None
    for scale in np.linspace(1.0, 1.8, 9):
        dims = list(int(math.floor(W / (min_edge * scale)))
                    for W in widths)
        if z_divisor > 1:
            dims[2] = (dims[2] // z_divisor) * z_divisor
        dims = tuple(dims)
        if any(d < 3 for d in dims):
            continue
        edges = [W / d for W, d in zip(widths, dims)]
        if min(edges) < min_edge:
            continue
        n_cells_d = float(np.prod(dims))
        mean = n / n_cells_d
        # equilibrium occupancy fluctuations: capacity must cover the
        # RUNNING max over a whole run, i.e. the max over roughly
        # n_cells * n_repacks (~100 per 1000 steps) effectively
        # independent counts -- not one snapshot's max. A plan sized to
        # the snapshot (mean + sqrt(2 ln n_cells) * sqrt(0.6 mean), the
        # round-2 formula) measured ~5 overflow events per 1000 steps
        # at 64k on a live kT=1.2 fluid; the time-horizon factor and a
        # near-Poisson variance (0.9 -- the sub-Poisson 0.6 of dense
        # liquids is optimistic at moderate density) cover it.
        # Structured initial conditions (lattices) can exceed the
        # statistical estimate, so the measured t=0 max is a floor.
        # Overflow is still detected at every repack, and run() rolls
        # back and replans with a raised floor when it fires.
        c = math.sqrt(2.0 * math.log(max(n_cells_d, 2.0) * 100.0))
        est = int(math.ceil(mean + c * math.sqrt(0.9 * max(mean, 1.0))))
        if occ_observed is not None:
            # measured-running-max calibration: the observed max over a
            # run's repacks bounds what the formula above estimates
            # blind. The fluctuation EXCESS (max - mean) transfers to a
            # different grid as ~sqrt(mean ratio) (near-Poisson counts,
            # same extreme-value factor); +2 covers run-to-run drift of
            # the running max.
            cal_grid, cal_occ = occ_observed
            cal_mean = n / float(np.prod(cal_grid))
            excess = max(float(cal_occ) - cal_mean, 0.0)
            est_obs = int(math.ceil(
                mean + excess * math.sqrt(mean / max(cal_mean, 1e-9)))) + 2
            est = min(est, est_obs)
        if config.capacity is not None:
            cap = int(config.capacity)  # the user's word, exactly
        elif positions is not None:
            occ_max, _, _ = _measured_occupancy(
                positions, lo, lengths, dims, tilt=tilt)
            cap = (max(occ_max + 1, est) if occ_observed is not None
                   else max(occ_max, est) + 3)
        elif occ_observed is not None:
            # est_obs already carries the +2 extreme-value margin; no
            # snapshot needed (the running max bounds any snapshot)
            cap = est
        else:
            cap = est + 4
        n_cells = int(np.prod(dims))
        skin = min(edges) - r_cut
        lane_cost = (_PAIR_LANE_COST_PALLAS if stencil == "pallas"
                     else _PAIR_LANE_COST)
        cost = (pair_lanes(n, n_cells, cap, stencil) * lane_cost *
                lane_cost_scale)
        if drift_per_step and drift_per_step > 0:
            interval = max(1.0, (skin * 0.98 / 2.0) / drift_per_step)
            cost += n_cells * cap * _REPACK_SLOT_COST / interval
        key = (cost, -skin)
        if best is None or key < best[0]:
            best = (key, CellwisePlan(grid=dims, capacity=cap,
                                      lengths=tuple(float(L)
                                                    for L in lengths),
                                      r_cut=float(r_cut), tilt=tilt))
    return best[1] if best else None


def slot_cell_centers(plan, lo, dtype=jnp.float32, lengths=None):
    """``[n_slots, 3]`` cell-center coordinates -- the parking spot for
    ghost slots (safely inside the box: min-image math never sees a far
    sentinel, and position wrapping is a fixed point there).

    ``lo``/``lengths`` may be traced values (dynamic-box mode, NPT): the
    grid is static, the geometry scales with the box."""
    nx, ny, nz = plan.grid
    cap = plan.capacity
    if lengths is None:
        ex, ey, ez = plan.edges
    else:
        lengths = jnp.asarray(lengths, dtype=dtype)
        dims = jnp.asarray(plan.grid, dtype=dtype)
        ex, ey, ez = (lengths[i] / dims[i] for i in range(3))
    cell = jnp.arange(plan.n_slots) // cap
    cx = (cell % nx).astype(dtype)
    cy = ((cell // nx) % ny).astype(dtype)
    cz = (cell // (nx * ny)).astype(dtype)
    lo = jnp.asarray(lo, dtype=dtype)
    fx, fy, fz = (cx + 0.5) * ex, (cy + 0.5) * ey, (cz + 0.5) * ez
    if any(plan.tilt):
        # cells are a regular grid in fractional space; the Cartesian
        # center is the cell matrix applied to the fractional center
        xy, xz, yz = plan.tilt
        return jnp.stack([lo[0] + fx + xy * fy + xz * fz,
                          lo[1] + fy + yz * fz,
                          lo[2] + fz], axis=-1)
    return jnp.stack([lo[0] + fx, lo[1] + fy, lo[2] + fz], axis=-1)


def bin_cells(pos3, lo, plan, lengths=None):
    """Flat cell id per row (x-minor / z-major layout, matching the
    ``[nz, ny, nx, cap]`` slot view). ``lo``/``lengths`` may be traced
    (dynamic-box mode)."""
    dtype = pos3.dtype
    if lengths is None:
        lengths = plan.lengths
    lengths = jnp.asarray(lengths, dtype=dtype)
    dims = jnp.asarray(plan.grid, dtype=jnp.int32)
    r = pos3 - jnp.asarray(lo, dtype=dtype)
    if any(plan.tilt):
        # fractional coordinates via the upper-triangular solve
        xy, xz, yz = (jnp.asarray(t, dtype=dtype) for t in plan.tilt)
        fz = r[:, 2] / lengths[2]
        fy = (r[:, 1] - yz * lengths[2] * fz) / lengths[1]
        fx = (r[:, 0] - xy * lengths[1] * fy - xz * lengths[2] * fz) \
            / lengths[0]
        frac = jnp.stack([fx, fy, fz], axis=-1)
    else:
        frac = r / lengths
    frac = frac - jnp.floor(frac)
    xyz = jnp.minimum((frac * dims.astype(dtype)).astype(jnp.int32),
                      dims - 1)
    nx, ny, _ = plan.grid
    return xyz[:, 0] + nx * (xyz[:, 1] + ny * xyz[:, 2])


def _roll_offs(plane, plan, offs_list):
    """``[n_slots]`` plane -> ``[n_cells, len(offs)*cap]`` candidate rows
    via static rolls of the ``[nz, ny, nx, cap]`` view. A roll is a pair
    of contiguous slices (no gather); XLA fuses the stack into
    consumers."""
    nx, ny, nz = plan.grid
    cap = plan.capacity
    a = plane.reshape(nz, ny, nx, cap)
    outs = [jnp.roll(a, shift=(-oz, -oy, -ox), axis=(0, 1, 2))
            for (ox, oy, oz) in offs_list]
    return jnp.stack(outs, axis=3).reshape(plan.n_cells,
                                           len(offs_list) * cap)


def _roll27(plane, plan):
    return _roll_offs(plane, plan, _OFFS)


def _roll_back(block, plan, off):
    """Push a ``[n_cells, cap]`` per-candidate partial (computed at cell
    ``c`` for the slots of cell ``c + off``) onto the rows of cell
    ``c + off``: the inverse roll of the candidate gather."""
    ox, oy, oz = off
    nx, ny, nz = plan.grid
    a = block.reshape(nz, ny, nx, plan.capacity)
    return jnp.roll(a, shift=(oz, oy, ox), axis=(0, 1, 2)).reshape(
        plan.n_cells, plan.capacity)


def cellwise_planes(positions, types, valid, plan, rcut_matrix=None,
                    lengths=None):
    """Masked candidate planes for slot-resident state.

    :param positions: ``[n_slots, 3]`` slot positions (ghosts at centers).
    :param types: ``[n_slots]`` integer types (ghosts 0).
    :param valid: ``[n_slots]`` 1.0 for real rows, 0.0 for ghosts.
    :param rcut_matrix: per-type-pair ``[ntypes, ntypes]`` cutoffs
        (negative = never neighbors; ``plan.r_cut`` must be its max).
    :param lengths: dynamic box lengths ``[3]`` (traced; dynamic-box
        mode). Defaults to the plan's static lengths.
    :returns: :class:`.direct.NlistPlanes` with ``[n_slots, 27*cap]``
        components; ghost *rows* and ghost *candidates* are exactly zero,
        like the padded slots of the packed nlist.
    """
    dtype = positions.dtype
    n_cells, cap, C = plan.n_cells, plan.capacity, plan.width
    rc2 = plan.r_cut * plan.r_cut
    px, py, pz = positions[:, 0], positions[:, 1], positions[:, 2]
    tt = types.astype(dtype)
    gx, gy, gz = _roll27(px, plan), _roll27(py, plan), _roll27(pz, plan)
    gt, gv = _roll27(tt, plan), _roll27(valid, plan)

    def mi(d, L):
        return d - jnp.round(d / L) * L

    if lengths is None:
        lengths = plan.lengths
    lengths = jnp.asarray(lengths, dtype=dtype)
    Lx, Ly, Lz = lengths[0], lengths[1], lengths[2]
    ddx = gx.reshape(n_cells, 1, C) - px.reshape(n_cells, cap, 1)
    ddy = gy.reshape(n_cells, 1, C) - py.reshape(n_cells, cap, 1)
    ddz = gz.reshape(n_cells, 1, C) - pz.reshape(n_cells, cap, 1)
    if any(plan.tilt):
        # sequential triclinic minimum image (z removes its lattice
        # vector from all three components, then y, then x)
        xy, xz, yz = (jnp.asarray(t, dtype=dtype) for t in plan.tilt)
        iz = jnp.round(ddz / Lz)
        ddx, ddy, ddz = (ddx - iz * xz * Lz, ddy - iz * yz * Lz,
                         ddz - iz * Lz)
        iy = jnp.round(ddy / Ly)
        ddx, ddy = ddx - iy * xy * Ly, ddy - iy * Ly
        ddx = mi(ddx, Lx)
    else:
        ddx, ddy, ddz = mi(ddx, Lx), mi(ddy, Ly), mi(ddz, Lz)
    d2 = ddx * ddx + ddy * ddy + ddz * ddz
    ok = ((d2 <= rc2) & (d2 >= 25e-8) &
          (gv.reshape(n_cells, 1, C) > 0) &
          (valid.reshape(n_cells, cap, 1) > 0))
    if rcut_matrix is not None:
        from .nlist import pair_rc2
        prc2 = pair_rc2(tt.reshape(n_cells, cap, 1),
                        gt.reshape(n_cells, 1, C), rcut_matrix, dtype)
        ok = ok & (d2 <= prc2)
    zero = jnp.zeros((), dtype=dtype)
    n_slots = plan.n_slots

    def sel(d):
        return jnp.where(ok, d, zero).reshape(n_slots, C)

    return NlistPlanes(
        dx=sel(ddx), dy=sel(ddy), dz=sel(ddz),
        type=jnp.where(ok, gt.reshape(n_cells, 1, C),
                       zero).reshape(n_slots, C))


def _relative_coords(positions, valid, plan, lo, offs_list, lengths=None):
    """Shared analytic-path prologue: cell-relative coordinates (ghosts
    pushed FAR along x) and the per-direction candidate planes with the
    static stencil offsets pre-added, so downstream displacement math is
    exact without min-image rounding. ``lo``/``lengths`` may be traced
    (dynamic-box mode); the stencil offsets then scale with the box."""
    dtype = positions.dtype
    cap = plan.capacity
    C = len(offs_list) * cap
    dynamic = lengths is not None
    np_dtype = np.dtype(dtype)
    tilted = any(plan.tilt)
    if dynamic:
        if tilted:
            raise NotImplementedError(
                "dynamic-box (NPT) mode does not support tilted boxes")
        L3 = jnp.asarray(lengths, dtype=dtype)
        edges = L3 / jnp.asarray(plan.grid, dtype=dtype)
        ioffs = np.asarray(offs_list, dtype=np_dtype)    # [n_offs, 3]
        offs = jnp.asarray(ioffs) * edges[None, :]       # traced
        off_x = jnp.repeat(offs[:, 0], cap, total_repeat_length=C)
        off_y = jnp.repeat(offs[:, 1], cap, total_repeat_length=C)
        off_z = jnp.repeat(offs[:, 2], cap, total_repeat_length=C)
        centers = slot_cell_centers(plan, lo, dtype, lengths=lengths)
    else:
        # static geometry: bake the offsets as numpy constants so they
        # embed in the program instead of tracing through repeat ops.
        # Tilted boxes: the Cartesian offset between a cell and its
        # (ox,oy,oz) stencil neighbor is the cell matrix applied to the
        # fractional offset -- still a compile-time constant, so the
        # hot-loop structure (and the Pallas kernel) is unchanged.
        ex, ey, ez = plan.edges
        xy, xz, yz = plan.tilt
        noffs = np.array([(ox * ex + xy * oy * ey + xz * oz * ez,
                           oy * ey + yz * oz * ez,
                           oz * ez)
                          for (ox, oy, oz) in offs_list], dtype=np_dtype)
        off_x = jnp.asarray(np.repeat(noffs[:, 0], cap))
        off_y = jnp.asarray(np.repeat(noffs[:, 1], cap))
        off_z = jnp.asarray(np.repeat(noffs[:, 2], cap))
        centers = slot_cell_centers(plan, lo, dtype)
    FAR = 4.0 * float(max(plan.lengths))
    q = positions - centers
    # wrap: unwrapped trajectories may place a particle many boxes from
    # its (wrapped-binning) cell; the relative coordinate is the
    # physical position modulo box
    if tilted:
        q = _wrap_tri(q, plan.lengths, plan.tilt)
    else:
        L3 = L3 if dynamic else jnp.asarray(plan.lengths, dtype=dtype)
        q = q - jnp.round(q / L3) * L3
    # rank-scaled FAR: each ghost is pushed a DISTINCT distance along x
    # (FAR * (1 + in-cell slot rank)). A uniform FAR places every ghost
    # of a cell at the SAME point, so ghost<->ghost lanes sit at d2 = 0
    # and evaluate the pair function at the min_r2 clamp. For built-in
    # LJ at the default clamp that value is huge but finite (~2e29) and
    # the dx = 0 product zeroes it exactly -- but a steeper user
    # potential or a smaller min_r2 overflows f32 to inf there, and
    # inf * 0 = NaN on ghost rows. Distinct pushes keep every ghost
    # pair FAR apart, so ghost lanes are distance-masked and ghost
    # forces are finite-zero for ANY pair function.
    rank = (jnp.arange(plan.n_slots, dtype=jnp.int32) %
            plan.capacity).astype(dtype)
    qx = q[:, 0] + (1.0 - valid) * FAR * (1.0 + rank)
    qy, qz = q[:, 1], q[:, 2]

    gx = _roll_offs(qx, plan, offs_list) + off_x
    gy = _roll_offs(qy, plan, offs_list) + off_y
    gz = _roll_offs(qz, plan, offs_list) + off_z
    return qx, qy, qz, gx, gy, gz


def analytic_pair_forces(positions, types, valid, plan, lo, pair_fn,
                         needs_virial=False, min_r2=1e-4, with_types=False,
                         rcut_matrix=None, stencil="auto", lengths=None,
                         needs_energy=True, mesh=None, shard_axis=None):
    """Forces/energy (and optionally virial) for a pair potential on
    slot-resident state, computed *analytically forward-only* -- the fast
    path behind :class:`..models.pair.PairModel`.

    The generic planes route evaluates the potential twice (forward +
    vjp replay, each rematerializing the candidate planes). For a pair
    potential ``U(r^2, t_i, t_j)`` the per-pair force coefficient is just
    ``dU/d(r^2)``, obtained in the same forward pass with one
    ``jax.jvp`` (or the pair function's own shared-subexpression
    slope).

    With the half stencil (``'half'`` and ``'pallas'``) each unordered
    pair is evaluated ONCE: the candidate planes hold the self cell plus
    13 directed offsets (14/27 of the lanes), and Newton's third law
    supplies the other side. For each directed block, the row side
    accumulates over the candidate (lane) axis as usual, while the
    candidate side is a reduction over the *row* axis of the same
    product arrays, pushed onto its home cell by the inverse roll --
    pure contiguous data movement, no scatter. A bonus over the full
    stencil: the pair force is bit-exactly antisymmetric (both sides
    come from the same f32 product), so net momentum is conserved to
    the rounding of the final sum rather than of two
    independently-evaluated forces.

    Design notes, all load-bearing:

    - Displacements come from *cell-relative* coordinates plus a static
      per-stencil-direction offset, so there is no min-image round() on
      the hot loop: ``x_j - x_i = (q_j + off_k) - q_i`` exactly, for
      cells >= 3 per axis and in-range pairs.
    - The self-pair is excluded *structurally* (in the self-cell block,
      candidate column ``k`` of row ``k`` is the particle itself). A
      small-r2 threshold cannot do this: the expanded distance form
      loses ~1e-5 absolute to f32 rounding, which leaks the self-pair
      through any tiny threshold with catastrophic r^-12 amplification.
    - In-cell pairs (the self block) are deliberately evaluated from
      both rows like the full stencil -- Newton inside one cap x cap
      block saves no padded lanes, and skipping the back-accumulation
      for block 0 keeps the reduction structure uniform.
    - Ghost slots are pushed ``FAR * (1 + in-cell rank)`` out along x
      instead of carrying a validity plane -- one fused add instead of a
      [rows, C] mask input. The rank scaling makes every ghost<->ghost
      lane distance-masked too (a uniform FAR puts co-resident ghosts at
      d2 = 0, where a pair function steeper than LJ -- or a smaller
      ``min_r2`` -- overflows f32 to inf at the clamp and NaN-poisons
      ghost rows via inf * 0), so ghost forces are finite-zero for any
      pair function.
    - ``r2`` is clamped to ``min_r2`` before the user function so
      overlapping (unphysical) pairs produce huge-but-finite f32 forces
      instead of inf/NaN.

    :param positions: ``[n_slots, 3]`` slot positions.
    :param types: ``[n_slots]`` integer types (used when ``with_types``
        or ``rcut_matrix`` is given).
    :param valid: ``[n_slots]`` 1.0 real / 0.0 ghost.
    :param plan: the :class:`CellwisePlan`.
    :param lo: box lower corner (static).
    :param pair_fn: ``U(r2[, ti, tj]) -> (U, dU/dr2)`` per lane (full
        pair energy and its slope; masked lanes are forced to zero
        afterwards). Deriving the slope with shared subexpressions
        saves work over a jvp of the energy alone.
    :param needs_virial: also return the per-particle virial
        ``[n_slots, 3, 3]`` (else ``None``).
    :param min_r2: overlap clamp (see above).
    :param with_types: pass type planes to ``pair_fn``.
    :param rcut_matrix: per-type-pair ``[ntypes, ntypes]`` cutoffs
        (negative = never neighbors; ``plan.r_cut`` must be its max).
    :param stencil: ``'auto'`` (chosen by :func:`.routes.pair_stencil`
        from the platform and ``pair_fn``), ``'pallas'`` (the
        half-stencil kernel of :mod:`.cellwise_pallas`; compiled on the
        GPU, interpreted on the CPU), ``'half'`` (Newton in pure XLA:
        XLA does not fuse its two reduction axes, see
        ops/cellwise_pallas.py), or ``'full'`` (27 blocks, both pair
        sides evaluated independently). Under a ``mesh`` both 'full'
        (via sharding propagation) and 'pallas' (via a shard_map-wrapped
        kernel) partition over z-slabs.
    :param needs_energy: compute the per-particle energy (force column
        4). The hot loop passes False on all but logged/final steps,
        skipping the energy-only lane math and its dual reduction; the
        column is zero when skipped.
    :returns: ``(forces4 [n_slots, 4], virial or None)`` with
        per-particle energy in force column 4; ghost rows all zero.
    """
    from . import routes
    if stencil not in routes.STENCILS:
        raise ValueError(f"stencil must be one of {routes.STENCILS}, "
                         f"got {stencil!r}")
    if stencil == "auto":
        stencil = routes.pair_stencil(pair_fn, with_types, positions.dtype)
    if stencil == "pallas":
        from .cellwise_pallas import half_stencil_pair_forces
        return half_stencil_pair_forces(
            positions, types, valid, plan, lo, pair_fn,
            needs_virial=needs_virial, min_r2=min_r2,
            with_types=with_types, rcut_matrix=rcut_matrix,
            lengths=lengths, needs_energy=needs_energy,
            interpret=routes.pallas_interpret(),
            mesh=mesh, shard_axis=shard_axis)
    dtype = positions.dtype
    n_cells, cap = plan.n_cells, plan.capacity
    offs_list = _HALF_OFFS if stencil == "half" else _OFFS
    n_offs = len(offs_list)
    C = n_offs * cap
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
    if stencil == "half":
        # the self cell is block 0
        not_self = jnp.logical_not((col < cap) & (col == row))[None]
    else:
        not_self = (col != 13 * cap + row)[None, :, :]
    ok = (d2 <= rc2) & not_self

    need_types = with_types or rcut_matrix is not None
    if need_types:
        tt = types.astype(dtype)
        gt = _roll_offs(tt, plan, offs_list)
        ti = tt.reshape(n_cells, cap)[:, :, None]
        tj = gt[:, None, :]
    if rcut_matrix is not None:
        from .nlist import pair_rc2
        ok = ok & (d2 <= pair_rc2(ti, tj, rcut_matrix, dtype))
    r2_eval = jnp.maximum(d2, jnp.asarray(min_r2, dtype=dtype))

    if with_types:
        U, dU = pair_fn(r2_eval, ti, tj)
    else:
        U, dU = pair_fn(r2_eval)
    zero = jnp.zeros((), dtype=dtype)
    s = jnp.where(ok, dU, zero)
    sdx, sdy, sdz = s * dx, s * dy, s * dz

    def dual_reduce(prod, fwd_coeff, back_coeff):
        """Row-side lane reduction, plus (half stencil) the candidate-side
        row-axis reduction of the SAME product array rolled back onto each
        directed block's home cell."""
        out = fwd_coeff * jnp.sum(prod, axis=2)
        if stencil == "half":
            back = back_coeff * jnp.sum(prod, axis=1)  # [n_cells, C]
            for t in range(1, n_offs):
                out = out + _roll_back(back[:, t * cap:(t + 1) * cap],
                                       plan, offs_list[t])
        return out.reshape(-1)

    # e_i = sum_j U/2 (in-cell pairs counted from both rows; directed
    # pairs counted once, half to each side);
    # F_i = -2 * sum_j U'(d2) * (x_i - x_j) = 2 * sum_j U' * d, and the
    # candidate side of a directed pair gets the exact negation
    if needs_energy:
        g = jnp.where(ok, U, zero)      # full pair energy per lane
        e = dual_reduce(g, 0.5, 0.5)
    else:
        e = jnp.zeros((plan.n_slots,), dtype=dtype)
    fx = dual_reduce(sdx, 2.0, -2.0)
    fy = dual_reduce(sdy, 2.0, -2.0)
    fz = dual_reduce(sdz, 2.0, -2.0)
    forces4 = jnp.stack([fx, fy, fz, e], axis=-1) * valid[:, None]

    virial = None
    if needs_virial:
        # W_i = -sum_j U'(d2) * d (x) d -- identical to
        # ops/forces._compute_virial with f_ij = 2 s d (HOOMD sign:
        # positive diagonal for repulsion). d (x) d is direction-even,
        # so both sides of a directed pair accumulate the same term.
        def acc(da, db):
            return dual_reduce(s * da * db, -1.0, -1.0)
        wxx, wyy, wzz = acc(dx, dx), acc(dy, dy), acc(dz, dz)
        wxy, wxz, wyz = acc(dx, dy), acc(dx, dz), acc(dy, dz)
        W = jnp.stack([
            jnp.stack([wxx, wxy, wxz], -1),
            jnp.stack([wxy, wyy, wyz], -1),
            jnp.stack([wxz, wyz, wzz], -1)], -2)
        virial = W * valid[:, None, None]
    return forces4, virial


def repack_order(positions, valid, lo, plan, lengths=None):
    """Compute the slot permutation for a rebuild. ``lo``/``lengths``
    may be traced (dynamic-box mode).

    :returns: ``(order, new_slot, kept, overflow)`` where row ``i`` of the
        repacked layout comes from ``old[order[i]]``... more precisely:
        ``new[new_slot[j]] = old[order[j]]`` for each sorted row ``j`` with
        ``kept[j]`` true; rows not written keep their ghost defaults.
        ``overflow`` is True when a cell exceeded capacity (its surplus
        particles would be dropped -- the engine surfaces this as an
        error, like ``check_nlist``).
    """
    n_slots, cap = plan.n_slots, plan.capacity
    n_cells = plan.n_cells
    rows = positions.shape[0]  # n_slots for a rebuild, n for initial pack
    cell = bin_cells(positions, lo, plan, lengths=lengths)
    key = jnp.where(valid > 0, cell, n_cells)  # ghosts sort to the end
    # one sort pass yields both the sorted keys and the permutation
    sk, order = jax.lax.sort(
        (key, jnp.arange(rows, dtype=jnp.int32)), num_keys=1)
    # rank within cell, from the sorted keys alone: position minus the
    # index where this key's run starts (a segmented max-scan -- cheaper
    # than a searchsorted over the cell table)
    idx = jnp.arange(rows, dtype=jnp.int32)
    seg_start = jnp.concatenate(
        [jnp.ones((1,), bool), sk[1:] != sk[:-1]])
    rank = idx - jax.lax.associative_scan(
        jnp.maximum, jnp.where(seg_start, idx, 0))
    real = sk < n_cells
    overflow = jnp.any(real & (rank >= cap))
    kept = real & (rank < cap)
    new_slot = jnp.where(kept, sk * cap + jnp.minimum(rank, cap - 1),
                         n_slots)  # out-of-range -> dropped by the scatter
    # max cell occupancy of THIS snapshot, free from the ranks already in
    # hand: the running max over a run calibrates replan() capacity (the
    # statistical fluctuation formula in plan_cellwise is deliberately
    # conservative; the measured running max is the ground truth)
    occ = jnp.max(jnp.where(real, rank, -1)) + 1
    return order, new_slot, kept, overflow, occ


def repack_src(positions, valid, lo, plan, lengths=None, with_occ=False):
    """Single-permutation form of :func:`repack_order`: the per-SLOT
    source-row map.

    ``src[i] = j`` means new slot row ``i`` takes old row ``j``;
    ``src[i] == rows`` marks a ghost slot. Applying the repack is then
    ONE clipped gather + select per array (``where(has, vals[src],
    default)``) instead of a gather by ``order`` followed by a scatter
    by ``new_slot``.

    :returns: ``(src [n_slots] int32, overflow)``, plus the snapshot max
        cell occupancy (int32 scalar) when ``with_occ``.
    """
    order, new_slot, kept, overflow, occ = repack_order(
        positions, valid, lo, plan, lengths=lengths)
    rows = positions.shape[0]
    src = jnp.full((plan.n_slots,), rows, jnp.int32).at[new_slot].set(
        order.astype(jnp.int32), mode="drop")
    if with_occ:
        return src, overflow, occ
    return src, overflow
