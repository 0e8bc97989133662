"""Trajectory-driven workflows (no simulation engine needed).

Functional parity with the reference (``utils.py:164-233, 627-749``):
iterate an MDAnalysis trajectory into model inputs, scan a 2-particle
separation, build gsd snapshots. MDAnalysis/gsd are optional dependencies,
gated at call time; any object implementing the small universe protocol
(``select_atoms``, ``trajectory``, ``dimensions``, atom ``positions`` /
``types``) works, which the tests use to avoid the dependency.
"""

import jax.numpy as jnp
import numpy as np

from ..ops.nlist import compute_nlist

__all__ = ["iter_from_trajectory", "compute_pairwise", "create_frame",
           "TrajectoryFrame"]


class TrajectoryFrame:
    """Selection-consistent view of one trajectory frame.

    The reference rebuilds a sub-universe under a selection so the yielded
    timestep carries that selection's velocities and forces
    (``utils.py:666-686``) -- offline force matching reads ``ts.forces``
    as training labels. This wrapper gives the same contract:
    ``positions`` / ``velocities`` / ``forces`` are the (selection) atom
    group's arrays *snapshotted at yield time* (MDAnalysis mutates one
    live Timestep per frame -- the snapshot removes that footgun, so
    frames collected with ``list(...)`` stay frame-consistent);
    everything else (``frame``, ``time``, ``dt``, ...) delegates to the
    underlying timestep object. ``velocities``/``forces`` raise
    ``AttributeError`` when the trajectory does not carry them, like
    MDAnalysis.
    """

    def __init__(self, ts, atom_group):
        self._ts = ts
        self.positions = np.array(atom_group.positions, dtype=np.float32)
        self._velocities = self._snap(atom_group, "velocities")
        self._forces = self._snap(atom_group, "forces")

    @staticmethod
    def _snap(group, name):
        # MDAnalysis raises NoDataError (subclasses both AttributeError
        # and ValueError) when the trajectory lacks the attribute
        try:
            return np.array(getattr(group, name), dtype=np.float32)
        except (AttributeError, ValueError):
            return None

    @property
    def velocities(self):
        if self._velocities is None:
            raise AttributeError("this trajectory has no velocities")
        return self._velocities

    @property
    def forces(self):
        if self._forces is None:
            raise AttributeError("this trajectory has no forces")
        return self._forces

    def __getattr__(self, name):
        return getattr(object.__getattribute__(self, "_ts"), name)

    def __repr__(self):
        return f"TrajectoryFrame({self._ts!r})"


def iter_from_trajectory(nneighbor_cutoff, universe, selection="all",
                         r_cut=10.0, period=1, start=0, end=None,
                         progress=False):
    """Yield ``([nlist, positions, box], frame)`` per trajectory frame.

    The inputs list can be passed directly to a :class:`.SimModel`
    (``model(inputs)``). Box angles are converted to hoomd tilt factors as
    in the reference (``utils.py:689-702``). The yielded ``frame`` is a
    :class:`TrajectoryFrame`: ``frame.forces`` / ``frame.velocities`` give
    the selection's per-frame labels when the trajectory carries them
    (reference parity: the sub-universe of ``utils.py:666-686``), so
    offline force matching can train on ``frame.forces`` directly.

    One deliberate fix vs. the reference: the neighbor list is recomputed
    **every frame** (the reference computed it once from frame 0 and reused
    it for all frames, ``utils.py:717-749`` -- a known quirk; under jit the
    rebuild is cheap).

    :param nneighbor_cutoff: maximum neighbors NN.
    :param universe: MDAnalysis universe (or duck-typed equivalent).
    :param selection: atom selection string.
    :param r_cut: neighbor cutoff radius.
    :param period: yield every ``period``-th frame.
    :param start: first frame to include.
    :param end: last frame to include (inclusive; default: all).
    :param progress: show a tqdm progress bar if available.
    """
    atom_group = universe.select_atoms(selection)

    box = np.asarray(universe.dimensions, dtype=np.float64)
    # lattice angles -> hoomd tilt factors (reference parity incl. its
    # b = c = 1 normalization, utils.py:690-700)
    b = 1.0
    c = 1.0
    alpha, beta, gamma = np.deg2rad(box[3]), np.deg2rad(box[4]), \
        np.deg2rad(box[5])
    xy = 1.0 / np.tan(gamma)
    xz = c * np.cos(beta)
    yz = b * c * np.cos(alpha) - xy * xz
    hoomd_box = np.array([[0, 0, 0], [box[0], box[1], box[2]],
                          [xy, xz, yz]], dtype=np.float32)

    try:
        types = list(np.unique(atom_group.atoms.types))
        type_array = np.array(
            [types.index(t) for t in atom_group.atoms.types],
            dtype=np.float32).reshape(-1, 1)
    except Exception:
        type_array = np.zeros((len(atom_group), 1), dtype=np.float32)

    frames = universe.trajectory
    if progress:
        try:
            from tqdm import tqdm
            frames = tqdm(frames)
        except ImportError:
            pass
    if end is None:
        end = float("inf")

    for i, ts in enumerate(frames):
        frame = getattr(ts, "frame", i)
        if frame < start or frame > end:
            continue
        if i % period != 0:
            continue
        positions = np.concatenate(
            [np.asarray(atom_group.positions, dtype=np.float32),
             type_array], axis=1)
        # skewed frames get the triclinic minimum image (the reference
        # converts the angles but then asserts against the skew it just
        # computed, simmodel.py:195 -- here tilt is supported end to end)
        nlist = compute_nlist(positions[:, :3], r_cut=r_cut,
                              NN=nneighbor_cutoff,
                              box_size=(hoomd_box if np.any(
                                  np.abs(hoomd_box[2]) > 1e-6)
                                  else box[:3]))
        yield ([nlist, jnp.asarray(positions), jnp.asarray(hoomd_box)],
               TrajectoryFrame(ts, atom_group))


def compute_pairwise(model, r, type_i=0, type_j=0):
    """Model output for a 2-particle system scanned over separations ``r``
    (reference parity: ``utils.py:164-201``).

    :param model: a :class:`.SimModel`.
    :param r: 1D array of separations.
    :param type_i: type of the first particle.
    :param type_j: type of the second particle.
    :return: tuple of stacked numpy outputs, leading axis ``len(r)``.
    """
    import jax

    from ..models.module import get_state, set_state

    NN = model.nneighbor_cutoff
    box = jnp.asarray([[0.0, 0, 0], [1e10, 1e10, 1e10], [0, 0, 0]],
                      dtype=model.dtype)
    base_nlist = np.zeros((2, NN, 4), dtype=np.float32)
    base_nlist[0, :, 3] = type_j
    base_nlist[1, :, 3] = type_i
    positions = np.zeros((2, 4), dtype=np.float32)
    positions[0, 3] = type_i
    positions[1, 3] = type_j
    positions = jnp.asarray(positions)

    # all separations in ONE device program (vmap over r) -- a host loop
    # of eager dispatches is dispatch-latency bound
    r = np.asarray(r, dtype=np.float32)
    nlists = np.broadcast_to(base_nlist, (len(r),) + base_nlist.shape) \
        .copy()
    nlists[:, 0, 0, 1] = r
    nlists[:, 1, 0, 1] = -r
    model.ensure_built([jnp.asarray(base_nlist), positions, box],
                       training=False)
    snap = get_state(model)
    try:
        outs = jax.jit(jax.vmap(
            lambda nl: tuple(model([nl, positions, box]))))(
                jnp.asarray(nlists))
    finally:
        # any variable updates made under the vmap trace are discarded
        set_state(model, snap)
    return [np.asarray(o) for o in outs]


def create_frame(frame_number, N, types, typeids, positions, box):
    """Build a gsd snapshot (reference parity: ``utils.py:204-233``).

    Uses the ``gsd`` package when available; otherwise returns a
    schema-compatible lightweight snapshot that the native GSD writer
    (:func:`.gsd_io.write_gsd_frames` / :class:`.gsd_io.GSDFile`)
    understands, so the workflow needs no optional dependencies.
    """
    try:
        import gsd.hoomd
        s = gsd.hoomd.Snapshot()
    except ImportError:
        from types import SimpleNamespace
        s = SimpleNamespace(configuration=SimpleNamespace(),
                            particles=SimpleNamespace())
    s.configuration.step = frame_number
    s.configuration.box = box
    s.particles.N = N
    s.particles.types = types
    s.particles.typeid = typeids
    s.particles.position = positions
    return s
