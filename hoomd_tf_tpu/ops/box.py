"""Simulation-box math: sizes, periodic wrapping, tilt handling.

The box convention follows the reference (hoomd-tf ``simmodel.py:597-615``):
a ``[3, 3]`` array whose rows are ``low``, ``high`` and ``tilt`` factors
``(xy, xz, yz)``.  This rebuild keeps the same convention so user
``compute`` functions written against the reference transfer directly, but
there is no sparse-tensor workaround (that existed only to dodge a TF 2.4
Keras shape bug).
"""

import jax.numpy as jnp

__all__ = ["box_size", "wrap_vector", "make_box", "box_from_lengths",
           "box_matrix"]


def make_box(low, high, tilt=None, dtype=jnp.float32):
    """Assemble a ``[3,3]`` box array from low/high corners and tilt factors."""
    low = jnp.asarray(low, dtype=dtype)
    high = jnp.asarray(high, dtype=dtype)
    if tilt is None:
        tilt = jnp.zeros(3, dtype=dtype)
    else:
        tilt = jnp.asarray(tilt, dtype=dtype)
    return jnp.stack([low, high, tilt])


def box_from_lengths(lengths, dtype=jnp.float32):
    """Centered orthorhombic box (hoomd style: ``-L/2 .. L/2``) from ``[Lx,Ly,Lz]``."""
    lengths = jnp.asarray(lengths, dtype=dtype)
    if lengths.ndim == 0:
        lengths = jnp.broadcast_to(lengths, (3,))
    return make_box(-lengths / 2, lengths / 2, dtype=dtype)


def box_size(box):
    """Edge lengths ``high - low`` of the box.

    Mirrors reference ``simmodel.py:597-603`` (minus the TF 2.4 sparse hack).

    :param box: ``[3,3]`` box array (rows: low, high, tilt).
    :return: shape ``[3]`` array of edge lengths.
    """
    box = jnp.asarray(box)
    return box[1, :] - box[0, :]


def box_matrix(box):
    """Upper-triangular box (cell) matrix ``h`` whose COLUMNS are the
    lattice vectors, HOOMD convention (dimensionless tilt factors):

    .. code-block:: text

        h = [[Lx, xy*Ly, xz*Lz],
             [0,  Ly,    yz*Lz],
             [0,  0,     Lz   ]]

    :param box: ``[3,3]`` box array (rows: low, high, tilt ``(xy,xz,yz)``).
    :return: ``[3,3]`` cell matrix.
    """
    box = jnp.asarray(box)
    L = box[1] - box[0]
    xy, xz, yz = box[2, 0], box[2, 1], box[2, 2]
    z = jnp.zeros((), dtype=box.dtype)
    return jnp.stack([
        jnp.stack([L[0], xy * L[1], xz * L[2]]),
        jnp.stack([z, L[1], yz * L[2]]),
        jnp.stack([z, z, L[2]])])


def wrap_vector(r, box):
    """Minimum-image wrap of displacement vector(s) ``r``.

    Mirrors reference ``simmodel.py:606-615``, extended beyond it:
    the reference asserts against skew in ``compute_inputs`` while this
    version handles triclinic (tilted) boxes with HOOMD's sequential
    minimum-image convention (wrap z, then y, then x, each removing the
    corresponding lattice-vector image -- exact for tilt factors up to
    0.5, hoomd's supported range). For an unskewed box the tilt terms
    are zero and this reduces to the classic ``r - round(r/L) * L``.

    :param r: displacement vector(s), trailing axis 3.
    :param box: ``[3,3]`` box array (rows: low, high, tilt).
    :return: wrapped vector(s), same shape as ``r``.
    """
    box = jnp.asarray(box)
    bs = box_size(box).astype(jnp.asarray(r).dtype)
    xy, xz, yz = (box[2, i].astype(bs.dtype) for i in range(3))
    rx, ry, rz = r[..., 0], r[..., 1], r[..., 2]
    iz = jnp.round(rz / bs[2])
    rx = rx - iz * xz * bs[2]
    ry = ry - iz * yz * bs[2]
    rz = rz - iz * bs[2]
    iy = jnp.round(ry / bs[1])
    rx = rx - iy * xy * bs[1]
    ry = ry - iy * bs[1]
    rx = rx - jnp.round(rx / bs[0]) * bs[0]
    return jnp.stack([rx, ry, rz], axis=-1)
