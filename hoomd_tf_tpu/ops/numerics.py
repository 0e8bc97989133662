"""NaN-safe numerics used throughout pair-potential models.

These reproduce the reference's carefully-tuned semantics
(``simmodel.py:581-693``): padded (all-zero) neighbor rows must contribute
exactly zero energy, zero force *and* zero gradient. In JAX that requires
double-``where`` guards because ``grad`` of ``where`` still propagates NaN
from the untaken branch.
"""

import jax.numpy as jnp

__all__ = ["safe_norm", "nlist_rinv", "masked_nlist", "divide_no_nan",
           "multiply_no_nan"]


def divide_no_nan(x, y):
    """``x / y`` but exactly 0 (with zero gradient) where ``y == 0``.

    JAX-native equivalent of ``tf.math.divide_no_nan``.
    """
    x = jnp.asarray(x)
    y = jnp.asarray(y)
    zero = y == 0
    safe_y = jnp.where(zero, jnp.ones_like(y), y)
    return jnp.where(zero, jnp.zeros(jnp.broadcast_shapes(x.shape, y.shape),
                                     dtype=jnp.result_type(x, y)), x / safe_y)


def multiply_no_nan(x, y):
    """``x * y`` but exactly 0 where ``y == 0`` even if ``x`` is NaN/inf.

    JAX-native equivalent of ``tf.math.multiply_no_nan``.
    """
    x = jnp.asarray(x)
    y = jnp.asarray(y)
    zero = y == 0
    safe_x = jnp.where(zero, jnp.zeros_like(x), x)
    return jnp.where(zero, jnp.zeros(jnp.broadcast_shapes(x.shape, y.shape),
                                     dtype=jnp.result_type(x, y)), safe_x * y)


def safe_norm(tensor, delta=1e-7, axis=None, **kwargs):
    """Norm with a small delta shift for gradient stability.

    Mirrors reference ``simmodel.py:581-594``: the delta is added to the
    *components* before the norm so near-zero vectors do not produce NaN
    gradients. Do **not** combine with :func:`divide_no_nan` (see the
    upstream TF issue referenced there) -- use :func:`nlist_rinv` instead.

    :param tensor: input array.
    :param delta: small value added to the components.
    :param axis: axis over which to take the norm.
    :return: the norm.
    """
    return jnp.linalg.norm(tensor + delta, axis=axis, **kwargs)


def nlist_rinv(nlist):
    """``1/r`` for each neighbor, exactly zero for padded rows, differentiable.

    Mirrors reference ``simmodel.py:618-635`` (the "dark magic" deltas are
    kept verbatim: they are tuned so that differentiating through ``1/r``
    w.r.t. model parameters never produces NaN).

    Accepts either the packed ``[N, NN, 4]`` neighbor list or the
    wide-direct :class:`..ops.direct.NlistPlanes` form.

    :return: ``[N, NN]`` (or ``[N, C]``) array of ``1/r``.
    """
    delta = 3e-6
    d = delta / 3 / 10
    from .direct import NlistPlanes
    if isinstance(nlist, NlistPlanes):
        # planes are this framework's own form (no reference semantics to
        # preserve), so use the cheaper fused rsqrt instead of sqrt+divide
        # -- this sits on the innermost [rows, 27*cap] hot loop of the
        # cellwise mode. Zero rows still yield exactly zero with zero
        # gradient (double-where).
        import jax
        r2 = ((nlist.dx + d) ** 2 + (nlist.dy + d) ** 2 +
              (nlist.dz + d) ** 2)
        good = r2 > delta * delta
        safe_r2 = jnp.where(good, r2, jnp.ones_like(r2))
        return jnp.where(good, jax.lax.rsqrt(safe_r2), jnp.zeros_like(r2))
    r = safe_norm(nlist[..., :3], axis=-1, delta=d)
    # double-where so the gradient of the untaken branch is cut
    safe_r = jnp.where(r > delta, r, jnp.ones_like(r))
    return jnp.where(r > delta, 1.0 / (safe_r + delta), jnp.zeros_like(r))


def masked_nlist(nlist, type_tensor, type_i=None, type_j=None):
    """Neighbor list masked by particle type(s).

    Mirrors reference ``simmodel.py:672-693`` with one deviation:
    ``type_i`` filtering *zeroes out* non-matching particle rows instead of
    removing them (``tf.boolean_mask`` produces a dynamic shape, which is
    incompatible with XLA's static-shape compilation; a zero row contributes
    nothing downstream, e.g. to :func:`compute_rdf`).

    Accepts the packed ``[N, NN, 4]`` form or wide-direct
    :class:`..ops.direct.NlistPlanes`.

    :param nlist: ``[N, NN, 4]`` neighbor list (or planes).
    :param type_tensor: ``[N]`` particle types (e.g. ``positions[:, 3]``).
    :param type_i: center-particle type filter.
    :param type_j: neighbor type filter.
    :return: masked neighbor list, same form as the input.
    """
    from .direct import NlistPlanes
    if isinstance(nlist, NlistPlanes):
        mask = jnp.ones_like(nlist.dx)
        if type_i is not None:
            mask = mask * (type_tensor == type_i).astype(
                nlist.dx.dtype)[:, None]
        if type_j is not None:
            mask = mask * (nlist.type == type_j).astype(nlist.dx.dtype)
        return NlistPlanes(nlist.dx * mask, nlist.dy * mask,
                           nlist.dz * mask, nlist.type * mask)
    nlist = jnp.asarray(nlist)
    if type_i is not None:
        mask = (type_tensor == type_i).astype(nlist.dtype)
        nlist = nlist * mask[:, None, None]
    if type_j is not None:
        mask = (nlist[:, :, 3] == type_j).astype(nlist.dtype)
        nlist = nlist * mask[:, :, None]
    return nlist
