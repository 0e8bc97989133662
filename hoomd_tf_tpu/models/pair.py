"""PairModel: the pair-potential model specialization.

A large share of machine-learned and classical potentials are pair
potentials: the energy is a sum of per-pair terms ``U(r^2, type_i,
type_j)``. Declaring that structure (instead of writing a generic
``compute``) lets the engine evaluate the model on an analytic
forward-only path in the slot-resident (cellwise) neighbor mode: the
per-pair force coefficient ``dU/d(r^2)`` comes from one ``jax.jvp`` in
the same pass, so there is no vjp replay and no candidate-plane
rematerialization (see ops/cellwise.analytic_pair_forces).

Everywhere else -- packed neighbor lists, the wide-direct planes mode,
training, CPU -- :class:`PairModel` behaves exactly like a
:class:`.simmodel.SimModel` through the default :meth:`compute` built on
the same ``pair_energy``, so one definition runs on every path with
identical physics.

The reference has no analog (its models are opaque TF graphs); the
closest counterpart is the pair-potential pattern of its examples
(``build_examples.py`` LJModel et al.), which this class packages.
"""

import jax.numpy as jnp

from .simmodel import SimModel, _sniff_compute
from ..ops.forces import compute_nlist_forces

__all__ = ["PairModel"]


class PairModel(SimModel):
    """A :class:`.SimModel` defined by a per-pair energy.

    Subclasses implement::

        def pair_energy(self, r2):                      # single-type
        def pair_energy(self, r2, type_i, type_j):      # typed

    returning the **full** pair energy per lane from the squared
    separation ``r2`` (same shape as the neighbor lanes; masked lanes
    are zeroed by the framework, and ``r2`` is pre-clamped to
    ``min_r2`` so overlapping pairs stay finite in float32). Use even
    powers of ``1/r2`` where possible; take ``jnp.sqrt(r2)`` only if the
    potential genuinely needs ``r``.

    :param nneighbor_cutoff: max neighbors NN (as in SimModel).
    :param min_r2: squared-distance clamp applied before
        ``pair_energy`` (overlap guard; default ``1e-4``).
    :param proxy_degree: opt-in Chebyshev proxy: evaluate the pair
        function through a ``proxy_degree``-term interpolant in
        ``1/r^2`` space (see :mod:`..ops.chebyshev`). The model is
        evaluated only at the K nodes per step; the per-lane cost
        becomes a Clenshaw recurrence -- pure fused multiply-adds,
        which the half-stencil kernel can replay even for NN pair
        energies (ops/cellwise_pallas.pair_fn_lowers). Untyped
        pair functions need only this; a typed
        ``pair_energy(r2, ti, tj)`` additionally needs
        ``proxy_types=<number of particle types>`` and gets one
        coefficient table per unordered type pair, blended per lane by
        type masks (~2.2x the untyped proxy cost at 2 types; each extra
        type pair adds ``2 * proxy_degree`` mask-FMAs per lane -- see
        :func:`..ops.chebyshev.make_typed_pair_proxy`). Accuracy: exact
        for inverse-power polynomials up to the degree (LJ needs 7);
        ~1e-4 relative for smooth MLPs at 16. The proxy force is exactly
        the negative gradient of the proxy energy (the slope series is
        the analytic derivative of the energy series).
    :param proxy_r_lo: inner edge (a distance) of the proxy fit range;
        below it the potential continues C^1-linearly in ``1/r^2``
        (finite, stiffening overlap barrier). Default ``0.25 * r_cut``
        at attach time.
    """

    def __init__(self, nneighbor_cutoff, min_r2=1e-4, proxy_degree=None,
                 proxy_r_lo=None, proxy_types=None, **kwargs):
        self.min_r2 = float(min_r2)
        n_args, _ = _sniff_compute(self.pair_energy, 3, "PairModel")
        if n_args not in (1, 3):
            raise ValueError(
                "pair_energy must take (r2) or (r2, type_i, type_j), "
                f"got {n_args} tensor arguments")
        self.pair_with_types = n_args == 3
        self.proxy_degree = int(proxy_degree) if proxy_degree else None
        self.proxy_r_lo = float(proxy_r_lo) if proxy_r_lo else None
        self.proxy_types = int(proxy_types) if proxy_types else None
        if self.proxy_degree and self.pair_with_types and \
                not self.proxy_types:
            raise ValueError(
                "a typed pair_energy(r2, ti, tj) with proxy_degree "
                "needs proxy_types=<number of particle types> (one "
                "coefficient set per unordered type pair); untyped "
                "pair_energy(r2) needs neither")
        super().__init__(nneighbor_cutoff, **kwargs)

    def proxy_parts(self, r_cut):
        """``(fit, eval)`` of the Chebyshev proxy for this model at
        ``r_cut`` (see ``proxy_degree``); typed models get the
        per-type-pair table variant."""
        from ..ops.chebyshev import make_pair_proxy, make_typed_pair_proxy
        r_lo = self.proxy_r_lo if self.proxy_r_lo is not None \
            else 0.25 * float(r_cut)
        r2_lo = max(r_lo * r_lo, self.min_r2)
        if self.pair_with_types:
            return make_typed_pair_proxy(self.proxy_degree, r2_lo,
                                         float(r_cut) ** 2,
                                         self.proxy_types,
                                         dtype=self.dtype)
        return make_pair_proxy(self.proxy_degree, r2_lo,
                               float(r_cut) ** 2, dtype=self.dtype)

    def proxy_pair_fn(self, r_cut):
        """The Chebyshev-proxy pair function for this model at
        ``r_cut`` (``r2[, ti, tj] -> (U, dU/dr2)``). Build it inside
        the traced step (and inside the functional rebind when
        training) so coefficient gradients flow to the parameters."""
        fit, evaluate = self.proxy_parts(r_cut)
        coeffs = fit(self.pair_energy_and_slope)
        if self.pair_with_types:
            return lambda r2, ti, tj: evaluate(coeffs, r2, ti, tj)
        return lambda r2: evaluate(coeffs, r2)

    # ------------------------------------------------------------------
    def pair_energy(self, r2, type_i=None, type_j=None):
        raise NotImplementedError(
            "PairModel subclasses implement pair_energy")

    def pair_energy_and_slope(self, r2, type_i=None, type_j=None):
        """``(U, dU/dr2)`` per lane for the analytic fast path.

        The default differentiates :meth:`pair_energy` with one
        forward-mode ``jax.jvp``. Override to share subexpressions
        between the energy and its slope (e.g. reuse ``sr6`` in LJ) --
        measured ~15% faster at 64k particles.
        """
        import jax
        if self.pair_with_types:
            fn = lambda x: self.pair_energy(x, type_i, type_j)
        else:
            fn = self.pair_energy
        return jax.jvp(fn, (r2,), (jnp.ones_like(r2),))

    def get_config(self):
        config = super().get_config()
        config["min_r2"] = self.min_r2
        if self.proxy_degree:
            config["proxy_degree"] = self.proxy_degree
            config["proxy_r_lo"] = self.proxy_r_lo
            if self.proxy_types:
                config["proxy_types"] = self.proxy_types
        return config

    # ------------------------------------------------------------------
    def compute(self, nlist, positions, box):
        """Generic route: same physics as the fast path, derived through
        the standard capture vjp (works for packed nlists and planes)."""
        from ..ops.direct import NlistPlanes
        if isinstance(nlist, NlistPlanes):
            r2 = nlist.r2()
            tj = nlist.type
        else:
            n3 = nlist[..., :3]
            r2 = jnp.sum(n3 * n3, axis=-1)
            tj = nlist[..., 3] if nlist.shape[-1] > 3 else None
        pad = r2 > 0
        r2s = jnp.where(pad, jnp.maximum(r2, self.min_r2),
                        jnp.ones_like(r2))
        if self.pair_with_types:
            ti = positions[:, 3][:, None]
            U = self.pair_energy(r2s, ti, tj)
        else:
            U = self.pair_energy(r2s)
        energy = 0.5 * jnp.sum(jnp.where(pad, U, jnp.zeros_like(U)),
                               axis=1)
        return compute_nlist_forces(nlist, energy, virial=self.virial)
