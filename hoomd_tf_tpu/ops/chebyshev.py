"""Chebyshev pair-potential proxy: evaluate expensive pair functions
(per-lane NN potentials) through a low-degree interpolant.

The cellwise analytic route evaluates the pair function on EVERY padded
candidate lane ([n_cells, cap, 14*cap] at 64k). For a closed-form LJ
that is ~10 flops/lane; for an ML pair potential it is an MLP whose
per-lane activations dwarf the physics (and whose hidden axis per lane
keeps it out of the half-stencil kernel, ops/cellwise_pallas).

A pair potential is one smooth scalar function ``U(r2)`` on
``[r2_lo, r_cut^2]``. So: evaluate the model at ``K`` Chebyshev nodes
(K ~ 16 -- lane-count-independent), fit Chebyshev coefficients with one
``[K, K]`` constant matmul, and evaluate per lane with a Clenshaw
recurrence -- pure fused multiply-adds that the half-stencil kernel
can replay, no per-lane activations. Training composes for free: the
lane-contraction VJP (ops/pair_train.py) differentiates the contraction
w.r.t. the coefficients (the Clenshaw backward is one fused lane pass),
and the chain through the node fit and the model-at-nodes is K-sized.

Interpolation runs in ``u = 1/r2`` (inverse-square) space, where
LJ-family cores are LOW-DEGREE POLYNOMIALS (LJ itself is degree 6 in u:
exactly represented at K >= 7). Below ``r2_lo`` (inside the fit range)
the potential continues C^1-linearly in ``u`` -- a stiffening
``~u``-barrier that keeps overlap forces finite and repulsive without
polluting the fit with the diverging core.

Accuracy: for smooth potentials (LJ exactly; tanh-MLPs to ~1e-6
relative at K=16) the proxy is numerically indistinguishable from the
exact function over the fit range; it IS a (slightly) different
function, so the feature is opt-in (``PairModel(proxy_degree=...)``)
and the trained object is the proxy-composed model, self-consistently
(the gradient is the exact gradient of the evaluated function).

Beyond reference scope (the reference evaluates TF models verbatim);
the MD-community analog is tabulated potentials (hoomd.md.pair.table).
"""

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["pair_proxy", "make_pair_proxy", "make_typed_pair_proxy",
           "clenshaw"]


def _dct_matrix(K):
    """Chebyshev-fit matrix for Gauss-Chebyshev nodes:
    ``c = D @ f(nodes)`` gives interpolation coefficients of degree K-1."""
    k = np.arange(K)
    theta = np.pi * (k + 0.5) / K
    D = np.cos(np.outer(k, theta)) * (2.0 / K)
    D[0] *= 0.5
    return D, np.cos(theta)  # fit matrix, nodes x_k in [-1, 1]


def _diff_matrix(K):
    """Chebyshev differentiation matrix: series coefficients ``c`` of
    ``f(w)`` -> coefficients ``Dd @ c`` of ``df/dw`` (standard backward
    recurrence ``d_{k-1} = d_{k+1} + 2 k c_k``, ``d_0`` halved)."""
    Dd = np.zeros((K, K))
    for k in range(K - 1, 0, -1):
        prev = Dd[k + 1] if k + 1 < K else np.zeros(K)
        row = prev.copy()
        row[k] += 2.0 * k
        Dd[k - 1] = row
    Dd[0] *= 0.5
    return Dd


def clenshaw(coeffs, w):
    """Evaluate a Chebyshev series at ``w`` (in [-1, 1], any array
    shape). ``coeffs`` is a python list of scalars/tracers so a Pallas
    closure hoist sees K scalar operands, not an indexed array."""
    b1 = jnp.zeros_like(w)
    b2 = jnp.zeros_like(w)
    two_w = 2.0 * w
    for c in coeffs[:0:-1]:
        b1, b2 = c + two_w * b1 - b2, b1
    return coeffs[0] + w * b1 - b2


def make_pair_proxy(degree, r2_lo, r2_hi, dtype=None):
    """``(fit, eval)`` pair for the Chebyshev pair proxy over
    ``u = 1/r2`` on ``[r2_lo, r2_hi]``.

    ``fit(pair_energy_and_slope) -> coeffs`` evaluates the underlying
    pair function at the K nodes and returns the coefficient pytree
    (two lists of K scalars, so a Pallas closure hoist sees scalar
    operands). ``eval(coeffs, r2) -> (U, dU/dr2)`` is the lane-shaped
    evaluation -- pure fused multiply-adds.

    The returned force is **exactly** ``-d/dr2`` of the returned energy:
    the slope series is the analytic Chebyshev derivative of the fitted
    energy series (``_diff_matrix`` recurrence), not an independent fit
    of the model's slope. Two independent fits would disagree at the
    fit-residual level, a small systematic NVE energy-drift source; the
    derived series makes the proxy a conservative force field by
    construction. (For polynomials in ``u`` up to the degree -- LJ at
    K >= 7 -- both routes are exact anyway.)

    The split matters for training: the engine computes ``coeffs``
    OUTSIDE the kernel-traced pair function (so the Pallas kernel sees
    only Clenshaw arithmetic) and passes them as the differentiable
    ``params`` of :func:`.pair_train.pair_train_forces`; the chain from
    model parameters through ``fit`` is K-sized and differentiated by
    plain XLA autodiff.

    :param degree: number of Chebyshev terms K.
    :param r2_lo: inner edge of the fit range; below it the potential
        continues C^1-linearly in ``u`` (finite, stiffening barrier).
    :param r2_hi: outer edge (``r_cut**2``; larger ``r2`` evaluates at
        the edge -- those lanes are masked by the caller anyway).
    :param dtype: node/coefficient dtype (default float32). Pass the
        state dtype in double-precision runs so the fit does not cap
        coefficient precision at ~1e-7 relative (PairModel threads its
        own ``dtype`` through automatically).
    """
    K = int(degree)
    fit_dtype = jnp.float32 if dtype is None else jnp.dtype(dtype)
    u_lo, u_hi = 1.0 / float(r2_hi), 1.0 / float(r2_lo)
    mid, half = 0.5 * (u_hi + u_lo), 0.5 * (u_hi - u_lo)
    D, x = _dct_matrix(K)
    u_nodes = mid + half * x
    r2_nodes_np = 1.0 / u_nodes
    inv_half = 1.0 / half
    # slope series = d(energy series)/du: Chebyshev-differentiate the
    # energy coefficients (dw/du = 1/half)
    Dd = _diff_matrix(K) * inv_half

    def fit(pair_energy_and_slope):
        r2_nodes = jnp.asarray(r2_nodes_np, dtype=fit_dtype)
        U_k, _ = pair_energy_and_slope(r2_nodes)
        Dj = jnp.asarray(D, dtype=fit_dtype)
        # full-precision products: these coefficients set the proxy's
        # energy and force for every lane (TF32 would cost ~3 digits)
        hi = jax.lax.Precision.HIGHEST
        c = jnp.matmul(Dj, U_k.astype(fit_dtype), precision=hi)
        cd = jnp.matmul(jnp.asarray(Dd, dtype=fit_dtype), c, precision=hi)
        return {"c": [c[j] for j in range(K)],
                "cd": [cd[j] for j in range(K)]}

    def evaluate(coeffs, r2):
        c_list, cd_list = coeffs["c"], coeffs["cd"]
        # series value at w=1 (u = u_hi): T_j(1) = 1
        U_hi_edge = sum(c_list[1:], c_list[0])
        s_hi = sum(cd_list[1:], cd_list[0])
        u = 1.0 / r2
        over = jnp.maximum(u - u_hi, 0.0)
        w = jnp.clip((u - mid) * inv_half, -1.0, 1.0)
        su = clenshaw(cd_list, w)
        in_range = over <= 0.0
        # C^1 linear-in-u continuation past u_hi (the overlap barrier)
        U = jnp.where(in_range, clenshaw(c_list, w),
                      U_hi_edge + s_hi * over)
        su = jnp.where(in_range, su, s_hi)
        return U, -su * u * u

    return fit, evaluate


def pair_proxy(pair_energy_and_slope, degree, r2_lo, r2_hi, dtype=None):
    """Closure form of :func:`make_pair_proxy` for evaluation paths:
    fits here (call inside the traced step so coefficient gradients
    flow) and returns ``pair_fn(r2) -> (U, dU/dr2)``."""
    fit, evaluate = make_pair_proxy(degree, r2_lo, r2_hi, dtype=dtype)
    coeffs = fit(pair_energy_and_slope)
    return lambda r2: evaluate(coeffs, r2)


def make_typed_pair_proxy(degree, r2_lo, r2_hi, n_types, dtype=None):
    """Typed variant of :func:`make_pair_proxy`: one coefficient set per
    unordered type pair ``(a, b)``, fitted from
    ``pair_energy_and_slope(r2, ti, tj)`` (which must be symmetric under
    type swap, the package-wide contract).

    Per lane, the type masks collapse the selection into K masked
    coefficient sums feeding ONE Clenshaw with lane-varying
    coefficients (the recurrence is elementwise, so per-lane
    coefficients cost the same as scalars): total cost is
    ``T(T+1)/2`` mask-FMAs per term plus one Clenshaw per series --
    ~2.2x the untyped proxy at T=2. Practical for small T (document:
    each extra type pair adds 2K mask-FMAs per lane).
    """
    K = int(degree)
    T = int(n_types)
    fit_u, eval_u = make_pair_proxy(degree, r2_lo, r2_hi, dtype=dtype)
    pairs = [(a, b) for a in range(T) for b in range(a, T)]

    def fit(pair_energy_and_slope):
        out = {}
        for a, b in pairs:
            def es(r2, a=a, b=b):
                ta = jnp.full_like(r2, float(a))
                tb = jnp.full_like(r2, float(b))
                return pair_energy_and_slope(r2, ta, tb)
            out[(a, b)] = fit_u(es)
        return out

    def evaluate(coeffs, r2, ti, tj):
        # lane-varying effective coefficients via type-pair masks
        masks = []
        for a, b in pairs:
            m = (ti == float(a)) & (tj == float(b))
            if a != b:
                m = m | ((ti == float(b)) & (tj == float(a)))
            masks.append(m.astype(r2.dtype))
        zero = jnp.zeros_like(r2)

        def blend(key):
            return [sum((m * coeffs[p][key][k] for m, p in
                         zip(masks, pairs)), zero) for k in range(K)]

        eff = {"c": blend("c"), "cd": blend("cd")}
        return eval_u(eff, r2)

    return fit, evaluate
