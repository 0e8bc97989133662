"""Built-in layers (reference parity: ``htf/layers.py``), plus a small
``Dense`` so neural-network potentials need no external framework.
"""

import jax
import jax.numpy as jnp
import numpy as np

from .module import Layer
from ..ops.numerics import nlist_rinv, divide_no_nan

__all__ = ["RBFExpansion", "WCARepulsion", "EDSLayer", "Dense"]

# deterministic per-process init stream for lazily-built layers
_INIT_SEED = [0]


def _next_key():
    _INIT_SEED[0] += 1
    return jax.random.PRNGKey(_INIT_SEED[0])


class Dense(Layer):
    """Fully connected layer ``y = x W + b`` (Keras ``Dense`` equivalent).

    Weights are built lazily on first call (input width unknown until then);
    Glorot-uniform kernel, zero bias.
    """

    def __init__(self, units, activation=None, use_bias=True, name="dense",
                 dtype=jnp.float32):
        super().__init__(name=name, dtype=dtype)
        self.units = int(units)
        self.activation = activation
        self.use_bias = use_bias
        self.kernel = None
        self.bias = None

    def _build(self, in_dim):
        limit = float(np.sqrt(6.0 / (in_dim + self.units)))
        # may run inside an abstract ensure_built trace: the RNG draw
        # must stay concrete (see Layer.add_weight)
        with jax.ensure_compile_time_eval():
            k = jax.random.uniform(
                _next_key(), (in_dim, self.units),
                minval=-limit, maxval=limit, dtype=self.dtype)
        self.kernel = self.add_weight(
            (in_dim, self.units), initializer=lambda s: k,
            name=f"{self.name}.kernel")
        if self.use_bias:
            self.bias = self.add_weight(
                (self.units,), name=f"{self.name}.bias")

    def get_config(self):
        return {"units": self.units, "use_bias": self.use_bias,
                "name": self.name}

    def call(self, x):
        x = jnp.asarray(x, dtype=self.dtype)
        if self.kernel is None:
            self._build(x.shape[-1])
        k = self.kernel.value
        in_dim, units = k.shape
        if in_dim <= 8 or units <= 8:
            # per-lane MLPs (NN pair potentials) apply Dense over a huge
            # lane batch with a tiny feature axis; a matmul there would
            # materialize the [lanes, units] intermediates in device
            # memory. Broadcast-multiply + reduce stays elementwise,
            # which XLA fuses through the surrounding lane math. Real
            # widths keep the matmul.
            y = jnp.sum(x[..., :, None] * k, axis=-2)
        else:
            y = jnp.matmul(x, k, preferred_element_type=self.dtype)
        if self.use_bias:
            y = y + self.bias.value
        if self.activation is not None:
            y = self.activation(y)
        return y


class RBFExpansion(Layer):
    r"""SchNet-style Gaussian radial basis expansion
    (reference ``layers.py:7-49``).

    Input: rank-K distances; output: rank K+1 with a trailing ``count`` axis,
    :math:`\exp(-(d - \mu)^2 / \gamma^{-1})` with :math:`\mu` evenly spaced
    on ``[low, high]``.
    """

    def __init__(self, low, high, count, name="rbf-layer"):
        super().__init__(name=name)
        self.low = low
        self.high = high
        self.centers = jnp.linspace(float(low), float(high), count,
                                    dtype=jnp.float32)
        self.gap = self.centers[1] - self.centers[0]

    def get_config(self):
        return {"low": self.low, "high": self.high,
                "count": int(self.centers.shape[0])}

    def call(self, inputs):
        return jnp.exp(-(inputs[..., None] - self.centers) ** 2 / self.gap)


class WCARepulsion(Layer):
    r"""Trainable Weeks-Chandler-Anderson repulsion
    (reference ``layers.py:52-98``).

    .. math::
        U(r) = (\sigma/r)^6 \;\; \text{for } r \le 2^{1/3}\sigma,\;
        \text{else } 0

    with trainable :math:`\sigma` and a negative-strength regularizer that
    pushes :math:`\sigma` toward larger distances. Input is the neighbor
    list; output is the clipped per-pair energy ``[N, NN]``.

    Note the cutoff is :math:`2^{1/3}\sigma` -- the minimum of the
    :math:`\sigma^6/r^6`-only potential used here (reference parity);
    the built-in full-LJ :class:`..md.pair.WCA` force cuts at the
    physical :math:`2^{1/6}\sigma` instead. The difference is
    deliberate.
    """

    def __init__(self, sigma, regularization_strength=1e-3,
                 name="wca-repulsion"):
        super().__init__(name=name)
        self.sigma = self.add_weight(
            (), initializer=float(sigma),
            regularizer=lambda x: -regularization_strength * x,
            name="sigma")

    def get_config(self):
        return {"sigma": float(self.sigma.value)}

    def call(self, nlist):
        rinv = nlist_rinv(nlist)
        true_sig = self.sigma.value
        rp = (true_sig * rinv) ** 6
        r = jnp.linalg.norm(nlist[..., :3], axis=-1)
        r_pair_energy = (r < true_sig * 2 ** (1 / 3)).astype(rp.dtype) * rp
        return jnp.clip(r_pair_energy, 0.0, 10.0)


class EDSLayer(Layer):
    r"""Experiment-Directed-Simulation coupling constant
    (reference ``layers.py:101-195``).

    Called on a collective variable each step; maintains Welford-style
    running statistics of the CV and, every ``period`` steps, takes an
    internal Adam step on the bias coupling :math:`\alpha` so that the
    biased simulation's mean CV converges to ``set_point``. Returns the
    current :math:`\alpha`.

    All state (statistics, Adam moments) lives in non-trainable variables,
    so the layer works unchanged inside the jitted MD step: the
    :class:`..md.simulation.Simulation` scan carries the state explicitly.
    """

    def __init__(self, set_point, period, learning_rate=1e-2, cv_scale=1.0,
                 name="eds-layer", beta1=0.9, beta2=0.999, epsilon=1e-8,
                 dtype=jnp.float32):
        set_point = jnp.asarray(set_point)
        if not jnp.issubdtype(set_point.dtype, jnp.floating):
            raise ValueError(
                "EDS only works with floats, not dtype " +
                str(set_point.dtype))
        super().__init__(name=name, dtype=set_point.dtype)
        self.set_point = set_point
        self.period = int(period)
        self.cv_scale = cv_scale
        self.learning_rate = learning_rate
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        self._stats_built = False

    def get_config(self):
        return {"set_point": np.asarray(self.set_point).tolist(),
                "period": self.period, "cv_scale": self.cv_scale,
                "learning_rate": self.learning_rate, "name": self.name}

    def _build(self, shape):
        self.mean = self.add_weight(shape, trainable=False, name="mean")
        self.ssd = self.add_weight(shape, trainable=False, name="ssd")
        self.n = self.add_weight(shape, trainable=False, dtype=jnp.int32,
                                 name="n")
        self.alpha = self.add_weight(shape, name="alpha")
        # internal Adam state (tf.compat.v1 AdamOptimizer semantics)
        self.adam_m = self.add_weight(shape, trainable=False, name="adam_m")
        self.adam_v = self.add_weight(shape, trainable=False, name="adam_v")
        self.adam_t = self.add_weight((), trainable=False, dtype=jnp.int32,
                                      name="adam_t")
        self._stats_built = True

    def _adam_step(self, grad, apply_mask):
        """Masked v1-Adam update on alpha: state advances only when
        ``apply_mask`` (the every-``period``-steps condition) is true."""
        b1, b2, eps = self.beta1, self.beta2, self.epsilon
        t = self.adam_t.value + jnp.any(apply_mask).astype(jnp.int32)
        m = self.beta1 * self.adam_m.value + (1 - b1) * grad
        v = b2 * self.adam_v.value + (1 - b2) * grad ** 2
        tf_ = t.astype(self.dtype)
        lr_t = self.learning_rate * jnp.sqrt(1 - b2 ** tf_) / (1 - b1 ** tf_)
        new_alpha = self.alpha.value - lr_t * m / (jnp.sqrt(v) + eps)
        keep = apply_mask.astype(self.dtype)
        self.adam_t.assign(t)
        self.adam_m.assign(keep * m + (1 - keep) * self.adam_m.value)
        self.adam_v.assign(keep * v + (1 - keep) * self.adam_v.value)
        self.alpha.assign(keep * new_alpha + (1 - keep) * self.alpha.value)

    def call(self, cv):
        cv = jnp.asarray(cv, dtype=self.dtype)
        if not self._stats_built:
            self._build(cv.shape)
        reset_mask = (self.n.value != 0).astype(self.dtype)
        self.mean.assign(self.mean.value * reset_mask)
        self.ssd.assign(self.ssd.value * reset_mask)

        update_mask = (self.n.value > self.period // 2).astype(self.dtype)
        delta = (cv - self.mean.value) * update_mask
        self.mean.assign_add(divide_no_nan(
            delta, (self.n.value - self.period // 2).astype(self.dtype)))
        self.ssd.assign_add(delta * (cv - self.mean.value))

        apply_mask = self.n.value == self.period - 1
        gradient = (apply_mask.astype(self.dtype) * -2.0 *
                    (self.mean.value - self.set_point) * self.ssd.value /
                    self.period / 2 / self.cv_scale)
        self._adam_step(gradient, apply_mask)
        self.n.assign((self.n.value + 1) % self.period)
        return self.alpha.value
