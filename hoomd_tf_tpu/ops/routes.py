"""Route choice: which implementation each hot operation takes.

Every platform- or model-dependent choice of implementation is made
here, from facts the code can observe: the JAX backend and the traced
pair function. Nothing here reads environment variables, and no route
runs a Pallas kernel in the interpreter on an accelerator.

- Analytic pair forces (:func:`.cellwise.analytic_pair_forces`): on the
  GPU, the Newton half-stencil Pallas kernel (Triton route,
  :mod:`.cellwise_pallas`) when the model's pair function can be
  replayed inside it, else the 27-block XLA full stencil. On the CPU,
  the XLA full stencil.
- Pallas kernels compile on the GPU and run in the interpreter on the
  CPU, where the tests reach them.
"""

import jax
import jax.numpy as jnp

__all__ = ["pallas_interpret", "pair_stencil", "STENCILS"]

STENCILS = ("auto", "pallas", "half", "full")


def pallas_interpret(platform=None):
    """Whether a Pallas kernel runs in the interpreter: True only on the
    CPU. Platforms other than the CPU and the GPU have no kernel route."""
    platform = platform or jax.default_backend()
    if platform == "cpu":
        return True
    if platform in ("gpu", "cuda"):
        return False
    raise NotImplementedError(
        f"no Pallas route for platform {platform!r} (supported: gpu, "
        "cpu)")


def pair_stencil(pair_fn, with_types=True, dtype=jnp.float32,
                 platform=None):
    """Stencil for the analytic pair route of ``pair_fn``: ``'pallas'``
    (the half-stencil kernel) on the GPU when
    :func:`.cellwise_pallas.pair_fn_lowers` accepts the pair function,
    else ``'full'``."""
    platform = platform or jax.default_backend()
    if platform not in ("gpu", "cuda"):
        return "full"
    from .cellwise_pallas import pair_fn_lowers
    return "pallas" if pair_fn_lowers(pair_fn, with_types, dtype) \
        else "full"
