"""Device-mesh helpers.

The reference's distribution story is MPI spatial decomposition through
HOOMD (SURVEY.md section 2.3); the equivalent here is a
``jax.sharding.Mesh`` over the devices (NVLink-connected GPUs) with
XLA-emitted collectives.
"""

import jax
import numpy as np
from jax.sharding import Mesh

__all__ = ["make_mesh"]


def make_mesh(n_devices=None, axis="d", devices=None):
    """A 1-D mesh over (the first ``n_devices``) local devices.

    :param n_devices: number of devices (default: all).
    :param axis: mesh axis name (the particle/batch sharding axis).
    :param devices: explicit device list (overrides ``n_devices``).
    """
    if devices is None:
        devices = jax.devices()
        if n_devices is not None:
            devices = devices[:n_devices]
    return Mesh(np.array(devices), (axis,))
