"""The device an entry point measures on."""

import os
import subprocess

import jax

__all__ = ["require_accelerator", "gpu_name_and_power_limit"]


def require_accelerator():
    """``(platform, device_kind, count)`` of JAX's devices.

    Raises ``RuntimeError`` when JAX finds no GPU, unless the CPU was
    asked for explicitly (``JAX_PLATFORMS=cpu``): a measurement path that
    finds no chip fails instead of timing the CPU."""
    devs = jax.devices()
    platform = devs[0].platform
    if platform != "gpu" and os.environ.get("JAX_PLATFORMS") != "cpu":
        raise RuntimeError(
            f"no GPU found (JAX platform {platform!r}); set "
            "JAX_PLATFORMS=cpu to run on the CPU deliberately")
    return platform, devs[0].device_kind, len(devs)


def gpu_name_and_power_limit():
    """The ``name, power.limit`` line(s) of ``nvidia-smi``, read by a
    child process that does not import JAX; ``None`` without
    ``nvidia-smi``."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip()
