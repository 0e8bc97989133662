"""Test configuration: run on the CPU with 8 virtual devices so sharding
tests exercise real multi-device code paths without accelerator hardware.

``--on-device`` keeps whatever platform JAX already runs on: chip_smoke.py
runs the ``chip``-marked tests in its own process on the GPU with it.
Whether a GPU is present is decided inside the tests' fixtures.
"""

import os


def pytest_addoption(parser):
    parser.addoption(
        "--on-device", action="store_true",
        help="do not pin the CPU (the chip tests run in-process on the GPU "
             "from chip_smoke.py)")


def pytest_configure(config):
    if config.getoption("--on-device"):
        return
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", False)

    assert jax.default_backend() == "cpu", jax.default_backend()
    assert len(jax.devices()) == 8, jax.devices()
