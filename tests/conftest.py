"""Test configuration: run JAX on CPU with 8 virtual devices.

Multi-device sharding logic is validated on a virtual CPU mesh (the
analog of the reference's "csim as fake device" strategy — SURVEY.md §4);
the fused Pallas kernel runs in interpret mode.  Numbers for the card
come from chip_smoke.py and bench.py, run on the GPU.
"""

import os

# Force CPU regardless of ambient JAX_PLATFORMS (jax.config.update
# overrides it even when jax was imported before conftest runs).
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(42)


@pytest.fixture
def small_img(rng):
    """A 24x20 RGB uint8 test image with structure (gradients + noise)."""
    h, w = 24, 20
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack(
        [
            (yy * 255 // max(h - 1, 1)),
            (xx * 255 // max(w - 1, 1)),
            ((yy + xx) * 255 // max(h + w - 2, 1)),
        ],
        axis=-1,
    ).astype(np.int64)
    noise = rng.integers(-40, 40, size=base.shape)
    return np.clip(base + noise, 0, 255).astype(np.uint8)
