"""Timing harness and device-identity invariants."""

import types

import jax
import jax.numpy as jnp
import pytest

from lanczos_tpu.core.config import Profile, ResampleConfig
from lanczos_tpu.utils.profiling import (
    CHIP_SPECS,
    Roofline,
    chip_spec,
    device_info,
    require_gpu,
    time_fn,
)

H100 = types.SimpleNamespace(device_kind="NVIDIA H100 80GB HBM3")


def test_steady_time_positive_and_bounded():
    """The timer (block_until_ready around each timed loop, median of
    repetitions) returns a sane positive per-call time, even for a
    sub-microsecond fn."""
    f = jax.jit(lambda v: v ^ jnp.uint8(1))
    x = jnp.zeros((1 << 16,), jnp.uint8)
    dt = time_fn(f, x, iters=8, reps=3)
    assert 0 < dt < 1.0


def test_chip_spec_single_source():
    """H100 kinds resolve through the one table (data-sheet peaks); a
    device the table does not know is an error, never a default."""
    assert chip_spec(H100) == CHIP_SPECS["h100"] == (3.35e12, 989e12)
    sxm = types.SimpleNamespace(device_kind="NVIDIA H100 SXM5 80GB")
    assert chip_spec(sxm) == CHIP_SPECS["h100"]
    for kind in ("cpu", "NVIDIA A100-SXM4-80GB", ""):
        with pytest.raises(KeyError):
            chip_spec(types.SimpleNamespace(device_kind=kind))


def test_roofline_fraction():
    cfg = ResampleConfig.from_profile(
        Profile.PRECISE, (2160, 3840), out_shape=(4320, 7680), a=3
    )
    r = Roofline.for_config(cfg, device=H100)
    assert r.hbm_bytes == 3 * (2160 * 3840 + 4320 * 7680)
    assert 0 < r.fraction(r.min_seconds * 2) <= 0.5 + 1e-9
    # memory-bound: 124 MB at 3.35 TB/s ≈ 37 µs
    assert r.min_seconds == pytest.approx(r.hbm_bytes / 3.35e12)


def test_device_info_and_gpu_gate():
    """Every result names its device; a measurement refuses to run on a
    machine with no GPU rather than fall back to the CPU."""
    info = device_info()
    assert info == {
        "platform": "cpu", "kind": jax.devices()[0].device_kind,
        "count": len(jax.devices()),
    }
    with pytest.raises(SystemExit):
        require_gpu()
