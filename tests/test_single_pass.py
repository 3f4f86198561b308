"""Single-pass (one-axis) seams — the working version of the reference's
stale worker testbench (``worker_TB.h``: row pass alone vs a row-only
oracle, SURVEY.md §3.4)."""

import numpy as np
import pytest

from lanczos_tpu.core.config import EdgeMode
from lanczos_tpu.core.weights import banded_weights
from lanczos_tpu.ops.resample_xla import apply_banded
from lanczos_tpu.ref.oracle import oracle_resample_axis0

import jax.numpy as jnp


@pytest.mark.parametrize("scale", [(2, 1), (3, 1), (5, 2)])
def test_row_pass_alone_vs_row_oracle(rng, scale):
    """Horizontal (row) pass only, drop-edge unnormalized — exactly the
    worker_TB comparison that never linked in the reference."""
    n, d = scale
    w_in = 16 * d
    img = rng.integers(0, 256, size=(12, w_in, 3)).astype(np.uint8)
    out_w = w_in * n // d
    # oracle along axis 0 of the transposed image = row pass
    want = oracle_resample_axis0(
        np.ascontiguousarray(img.transpose(1, 0, 2)), out_w, 2
    ).transpose(1, 0, 2)
    op = banded_weights(
        w_in, out_w, 2, "lanczos", EdgeMode.DROP, normalize=False,
        coord_mode="c_double",
    )
    got = np.asarray(
        apply_banded(
            jnp.asarray(img, jnp.float64),
            jnp.asarray(op.idx),
            jnp.asarray(op.weights),
            axis=1,
        )
    )
    np.testing.assert_allclose(got, want, atol=5e-4)  # jax f32 default


def test_col_pass_alone_vs_col_oracle(rng):
    img = rng.integers(0, 256, size=(20, 8, 3)).astype(np.uint8)
    want = oracle_resample_axis0(img, 40, 2)
    op = banded_weights(
        20, 40, 2, "lanczos", EdgeMode.DROP, normalize=False,
        coord_mode="c_double",
    )
    got = np.asarray(
        apply_banded(
            jnp.asarray(img, jnp.float64),
            jnp.asarray(op.idx),
            jnp.asarray(op.weights),
            axis=0,
        )
    )
    np.testing.assert_allclose(got, want, atol=5e-4)  # jax f32 default


def test_roofline_model():
    from lanczos_tpu.core.config import Profile, ResampleConfig
    from lanczos_tpu.utils.profiling import Roofline, chip_spec, time_fn

    cfg = ResampleConfig.from_profile(
        Profile.PRECISE, (2160, 3840), out_shape=(4320, 7680), a=3
    )
    import types

    h100 = types.SimpleNamespace(device_kind="NVIDIA H100 80GB HBM3")
    r = Roofline.for_config(cfg, device=h100)
    assert r.hbm_bytes == 3 * (2160 * 3840 + 4320 * 7680)
    assert r.min_seconds > 0 and r.mpix_per_s() > 0
    assert 0 < r.fraction(r.min_seconds * 2) <= 0.5 + 1e-9
    bw, pk = chip_spec(h100)
    assert bw > 0 and pk > 0

    import jax

    f = jax.jit(lambda x: x + 1)
    dt = time_fn(f, jnp.zeros((8, 8)), iters=2)
    assert dt >= 0
