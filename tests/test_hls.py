"""HLS-faithful fixed-point path: the vectorized JAX implementation must be
bit-exact against the literal stream-machine simulator."""

import numpy as np
import pytest

from lanczos_tpu.core.config import Profile, ResampleConfig
from lanczos_tpu.models.upscaler import Upscaler
from lanczos_tpu.ref.hls_sim import hls_stream_upscale
from lanczos_tpu.ref.oracle import c_oracle_upscale
from lanczos_tpu.utils.metrics import psnr


@pytest.mark.parametrize("a", [2, 3])
@pytest.mark.parametrize("scale", [(2, 1), (3, 1), (3, 2)])
def test_bit_exact_vs_stream_sim(a, scale, small_img):
    n, d = scale
    oh, ow = small_img.shape[0] * n // d, small_img.shape[1] * n // d
    cfg = ResampleConfig.from_profile(Profile.HLS, small_img.shape[:2], scale=scale, a=a)
    got = np.asarray(Upscaler(cfg)(small_img))
    want = hls_stream_upscale(small_img, oh, ow, a, cfg.bit_precision)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("bit_precision", [6, 8, 10])
def test_bit_exact_other_precisions(bit_precision, small_img):
    cfg = ResampleConfig.from_profile(
        Profile.HLS, small_img.shape[:2], scale=(2, 1), a=2,
        bit_precision=bit_precision,
    )
    got = np.asarray(Upscaler(cfg)(small_img))
    want = hls_stream_upscale(
        small_img, *cfg.out_shape, 2, bit_precision
    )
    np.testing.assert_array_equal(got, want)


def test_hls_vs_c_oracle_rms(small_img):
    """The reference's own two paths disagree (fixed point, dering,
    asymmetric edges) — the RMS between them is the number full_TB.h:166
    prints.  Sanity-check ours is in a plausible range (a few LSB)."""
    cfg = ResampleConfig.from_profile(Profile.HLS, small_img.shape[:2], scale=(2, 1), a=2)
    hls = np.asarray(Upscaler(cfg)(small_img))
    oracle = c_oracle_upscale(small_img, *cfg.out_shape, 2)
    p = psnr(hls, oracle)
    assert 15 < p < 60, f"HLS vs oracle PSNR {p:.1f} dB out of plausible range"


def test_hls_vs_c_oracle_rms_pinned_on_golden():
    """Regression-pin the exact RMS the reference testbench would print
    (full_TB.h:166) on the golden image at 2x/a=2 — both operands are
    integer-exact paths, so this value is platform-independent."""
    import os

    from lanczos_tpu.io import read_png
    from lanczos_tpu.utils.metrics import rms_error

    img = read_png(
        os.path.join(os.path.dirname(__file__), "data", "input_48x40.png")
    )
    cfg = ResampleConfig.from_profile(Profile.HLS, (48, 40), scale=(2, 1), a=2)
    hls = np.asarray(Upscaler(cfg)(img))
    oracle = c_oracle_upscale(img, *cfg.out_shape, 2)
    assert abs(rms_error(hls, oracle) - 13.301039994322082) < 1e-9


def test_output_in_range(small_img):
    """Dering guarantees the fixed-point path never wraps (the reference's
    clamp_to_byte would wrap without it)."""
    cfg = ResampleConfig.from_profile(Profile.HLS, small_img.shape[:2], scale=(2, 1), a=3)
    out = np.asarray(Upscaler(cfg)(small_img))
    assert out.dtype == np.uint8
