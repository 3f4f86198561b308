"""Fused Pallas kernel (interpret mode) vs the XLA gather path.

The kernel computes the same banded operators as dense bf16-split dots
accumulated in f32, the gather path as per-tap FMAs, so uint8 outputs may
differ by 1 where a value sits exactly on a truncation boundary; assert
≤1 LSB and a small differing share.  Small ``tile_h``/``cb`` (powers of two
≥ 16) give the small test images multi-program grids.
"""

import numpy as np
import pytest

from lanczos_tpu.core.config import EdgeMode, Profile, ResampleConfig
from lanczos_tpu.models.upscaler import Upscaler
from lanczos_tpu.ops.resample_pallas import PallasOps, resample_2d_pallas, upscale_planar
from lanczos_tpu.utils.metrics import psnr


def _run_pallas(cfg, img, **kw):
    ops = PallasOps(cfg, interpret=True, **kw)
    return np.asarray(resample_2d_pallas(img, ops))


@pytest.mark.parametrize("scale", [(2, 1), (3, 1), (3, 2)])
def test_pallas_matches_xla_upscale(rng, scale, small_img):
    n, d = scale
    h, w = small_img.shape[:2]
    h, w = (h // d) * d, (w // d) * d
    img = small_img[:h, :w]
    cfg = ResampleConfig.from_profile(Profile.PRECISE, (h, w), scale=scale, a=2)
    ref = np.asarray(Upscaler(cfg, backend="xla")(img))
    out = _run_pallas(cfg, img, tile_h=16, cb=16)
    diff = np.abs(ref.astype(int) - out.astype(int))
    assert diff.max() <= 1, f"max diff {diff.max()}"
    assert (diff > 0).mean() < 0.02


@pytest.mark.parametrize("edge", [EdgeMode.CLAMP, EdgeMode.DROP, EdgeMode.REFLECT])
def test_pallas_edge_modes(rng, edge, small_img):
    cfg = ResampleConfig.from_profile(
        Profile.PRECISE, small_img.shape[:2], scale=(2, 1), a=3,
        edge_mode=edge, normalize=edge != EdgeMode.DROP,
    )
    ref = np.asarray(Upscaler(cfg, backend="xla")(small_img))
    out = _run_pallas(cfg, small_img, tile_h=16, cb=16)
    diff = np.abs(ref.astype(int) - out.astype(int))
    assert diff.max() <= 1


def test_pallas_batched_planar(rng, small_img):
    cfg = ResampleConfig.from_profile(
        Profile.PRECISE, small_img.shape[:2], scale=(2, 1), a=2
    )
    batch = np.stack([small_img, small_img[::-1].copy()])
    ops = PallasOps(cfg, interpret=True, tile_h=16, cb=16)
    planar = np.transpose(batch, (0, 3, 1, 2)).copy()
    out_p = np.asarray(upscale_planar(planar, ops))
    out_i = np.asarray(resample_2d_pallas(batch, ops))
    np.testing.assert_array_equal(np.transpose(out_p, (0, 2, 3, 1)), out_i)
    assert out_i.shape == (2, *cfg.out_shape, 3)


def test_pallas_nondivisible_tiles(rng, small_img):
    """Output dims not divisible by the tile → partial edge tiles masked."""
    h, w = small_img.shape[:2]
    cfg = ResampleConfig.from_profile(Profile.PRECISE, (h, w), scale=(2, 1), a=2)
    ref = np.asarray(Upscaler(cfg, backend="xla")(small_img))
    out = _run_pallas(cfg, small_img, tile_h=32, cb=32)
    diff = np.abs(ref.astype(int) - out.astype(int))
    assert diff.max() <= 1


def test_pallas_psnr_vs_oracle(rng, small_img):
    """End-to-end quality: fused kernel vs fp64 clean resample ≥ 55 dB."""
    from lanczos_tpu.ref.oracle import clean_resample_2d

    cfg = ResampleConfig.from_profile(
        Profile.PRECISE, small_img.shape[:2], scale=(2, 1), a=3
    )
    out = _run_pallas(cfg, small_img, tile_h=16, cb=16)
    gold = clean_resample_2d(small_img, cfg)
    gold = np.trunc(np.clip(gold, 0, 255)).astype(np.uint8)
    assert psnr(out, gold) > 55.0


def test_pallas_dering(rng, small_img):
    """FSR-style anti-ringing clamp (one-hot central-tap selectors in the
    same dots) vs XLA."""
    cfg = ResampleConfig.from_profile(
        Profile.PRECISE, small_img.shape[:2], scale=(2, 1), a=2, dering=True
    )
    ref = np.asarray(Upscaler(cfg, backend="xla")(small_img))
    out = _run_pallas(cfg, small_img, tile_h=16, cb=16)
    diff = np.abs(ref.astype(int) - out.astype(int))
    assert diff.max() <= 1


def test_pallas_downscale(rng):
    img = (
        np.linspace(0, 255, 64 * 48 * 3).reshape(64, 48, 3).astype(np.uint8)
    )
    cfg = ResampleConfig.from_profile(Profile.PRECISE, (64, 48), scale=(1, 2), a=2)
    ref = np.asarray(Upscaler(cfg, backend="xla")(img))
    out = _run_pallas(cfg, img, tile_h=16, cb=16)
    diff = np.abs(ref.astype(int) - out.astype(int))
    assert diff.max() <= 1


@pytest.mark.parametrize("scale", [(2, 1), (3, 1)])
def test_mxu_matches_xla_upscale(rng, scale, small_img):
    """Dense bf16-split dots on the unpadded input vs gather."""
    cfg = ResampleConfig.from_profile(
        Profile.PRECISE, small_img.shape[:2], scale=scale, a=3
    )
    ref = np.asarray(Upscaler(cfg, backend="xla")(small_img))
    out = _run_pallas(cfg, small_img)
    diff = np.abs(ref.astype(int) - out.astype(int))
    assert diff.max() <= 1, f"max diff {diff.max()}"
    assert (diff > 0).mean() < 0.02


@pytest.mark.parametrize(
    "scale, align, shape",
    [
        ((3, 2), "zero", (60, 80)),  # rational upscale
        ((7, 5), "zero", (60, 80)),
        ((3, 2), "center", (60, 80)),
        ((1, 2), "zero", (60, 80)),  # antialiased downscale (support widens)
        ((2, 3), "center", (60, 90)),
    ],
)
def test_mxu_rational_and_downscale(rng, scale, align, shape):
    """Generalized plan: per-tile/per-block dense matrices cover any
    linear N/D, incl. downscales, matching the gather reference <= 1 LSB
    (bf16-split summation order)."""
    cfg = ResampleConfig.from_profile(
        Profile.PRECISE, shape, scale=scale, a=3, align=align
    )
    img = rng.integers(0, 256, size=(*shape, 3), dtype=np.uint8)
    ref = np.asarray(Upscaler(cfg, backend="xla")(img))
    out = _run_pallas(cfg, img)
    diff = np.abs(ref.astype(int) - out.astype(int))
    assert diff.max() <= 1, f"max diff {diff.max()}"


@pytest.mark.parametrize(
    "edge, normalize",
    [
        (EdgeMode.CLAMP, True),
        (EdgeMode.REFLECT, True),
        (EdgeMode.DROP, False),
        (EdgeMode.DROP, True),  # drop+normalize: per-row renormalized weights
    ],
)
def test_mxu_edge_modes(rng, edge, normalize, small_img):
    """Edge semantics live in the per-tile/per-block weight matrices (no
    input padding) — including drop+normalize, which no padded kernel can
    express (per-row renormalization over surviving taps)."""
    cfg = ResampleConfig.from_profile(
        Profile.PRECISE, small_img.shape[:2], scale=(2, 1), a=3,
        edge_mode=edge, normalize=normalize,
    )
    ref = np.asarray(Upscaler(cfg, backend="xla")(small_img))
    out = _run_pallas(cfg, small_img)
    diff = np.abs(ref.astype(int) - out.astype(int))
    assert diff.max() <= 1


def test_mxu_batched_planar_and_partial_tiles(rng):
    """Batched planar == interleaved; odd dims exercise the row/lane
    alignment pads and partial output tiles."""
    shape = (51, 45)
    cfg = ResampleConfig.from_profile(Profile.PRECISE, shape, scale=(2, 1), a=2)
    imgs = rng.integers(0, 256, size=(2, *shape, 3), dtype=np.uint8)
    ops = PallasOps(cfg, interpret=True)
    planar = np.transpose(imgs, (0, 3, 1, 2)).copy()
    out_p = np.asarray(upscale_planar(planar, ops))
    out_i = np.asarray(resample_2d_pallas(imgs, ops))
    np.testing.assert_array_equal(np.transpose(out_p, (0, 2, 3, 1)), out_i)
    ref = np.asarray(Upscaler(cfg, backend="xla")(imgs[0]))
    assert np.abs(ref.astype(int) - out_i[0].astype(int)).max() <= 1


@pytest.mark.parametrize(
    "scale, edge",
    [
        ((2, 1), EdgeMode.CLAMP),
        ((3, 1), EdgeMode.REFLECT),
        ((3, 2), EdgeMode.CLAMP),  # rational dering
    ],
)
def test_mxu_dering(rng, scale, edge):
    """FSR dering clamp fused via one-hot central-tap bound rows/cols in
    the same matmuls (worker.cpp:64-75): bounds are exact (uint8 one-hots
    vertically; m_hi·S + m_lo·S = mid horizontally), so agreement with the
    gather path stays <= 1 LSB."""
    shape = (60, 80)
    cfg = ResampleConfig.from_profile(
        Profile.PRECISE, shape, scale=scale, a=3, dering=True, edge_mode=edge
    )
    img = rng.integers(0, 256, size=(*shape, 3), dtype=np.uint8)
    ref = np.asarray(Upscaler(cfg, backend="xla")(img))
    out = _run_pallas(cfg, img)
    diff = np.abs(ref.astype(int) - out.astype(int))
    assert diff.max() <= 1, f"max diff {diff.max()}"


@pytest.mark.parametrize(
    "ins, outs",
    [
        ((60, 80), (120, 120)),  # 2x vertical, 3/2 horizontal
        ((64, 90), (32, 135)),   # downscale vertical, upscale horizontal
        ((50, 64), (175, 64)),   # 7/2 vertical, identity horizontal
    ],
)
def test_mxu_anisotropic(rng, ins, outs):
    """Per-axis independent plans: mixed up/down/identity scales."""
    cfg = ResampleConfig.from_profile(Profile.PRECISE, ins, out_shape=outs, a=3)
    img = rng.integers(0, 256, size=(*ins, 3), dtype=np.uint8)
    ref = np.asarray(Upscaler(cfg, backend="xla")(img))
    out = _run_pallas(cfg, img)
    assert np.abs(ref.astype(int) - out.astype(int)).max() <= 1


def test_mxu_dering_order_and_drop_gates(rng):
    """Width-first dering has no RAW fused plan (it delegates through the
    transposed config instead); drop-edge dering fuses directly — the
    one-hot bound selectors use the operator's clipped tap indices, which
    is exactly the gather path's x[idx[a-1]]/x[idx[a]] clamp."""
    from lanczos_tpu.core.config import Order
    from lanczos_tpu.ops.resample_pallas import _mxu_plan

    wf = ResampleConfig.from_profile(
        Profile.PRECISE, (48, 64), scale=(2, 1), a=3, dering=True,
        order=Order.WIDTH_FIRST,
    )
    assert _mxu_plan(wf) is None
    for norm in (False, True):
        dr = ResampleConfig.from_profile(
            Profile.PRECISE, (48, 64), scale=(3, 2), a=3, dering=True,
            edge_mode=EdgeMode.DROP, normalize=norm,
        )
        assert _mxu_plan(dr) is not None
        img = rng.integers(0, 256, size=(48, 64, 3), dtype=np.uint8)
        ref = np.asarray(Upscaler(dr, backend="xla")(img))
        out = _run_pallas(dr, img)
        diff = np.abs(ref.astype(int) - out.astype(int))
        assert diff.max() <= 1, f"norm={norm} max diff {diff.max()}"


def test_mxu_intermediate_quantize(rng):
    """uint8-quantized intermediate (full_TB.h:63) fused in-kernel: the
    mid split disappears (integers are exact in bf16) and output matches
    the gather path's quantize-between-passes <= 1 LSB.  WIDTH_FIRST order
    is observable through the nonlinearity, so its plan is refused."""
    from lanczos_tpu.core.config import Order
    from lanczos_tpu.ops.resample_pallas import _mxu_plan

    shape = (48, 64)
    cfg = ResampleConfig.from_profile(
        Profile.PRECISE, shape, scale=(2, 1), a=3, intermediate_quantize=True
    )
    img = rng.integers(0, 256, size=(*shape, 3), dtype=np.uint8)
    ref = np.asarray(Upscaler(cfg, backend="xla")(img))
    out = _run_pallas(cfg, img)
    diff = np.abs(ref.astype(int) - out.astype(int))
    assert diff.max() <= 1, f"max diff {diff.max()}"
    wf = ResampleConfig.from_profile(
        Profile.PRECISE, shape, scale=(2, 1), a=3,
        intermediate_quantize=True, order=Order.WIDTH_FIRST,
    )
    # the raw plan is height-first only...
    assert _mxu_plan(wf) is None
    # ...but PallasOps routes width-first through the height-first kernel
    # on the transposed image (tr_ops), matching the gather path exactly
    # up to summation-order LSBs
    ref_wf = np.asarray(Upscaler(wf, backend="xla")(img))
    out_wf = _run_pallas(wf, img)
    diff_wf = np.abs(ref_wf.astype(int) - out_wf.astype(int))
    assert diff_wf.max() <= 1, f"max diff {diff_wf.max()}"
    # pass order is genuinely observable through the quantize: the two
    # orders disagree on this image, so the transpose trick is load-bearing
    assert not np.array_equal(ref_wf, ref)


def test_mxu_width_first_dering(rng):
    """Width-first dering rides the same transposed-kernel delegation."""
    from lanczos_tpu.core.config import Order

    shape = (40, 56)
    cfg = ResampleConfig.from_profile(
        Profile.PRECISE, shape, scale=(3, 2), a=3, dering=True,
        order=Order.WIDTH_FIRST,
    )
    img = rng.integers(0, 256, size=(*shape, 3), dtype=np.uint8)
    ref = np.asarray(Upscaler(cfg, backend="xla")(img))
    out = _run_pallas(cfg, img)
    diff = np.abs(ref.astype(int) - out.astype(int))
    assert diff.max() <= 1, f"max diff {diff.max()}"
    # batched planar goes through the same delegation
    ops = PallasOps(cfg, interpret=True)
    assert ops.tr_ops is not None
    batch = np.stack([img, img[::-1].copy()])
    planar = np.transpose(batch, (0, 3, 1, 2)).copy()
    out_p = np.transpose(np.asarray(upscale_planar(planar, ops)), (0, 2, 3, 1))
    np.testing.assert_array_equal(out_p[0], out)


def test_mxu_eligibility():
    """Any float config plans (incl. rational scales, downscales, dering and
    drop-edge dering); the fixed-point and c_faithful semantics do not."""
    rational = ResampleConfig.from_profile(
        Profile.PRECISE, (24, 20), scale=(3, 2), a=2
    )
    assert PallasOps(rational, interpret=True).mxu is not None
    down = ResampleConfig.from_profile(
        Profile.PRECISE, (24, 20), scale=(1, 2), a=2
    )
    assert PallasOps(down, interpret=True).mxu is not None
    dering = ResampleConfig.from_profile(
        Profile.PRECISE, (24, 20), scale=(2, 1), a=2, dering=True
    )
    assert PallasOps(dering, interpret=True).mxu is not None
    drop_dering = ResampleConfig.from_profile(
        Profile.PRECISE, (24, 20), scale=(2, 1), a=2, dering=True,
        edge_mode=EdgeMode.DROP,
    )
    assert PallasOps(drop_dering, interpret=True).mxu is not None
    ok = ResampleConfig.from_profile(Profile.PRECISE, (24, 20), scale=(2, 1), a=2)
    assert PallasOps(ok, interpret=True).mxu is not None
    for profile in (Profile.HLS, Profile.C_ORACLE):
        cfg = ResampleConfig.from_profile(profile, (24, 20), scale=(2, 1), a=2)
        with pytest.raises(NotImplementedError):
            PallasOps(cfg, interpret=True)


def test_mxu_horizontal_block_dedup():
    """Interior tiles and column blocks share one matrix (phase-LUT
    invariance, kernel.cpp:50-59): a 4K 2x plan needs <= 3 distinct
    matrices per axis."""
    from lanczos_tpu.ops.resample_pallas import _mxu_plan

    cfg = ResampleConfig.from_profile(
        Profile.PRECISE, (2160, 3840), out_shape=(4320, 7680), a=3
    )
    plan = _mxu_plan(cfg)
    assert plan is not None
    assert plan.wh.shape[0] <= 3 and plan.wv.shape[0] <= 3
    assert plan.n_cb == 120 and plan.num_tiles == 68


@pytest.mark.parametrize("ext", [1, 16, 17, 37, 48, 69, 100, 139, 200, 256])
def test_window_pieces_tile_rules(ext):
    """Window extents are covered by contiguous power-of-two pieces of at
    least 16 (Triton's block and dot rules), exceeding the 16-rounded
    extent by at most a quarter."""
    from lanczos_tpu.ops.resample_pallas import window_pieces

    pieces = window_pieces(ext)
    off = 0
    for o, n in pieces:
        assert o == off and n >= 16 and n & (n - 1) == 0
        off += n
    k16 = -(-ext // 16) * 16
    assert off >= ext and off * 4 <= k16 * 5


def _apply_plan(plan, x, ih, iw, oh, ow):
    """The kernel's arithmetic in float64 NumPy: per (tile, block), the
    dense window matrices applied to the zero-masked input window."""
    kv, kh, t, cb = plan.kv, plan.kh, plan.tile_out, plan.cb
    pad = np.zeros((ih + kv, iw + kh))
    pad[:ih, :iw] = x
    out = np.zeros((plan.num_tiles * t, plan.n_cb * cb))
    for i in range(plan.num_tiles):
        sv, wv = plan.starts_v[i], plan.wv[plan.uniq_v[i]][:t]
        for b in range(plan.n_cb):
            sh, wh = plan.starts_h[b], plan.wh[plan.uniq_h[b]][:, :cb]
            win = pad[sv : sv + kv, sh : sh + kh]
            out[i * t : (i + 1) * t, b * cb : (b + 1) * cb] = wv @ win @ wh
    return out[:oh, :ow]


@pytest.mark.parametrize(
    "ins, outs, kw",
    [
        ((270, 480), (540, 960), {}),
        ((271, 480), (541, 961), {}),  # large-N rational: per-tile matrices
        ((270, 480), (135, 240), {}),  # antialiased downscale
        ((60, 80), (90, 120), dict(edge_mode=EdgeMode.DROP, normalize=True)),
        ((60, 80), (120, 160), dict(align="center", edge_mode=EdgeMode.REFLECT)),
    ],
)
def test_plan_windows_cover_the_band(rng, ins, outs, kw):
    """Every tile's window and block covers its band: the plan's dense
    matrices reproduce the fp64 reference resample exactly (≤ 1e-9)."""
    from lanczos_tpu.ops.resample_pallas import _mxu_plan
    from lanczos_tpu.ref.oracle import clean_resample_2d

    cfg = ResampleConfig.from_profile(Profile.PRECISE, ins, out_shape=outs, a=3, **kw)
    plan = _mxu_plan(cfg)
    assert plan is not None
    x = rng.integers(0, 256, size=ins).astype(np.float64)
    got = _apply_plan(plan, x, *ins, *outs)
    want = clean_resample_2d(x[..., None], cfg)[..., 0]
    np.testing.assert_allclose(got, want, atol=1e-9)


@pytest.mark.parametrize(
    "kw",
    [
        {},
        dict(precision="bf16"),
        dict(dering=True),
        dict(order="width_first", intermediate_quantize=True),
    ],
)
def test_kernel_lowers_to_triton_at_4k(kw):
    """The compiled route (not the interpreter): the 4K→8K kernel lowers
    to one Triton call for the GPU, whose block shapes Triton accepts."""
    import jax
    import jax.numpy as jnp

    cfg = ResampleConfig.from_profile(
        Profile.PRECISE, (2160, 3840), out_shape=(4320, 7680), a=3, **kw
    )
    ops = PallasOps(cfg, interpret=False)
    x = jax.ShapeDtypeStruct((4, 3, 2160, 3840), jnp.uint8)
    exp = jax.export.export(
        jax.jit(lambda v: upscale_planar(v, ops)),
        platforms=["cuda"],
        disabled_checks=[
            jax.export.DisabledSafetyCheck.custom_call("__gpu$xla.gpu.triton")
        ],
    )(x)
    text = exp.mlir_module()
    assert text.count("__gpu$xla.gpu.triton") == 1
    assert "lanczos_fused" in text


def test_block_loop_matches_one_block_per_program(rng, monkeypatch):
    """Programs that loop over a group of column blocks (the last group
    clipped at the frame edge) write exactly what one block per program
    writes."""
    import lanczos_tpu.ops.resample_pallas as rp

    cfg = ResampleConfig.from_profile(
        Profile.PRECISE, (40, 40), out_shape=(80, 80), a=3
    )
    img = rng.integers(0, 256, size=(2, 40, 40, 3), dtype=np.uint8)
    monkeypatch.setattr(rp, "BLOCKS_PER_PROGRAM", 2)
    looped = _run_pallas(cfg, img, tile_h=16, cb=16)  # 5 blocks: 2 + 2 + 1
    monkeypatch.setattr(rp, "PIPELINE_WINDOW", 0)
    single = _run_pallas(cfg, img, tile_h=16, cb=16)
    np.testing.assert_array_equal(looped, single)
