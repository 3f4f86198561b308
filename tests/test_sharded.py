"""Multi-device row-partitioned path vs the single-device XLA path.

Runs on the virtual 8-device CPU mesh (conftest.py) — the analog of the
reference's "csim as fake device" strategy (SURVEY.md §4).
"""

import jax
import numpy as np
import pytest

from lanczos_tpu.core.config import EdgeMode, Profile, ResampleConfig
from lanczos_tpu.models.upscaler import Upscaler
from lanczos_tpu.parallel.sharded import ShardedUpscaler, choose_mesh_shape


def _img(rng, b, h, w):
    return rng.integers(0, 256, size=(b, h, w, 3), dtype=np.uint8)


@pytest.mark.parametrize("mesh_shape", [(1, 8), (2, 4), (4, 2), (8, 1)])
def test_sharded_matches_single_chip(rng, mesh_shape):
    mesh = jax.make_mesh(mesh_shape, ("data", "rows"))
    cfg = ResampleConfig.from_profile(
        Profile.PRECISE, (32, 24), scale=(2, 1), a=2
    )
    img = _img(rng, mesh_shape[0], 32, 24)
    ref = np.asarray(Upscaler(cfg, backend="xla")(img))
    out = np.asarray(ShardedUpscaler(cfg, mesh)(img))
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("scale", [(2, 1), (3, 1), (3, 2), (5, 4), (7, 2)])
@pytest.mark.parametrize("edge", [EdgeMode.CLAMP, EdgeMode.DROP, EdgeMode.REFLECT])
def test_sharded_scales_and_edges(rng, scale, edge):
    mesh = jax.make_mesh((2, 4), ("data", "rows"))
    n, d = scale
    in_h = 8 * d * 4  # divisible by rows axis and by d
    in_w = 16 * d
    cfg = ResampleConfig.from_profile(
        Profile.PRECISE, (in_h, in_w), scale=scale, a=3, edge_mode=edge
    )
    img = _img(rng, 2, in_h, in_w)
    ref = np.asarray(Upscaler(cfg, backend="xla")(img))
    out = np.asarray(ShardedUpscaler(cfg, mesh)(img))
    np.testing.assert_array_equal(out, ref)


def test_sharded_dering(rng):
    mesh = jax.make_mesh((1, 4), ("data", "rows"))
    cfg = ResampleConfig.from_profile(
        Profile.PRECISE, (32, 16), scale=(2, 1), a=2, dering=True
    )
    img = _img(rng, 1, 32, 16)
    ref = np.asarray(Upscaler(cfg, backend="xla")(img))
    out = np.asarray(ShardedUpscaler(cfg, mesh)(img))
    np.testing.assert_array_equal(out, ref)


def test_sharded_downscale(rng):
    """Downscale needs a wider (a·D/N-row) halo."""
    mesh = jax.make_mesh((1, 4), ("data", "rows"))
    cfg = ResampleConfig.from_profile(
        Profile.PRECISE, (64, 32), scale=(1, 2), a=3
    )
    img = _img(rng, 1, 64, 32)
    ref = np.asarray(Upscaler(cfg, backend="xla")(img))
    out = np.asarray(ShardedUpscaler(cfg, mesh)(img))
    np.testing.assert_array_equal(out, ref)


def test_sharded_width_first_quantized(rng):
    """Width-first with a quantized intermediate (order-sensitive path)."""
    from lanczos_tpu.core.config import Order

    mesh = jax.make_mesh((1, 4), ("data", "rows"))
    cfg = ResampleConfig.from_profile(
        Profile.PRECISE, (32, 16), scale=(2, 1), a=2,
        order=Order.WIDTH_FIRST, intermediate_quantize=True, normalize=False,
        edge_mode=EdgeMode.DROP,
    )
    img = _img(rng, 1, 32, 16)
    ref = np.asarray(Upscaler(cfg, backend="xla")(img))
    out = np.asarray(ShardedUpscaler(cfg, mesh)(img))
    np.testing.assert_array_equal(out, ref)


def test_sharded_fixed_point_hls(rng):
    """HLS-faithful fixed-point path sharded over rows: bit-exact vs the
    single-chip fixed path AND vs the literal stream simulator."""
    from lanczos_tpu.ref.hls_sim import hls_stream_upscale

    mesh = jax.make_mesh((1, 4), ("data", "rows"))
    cfg = ResampleConfig.from_profile(Profile.HLS, (32, 16), scale=(2, 1), a=2)
    img = _img(rng, 1, 32, 16)
    single = np.asarray(Upscaler(cfg)(img[0]))
    out = np.asarray(ShardedUpscaler(cfg, mesh)(img))[0]
    np.testing.assert_array_equal(out, single)
    sim = hls_stream_upscale(img[0], 64, 32, a=2, bit_precision=cfg.bit_precision)
    np.testing.assert_array_equal(out, sim)


def test_choose_mesh_shape():
    for n in (1, 2, 4, 8, 16):
        d, r = choose_mesh_shape(n)
        assert d * r == n
    assert choose_mesh_shape(8) == (2, 4)
    assert choose_mesh_shape(1) == (1, 1)


def test_sharded_halo_exceeding_shard_raises(rng):
    """ADVICE r1: float paths must reject halo > rows-per-shard up front.

    (64,32)->(16,8) at scale 1/4, a=3 over 8 row shards needs a 12-row
    vertical halo but each shard holds only 8 rows; before the guard the
    gather path silently produced wrong pixels."""
    mesh = jax.make_mesh((1, 8), ("data", "rows"))
    cfg = ResampleConfig.from_profile(
        Profile.PRECISE, (64, 32), scale=(1, 4), a=3
    )
    with pytest.raises(ValueError, match="halo"):
        ShardedUpscaler(cfg, mesh)


@pytest.mark.parametrize(
    "a,scale,hw,mesh_shape",
    [
        (2, (2, 1), (32, 24), (2, 4)),
        (3, (2, 1), (64, 32), (1, 4)),
        (2, (3, 2), (48, 24), (1, 4)),
        (3, (3, 1), (48, 32), (2, 2)),
    ],
)
def test_sharded_c_faithful_bit_exact(rng, a, scale, hw, mesh_shape):
    """Round 2: the c_faithful (c_oracle) profile sharded over rows is
    bit-exact vs the host oracle — the width pass is row-local, the height
    pass exchanges an a-row halo of the uint8 intermediate, and the
    in-place quirk rows are recomputed on their owner shard."""
    from lanczos_tpu.ref.oracle import c_oracle_upscale

    mesh = jax.make_mesh(mesh_shape, ("data", "rows"))
    cfg = ResampleConfig.from_profile("c_oracle", hw, scale=scale, a=a)
    sh = ShardedUpscaler(cfg, mesh)
    imgs = rng.integers(0, 256, size=(mesh_shape[0], *hw, 3), dtype=np.uint8)
    out = np.asarray(sh(imgs))
    for b in range(mesh_shape[0]):
        np.testing.assert_array_equal(
            out[b], c_oracle_upscale(imgs[b], *cfg.out_shape, a)
        )


@pytest.mark.parametrize(
    "outs, kw",
    [
        ((128, 96), {}),
        ((96, 72), {}),  # rational 3/2
        ((128, 96), dict(edge_mode=EdgeMode.DROP, normalize=True)),
        ((128, 96), dict(dering=True)),
        # drop-edge dering: the one-hot bounds use the per-shard operator's
        # clipped indices, so the fusion extends through the mesh (round 3)
        ((128, 96), dict(edge_mode=EdgeMode.DROP, normalize=False, dering=True)),
        ((128, 96), dict(edge_mode=EdgeMode.DROP, normalize=True, dering=True)),
        ((128, 96), dict(edge_mode=EdgeMode.REFLECT)),
        ((128, 96), dict(intermediate_quantize=True)),
    ],
)
def test_sharded_mxu_bit_identical_to_single_chip(rng, outs, kw):
    """The fused MXU overlay: per-shard edge-exact weight matrices as
    row-sharded operands.  Same band values + zero-column window shifts
    (exact 0.0 additions) => BIT-IDENTICAL to the single-chip pallas MXU
    backend, incl. drop+normalize and dering."""
    import jax.numpy as jnp

    from lanczos_tpu.ops.resample_pallas import PallasOps, resample_2d_pallas

    ins = (64, 48)
    cfg = ResampleConfig.from_profile(Profile.PRECISE, ins, out_shape=outs, a=3, **kw)
    mesh = jax.make_mesh((2, 4), ("data", "rows"))
    imgs = rng.integers(0, 256, size=(2, *ins, 3), dtype=np.uint8)
    sh = ShardedUpscaler(cfg, mesh, backend="mxu")
    assert sh.use_mxu
    out = np.asarray(sh(jnp.asarray(imgs)))
    ops = PallasOps(cfg, interpret=True)
    ref = np.stack(
        [np.asarray(resample_2d_pallas(jnp.asarray(im), ops)) for im in imgs]
    )
    np.testing.assert_array_equal(out, ref)


def test_sharded_mxu_gate():
    """Fixed-point / c_faithful configs cannot take the MXU overlay."""
    cfg = ResampleConfig.from_profile(Profile.HLS, (64, 48), scale=(2, 1), a=2)
    mesh = jax.make_mesh((1, 4), ("data", "rows"))
    with pytest.raises(NotImplementedError):
        ShardedUpscaler(cfg, mesh, backend="mxu")


# ------------------------------------------- halo-overlap structure (r4)


@pytest.mark.parametrize(
    "kw",
    [
        dict(scale=(2, 1), a=2),
        dict(scale=(3, 2), a=3),
        dict(scale=(7, 3), a=3),
        dict(scale=(2, 1), a=3, dering=True),
        dict(scale=(1, 2), a=2),  # downscale: halo from d > n
    ],
)
def test_gather_overlap_bit_identical_to_serial_exchange(rng, kw):
    """The interior/boundary split (overlap=True, the default) must be
    bit-identical to exchange-then-compute on every path and config."""
    mesh = jax.make_mesh((2, 4), ("data", "rows"))
    n, d = kw["scale"]
    h = 48 if d == 3 else (128 if n < d else 64)
    cfg = ResampleConfig.from_profile(Profile.PRECISE, (h, 24), **kw)
    img = _img(rng, 2, h, 24)
    a = np.asarray(ShardedUpscaler(cfg, mesh, backend="gather")(img))
    b = np.asarray(
        ShardedUpscaler(cfg, mesh, backend="gather", overlap=False)(img)
    )
    np.testing.assert_array_equal(a, b)


def test_gather_overlap_split_bounds_sane(rng):
    mesh = jax.make_mesh((1, 4), ("data", "rows"))
    cfg = ResampleConfig.from_profile(Profile.PRECISE, (64, 16), scale=(2, 1), a=3)
    m = ShardedUpscaler(cfg, mesh, backend="gather")
    assert m.b_top >= 0  # split available
    ol = m.out_h_local
    # interior dominates: boundary rows are O(a·N/D) each side
    assert m.b_top + m.b_bot < ol // 2
    # windows stay within halo+slab
    assert 1 <= m.wtop <= m.in_h_local and 1 <= m.wbot <= m.in_h_local


def test_mxu_overlay_channel_groups_bit_identical(rng):
    mesh = jax.make_mesh((2, 4), ("data", "rows"))
    cfg = ResampleConfig.from_profile(Profile.PRECISE, (64, 32), scale=(2, 1), a=3)
    img = _img(rng, 2, 64, 32)
    a = np.asarray(ShardedUpscaler(cfg, mesh, backend="mxu")(img))
    b = np.asarray(
        ShardedUpscaler(cfg, mesh, backend="mxu", overlap=False)(img)
    )
    np.testing.assert_array_equal(a, b)


def test_sharded_uint16_contract(rng):
    """uint16 frames follow the Upscaler dtype contract on the mesh:
    float path + trunc-clip against 65535 (VERDICT r4 weak #5)."""
    mesh = jax.make_mesh((2, 4), ("data", "rows"))
    cfg = ResampleConfig.from_profile(
        Profile.PRECISE, (32, 24), scale=(2, 1), a=2
    )
    img16 = rng.integers(0, 65536, size=(2, 32, 24, 3), dtype=np.uint16)
    ref = np.stack([
        np.asarray(Upscaler(cfg, backend="xla")(img16[i])) for i in range(2)
    ])
    out = np.asarray(ShardedUpscaler(cfg, mesh)(img16))
    assert out.dtype == np.uint16
    np.testing.assert_array_equal(out, ref)


def test_upscale_one_shot_mesh(rng):
    """upscale(..., mesh=) routes through ShardedUpscaler."""
    from lanczos_tpu.models.upscaler import upscale

    mesh = jax.make_mesh((2, 4), ("data", "rows"))
    cfg = ResampleConfig.from_profile(
        Profile.PRECISE, (32, 24), scale=(2, 1), a=2
    )
    img = _img(rng, 2, 32, 24)
    ref = np.asarray(Upscaler(cfg, backend="xla")(img))
    out = np.asarray(upscale(img, scale=(2, 1), a=2, mesh=mesh))
    np.testing.assert_array_equal(out, ref)
