"""Seeded config fuzz: all backends agree on random configurations.

Each case draws (dims, scale, a, edge mode, alignment, dering, filter)
from a seeded RNG and checks every applicable backend against the gather
reference within 1 uint8 ULP — a safety net across the config-space
corners no targeted test hits.
"""

import numpy as np
import pytest

from lanczos_tpu.core.config import EdgeMode, Profile, ResampleConfig
from lanczos_tpu.models.upscaler import Upscaler

SCALES = [(2, 1), (3, 1), (4, 1), (3, 2), (5, 4), (5, 2), (1, 2), (2, 3), (7, 3)]
EDGES = [EdgeMode.CLAMP, EdgeMode.DROP, EdgeMode.REFLECT]
FILTERS = ["lanczos", "mitchell", "catmull_rom", "triangle"]


def _random_cfg(rng):
    n, d = SCALES[rng.integers(len(SCALES))]
    h = int(rng.integers(2, 7)) * d * 2
    w = int(rng.integers(2, 7)) * d * 2
    a = int(rng.integers(2, 4))
    edge = EDGES[rng.integers(len(EDGES))]
    align = "center" if rng.integers(2) else "zero"
    # dering applies to downscales too (clamp to the widened band's two
    # central taps); all backends agree (MXU verified <= 1 LSB)
    dering = bool(rng.integers(2))
    filt = FILTERS[rng.integers(len(FILTERS))]
    return ResampleConfig.from_profile(
        Profile.PRECISE, (h, w), scale=(n, d), a=a, edge_mode=edge,
        align=align, dering=dering, filter=filt,
        normalize=edge != EdgeMode.DROP,
    )


@pytest.mark.parametrize("seed", range(24))
def test_backends_agree_random_config(seed):
    rng = np.random.default_rng(1000 + seed)
    cfg = _random_cfg(rng)
    img = rng.integers(0, 256, size=(*cfg.in_shape, 3), dtype=np.uint8)
    ref = np.asarray(Upscaler(cfg, backend="xla")(img))
    assert ref.shape == (*cfg.out_shape, 3)
    for b in ("shift_xla", "pallas"):
        try:
            out = np.asarray(Upscaler(cfg, backend=b)(img))
        except (NotImplementedError, ValueError):
            continue  # backend legitimately rejects this config
        diff = np.abs(ref.astype(int) - out.astype(int))
        assert diff.max() <= 1, (
            f"seed {seed} backend {b} cfg {cfg}: max diff {diff.max()}"
        )


@pytest.mark.parametrize("seed", range(8))
def test_execution_modes_agree_random_config(seed):
    """Sharded mesh and streaming chunks vs the whole-frame path."""
    import jax

    from lanczos_tpu.models.streaming import StreamingUpscaler
    from lanczos_tpu.parallel.sharded import ShardedUpscaler

    rng = np.random.default_rng(2000 + seed)
    n, d = SCALES[rng.integers(len(SCALES))]
    # dims divisible by 4 shards, the scale D, and the chunk rounding
    h = int(rng.integers(2, 5)) * d * n * 4
    w = int(rng.integers(2, 5)) * d * 2
    a = int(rng.integers(2, 4))
    align = "center" if rng.integers(2) else "zero"
    cfg = ResampleConfig.from_profile(
        Profile.PRECISE, (h, w), scale=(n, d), a=a, align=align,
        edge_mode=EDGES[rng.integers(len(EDGES))],
    )
    if cfg.edge_mode == EdgeMode.DROP:
        cfg = ResampleConfig.from_profile(
            Profile.PRECISE, (h, w), scale=(n, d), a=a, align=align,
            edge_mode=EdgeMode.DROP, normalize=False,
        )
    img = rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8)
    ref = np.asarray(Upscaler(cfg, backend="xla")(img))

    mesh = jax.make_mesh((1, 4), ("data", "rows"))
    out_sh = np.asarray(ShardedUpscaler(cfg, mesh)(img[None]))[0]
    np.testing.assert_array_equal(out_sh, ref, err_msg=f"sharded seed {seed}")

    chunk = int(rng.integers(1, 4)) * n * 2
    out_st = StreamingUpscaler(cfg, chunk_rows=chunk)(img)
    np.testing.assert_array_equal(out_st, ref, err_msg=f"stream seed {seed}")


@pytest.mark.parametrize("seed", range(12))
def test_mxu_variant_random_config(seed):
    """The fused kernel's generalized plan (interpret mode) across random
    configs — the CPU twin of the on-card fuzz (``hwcert.py``)."""
    from lanczos_tpu.ops.resample_pallas import PallasOps, resample_2d_pallas

    rng = np.random.default_rng(7000 + seed)
    cfg = _random_cfg(rng)
    img = rng.integers(0, 256, size=(*cfg.in_shape, 3), dtype=np.uint8)
    try:
        ops = PallasOps(cfg, interpret=True)
    except NotImplementedError:
        return  # no feasible plan (e.g. drop-edge dering)
    out = np.asarray(resample_2d_pallas(img, ops))
    ref = np.asarray(Upscaler(cfg, backend="xla")(img))
    diff = np.abs(ref.astype(int) - out.astype(int))
    assert diff.max() <= 1, f"seed {seed} cfg {cfg}: max diff {diff.max()}"


@pytest.mark.parametrize("seed", range(8))
def test_sharded_overlap_matches_serial_random_config(seed):
    """The interior/boundary halo-overlap structure (round 4) vs the
    serial exchange-then-compute path, across random configs and mesh
    shapes — both must be bit-identical everywhere."""
    import jax

    from lanczos_tpu.parallel.sharded import ShardedUpscaler

    rng = np.random.default_rng(3000 + seed)
    n, d = SCALES[rng.integers(len(SCALES))]
    R = int(rng.choice([2, 4]))
    h = int(rng.integers(2, 5)) * d * n * R * 2
    w = int(rng.integers(2, 5)) * d * 2
    a = int(rng.integers(2, 4))
    cfg = ResampleConfig.from_profile(
        Profile.PRECISE, (h, w), scale=(n, d), a=a,
        align="center" if rng.integers(2) else "zero",
        edge_mode=EDGES[rng.integers(2)],  # clamp/drop
        dering=bool(rng.integers(2)),
        normalize=True,
    )
    img = rng.integers(0, 256, size=(2, h, w, 3), dtype=np.uint8)
    mesh = jax.make_mesh((2, R), ("data", "rows"))
    for backend in ("gather", "auto"):
        a_out = np.asarray(
            ShardedUpscaler(cfg, mesh, backend=backend)(img)
        )
        b_out = np.asarray(
            ShardedUpscaler(cfg, mesh, backend=backend, overlap=False)(img)
        )
        np.testing.assert_array_equal(
            a_out, b_out, err_msg=f"seed {seed} backend {backend}"
        )
