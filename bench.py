"""Headline benchmark: 4K→8K Lanczos-3 upscale on one card, fused kernel
against the plain-XLA formulations.

For each config (by default fp32, bf16, dering) it times every formulation that
covers it — the fused Pallas kernel (``pallas``), ``shift_xla`` and
``block`` — on the same batch-4 planar uint8 input, each call ending in
``block_until_ready``, and prints one JSON line per (config, formulation):

    {"metric": "4K->7680x4320_a3_fp32", "backend": "pallas", "ms_per_frame": ...,
     "mpix_s": ..., "roofline_share": ..., "device": {...}, "card": "..."}

``roofline_share`` is the uint8 traffic floor (read the input once, write
the output once, at the card's published bandwidth) over the measured
time.  The last line is the headline: the formulation ``auto`` picks at
fp32.  Refuses to run without a GPU.

    python bench.py [--iters 20] [--reps 5] [--configs fp32,bf16,dering]

``--configs`` also takes the nonlinear and odd-scale configs (dropnorm,
dropdering, wf_quant, largeN, down2).
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

IN_SHAPE, OUT_SHAPE, A, BATCH = (2160, 3840), (4320, 7680), 3, 4
# name -> (output shape, config overrides); the first three run by default
CONFIGS = {
    "fp32": (OUT_SHAPE, {}),
    "bf16": (OUT_SHAPE, {"precision": "bf16"}),
    "dering": (OUT_SHAPE, {"dering": True}),
    "dropnorm": (OUT_SHAPE, {"edge_mode": "drop", "normalize": True}),
    "dropdering": (OUT_SHAPE, {"edge_mode": "drop", "normalize": False,
                               "dering": True}),
    "wf_quant": (OUT_SHAPE, {"order": "width_first",
                             "intermediate_quantize": True}),
    "largeN": ((4321, 7681), {}),
    "down2": ((1080, 1920), {}),
}
DEFAULT_CONFIGS = "fp32,bf16,dering"


def planar_fn(cfg, backend):
    """jitted (B, C, H, W) uint8 → (B, C, OH, OW) uint8 for one formulation
    (``block`` is channel-last: a trailing unit axis makes the planes its
    (H, W, 1) images, with no transpose)."""
    import jax

    if backend == "pallas":
        from lanczos_tpu.ops.resample_pallas import PallasOps, upscale_planar

        ops = PallasOps(cfg)
        return jax.jit(lambda x: upscale_planar(x, ops))
    if backend == "shift_xla":
        from lanczos_tpu.ops.resample_shift_xla import (
            ShiftOps,
            resample_2d_shift_xla,
        )

        ops = ShiftOps(cfg)
        return jax.jit(
            lambda x: resample_2d_shift_xla(x, ops, channel_last=False)
        )
    if backend == "block":
        from lanczos_tpu.ops.resample_block_xla import (
            BlockOps,
            resample_2d_block,
        )

        ops = BlockOps(cfg)
        return jax.jit(lambda x: resample_2d_block(x[..., None], ops)[..., 0])
    raise ValueError(backend)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--reps", type=int, default=5)
    p.add_argument("--configs", default=DEFAULT_CONFIGS,
                   help=f"comma list of {', '.join(CONFIGS)}")
    args = p.parse_args(argv)

    from lanczos_tpu import platform
    from lanczos_tpu.utils.profiling import (
        Roofline,
        gpu_name_and_power,
        require_gpu,
        time_fn,
    )

    device = require_gpu()
    platform.enable_compile_cache()
    card = gpu_name_and_power()
    print(card, flush=True)

    import jax.numpy as jnp

    from lanczos_tpu.core.config import Profile, ResampleConfig
    from lanczos_tpu.models.upscaler import _block_eligible, _shift_eligible

    rng = np.random.default_rng(0)
    x = jnp.asarray(
        rng.integers(0, 256, size=(BATCH, 3, *IN_SHAPE), dtype=np.uint8)
    )
    headline = None
    for name in args.configs.split(","):
        out_shape, kw = CONFIGS[name]
        cfg = ResampleConfig.from_profile(
            Profile.PRECISE, IN_SHAPE, out_shape=out_shape, a=A, **kw
        )
        out_mpix = out_shape[0] * out_shape[1] / 1e6
        roof = Roofline.for_config(cfg)
        auto = platform.auto_backend(cfg)
        backends = ["pallas"]
        if _shift_eligible(cfg):
            backends.append("shift_xla")
        if _block_eligible(cfg):
            backends.append("block")
        for backend in backends:
            fn = planar_fn(cfg, backend)
            dt = time_fn(fn, x, iters=args.iters, reps=args.reps) / BATCH
            row = {
                "metric": f"4K->{out_shape[1]}x{out_shape[0]}_a{A}_{name}",
                "backend": backend,
                "auto": backend == auto,
                "batch": BATCH,
                "ms_per_frame": dt * 1e3,
                "mpix_s": out_mpix / dt,
                "roofline_share": roof.fraction(dt),
                "device": device,
                "card": card,
            }
            print(json.dumps(row), flush=True)
            if name == "fp32" and backend == auto:
                headline = row
    if headline is not None:
        print(json.dumps(headline))
    return 0


if __name__ == "__main__":
    sys.exit(main())
