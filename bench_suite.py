"""Extended benchmark suite on the card: one row per config.

  1. 256×256→512×512 a=2 (reference's own test size)
  2. 1080p→4K a=3, single frame
  3. batch-32 1080p→4K
  4. 4K→8K a=3 (the headline; bench.py compares formulations there)
  5. 4K→8K+1px (large-N rational), drop+normalize, drop-edge dering and
     width-first quantized intermediate at 4K→8K
  6. streaming 4K→8K row-chunked (bounded-memory mode)

Usage: python bench_suite.py [--backend auto|xla|pallas] [--iters N]
                             [--mesh R] [--frames N] [--bf16]
Prints one JSON line per row, each naming the device and the card's
power limit, plus a human line to stderr.  Refuses to run without a GPU.

``--mesh R`` adds the row-partitioned config: a (data × R) mesh running
ShardedUpscaler, reporting scaling efficiency vs the single-card
throughput measured in the same process (``--mesh 4`` on four cards).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

_ID: dict = {}


def run_case(name, fn, in_shape, out_shape, iters, extra=None):
    from lanczos_tpu.utils.profiling import chip_spec, time_fn

    dt = time_fn(fn, iters=iters, reps=3)
    bw, _ = chip_spec()
    batch = extra.get("batch", 1) if extra else 1
    out_mpix = batch * out_shape[0] * out_shape[1] / 1e6
    min_bytes = batch * 3 * (
        in_shape[0] * in_shape[1] + out_shape[0] * out_shape[1]
    )
    roof = out_mpix / (min_bytes / bw)
    row = {
        "metric": name,
        "value": out_mpix / dt,
        "unit": "Mpix/s",
        "roofline_share": out_mpix / dt / roof,
        **_ID,
    }
    print(json.dumps(row))
    print(f"# {name}: {dt*1e3:.3f} ms  roofline {roof:.0f} Mpix/s", file=sys.stderr)
    return row


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--backend", default="auto")
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--mesh", type=int, default=0, metavar="R",
                    help="add a row-sharded config over a (data x R) mesh")
    ap.add_argument("--frames", type=int, default=0, metavar="N",
                    help="with --mesh: add the multi-card video-streaming "
                         "row (N frames through the (data x R) mesh)")
    ap.add_argument("--bf16", action="store_true",
                    help="add a Precision.BF16 4K->8K row")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from lanczos_tpu import platform
    from lanczos_tpu.utils.profiling import gpu_name_and_power, require_gpu

    _ID["device"] = require_gpu()
    _ID["card"] = gpu_name_and_power()
    platform.enable_compile_cache()

    from lanczos_tpu.core.config import Profile, ResampleConfig
    from lanczos_tpu.models.upscaler import Upscaler
    from lanczos_tpu.models.streaming import StreamingUpscaler

    rng = np.random.default_rng(0)

    def img(h, w, b=None):
        shape = (b, h, w, 3) if b else (h, w, 3)
        return jnp.asarray(rng.integers(0, 256, size=shape, dtype=np.uint8))

    cases = [
        ("256x256->512x512_a2", (256, 256), (512, 512), 2, None),
        ("1080p->4K_a3", (1080, 1920), (2160, 3840), 3, None),
        ("batch32_1080p->4K_a3", (1080, 1920), (2160, 3840), 3, 32),
        ("4K->8K_a3", (2160, 3840), (4320, 7680), 3, None),
        # prime-ish arbitrary scale (N=4321/7681) — exercises the
        # generalized per-block plans (shift-FMA caps at 32 phases)
        ("4K->8K+1px_a3_largeN", (2160, 3840), (4321, 7681), 3, None),
        # drop+normalize — per-row renormalized weights in the fused kernel
        ("4K->8K_a3_dropnorm", (2160, 3840), (4320, 7680), 3, None),
        # drop-edge dering (one-hot bounds use the operator's clipped
        # indices)
        ("4K->8K_a3_dropdering", (2160, 3840), (4320, 7680), 3, None),
        # width-first quantized intermediate — transposed-kernel
        # delegation
        ("4K->8K_a3_wf_quant", (2160, 3840), (4320, 7680), 3, None),
    ]
    for name, ins, outs, a, batch in cases:
        kw = {}
        if "dropnorm" in name:
            from lanczos_tpu.core.config import EdgeMode

            kw = dict(edge_mode=EdgeMode.DROP, normalize=True)
        elif "dropdering" in name:
            from lanczos_tpu.core.config import EdgeMode

            kw = dict(edge_mode=EdgeMode.DROP, normalize=False, dering=True)
        elif "wf_quant" in name:
            from lanczos_tpu.core.config import Order

            kw = dict(order=Order.WIDTH_FIRST, intermediate_quantize=True)
        cfg = ResampleConfig.from_profile(
            Profile.PRECISE, ins, out_shape=outs, a=a, **kw
        )
        model = Upscaler(cfg, backend=args.backend)
        x = img(*ins, batch)
        run_case(
            name, lambda m=model, x=x: m(x), ins, outs, args.iters,
            {"batch": batch or 1},
        )
        if batch and model.backend in ("pallas", "shift_xla"):
            # the planar layout (no interleave transposes) — the
            # throughput-pipeline number; only labeled planar when the
            # backend has a native planar path
            xp = jnp.transpose(x, (0, 3, 1, 2))
            run_case(
                name + "_planar", lambda m=model, x=xp: m.planar(x),
                ins, outs, args.iters, {"batch": batch},
            )

    if args.bf16:
        from lanczos_tpu.core.config import Precision

        ins, outs = (2160, 3840), (4320, 7680)
        cfg = ResampleConfig.from_profile(
            Profile.PRECISE, ins, out_shape=outs, a=3,
            precision=Precision.BF16,
        )
        model = Upscaler(cfg, backend=args.backend)
        x = img(*ins)
        run_case(
            f"{outs[1]}x{outs[0]}_a3_bf16", lambda: model(x), ins, outs,
            args.iters,
        )

    # streaming (bounded memory): whole-frame wrapper, host loop included
    sins, souts, schunk = (2160, 3840), (4320, 7680), 1024
    cfg = ResampleConfig.from_profile(
        Profile.PRECISE, sins, out_shape=souts, a=3
    )
    sm = StreamingUpscaler(cfg, chunk_rows=schunk)
    frame = np.asarray(img(*sins))
    t0 = time.perf_counter()
    sm(frame)
    dt0 = time.perf_counter() - t0  # includes compile
    from lanczos_tpu.utils.profiling import time_fn

    # host arrays in and out: the wrapper's own readback ends each call
    dt = time_fn(sm, frame, iters=max(1, args.iters // 3), reps=3)
    mpix = souts[0] * souts[1] / 1e6
    print(json.dumps({
        "metric": f"stream{souts[1]}x{souts[0]}_a3_chunk{schunk}",
        "value": mpix / dt,
        "unit": "Mpix/s",
        **_ID,
    }))
    print(f"# streaming: {dt*1e3:.2f} ms/frame (first {dt0*1e3:.0f} ms)",
          file=sys.stderr)

    # row-partitioned mesh config: measured scaling efficiency against the
    # single-card throughput, and the halo model at the measured link rate
    if args.mesh:
        from lanczos_tpu.parallel.multihost import (
            ici_halo_model,
            measure_ici_bw,
            scaling_efficiency,
        )
        from lanczos_tpu.parallel.sharded import ShardedUpscaler
        from lanczos_tpu.utils.profiling import time_fn

        R = args.mesh
        n_dev = len(jax.devices())
        if n_dev % R:
            sys.exit(f"--mesh {R} does not divide device count {n_dev}")
        D = n_dev // R
        ins, outs = (2160, 3840), (4320, 7680)
        cfg = ResampleConfig.from_profile(
            Profile.PRECISE, ins, out_shape=outs, a=3
        )
        single = Upscaler(cfg, backend=args.backend)
        dt1 = time_fn(single, img(*ins), iters=args.iters, reps=3)
        single_mpix_s = outs[0] * outs[1] / 1e6 / dt1

        mesh = jax.make_mesh((D, R), ("data", "rows"))
        sh = ShardedUpscaler(cfg, mesh)
        dtm = time_fn(sh, img(*ins, D), iters=args.iters, reps=3)
        total_mpix_s = D * outs[0] * outs[1] / 1e6 / dtm
        eff = scaling_efficiency(total_mpix_s, single_mpix_s, n_dev)
        row = {
            "metric": f"{outs[1]}x{outs[0]}_a3_mesh{D}x{R}",
            "value": total_mpix_s,
            "unit": "Mpix/s",
            "measured_eff": eff,
            **_ID,
        }
        if R >= 2:
            bw = measure_ici_bw(mesh, "rows")
            model = ici_halo_model(
                cfg, R, dt1, halo_bytes=sh.halo_spec()["bytes"], ici_bw=bw
            )
            row["link_GBps_per_direction"] = bw / 1e9
            row["model_eff"] = model["efficiency"]
        print(json.dumps(row))
        print(f"# mesh {D}x{R}: {dtm*1e3:.2f} ms measured (eff {eff:.3f})",
              file=sys.stderr)

        # N frames streamed through the (data x rows) mesh
        if args.frames:
            from lanczos_tpu.models.video import VideoUpscaler

            n_frames = args.frames
            video = np.stack([np.asarray(img(*ins)) for _ in range(
                min(n_frames, 8))])
            video = np.concatenate(
                [video] * (-(-n_frames // video.shape[0])))[:n_frames]
            vu = VideoUpscaler(cfg, mesh=mesh, batch=D, depth=3)
            vu(video[: vu.batch])  # compile + warm
            t0 = time.perf_counter()
            vu(video)
            # one whole-stream wall measurement: the host loop is part of
            # the pipeline being measured
            fps = n_frames / (time.perf_counter() - t0)
            print(json.dumps({
                "metric": f"video{n_frames}f_{outs[1]}x{outs[0]}_mesh{D}x{R}",
                "value": fps,
                "unit": "frames/s",
                "measured_eff": fps * dt1 / n_dev,
                **_ID,
            }))


if __name__ == "__main__":
    main()
