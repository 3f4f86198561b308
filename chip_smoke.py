"""End-to-end smoke run of the resampler on NVIDIA cards.

    python chip_smoke.py            # one card: every phase below
    python chip_smoke.py --mesh 4   # four cards: the multi-card path only

One card, through the normal entry points, at real widths:

1. ``Upscaler`` (``backend="auto"``) 4K→8K a=3, fp32 and bf16, batch 4,
   against the gather reference (``ops/resample_xla.py``);
2. the same at 1080p→4K batch 8, 4K→4321×7681 (rational, large N),
   4K→1080p antialiased and 4K→8K dering;
3. the CLI (``python -m lanczos_tpu`` entry, in this process) on a PNG,
   its output read back and its PSNR check parsed;
4. 1080p→4K 420p8 and 420p10 Y4M clips through ``upscale_y4m``;
5. a ``StreamingUpscaler`` tall frame against the whole-frame result;
6. the bit-exact ``hls`` / ``c_oracle`` profiles against their oracles;
7. a short seeded sweep of the fused kernel against gather (``hwcert.py``).

``--mesh 4`` runs only ``ShardedUpscaler`` on (1×4) and (2×2) meshes,
``ShardedStreamingUpscaler`` and ``VideoUpscaler(mesh=)``, each against
the single-card output of the same formulation (bit-identical), and the
measured ring-ppermute (NVLink) bandwidth.

Tolerances against gather: fp32 ≤ 1 LSB on ≤ 1% of pixels; quantized
intermediate ≤ 2; bf16 ≤ 3 LSB (against the fp32 reference).  Prints the
card's name and power limit first, then one line per phase (backend
``auto`` chose, max |Δ|, time); the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
Exits non-zero without printing that line when JAX finds no GPU or any
phase fails.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys
import tempfile
import time
import traceback

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))


def _devices_or_exit(count: int):
    import jax

    try:
        devs = jax.devices()
    except RuntimeError as e:  # JAX_PLATFORMS names an absent platform
        sys.exit(f"chip_smoke: no GPU ({e})")
    if devs[0].platform != "gpu":
        sys.exit(f"chip_smoke: no GPU (JAX runs on {devs[0].platform!r})")
    if len(devs) < count:
        sys.exit(f"chip_smoke: needs {count} GPUs, found {len(devs)}")
    return devs


class Phases:
    """Runs named phases; a failure is printed and fails the whole run."""

    def __init__(self):
        self.failed: list[str] = []

    def run(self, name, fn):
        t0 = time.perf_counter()
        try:
            info = fn()
        except Exception as e:  # noqa: BLE001 — reported, and fails the run
            traceback.print_exc()
            print(f"[{name}] FAILED: {e!r}", flush=True)
            self.failed.append(name)
            return
        wall = time.perf_counter() - t0
        print(f"[{name}] ok wall_s={wall:.1f} {json.dumps(info)}", flush=True)


def _diff(got, want, tol: int, frac_lim: float = 0.01) -> dict:
    """max |Δ| and differing share of two integer images; raises past the
    tolerance."""
    got, want = np.asarray(got), np.asarray(want)
    if got.shape != want.shape:
        raise AssertionError(f"shape {got.shape} != {want.shape}")
    d = np.abs(got.astype(np.int64) - want.astype(np.int64))
    out = {"max_diff": int(d.max()), "frac_diff": float((d > 0).mean())}
    if out["max_diff"] > tol or out["frac_diff"] > frac_lim:
        raise AssertionError(f"{out} beyond tolerance {tol} / {frac_lim}")
    return out


def _cfg(ins, outs, **kw):
    from lanczos_tpu.core.config import Profile, ResampleConfig

    return ResampleConfig.from_profile(
        Profile.PRECISE, ins, out_shape=outs, a=3, **kw
    )


def _frames(rng, shape, dtype=np.uint8, hi=256):
    return rng.integers(0, hi, size=shape, dtype=dtype)


def _against_gather(cfg, imgs, tol, frac_lim=0.01, ref_cfg=None):
    """Upscaler(auto) vs the gather path on ``imgs``, timed."""
    import jax

    from lanczos_tpu.models.upscaler import Upscaler
    from lanczos_tpu.utils.profiling import time_fn

    model = Upscaler(cfg)
    x = jax.device_put(imgs)
    got = np.asarray(model(x))
    ms = time_fn(model, x, iters=5, reps=3) * 1e3
    ref = np.asarray(Upscaler(ref_cfg or cfg, backend="xla")(x))
    out = {"backend": model.backend, "ms_per_call": ms}
    out.update(_diff(got, ref, tol, frac_lim))
    return out


# ---------------------------------------------------------------- one card


def phase_upscaler_4k(rng):
    imgs = _frames(rng, (4, 2160, 3840, 3))
    fp32 = _cfg((2160, 3840), (4320, 7680))
    bf16 = _cfg((2160, 3840), (4320, 7680), precision="bf16")
    return {
        "fp32": _against_gather(fp32, imgs, tol=1),
        # bf16 rounds every pixel through 8 mantissa bits: the contract is
        # the 3-LSB bound against the fp32 reference, not a pixel share
        "bf16": _against_gather(bf16, imgs, tol=3, frac_lim=1.0,
                                ref_cfg=fp32),
    }


def phase_real_widths(rng):
    return {
        "1080p->4K_b8": _against_gather(
            _cfg((1080, 1920), (2160, 3840)), _frames(rng, (8, 1080, 1920, 3)),
            tol=1,
        ),
        "4K->4321x7681": _against_gather(
            _cfg((2160, 3840), (4321, 7681)), _frames(rng, (2160, 3840, 3)),
            tol=1,
        ),
        "4K->1080p_aa": _against_gather(
            _cfg((2160, 3840), (1080, 1920)), _frames(rng, (2160, 3840, 3)),
            tol=1,
        ),
        "4K->8K_dering": _against_gather(
            _cfg((2160, 3840), (4320, 7680), dering=True),
            _frames(rng, (2160, 3840, 3)), tol=1,
        ),
    }


def _smooth_image(rng, h, w):
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([yy * 255 // (h - 1), xx * 255 // (w - 1),
                     (yy + xx) * 255 // (h + w - 2)], axis=-1)
    noise = rng.integers(-12, 13, size=base.shape)
    return np.clip(base + noise, 0, 255).astype(np.uint8)


def phase_cli_png(rng, tmp):
    import contextlib
    import io

    from lanczos_tpu import cli
    from lanczos_tpu.io import read_image, write_image
    from lanczos_tpu.models.upscaler import Upscaler

    img = _smooth_image(rng, 256, 384)
    src, dst = os.path.join(tmp, "in.png"), os.path.join(tmp, "out.png")
    write_image(src, img)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main([src, dst, "--scale", "2/1", "--a", "3"])
    text = buf.getvalue()
    if rc != 0:
        raise AssertionError(f"cli exit {rc}: {text}")
    m = re.search(r"PSNR: ([0-9.]+|inf) dB", text)
    backend = re.search(r"backend=(\w+)", text).group(1)
    psnr = float(m.group(1))
    if psnr < 30.0:
        raise AssertionError(f"CLI PSNR vs oracle {psnr} dB < 30")
    got = read_image(dst)
    ref = np.asarray(
        Upscaler(_cfg((256, 384), (512, 768)), backend="xla")(img)
    )
    out = {"backend": backend, "psnr_vs_oracle_db": psnr}
    out.update(_diff(got, ref, tol=1))
    return out


def phase_y4m(rng, tmp):
    from lanczos_tpu.io.y4m import Y4MReader, write_y4m
    from lanczos_tpu.models.upscaler import Upscaler
    from lanczos_tpu.models.video import upscale_y4m

    res = {}
    for cs, dtype, hi in (("420p8", np.uint8, 256), ("420p10", np.uint16, 1024)):
        n = 3
        frames = []
        for _ in range(n):
            y = _frames(rng, (1080, 1920), dtype, hi)
            c = (y.shape[0] // 2, y.shape[1] // 2)
            frames.append((y, _frames(rng, c, dtype, hi),
                           _frames(rng, c, dtype, hi)))
        src = os.path.join(tmp, f"{cs}.y4m")
        dst = os.path.join(tmp, f"{cs}_up.y4m")
        tag = "420" if cs == "420p8" else cs
        write_y4m(src, frames, fps=(24, 1), colorspace=tag)
        t0 = time.perf_counter()
        upscale_y4m(src, dst, scale=(2, 1), a=3, batch=3)
        wall = time.perf_counter() - t0
        refs = {}
        worst = {"max_diff": 0, "frac_diff": 0.0}
        with Y4MReader(dst) as r:
            got = list(r)
        if len(got) != n:
            raise AssertionError(f"{cs}: {len(got)} frames out, {n} in")
        for k, planes in enumerate(got):
            for j, plane in enumerate(planes):
                shp = frames[k][j].shape
                if shp not in refs:
                    refs[shp] = Upscaler(
                        _cfg(shp, (2 * shp[0], 2 * shp[1])), backend="xla"
                    )
                # the writer clips to the stream's bit depth
                want = np.minimum(
                    np.asarray(refs[shp](frames[k][j][..., None]))[..., 0],
                    hi - 1,
                )
                d = _diff(plane, want, tol=1)
                worst = {key: max(worst[key], d[key]) for key in worst}
        res[cs] = dict(worst, wall_s_incl_compile=wall)
    return res


def phase_streaming(rng):
    from lanczos_tpu.models.streaming import StreamingUpscaler
    from lanczos_tpu.models.upscaler import Upscaler

    cfg = _cfg((4320, 1920), (8640, 3840))
    frame = _frames(rng, (4320, 1920, 3))
    sm = StreamingUpscaler(cfg, chunk_rows=1024)
    t0 = time.perf_counter()
    got = sm(frame)
    wall = time.perf_counter() - t0
    whole = Upscaler(cfg)
    want = np.asarray(whole(frame))
    out = {
        "chunk_path": "fused" if sm.use_mxu else (
            "shift" if sm.use_shift else "gather"),
        "whole_frame_backend": whole.backend,
        "wall_s_incl_compile": wall,
        "bit_identical": bool(np.array_equal(got, want)),
    }
    out.update(_diff(got, want, tol=1))
    return out


def phase_exact_profiles(_rng):
    import hwcert

    rows = [hwcert.run_seed_exact(seed) for seed in range(6)]
    bad = [r for r in rows if not r["ok"]]
    if bad:
        raise AssertionError(f"not bit-exact: {bad}")
    return {"seeds": len(rows), "profiles": sorted({r["profile"] for r in rows}),
            "max_in": max(max(r["in"]) for r in rows)}


def phase_sweep(_rng):
    import hwcert

    rows = [hwcert.run_seed(seed, cpu_smoke=False) for seed in range(8)]
    rows += [hwcert.run_seed_aniso(seed, False) for seed in range(2)]
    rows += [hwcert.run_seed_u16(seed, False) for seed in range(2)]
    bad = [r for r in rows if not r["ok"]]
    if bad:
        raise AssertionError(f"rejected: {bad}")
    return {
        "seeds": len(rows),
        "skipped": sum(1 for r in rows if r.get("skipped")),
        "max_diff": max(r.get("max_diff", 0) for r in rows),
    }


# --------------------------------------------------------------- four cards


def _single_reference(cfg, sharded):
    """The single-card model of the formulation ``sharded`` runs."""
    from lanczos_tpu.models.upscaler import Upscaler

    if sharded.use_mxu:
        return Upscaler(cfg, backend="pallas")
    return Upscaler(cfg, backend="shift_xla" if sharded.use_shift else "xla")


def phase_mesh_sharded(rng, shape):
    import jax

    from lanczos_tpu.parallel.sharded import ShardedUpscaler

    data_n, rows_n = shape
    cfg = _cfg((2160, 3840), (4320, 7680))
    imgs = _frames(rng, (2 * data_n, 2160, 3840, 3))
    mesh = jax.make_mesh(shape, ("data", "rows"))
    sh = ShardedUpscaler(cfg, mesh)
    got = np.asarray(sh(imgs))
    single = _single_reference(cfg, sh)
    want = np.asarray(single(imgs))
    if not np.array_equal(got, want):
        raise AssertionError(f"not bit-identical: {_diff(got, want, 255, 1.0)}")
    from lanczos_tpu.utils.profiling import time_fn

    ms = time_fn(sh, imgs, iters=5, reps=3) * 1e3
    return {"mesh": list(shape), "formulation": single.backend,
            "bit_identical": True, "ms_per_call": ms, "batch": len(imgs)}


def phase_mesh_streaming(rng):
    import jax

    from lanczos_tpu.models.streaming import (
        ShardedStreamingUpscaler,
        StreamingUpscaler,
    )

    cfg = _cfg((4320, 1920), (8640, 3840))
    frame = _frames(rng, (4320, 1920, 3))
    mesh = jax.make_mesh((4,), ("rows",))
    ssm = ShardedStreamingUpscaler(cfg, mesh, chunk_rows=512)
    got = ssm(frame)
    want = StreamingUpscaler(cfg, chunk_rows=512)(frame)
    if not np.array_equal(got, want):
        raise AssertionError(f"not bit-identical: {_diff(got, want, 255, 1.0)}")
    return {"chunk_path": "fused" if ssm.use_mxu else "xla",
            "bit_identical": True}


def phase_mesh_video(rng):
    import jax

    from lanczos_tpu.models.video import VideoUpscaler

    cfg = _cfg((1080, 1920), (2160, 3840))
    video = _frames(rng, (9, 1080, 1920, 3))
    mesh = jax.make_mesh((2, 2), ("data", "rows"))
    vu = VideoUpscaler(cfg, mesh=mesh, batch=4)
    got = vu(video)
    single = _single_reference(cfg, vu.model)
    want = np.stack([np.asarray(single(f)) for f in video])
    if not np.array_equal(got, want):
        raise AssertionError(f"not bit-identical: {_diff(got, want, 255, 1.0)}")
    return {"frames": len(video), "formulation": single.backend,
            "bit_identical": True}


def phase_mesh_bandwidth(_rng):
    import jax

    from lanczos_tpu.parallel.multihost import measure_ici_bw

    mesh = jax.make_mesh((4,), ("rows",))
    bw = measure_ici_bw(mesh, "rows", nbytes=64 << 20, iters=10)
    return {"ring_ppermute_GBps_per_direction": bw / 1e9}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--mesh", type=int, default=0, choices=[0, 4],
                   help="run only the four-card path")
    args = p.parse_args(argv)
    count = args.mesh or 1
    devs = _devices_or_exit(count)

    from lanczos_tpu import platform
    from lanczos_tpu.utils.profiling import gpu_name_and_power

    platform.enable_compile_cache()
    print(gpu_name_and_power(), flush=True)
    rng = np.random.default_rng(0)
    ph = Phases()
    if args.mesh:
        ph.run("mesh_sharded_1x4", lambda: phase_mesh_sharded(rng, (1, 4)))
        ph.run("mesh_sharded_2x2", lambda: phase_mesh_sharded(rng, (2, 2)))
        ph.run("mesh_streaming", lambda: phase_mesh_streaming(rng))
        ph.run("mesh_video", lambda: phase_mesh_video(rng))
        ph.run("mesh_bandwidth", lambda: phase_mesh_bandwidth(rng))
    else:
        with tempfile.TemporaryDirectory(dir=ROOT, prefix=".smoke_") as tmp:
            ph.run("upscaler_4k8k", lambda: phase_upscaler_4k(rng))
            ph.run("real_widths", lambda: phase_real_widths(rng))
            ph.run("cli_png", lambda: phase_cli_png(rng, tmp))
            ph.run("y4m", lambda: phase_y4m(rng, tmp))
            ph.run("streaming", lambda: phase_streaming(rng))
            ph.run("exact_profiles", lambda: phase_exact_profiles(rng))
            ph.run("hwcert_sweep", lambda: phase_sweep(rng))
    if ph.failed:
        print(f"chip_smoke: failed phases {ph.failed}", file=sys.stderr)
        return 1
    dev = devs[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind, "count": len(devs),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
