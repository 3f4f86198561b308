"""On-card certification: seeded config fuzz of the fused Pallas kernel
vs the gather reference, as a runnable artifact.

Reproduces the parity claims on the card with ONE command (the
reference's analog is its checked-in testbench, ``full_TB.h:99-180``):

    python hwcert.py [--seeds 40] [--seed0 0]

Each seed draws one configuration across
scales × edge modes × align × dering × quantize × order × precision ×
batch, runs the ``pallas`` backend against the ``xla`` gather reference
on the same device, and checks the agreement contract:

- fp32 linear configs: |Δ| ≤ 1 LSB;
- quantized-intermediate configs: |Δ| ≤ 2 (a truncation-boundary flip
  in the uint8 intermediate cascades through the horizontal taps on
  isolated pixels);
- bf16: |Δ| ≤ 3 LSB against the fp32 gather reference;
- fraction of differing pixels: ≤ 1% (fp32).  bf16 rounds every pixel
  through 8 mantissa bits: it carries the mid error through the
  horizontal taps and legitimately flips a large share of pixels by
  1-3 LSB, and intermediate QUANTIZE can AMPLIFY the fraction — each mid
  trunc-boundary flip from bf16 rounding becomes a full-LSB mid
  difference that spreads across the horizontal tap span.  bf16 is
  therefore bounded at ≤ 50% as the catastrophic-divergence catch; the
  semantic contract for bf16 is the ≤ 3 LSB bound.

Emits one JSON line per seed plus a summary line; exits nonzero on any
rejection.  ``--cpu-smoke`` runs a reduced sweep through the Pallas
interpreter so the script's logic is testable off the card (it is NOT the
certification).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import numpy as np


SCALES = [(2, 1), (3, 1), (4, 1), (3, 2), (5, 4), (7, 3), (1, 2), (2, 3)]
EDGES = ["clamp", "reflect", "drop"]


def draw_config(rng: np.random.Generator, cpu_smoke: bool):
    """One random certification config (+ matching input dims)."""
    from lanczos_tpu.core.config import (
        Align, EdgeMode, Order, Precision, Profile, ResampleConfig,
    )

    n, d = SCALES[rng.integers(len(SCALES))]
    a = int(rng.integers(2, 4))
    # dims: divisible by d, modest sizes (every config is a fresh
    # kernel compile)
    lo, hi = (6, 16) if cpu_smoke else (12, 48)
    h = int(rng.integers(lo, hi)) * 8
    w = int(rng.integers(lo, hi)) * 8
    h -= h % (8 * d)
    w -= w % (8 * d)
    kw = dict(
        a=a,
        edge_mode=EdgeMode(EDGES[rng.integers(len(EDGES))]),
        align=Align("center" if rng.integers(2) else "zero"),
        dering=bool(rng.integers(2)),
        intermediate_quantize=bool(rng.integers(2)),
        order=Order("width_first" if rng.integers(2) else "height_first"),
        # bf16 agreement bounds are a hardware property (the kernel's
        # f32-accumulated dots vs the gather path's bf16 chain differ more
        # in the interpreter)
        precision=(
            Precision.BF16
            if rng.integers(4) == 0 and not cpu_smoke
            else Precision.FP32
        ),
        normalize=True,
    )
    if kw["edge_mode"] == EdgeMode.DROP and not bool(rng.integers(2)):
        kw["normalize"] = False
    batch = int(rng.choice([1, 1, 4]))
    cfg = ResampleConfig.from_profile(
        Profile.PRECISE, (h, w), scale=(n, d), **kw
    )
    return cfg, batch


def tolerance(cfg) -> int:
    from lanczos_tpu.core.config import Precision

    if cfg.precision == Precision.BF16:
        return 3
    if cfg.intermediate_quantize:
        return 2
    return 1


def run_seed_exact(seed: int) -> dict:
    """Bit-exact profile certification: the device hls / c_oracle paths
    vs their host oracles (the stream-machine simulator and the
    compiled-reference-anchored fp64 oracle) — equality, not tolerance."""
    from lanczos_tpu.core.config import Profile
    from lanczos_tpu.models.upscaler import Upscaler
    from lanczos_tpu.core.config import ResampleConfig

    rng = np.random.default_rng(10_000 + seed)
    profile = Profile.HLS if seed % 2 else Profile.C_ORACLE
    n, d = [(2, 1), (3, 1), (4, 1), (3, 2)][rng.integers(4)]
    a = 2 if profile == Profile.HLS else int(rng.integers(2, 4))
    h = int(rng.integers(6, 20)) * 8  # *8 keeps h, w divisible by d
    w = int(rng.integers(6, 20)) * 8
    cfg = ResampleConfig.from_profile(profile, (h, w), scale=(n, d), a=a)
    img = rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8)

    t0 = time.time()
    got = np.asarray(Upscaler(cfg, backend="auto")(img))
    if profile == Profile.HLS:
        from lanczos_tpu.ref.hls_sim import hls_stream_upscale

        want = hls_stream_upscale(
            img, h * n // d, w * n // d, a, cfg.bit_precision
        )
    else:
        from lanczos_tpu.ref.oracle import c_oracle_upscale

        want = c_oracle_upscale(img, h * n // d, w * n // d, a)
    dt = time.time() - t0
    exact = bool(np.array_equal(got, want))
    return {
        "seed": seed,
        "ok": exact,
        "profile": profile.value,
        "scale": f"{n}/{d}",
        "in": [h, w],
        "a": a,
        "exact": exact,
        "wall_s": round(dt, 2),
    }


def run_seed(seed: int, cpu_smoke: bool, cfg=None, batch=None) -> dict:
    from lanczos_tpu.models.upscaler import Upscaler

    rng = np.random.default_rng(seed)
    if cfg is None:
        cfg, batch = draw_config(rng, cpu_smoke)
    elif batch is None:
        batch = 1
    h, w = cfg.in_shape
    img = rng.integers(0, 256, size=(batch, h, w, 3), dtype=np.uint8)
    if batch == 1:
        img = img[0]

    t0 = time.time()
    # the fused kernel (interpret mode under --cpu-smoke, compiled on the
    # card); configs whose plan is infeasible are reported as skipped
    import functools

    import jax
    import jax.numpy as jnp

    from lanczos_tpu.ops.resample_pallas import PallasOps, resample_2d_pallas

    try:
        ops = PallasOps(cfg)
    except NotImplementedError as e:
        return {"seed": seed, "ok": True, "skipped": str(e)[:80]}
    fn = jax.jit(functools.partial(resample_2d_pallas, ops=ops))
    got = np.asarray(fn(jnp.asarray(img)))
    from lanczos_tpu.core.config import Precision

    # bf16 is held to the fp32 gather reference: the gather path's own
    # bf16 chain rounds every op and sits up to ~7 LSB from fp32, while
    # the kernel's bf16 dots accumulate in f32
    ref_cfg = dataclasses.replace(cfg, precision=Precision.FP32)
    ref = np.asarray(Upscaler(ref_cfg, backend="xla")(img))
    dt = time.time() - t0

    diff = np.abs(got.astype(np.int32) - ref.astype(np.int32))
    tol = tolerance(cfg)
    frac = float((diff > 0).mean())
    if cfg.precision == Precision.BF16:
        # bf16 flips a large share of pixels by 1-3 LSB against fp32, and
        # mid-quantize can amplify the fraction (trunc-boundary flips
        # spread across the tap span) — see the module docstring
        frac_lim = 0.50
    else:
        frac_lim = 0.01
    ok = bool(diff.max() <= tol and frac <= frac_lim)
    return {
        "seed": seed,
        "ok": ok,
        "scale": f"{cfg.scale_h[0]}/{cfg.scale_h[1]}",
        "in": list(cfg.in_shape),
        "out": list(cfg.out_shape),
        "a": cfg.a,
        "edge": cfg.edge_mode.value,
        "align": cfg.align.value,
        "order": cfg.order.value,
        "dering": cfg.dering,
        "quantize": cfg.intermediate_quantize,
        "normalize": cfg.normalize,
        "precision": cfg.precision.value,
        "batch": batch,
        "fused": True,
        "max_diff": int(diff.max()),
        "tol": tol,
        "frac_diff": round(frac, 6),
        "wall_s": round(dt, 2),
    }


def run_seed_aniso(seed: int, cpu_smoke: bool) -> dict:
    """Anisotropic in/out shapes (round-4 verdict weak #5): distinct
    row/column rational scales through the same pallas-vs-gather
    certification contract."""
    from lanczos_tpu.core.config import (
        Align, EdgeMode, Profile, ResampleConfig,
    )

    rng = np.random.default_rng(20_000 + seed)
    n1, d1 = SCALES[rng.integers(len(SCALES))]
    n2, d2 = SCALES[rng.integers(len(SCALES))]
    while (n2, d2) == (n1, d1):
        n2, d2 = SCALES[rng.integers(len(SCALES))]
    lo, hi = (8, 14) if cpu_smoke else (12, 40)
    h = int(rng.integers(lo, hi)) * 8
    w = int(rng.integers(lo, hi)) * 8
    h -= h % (8 * d1)
    w -= w % (8 * d2)
    cfg = ResampleConfig.from_profile(
        Profile.PRECISE, (h, w),
        out_shape=(h * n1 // d1, w * n2 // d2),
        a=int(rng.integers(2, 4)),
        edge_mode=EdgeMode(EDGES[rng.integers(len(EDGES))]),
        align=Align("center" if rng.integers(2) else "zero"),
        dering=bool(rng.integers(2)),
    )
    row = run_seed(20_000 + seed, cpu_smoke, cfg=cfg, batch=1)
    row["kind"] = "aniso"
    row["scale"] = f"{n1}/{d1}x{n2}/{d2}"
    return row


def run_seed_u16(seed: int, cpu_smoke: bool) -> dict:
    """uint16 dtype-contract certification (round-4 verdict weak #5):
    the device float path + trunc-clip at 16-bit width vs the xla
    gather reference — |Δ| ≤ 1 LSB of the 16-bit range."""
    from lanczos_tpu.core.config import Profile, ResampleConfig
    from lanczos_tpu.models.upscaler import Upscaler

    rng = np.random.default_rng(30_000 + seed)
    n, d = [(2, 1), (3, 1), (3, 2), (1, 2)][rng.integers(4)]
    lo, hi = (6, 12) if cpu_smoke else (8, 24)
    h = int(rng.integers(lo, hi)) * 8
    w = int(rng.integers(lo, hi)) * 8
    h -= h % (8 * d)
    w -= w % (8 * d)
    cfg = ResampleConfig.from_profile(
        Profile.PRECISE, (h, w), scale=(n, d), a=int(rng.integers(2, 4))
    )
    img = rng.integers(0, 65536, size=(h, w, 3), dtype=np.uint16)
    t0 = time.time()
    got = np.asarray(Upscaler(cfg, backend="auto")(img))
    ref = np.asarray(Upscaler(cfg, backend="xla")(img))
    dt = time.time() - t0
    diff = np.abs(got.astype(np.int64) - ref.astype(np.int64))
    frac = float((diff > 0).mean())
    ok = bool(
        got.dtype == np.uint16 and diff.max() <= 1 and frac <= 0.01
    )
    return {
        "seed": 30_000 + seed,
        "ok": ok,
        "kind": "uint16",
        "scale": f"{n}/{d}",
        "in": [h, w],
        "a": cfg.a,
        "max_diff": int(diff.max()),
        "tol": 1,
        "frac_diff": round(frac, 6),
        "wall_s": round(dt, 2),
    }


def run_y4m_cert(cpu_smoke: bool, colorspace: str = "420p10") -> dict:
    """On-card Y4M end-to-end (round-4 verdict weak #5): a 24-frame clip
    through the plane-native device pipeline, every output plane checked
    against the fp64 NumPy CPU oracle (≤ 1 LSB of the stream's bit
    depth), output bytes hashed into the report.  ``colorspace`` covers
    the subsampling × depth matrix (420p10 default; 422p12, mono, ...)."""
    import hashlib
    import os
    import tempfile

    from lanczos_tpu.core.config import Profile, ResampleConfig
    from lanczos_tpu.io.y4m import _COLORSPACES, _split_depth, Y4MReader, write_y4m
    from lanczos_tpu.models.video import upscale_y4m
    from lanczos_tpu.ref.oracle import clean_resample_2d

    base, depth = _split_depth(colorspace)
    div = _COLORSPACES[base]
    lim = (1 << depth) - 1
    dt = np.uint8 if depth == 8 else np.uint16
    rng = np.random.default_rng(40_000)
    h, w = (32, 48) if cpu_smoke else (48, 64)
    n_frames = 8 if cpu_smoke else 24

    def draw(shape):
        return rng.integers(0, lim + 1, shape, dt)

    frames = [
        (draw((h, w)),) + (
            # Cb and Cr MUST be independent draws: identical planes would
            # blind the cert to U/V swap or crosstalk bugs (r5 review)
            (draw((h // div[0], w // div[1])),
             draw((h // div[0], w // div[1]))) if div else ()
        )
        for _ in range(n_frames)
    ]
    t0 = time.time()
    with tempfile.TemporaryDirectory() as td:
        src, dst = os.path.join(td, "s.y4m"), os.path.join(td, "o.y4m")
        write_y4m(src, frames, fps=(24, 1), colorspace=colorspace)
        upscale_y4m(src, dst, scale=(2, 1), a=3, batch=4)
        with open(dst, "rb") as f:
            digest = hashlib.sha256(f.read()).hexdigest()[:16]
        cfg_y = ResampleConfig.from_profile(
            Profile.PRECISE, (h, w), scale=(2, 1), a=3
        )
        cfg_c = ResampleConfig.from_profile(
            Profile.PRECISE, (h // div[0], w // div[1]), scale=(2, 1), a=3
        ) if div else None
        max_diff, ndiff, ntot = 0, 0, 0
        with Y4MReader(dst) as r:
            assert r.header.colorspace == colorspace, r.header.colorspace
            for k, got in enumerate(r):
                for j, plane in enumerate(got):
                    cfg = cfg_y if j == 0 else cfg_c
                    src_p = frames[k][j].astype(np.float64)[..., None]
                    want = clean_resample_2d(src_p, cfg)[..., 0]
                    want = np.trunc(np.clip(want, 0, lim)).astype(
                        plane.dtype
                    )
                    d = np.abs(
                        plane.astype(np.int64) - want.astype(np.int64)
                    )
                    max_diff = max(max_diff, int(d.max()))
                    ndiff += int((d > 0).sum())
                    ntot += d.size
    frac = ndiff / ntot
    ok = bool(max_diff <= 1 and frac <= 0.01)
    return {
        "seed": 40_000,
        "ok": ok,
        "kind": f"y4m_{colorspace}",
        "frames": n_frames,
        "in": [h, w],
        "sha256_16": digest,
        "max_diff": max_diff,
        "tol": 1,
        "frac_diff": round(frac, 6),
        "wall_s": round(time.time() - t0, 2),
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seeds", type=int, default=40)
    p.add_argument("--exact-seeds", type=int, default=8,
                   help="bit-exact hls/c_oracle profile seeds (device vs "
                        "host oracle, equality)")
    p.add_argument("--aniso-seeds", type=int, default=6,
                   help="anisotropic (distinct row/col scale) seeds")
    p.add_argument("--u16-seeds", type=int, default=6,
                   help="uint16 dtype-contract seeds")
    p.add_argument("--y4m", type=int, default=1, choices=[0, 1],
                   help="run the Y4M end-to-end certifications "
                        "(--y4m-colorspaces)")
    p.add_argument("--y4m-colorspaces", default="420p10,422p12,mono",
                   help="comma list of Y4M colorspace tags to certify")
    p.add_argument("--seed0", type=int, default=0)
    p.add_argument("--cpu-smoke", action="store_true",
                   help="reduced interpret-mode sweep for testing off the card")
    p.add_argument("--out", default=None, help="also write the report here")
    args = p.parse_args(argv)

    import jax

    from lanczos_tpu import platform

    if args.cpu_smoke:
        jax.config.update("jax_platforms", "cpu")
    on_gpu = platform.name() == "gpu"
    if not on_gpu and not args.cpu_smoke:
        print("hwcert needs the GPU (or pass --cpu-smoke)", file=sys.stderr)
        return 2
    platform.enable_compile_cache()

    rows = []
    fails = 0
    sink = open(args.out, "w") if args.out else None

    def emit(row):
        rows.append(row)
        line = json.dumps(row)
        print(line, flush=True)
        if sink:  # stream incrementally: a run cut short keeps the
            sink.write(line + "\n")  # seeds already certified
            sink.flush()

    for seed in range(args.seed0, args.seed0 + args.seeds):
        emit(run_seed(seed, args.cpu_smoke))
    for seed in range(args.exact_seeds):
        emit(run_seed_exact(seed))
    for seed in range(args.aniso_seeds):
        emit(run_seed_aniso(seed, args.cpu_smoke))
    for seed in range(args.u16_seeds):
        emit(run_seed_u16(seed, args.cpu_smoke))
    if args.y4m:
        for cs in args.y4m_colorspaces.split(","):
            emit(run_y4m_cert(args.cpu_smoke, cs.strip()))
    fails = sum(0 if r["ok"] else 1 for r in rows)
    summary = {
        "summary": True,
        "device": jax.devices()[0].device_kind,
        "mode": "cpu-smoke" if not on_gpu else "hardware",
        "seeds": len(rows),
        "passed": len(rows) - fails,
        "failed": fails,
        "fused_configs": sum(1 for r in rows if r.get("fused")),
        "exact_profiles": sum(1 for r in rows if "exact" in r),
        "aniso": sum(1 for r in rows if r.get("kind") == "aniso"),
        "uint16": sum(1 for r in rows if r.get("kind") == "uint16"),
        "y4m": sum(1 for r in rows if str(r.get("kind", "")).startswith("y4m")),
        "skipped": sum(1 for r in rows if r.get("skipped")),
    }
    print(json.dumps(summary), flush=True)
    if sink:
        sink.write(json.dumps(summary) + "\n")
        sink.close()
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
