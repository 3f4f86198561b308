"""Timing, roofline, device identity and trace utilities.

The reference's only observability is printf + the Vivado HLS static
schedule report (SURVEY.md §5).  The equivalents here:

- :func:`time_fn` — wall-clock a jitted callable, each loop ending in
  ``block_until_ready`` (compile excluded).
- :class:`Roofline` — the analytic model the HLS latency report played:
  given a config, the minimum device-memory bytes a fused resample must
  move and the resulting upper-bound throughput on the current card.
- :func:`device_line` / :func:`require_gpu` — what every measurement
  prints and checks: platform, device kind and count, the card's name and
  power limit.
- :func:`trace` — context manager around ``jax.profiler``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import subprocess
import time
from typing import Callable

import jax

from lanczos_tpu.core.config import ResampleConfig

# Peak device-memory bandwidth (bytes/s) and dense bf16 tensor-core FLOP/s
# by device-kind substring — NVIDIA H100 SXM data sheet (3.35 TB/s HBM3,
# 989 TFLOP/s bf16 dense, at the full 700 W power limit).  The single
# source of chip-spec truth: a device not listed here is an error.
CHIP_SPECS = {
    "h100": (3.35e12, 989e12),
}


def chip_spec(device=None):
    """(peak bytes/s, peak bf16 FLOP/s) of ``device`` (default: the first
    JAX device); raises ``KeyError`` for a device not in CHIP_SPECS."""
    device = device or jax.devices()[0]
    kind = getattr(device, "device_kind", "").lower()
    for key, spec in CHIP_SPECS.items():
        if key in kind:
            return spec
    raise KeyError(f"no peak rates known for device kind {kind!r}")


def time_fn(
    fn: Callable, *args, iters: int = 10, warmup: int = 1, reps: int = 1
) -> float:
    """Seconds per call of a device function: the median over ``reps`` of
    the mean of ``iters`` back-to-back calls, each loop ending in
    ``block_until_ready`` (JAX dispatch is asynchronous: a loop that does
    not wait measures the enqueue).  ``warmup`` calls (compilation
    included) run first and are not timed."""
    out = None
    for _ in range(warmup):
        out = fn(*args)
    jax.block_until_ready(out)
    samples = []
    for _ in range(max(1, reps)):
        t0 = time.perf_counter()
        for _ in range(iters):
            out = fn(*args)
        jax.block_until_ready(out)
        samples.append((time.perf_counter() - t0) / iters)
    samples.sort()
    return samples[len(samples) // 2]


def gpu_name_and_power() -> str:
    """The card's name and power limit as ``nvidia-smi`` reports them
    (``"NVIDIA H100 80GB HBM3, 700.00 W"``); one line per card."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


def device_info() -> dict:
    """The device as JAX reports it — the keys every result carries."""
    devs = jax.devices()
    return {
        "platform": devs[0].platform,
        "kind": devs[0].device_kind,
        "count": len(devs),
    }


def require_gpu() -> dict:
    """The :func:`device_info` of the card, or ``SystemExit`` when JAX
    finds no GPU: a measurement never falls back to the CPU."""
    try:
        info = device_info()
    except RuntimeError as e:  # JAX_PLATFORMS names a platform not present
        raise SystemExit(f"no GPU: {e}") from e
    if info["platform"] != "gpu":
        raise SystemExit(
            f"no GPU: JAX runs on {info['platform']!r} — measurements need "
            "the card"
        )
    return info


@dataclasses.dataclass
class Roofline:
    """Minimum-traffic roofline for a fused uint8→uint8 2D resample."""

    cfg: ResampleConfig
    hbm_bytes: int  # minimal device-memory traffic per frame
    flops: int  # useful banded FLOPs (2a taps per output of each pass)
    bw: float  # card memory bandwidth
    peak_flops: float

    @classmethod
    def for_config(
        cls, cfg: ResampleConfig, device=None, batch: int = 1
    ) -> "Roofline":
        (ih, iw), (oh, ow) = cfg.in_shape, cfg.out_shape
        c = cfg.channels
        bw, pk = chip_spec(device)
        bytes_min = batch * c * (ih * iw + oh * ow)  # uint8 in + out, once
        # useful banded MACs: every output element of each separable pass
        # touches 2a taps (height-first: vertical emits oh×iw, horizontal
        # oh×ow)
        taps = 2 * cfg.a
        flops = batch * c * 2 * taps * (oh * iw + oh * ow)
        return cls(cfg, bytes_min, int(flops), bw, pk)

    @property
    def min_seconds(self) -> float:
        return max(self.hbm_bytes / self.bw, self.flops / self.peak_flops)

    def mpix_per_s(self) -> float:
        oh, ow = self.cfg.out_shape
        return oh * ow / 1e6 / self.min_seconds

    def fraction(self, measured_seconds: float) -> float:
        return self.min_seconds / measured_seconds


@contextlib.contextmanager
def trace(logdir: str):
    """jax.profiler trace context (view with TensorBoard / xprof)."""
    jax.profiler.start_trace(logdir)
    try:
        yield logdir
    finally:
        jax.profiler.stop_trace()
