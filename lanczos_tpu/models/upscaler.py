"""High-level upscaler pipelines (the framework's "model" layer).

An :class:`Upscaler` owns, for one static :class:`ResampleConfig`:
host-precomputed weight/index tables, a jitted forward function, and a
backend choice.  It is the JAX counterpart of the reference's synthesized
``lanczos()`` top function (``lanczos.cpp:86-98``) — where the reference
bakes one (dims, scale, a, precision) combination per bitstream via
``params.h``, here each config is one jit cache entry.

Backends (``"auto"`` picks per platform in :mod:`lanczos_tpu.platform`):
- ``"pallas"``: the fused Pallas kernel for Hopper (ops/resample_pallas.py):
  both passes as dense bf16-split tensor-core dots, covering ANY float
  config whose plan exists — integer/rational scales, antialiased
  downscales, drop+normalize, dering, quantized intermediates.  Runs in
  interpret mode on the CPU (tests).
- ``"shift_xla"``: strided shift-FMA (plain XLA; needs N ≤ 32 phases).
- ``"block"``: blocked banded matmul (ops/resample_block_xla.py) — any
  linear config, any N/D; the plain-XLA fallback when shift is ineligible.
- ``"xla"``: gather-based separable passes (ops/resample_xla.py) — the
  portable reference path, also used for HLS-faithful fixed point.
- ``"c_exact"``: bit-exact fp64-emulating integer path for c_faithful.
- ``"ref"``: NumPy oracle on host (testing only).
"""

from __future__ import annotations

import collections
import functools
import threading
from collections import OrderedDict
from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from lanczos_tpu import platform
from lanczos_tpu.core.config import (
    EdgeMode,
    Order,
    Precision,
    Profile,
    ResampleConfig,
)
from lanczos_tpu.ops.fixed_point import HLSOps, hls_upscale_xla
from lanczos_tpu.ops.resample_xla import SeparableOps, resample_2d_xla


def _shift_eligible(cfg: ResampleConfig) -> bool:
    """Whether the strided shift-FMA XLA path covers this config.

    It is the fastest non-Pallas single-chip path (XLA fuses each pass into one
    loop); needs float precision, no c-faithful quirk, phase counts within
    the unroll budget, and D-divisible input dims.
    """
    from lanczos_tpu.ops.resample_shift_xla import MAX_PHASES

    if cfg.precision == Precision.FIXED or cfg.c_faithful:
        return False
    if cfg.intermediate_quantize:
        return False
    if cfg.edge_mode == EdgeMode.DROP and (cfg.normalize or cfg.dering):
        # drop-edge + normalization renormalizes over the surviving taps
        # per row, and drop-edge dering clamps against edge-clamped tap
        # VALUES — neither is expressible as zero padding + phase-uniform
        # weights
        return False
    if cfg.order == Order.WIDTH_FIRST and cfg.dering:
        # the shift path is height-first; with the (nonlinear) dering
        # clamp the pass order is observable — keep the gather path
        return False
    (nv, dv), (nh, dh) = cfg.scale_h, cfg.scale_w
    if nv > MAX_PHASES or nh > MAX_PHASES:
        return False
    return cfg.in_shape[0] % dv == 0 and cfg.in_shape[1] % dh == 0


def _block_eligible(cfg: ResampleConfig) -> bool:
    """Whether the blocked banded-matmul path covers this config.

    Any *linear* float config qualifies (edge modes, drop+normalize,
    dering-on-top, arbitrary N/D) — it replaces the per-tap gather path as
    the fallback for everything except the fixed-point and c-faithful
    semantics, at ~5-15x the gather throughput (round-1 verdict items 3-4).
    """
    return cfg.precision != Precision.FIXED and not cfg.c_faithful


def _pallas_eligible(cfg: ResampleConfig) -> bool:
    """Whether the fused Pallas kernel (ops/resample_pallas.py) covers this
    config: any float config whose plan exists — integer and rational
    scales, antialiased downscales, drop+normalize, and the fused
    nonlinearities (dering clamp, uint8-quantized intermediate; width-first
    ones through the transposed-image kernel).  Whether ``auto`` uses it
    on this platform is :func:`lanczos_tpu.platform.auto_backend`'s call."""
    if cfg.precision == Precision.FIXED or cfg.c_faithful:
        return False
    from lanczos_tpu.ops.resample_pallas import _mxu_plan, transposed_cfg

    if _mxu_plan(cfg) is not None:
        return True
    return (
        cfg.order == Order.WIDTH_FIRST
        and (cfg.dering or cfg.intermediate_quantize)
        and _mxu_plan(transposed_cfg(cfg)) is not None
    )


class Upscaler:
    def __init__(
        self,
        cfg: ResampleConfig,
        backend: str = "auto",
        dtype=jnp.float32,
    ):
        self.cfg = cfg
        if backend == "auto":
            backend = platform.auto_backend(cfg)
        self.backend = backend
        self.dtype = jnp.bfloat16 if cfg.precision == Precision.BF16 else dtype

        if backend == "ref":
            self._ops = None
            self._fn = self._ref_forward
        elif cfg.c_faithful and backend in ("auto", "xla", "c_exact"):
            # bit-exact integer-lattice emulation of the reference's fp64
            # sequential arithmetic (ops/c_exact.py); an fp32 gather path
            # CANNOT reproduce the oracle's truncations for a != 2
            from lanczos_tpu.ops.c_exact import CExactOps

            self.backend = "c_exact"
            self._ops = CExactOps(cfg)
            self._fn = self._ops  # jits + scopes x64 internally
        elif cfg.precision == Precision.FIXED:
            self._ops = HLSOps.build(cfg)
            self._fn = jax.jit(partial(hls_upscale_xla, ops=self._ops))
        elif backend == "shift_xla":
            from lanczos_tpu.ops.resample_shift_xla import (
                ShiftOps,
                resample_2d_shift_xla,
            )

            self._ops = ShiftOps(cfg, self.dtype)
            self._fn = jax.jit(partial(resample_2d_shift_xla, ops=self._ops))
        elif backend == "xla":
            self._ops = SeparableOps(cfg, self.dtype)
            self._fn = jax.jit(partial(resample_2d_xla, ops=self._ops))
        elif backend == "block":
            from lanczos_tpu.ops.resample_block_xla import (
                BlockOps,
                resample_2d_block,
            )

            self._ops = BlockOps(cfg, self.dtype)
            self._fn = jax.jit(partial(resample_2d_block, ops=self._ops))
        elif backend == "pallas":
            from lanczos_tpu.ops.resample_pallas import PallasOps, resample_2d_pallas

            self._ops = PallasOps(cfg, self.dtype)
            self._fn = jax.jit(partial(resample_2d_pallas, ops=self._ops))
        else:
            raise ValueError(f"unknown backend {backend!r}")

    def _ref_forward(self, img):
        from lanczos_tpu.ref.oracle import c_oracle_upscale, clean_resample_2d

        img = np.asarray(img)
        if img.ndim > 3:  # (..., H, W, C): oracle is single-image — loop
            lead = img.shape[:-3]
            flat = img.reshape((-1,) + img.shape[-3:])
            outs = np.stack([self._ref_forward(f) for f in flat])
            return outs.reshape(lead + outs.shape[1:])
        oh, ow = self.cfg.out_shape
        if self.cfg.precision == Precision.FIXED:
            from lanczos_tpu.ref.hls_sim import hls_stream_upscale

            return hls_stream_upscale(
                img, oh, ow, self.cfg.a, self.cfg.bit_precision
            )
        if self.cfg.c_faithful:
            return c_oracle_upscale(img, oh, ow, self.cfg.a)
        return clean_resample_2d(img, self.cfg)

    def __call__(self, img) -> jnp.ndarray:
        """img: (H, W, C) or (..., H, W, C); dims must match the config.

        dtype contract: uint8 → uint8 (the reference's trunc-clip byte
        cast); uint16 (e.g. from ``io.decode_image_16``) → uint16 via the
        same semantics at 16-bit width; float → float, linear and
        unclipped."""
        if img.shape[-3:-1] != tuple(self.cfg.in_shape):
            raise ValueError(
                f"image spatial dims {img.shape[-3:-1]} != config {self.cfg.in_shape}"
            )
        if img.dtype in (jnp.uint16, np.uint16):
            # the backends' integer path quantizes to the uint8 range (the
            # reference's clamp_to_byte); at 16-bit width run the float
            # path and apply the same trunc-clip against 65535
            if self.cfg.precision == Precision.FIXED or self.cfg.c_faithful:
                # (covers the c_exact backend too, which implies c_faithful;
                # the ref backend under PRECISE is dtype-agnostic floats and
                # satisfies the contract below)
                raise ValueError(
                    "uint16 input is not defined for the bit-exact uint8 "
                    "semantics profiles (hls/c_oracle); convert explicitly"
                )
            fn = (
                self._float_fallback_fn
                if self.backend == "pallas"
                else self._fn
            )
            y = fn(jnp.asarray(img, jnp.float32))
            return jnp.trunc(jnp.clip(y, 0.0, 65535.0)).astype(jnp.uint16)
        if self.backend == "pallas" and img.dtype not in (
            jnp.uint8,
            np.uint8,
        ):
            # the fused kernel is uint8→uint8 by design; quantizing a
            # float input would silently diverge from the float-in/
            # float-out contract the other backends honor
            return self._float_fallback_fn(img)
        return self._fn(img)

    @functools.cached_property
    def _float_fallback_fn(self):
        from lanczos_tpu.ops.resample_block_xla import (
            BlockOps,
            resample_2d_block,
        )

        if _shift_eligible(self.cfg):
            from lanczos_tpu.ops.resample_shift_xla import (
                ShiftOps,
                resample_2d_shift_xla,
            )

            ops = ShiftOps(self.cfg, self.dtype)
            return jax.jit(partial(resample_2d_shift_xla, ops=ops))
        ops = BlockOps(self.cfg, self.dtype)
        return jax.jit(partial(resample_2d_block, ops=ops))

    def planar(self, img) -> jnp.ndarray:
        """Planar fast path: (C, H, W) or (B, C, H, W) uint8 → same rank.

        Skips the interleaved↔planar transposes — the preferred layout for
        throughput pipelines (width is the minor dim end to end).
        Supported by the pallas and shift backends; other backends go
        through the interleaved path transparently."""
        if img.shape[-2:] != tuple(self.cfg.in_shape):
            raise ValueError(
                f"image spatial dims {img.shape[-2:]} != config {self.cfg.in_shape}"
            )
        if img.dtype not in (jnp.uint8, np.uint8):
            # uint16 / float planes take the dtype contract in __call__
            # (the pallas planar kernel is uint8-native)
            moved = jnp.moveaxis(img, -3, -1)
            return jnp.moveaxis(self(moved), -1, -3)
        fn = self._planar_fn
        if fn is not None:
            return fn(img)
        moved = jnp.moveaxis(img, -3, -1)
        return jnp.moveaxis(self._fn(moved), -1, -3)

    @functools.cached_property
    def _planar_fn(self):
        # built once: a fresh jax.jit(partial(...)) per call would retrace
        # the kernel every invocation (new cache key each time)
        if self.backend == "pallas":
            from lanczos_tpu.ops.resample_pallas import upscale_planar

            return jax.jit(partial(upscale_planar, ops=self._ops))
        if self.backend == "shift_xla":
            from lanczos_tpu.ops.resample_shift_xla import (
                resample_2d_shift_xla,
            )

            return jax.jit(
                partial(resample_2d_shift_xla, ops=self._ops, channel_last=False)
            )
        return None

    @property
    def jitted(self):
        return self._fn


def _device_table_bytes(model: Upscaler) -> int:
    """Estimate a compiled Upscaler's device-table footprint: every
    jax/NumPy array reachable from its ops/plan objects (weight stacks,
    bf16 splits, index maps).  Host NumPy tables count too — they become
    device-resident jit constants at trace time."""
    seen: set[int] = set()
    total = 0
    stack: list = [model]
    while stack:
        obj = stack.pop()
        if id(obj) in seen:
            continue
        seen.add(id(obj))
        if isinstance(obj, (jax.Array, np.ndarray)):
            total += obj.nbytes
        elif isinstance(obj, (list, tuple)):
            stack.extend(obj)
        elif isinstance(obj, dict):
            stack.extend(obj.values())
        elif type(obj).__module__.startswith("lanczos_tpu") and hasattr(
            obj, "__dict__"
        ):
            stack.extend(vars(obj).values())
    return total


class _UpscalerCache:
    """(cfg, backend) → compiled :class:`Upscaler`, LRU-evicted by TOTAL
    estimated device-table bytes as well as entry count.

    A fresh instance per call would rebuild the host weight tables and
    retrace the jit every time (~1 s on CPU plus a device compile), so
    caching is load-bearing — but each entry pins
    multi-MB device weight stacks, and a plain ``lru_cache(64)`` could
    quietly hold hundreds of MB of HBM in a long-lived process cycling
    configs.  ResampleConfig is a frozen dataclass, so it is its own
    cache key.  The newest entry always survives even if it alone
    exceeds ``max_bytes``."""

    def __init__(self, max_entries: int = 64, max_bytes: int = 256 << 20):
        self.max_entries = max_entries
        self.max_bytes = max_bytes
        self._data: "OrderedDict[tuple, tuple[Upscaler, int]]" = OrderedDict()
        self._bytes = 0
        self._hits = 0
        self._misses = 0
        # lru_cache (which this replaces) was thread-safe; keep that
        # contract — concurrent upscale() calls must not corrupt the
        # OrderedDict or drift the byte accounting.  Model construction
        # happens outside the lock (it can take ~1 s plus a compile).
        self._lock = threading.Lock()

    def __call__(self, cfg: ResampleConfig, backend: str) -> Upscaler:
        key = (cfg, backend)
        with self._lock:
            hit = self._data.get(key)
            if hit is not None:
                self._data.move_to_end(key)
                self._hits += 1
                return hit[0]
            self._misses += 1
        model = Upscaler(cfg, backend=backend)
        size = _device_table_bytes(model)
        with self._lock:
            race = self._data.get(key)
            if race is not None:  # another thread built it first
                self._data.move_to_end(key)
                return race[0]
            self._data[key] = (model, size)
            self._bytes += size
            while len(self._data) > 1 and (
                len(self._data) > self.max_entries
                or self._bytes > self.max_bytes
            ):
                _, (_, evicted) = self._data.popitem(last=False)
                self._bytes -= evicted
        return model

    def cache_clear(self) -> None:
        with self._lock:
            self._data.clear()
            self._bytes = 0
            self._hits = self._misses = 0

    def cache_info(self):
        with self._lock:
            return _CacheInfo(
                self._hits, self._misses, self.max_entries,
                len(self._data), self._bytes,
            )


_CacheInfo = collections.namedtuple(
    "CacheInfo", ["hits", "misses", "maxsize", "currsize", "currbytes"]
)

_cached_upscaler = _UpscalerCache()


def upscale(
    img,
    scale: Optional[Tuple[int, int]] = None,
    out_shape: Optional[Tuple[int, int]] = None,
    profile: Profile | str = Profile.PRECISE,
    a: int = 3,
    backend: str = "auto",
    mesh=None,
    **overrides,
) -> jnp.ndarray:
    """One-shot functional API: upscale (…, H, W, C) by N/D or to out_shape.

    A bare 2-D (H, W) image is treated as single-channel grayscale (the
    behavior of the reference's stb loader with ``req_comp=1``) and
    returned 2-D.  Repeat calls with the same (config, backend) reuse one
    compiled :class:`Upscaler` (LRU of 64).

    ``mesh``: run row+batch sharded on a (data × rows) mesh via
    :class:`~lanczos_tpu.parallel.sharded.ShardedUpscaler` (input must be
    batched (B, H, W, C) with B divisible by the data-axis size)."""
    gray2d = getattr(img, "ndim", 0) == 2
    if gray2d:
        img = img[..., None]
    h, w = img.shape[-3], img.shape[-2]
    cfg = ResampleConfig.from_profile(
        profile, (h, w), out_shape=out_shape, scale=scale, a=a, **overrides
    )
    if mesh is not None:
        from lanczos_tpu.parallel.sharded import ShardedUpscaler

        out = ShardedUpscaler(cfg, mesh, backend=backend)(img)
        return out[..., 0] if gray2d else out
    out = _cached_upscaler(cfg, backend)(img)
    return out[..., 0] if gray2d else out
