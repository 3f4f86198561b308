"""Bit-exact device emulation of the reference's fp64 oracle (c_faithful).

The reference software path (``full_TB.h:29-96``) computes each output pixel
as a *sequential IEEE-double* tap sum, then truncates to uint8.  Two traits
make this impossible to reproduce in fp32 on device:

1. **Integer-phase rows** (output positions whose source coordinate is an
   integer): the mathematically-zero side taps are not zero in double —
   ``sin(M_PI*n)`` is ~1e-16 because ``M_PI`` is inexact (``full_TB.h:39-53``).
   For a=2 those residual weights happen to be non-negative, so the double
   sum never dips below the integer and fp32 agrees.  For a=3 they carry
   both signs: the double sum lands a few *ulp* below the central pixel's
   value on ~2% of pixels, and the truncation yields ``p-1`` where fp32
   yields ``p`` (silent 1-2 LSB error, caught by the compiled-reference
   anchor in ``tests/test_reference_compiled.py``).
2. **Fractional-phase rows**: fp32 accumulation can straddle a truncation
   boundary the double sum doesn't (rare but real at 4K scale).

This module reproduces the double semantics with *integer* arithmetic, which
accelerators execute exactly:

- Fractional rows: a fixed-point lattice.  Weights are pre-rounded to
  ``2^-50`` units (int64); the tap sum is an exact int64 dot product, and
  ``trunc(clip(...))`` is a shift.  This equals the double-sequential result
  unless the true sum lies within ~1.4e-12 of a truncation boundary
  (probability ~1e-12 per pixel — and those pixels are exactly the ones
  whose value is platform-fragile in the reference itself).
- Integer-phase rows: the residual taps are ~1e-17, far below the lattice.
  Here the double rounding *walk* around the central value ``p`` is emulated
  exactly: residual weights are pre-scaled by ``2^70`` (int64), and each
  post-center accumulation step is rounded to the IEEE grid around ``p``
  (spacing ``ulp(p) = 2^(k-52)`` above, half that below when ``p`` is a
  power of two, ties-to-even — the mantissa-parity tie rule reduces to
  multiple-parity because ``p``'s mantissa bits sit far above the grid).
  The final truncation is then ``p - 1`` iff the walk ends below ``p``
  (``p`` if the center pixel is 0).  Exact up to the 2^-71-unit weight
  quantization, which only matters on exact rounding ties.

All arithmetic is int64, jitted under a local ``jax.enable_x64`` scope so
the global fp32 default is untouched.  Validated byte-for-byte against the
*compiled* reference oracle (tests/test_reference_compiled.py) via
``ref/oracle.c_oracle_upscale``.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from lanczos_tpu.core.config import ResampleConfig
from lanczos_tpu.ref.oracle import _oracle_weights

_LATTICE = 50  # fractional-row fixed-point bits
_WALK = 70  # integer-phase residual fixed-point bits


class _AxisTables(NamedTuple):
    idx: np.ndarray  # (out, 2a) int32, clipped tap indices (static)
    w50: np.ndarray  # (out, 2a) int64, round(w * 2^50)
    w70: np.ndarray  # (out, 2a) int64, walk rows' non-center residuals * 2^70
    is_walk: np.ndarray  # (out,) bool
    center: np.ndarray  # (out,) int64, central tap position
    fix_lo: np.ndarray  # (out,) highest in-range tap index (for in-place quirk)


def _build_axis(in_size: int, out_size: int, a: int) -> _AxisTables:
    idx, w = _oracle_weights(out_size, in_size, a)
    taps = w.shape[1]
    absw = np.abs(w)
    center = absw.argmax(1)
    cw = np.take_along_axis(w, center[:, None], 1)[:, 0]
    noncenter = np.arange(taps)[None, :] != center[:, None]
    # walk regime: exact 1.0 center + all residuals below the lattice floor
    is_walk = (cw == 1.0) & ((absw < 2.0**-40) | ~noncenter).all(1)
    w50 = np.round(w * 2.0**_LATTICE).astype(np.int64)
    w70 = np.round(
        np.where(is_walk[:, None] & noncenter, w * 2.0**_WALK, 0.0)
    ).astype(np.int64)
    hi = np.minimum(in_size - 1, idx.max(1))
    return _AxisTables(
        idx.astype(np.int32), w50, w70, is_walk, center.astype(np.int64), hi
    )


def _rnd_to_grid(v, u, d):
    """Round int64 lattice value v to the IEEE grid around p: multiples of u
    (spacing above p) for v >= 0, of d (spacing below) for v < 0, ties to
    the even multiple."""
    g = jnp.where(v >= 0, u, d)
    n = v // g
    r = v - n * g
    half = g >> 1
    up = (r > half) | ((r == half) & ((n & 1) == 1))
    return (n + up.astype(v.dtype)) * g


def _grid_spacings(p):
    """(u, d) lattice spacings of the IEEE double grid around integer p>=1,
    in 2^-_WALK units: u = ulp(p) = 2^(k-52), d = u/2 iff p == 2^k."""
    k = jnp.zeros_like(p)
    for v in (2, 4, 8, 16, 32, 64, 128):
        k = k + (p >= v).astype(p.dtype)
    u = jnp.int64(1) << (k + (_WALK - 52))
    d = jnp.where((p & (p - 1)) == 0, u >> 1, u)
    return u, d


def _combine(take, tbl: _AxisTables, ex):
    """Shared tap-combine: `take(j)` yields the int64 source for tap j
    (already broadcast against trailing dims); `ex` lifts a per-row (out,)
    table column to the source's shape."""
    taps = tbl.idx.shape[1]
    w50 = jnp.asarray(tbl.w50)
    w70 = jnp.asarray(tbl.w70)
    center = jnp.asarray(tbl.center)

    acc50 = None
    for j in range(taps):
        t = ex(w50[:, j]) * take(j)
        acc50 = t if acc50 is None else acc50 + t
    frac = jnp.minimum(jnp.maximum(acc50, 0) >> _LATTICE, 255)

    # integer-phase walk
    srcs = [take(j) for j in range(taps)]
    p = srcs[0] * 0
    for j in range(taps):
        p = jnp.where(ex(center) == j, srcs[j], p)
    u, d = _grid_spacings(p)
    pre = None
    for j in range(taps):
        t = jnp.where(ex(center) > j, ex(w70[:, j]) * srcs[j], 0)
        pre = t if pre is None else pre + t
    acc = _rnd_to_grid(pre, u, d)
    for j in range(taps):
        step = _rnd_to_grid(acc + ex(w70[:, j]) * srcs[j], u, d)
        acc = jnp.where(ex(center) < j, step, acc)
    walk = jnp.where(p == 0, 0, p - (acc < 0).astype(p.dtype))

    return jnp.where(ex(jnp.asarray(tbl.is_walk)), walk, frac)


def _exact_pass_axis0(x, tbl: _AxisTables):
    """Vectorized exact pass along axis 0.  x: (in, ...) integer array."""
    xi = x.astype(jnp.int64)
    idx = jnp.asarray(tbl.idx)
    tail = (1,) * (x.ndim - 1)

    def take(j):
        return jnp.take(xi, idx[:, j], axis=0)

    def ex(col):
        return col.reshape((-1,) + tail)

    return _combine(take, tbl, ex).astype(jnp.uint8)


def _exact_single_row(y: int, srcs, tbl: _AxisTables):
    """Exact combine for one output row y given its 2a gathered sources."""
    row = _AxisTables(
        tbl.idx[y : y + 1],
        tbl.w50[y : y + 1],
        tbl.w70[y : y + 1],
        tbl.is_walk[y : y + 1],
        tbl.center[y : y + 1],
        tbl.fix_lo[y : y + 1],
    )

    def take(j):
        return srcs[j].astype(jnp.int64)

    def ex(col):  # per-row tables are scalars after [0]; broadcast handles it
        return col[0]

    return _combine(take, row, ex).astype(jnp.uint8)


class CExactOps:
    """Tables + jitted function for one c_faithful config.

    The 2D schedule mirrors ``lanczos_expected`` exactly: width pass into a
    zero-initialized (out_h, out_w) uint8 buffer, then the height pass *in
    place, bottom-up* (``full_TB.h:67-77``) — rows whose tap window reaches
    above themselves read already-final rows; they are recomputed
    sequentially (descending) after the vectorized interior pass.
    """

    def __init__(self, cfg: ResampleConfig):
        if not cfg.c_faithful:
            raise ValueError("CExactOps requires a c_faithful config")
        in_h, in_w = cfg.in_shape
        out_h, out_w = cfg.out_shape
        self.cfg = cfg
        self.tbl_h = _build_axis(in_w, out_w, cfg.a)
        self.tbl_v = _build_axis(in_h, out_h, cfg.a)
        self.fix_rows = [
            int(y)
            for y in np.nonzero(self.tbl_v.fix_lo > np.arange(out_h))[0][::-1]
        ]
        with jax.enable_x64(True):
            self._fn = jax.jit(partial(_c_exact_2d, ops=self))

    def __call__(self, img):
        with jax.enable_x64(True):
            return self._fn(img)


def _c_exact_2d(img, ops: CExactOps):
    cfg = ops.cfg
    in_h = cfg.in_shape[0]
    out_h, out_w = cfg.out_shape
    lead = img.shape[:-3]  # honor the (..., H, W, C) contract
    x = img.reshape((-1,) + img.shape[-3:])
    x = x.astype(jnp.int64)
    B, C = x.shape[0], x.shape[-1]

    # width pass (axis 2 -> axis 0)
    mid = jnp.moveaxis(
        _exact_pass_axis0(jnp.moveaxis(x, 2, 0), ops.tbl_h), 0, 2
    )  # (B, in_h, out_w, C) uint8

    # height pass over the oracle's zero-padded in-place buffer
    buf = jnp.zeros((B, out_h, out_w, C), jnp.uint8)
    buf = buf.at[:, :in_h].set(mid)
    bufT = jnp.moveaxis(buf, 1, 0)  # (out_h, B, out_w, C)
    F = _exact_pass_axis0(bufT, ops.tbl_v)  # (out_h, B, out_w, C)

    # in-place quirk rows, descending: taps above y read final rows
    idx_v = ops.tbl_v.idx
    for y in ops.fix_rows:
        srcs = [
            (F[int(i)] if int(i) > y else bufT[int(i)]) for i in idx_v[y]
        ]
        F = F.at[y].set(_exact_single_row(y, srcs, ops.tbl_v))

    out = jnp.moveaxis(F, 0, 1)
    return out.reshape(lead + out.shape[1:])
