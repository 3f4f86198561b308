"""Shift-FMA resampling in pure XLA (no gathers, no Pallas).

The reference's phase decomposition (``kernel.cpp:50-59``) for ANY
reduced rational scale N/D: output position k·N+p is
Σ_t w[p,t]·x[kD + ⌊pD/N⌋ + 1 + t] over the support-padded input — every
phase is a sum of 2·support STRIDE-D shifted slices times scalar weights
(XLA strided slices are native and fuse), and phases interleave with a
stack+reshape.  Expressed as jnp ops, XLA fuses each pass into one loop
and handles the phase interleave natively — avoiding the gather ops of
``resample_xla``.  Downscales get the stretched-kernel treatment
(support = ⌈a·D/N⌉).

This is the plain-XLA path ``auto`` picks wherever the fused Pallas kernel
does not run; the gather path covers huge-N scales (unrolling N·2·support
slices stops paying off past N ≈ 32).
"""

from __future__ import annotations


import jax
import jax.numpy as jnp
import numpy as np

from lanczos_tpu.core.config import EdgeMode, Precision, ResampleConfig
from lanczos_tpu.core.config import EdgeMode as _EdgeMode
from lanczos_tpu.core.weights import phase_table as _phase_table

# np.pad mode per edge semantics
_PAD_MODE = {
    _EdgeMode.CLAMP: "edge",
    _EdgeMode.DROP: "constant",
    _EdgeMode.REFLECT: "reflect",
}

MAX_PHASES = 32  # beyond this the unrolled slice-FMA graph stops paying off


def _axis_shift_pass(x, n, d, support, tbl, axis, dering, off=0):
    """1-D shift-FMA pass along ``axis`` of support-padded x (float).

    ``off`` is the grid-alignment numerator offset: the output coordinate
    is (2·y·d + off) / (2·n) — 0 for zero-align, d−n for center-align.
    """
    size = x.shape[axis]
    m = (size - 2 * support) // d  # output positions per phase
    taps = 2 * support

    def sl(lo):
        idx = [slice(None)] * x.ndim
        idx[axis] = slice(lo, lo + (m - 1) * d + 1, d)
        return x[tuple(idx)]

    phases = []
    for p in range(n):
        fp = (2 * p * d + off) // (2 * n)
        slices = [sl(fp + 1 + t) for t in range(taps)]
        acc = None
        for t in range(taps):
            term = float(tbl[p, t]) * slices[t]
            acc = term if acc is None else acc + term
        if dering:
            lo = jnp.minimum(slices[support - 1], slices[support])
            hi = jnp.maximum(slices[support - 1], slices[support])
            acc = jnp.clip(acc, lo, hi)
        phases.append(acc)
    if n == 1:
        return phases[0]
    stacked = jnp.stack(phases, axis=axis + 1)  # (..., m, n, ...)
    shape = list(x.shape)
    shape[axis] = m * n
    return stacked.reshape(shape)


class ShiftOps:
    """Precomputed plan for the strided XLA path (any rational scale)."""

    def __init__(self, cfg: ResampleConfig, dtype=jnp.float32):
        if cfg.precision == Precision.FIXED or cfg.c_faithful:
            raise NotImplementedError("shift path covers the float modes")
        if cfg.edge_mode == EdgeMode.DROP and (cfg.normalize or cfg.dering):
            raise NotImplementedError(
                "drop-edge with normalization or dering needs the gather "
                "path (zero padding cannot reproduce either)"
            )
        if cfg.intermediate_quantize:
            raise NotImplementedError(
                "the shift path fuses both passes; a quantized intermediate "
                "needs the gather path"
            )
        from lanczos_tpu.core.config import Order

        if cfg.order == Order.WIDTH_FIRST and cfg.dering:
            raise NotImplementedError(
                "the shift path is height-first; width-first dering is "
                "order-sensitive — use the gather path"
            )
        (ih, iw), (oh, ow) = cfg.in_shape, cfg.out_shape
        nv, dv = cfg.scale_h
        nh, dh = cfg.scale_w
        if nv > MAX_PHASES or nh > MAX_PHASES:
            raise NotImplementedError(
                f"scale phases {nv}, {nh} exceed MAX_PHASES={MAX_PHASES}; "
                "use the gather or Pallas backend"
            )
        if ih % dv or iw % dh:
            raise NotImplementedError(
                "input dims must be divisible by the scale D — use the "
                "gather, block, or Pallas backend"
            )
        self.cfg = cfg
        self.dtype = jnp.bfloat16 if cfg.precision == Precision.BF16 else dtype
        self.nv, self.dv = nv, dv
        self.nh, self.dh = nh, dh
        self.sup_v = cfg.a if nv >= dv else -(-(cfg.a * dv) // nv)
        self.sup_h = cfg.a if nh >= dh else -(-(cfg.a * dh) // nh)
        al = cfg.align.value
        self.tbl_v = _phase_table(
            nv, dv, cfg.a, self.sup_v, cfg.filter, cfg.normalize, al
        )
        self.tbl_h = _phase_table(
            nh, dh, cfg.a, self.sup_h, cfg.filter, cfg.normalize, al
        )
        self.off_v = 0 if al == "zero" else dv - nv
        self.off_h = 0 if al == "zero" else dh - nh
        self.pad_mode = _PAD_MODE[cfg.edge_mode]


def resample_2d_shift_xla(
    img: jnp.ndarray, ops: ShiftOps, channel_last: bool = True
) -> jnp.ndarray:
    """(..., H, W, C) (default) or planar (..., H, W) uint8/float → uint8.

    Channel-last input is folded into the batch via a transpose (XLA
    transposes fuse into the surrounding ops).
    """
    cfg = ops.cfg
    channel_last = channel_last and img.ndim >= 3
    x = img
    if channel_last:
        x = jnp.moveaxis(x, -1, -3)
    was_int = jnp.issubdtype(x.dtype, jnp.integer)
    x = x.astype(ops.dtype)
    pad = [(0, 0)] * (x.ndim - 2) + [
        (ops.sup_v, ops.sup_v),
        (ops.sup_h, ops.sup_h),
    ]
    x = jnp.pad(x, pad, mode=ops.pad_mode)
    x = _axis_shift_pass(
        x, ops.nv, ops.dv, ops.sup_v, ops.tbl_v, x.ndim - 2, cfg.dering,
        ops.off_v,
    )
    # width axis still carries the horizontal padding; height is done
    x = _axis_shift_pass(
        x, ops.nh, ops.dh, ops.sup_h, ops.tbl_h, x.ndim - 1, cfg.dering,
        ops.off_h,
    )
    if was_int:
        from lanczos_tpu.ops.resample_xla import quantize_uint8

        x = quantize_uint8(x)
    if channel_last:
        x = jnp.moveaxis(x, -3, -1)
    return x
