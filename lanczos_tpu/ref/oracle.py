"""NumPy reference backends (the framework's test oracles).

:func:`c_oracle_upscale` is a bit-faithful reimplementation of the
reference's fp64 software path (``full_TB.h:29-96``), the PSNR anchor for
the whole framework (BASELINE.json: PSNR ≥ 60 dB vs the reference C path).
It reproduces, deliberately:

- the same IEEE double arithmetic: ``x = xx / (N/D)`` via double division
  of a double ``SCALE`` (``full_TB.h:57``), tap weights ``sinc(πt)·sinc(πt/a)``
  in double (``full_TB.h:51-53``),
- tap loop bounds clamped to the image, i.e. out-of-range taps are simply
  *dropped* (zero contribution), with **no weight normalization**
  (``full_TB.h:59,72``),
- the width pass writing a **uint8-truncated** intermediate
  (``double_to_uint8`` saturates then C-casts, truncating toward zero,
  ``full_TB.h:29-37,63``),
- the height pass running **in place, top row last** on the same uint8
  buffer (``full_TB.h:67-77``): output rows are written from the bottom up,
  so for the first few output rows (where ``⌊x⌋+a > xx``) some taps read
  rows that already hold *final* values rather than width-pass values.
  This is observable reference behavior and is kept.

:func:`clean_resample_2d` is the mathematically straightforward fp64
separable resampler (any config) used to validate the clean device paths.
"""

from __future__ import annotations

import numpy as np

from lanczos_tpu.core.config import ResampleConfig, Order, reduced_scale
from lanczos_tpu.core.weights import banded_weights


def _double_to_uint8(x: np.ndarray) -> np.ndarray:
    """full_TB.h:29-37: saturate to [0, 255], then C double→uint8 cast
    (truncation toward zero)."""
    return np.trunc(np.clip(x, 0.0, 255.0)).astype(np.uint8)


def _oracle_weights(out_size: int, in_size: int, a: int):
    """Per-output-position tap range + fp64 weights, exactly as the C loop.

    Returns (idx, w): idx (out, 2a) clipped indices, w (out, 2a) weights
    zeroed outside the reference's inclusive [lo, hi] tap bounds.
    """
    n, d = reduced_scale(in_size, out_size)
    scale = float(n) / float(d)  # the reference's double SCALE (lanczos.h:112)
    xx = np.arange(out_size, dtype=np.float64)
    x = xx / scale  # full_TB.h:57 — same double division
    fl = np.floor(x)
    lo = np.maximum(0, fl - a + 1).astype(np.int64)  # MAX(0, floor(x)-a+1)
    hi = np.minimum(in_size - 1, fl + a).astype(np.int64)  # MIN(in-1, floor(x)+a)
    j = np.arange(2 * a, dtype=np.int64)
    idx = (fl.astype(np.int64) - a + 1)[:, None] + j[None, :]
    t = x[:, None] - idx.astype(np.float64)
    w = np.sinc(t) * np.sinc(t / a)  # == sinc(pi t)/(pi t) form of full_TB.h:51-53
    w = np.where((idx >= lo[:, None]) & (idx <= hi[:, None]), w, 0.0)
    idx = np.clip(idx, 0, in_size - 1)
    return idx.astype(np.int32), w


def oracle_resample_axis0(img: np.ndarray, out_size: int, a: int) -> np.ndarray:
    """Drop-edge, unnormalized fp64 resample along axis 0 (no quantization)."""
    idx, w = _oracle_weights(out_size, img.shape[0], a)
    acc = np.zeros((out_size,) + img.shape[1:], dtype=np.float64)
    for j in range(w.shape[1]):
        acc += w[:, j].reshape((-1,) + (1,) * (img.ndim - 1)) * img[idx[:, j]].astype(
            np.float64
        )
    return acc


def c_oracle_upscale(img: np.ndarray, out_h: int, out_w: int, a: int = 2) -> np.ndarray:
    """Bit-faithful ``lanczos_expected`` (full_TB.h:79-96).

    img: (H, W, C) uint8.  Returns (out_h, out_w, C) uint8.
    """
    img = np.asarray(img)
    assert img.dtype == np.uint8 and img.ndim == 3
    in_h, in_w, c = img.shape
    if out_h < in_h or out_w < in_w:
        raise ValueError(
            "c_oracle_upscale is upscale-only (the reference C path, "
            f"full_TB.h, never downscales); got {in_h}x{in_w} -> "
            f"{out_h}x{out_w}"
        )

    # -- width pass (lanczos_interpolate_row per input row), uint8 intermediate
    buf = np.zeros((out_h, out_w, c), dtype=np.uint8)
    row = oracle_resample_axis0(
        np.ascontiguousarray(img.transpose(1, 0, 2)), out_w, a
    ).transpose(1, 0, 2)
    buf[:in_h] = _double_to_uint8(row)

    # -- height pass, in place, xx from out_h-1 down to 0 (full_TB.h:67-77)
    idx, w = _oracle_weights(out_h, in_h, a)
    lib = _oracle_native()
    if lib is not None:
        buf = np.ascontiguousarray(buf)
        idx_c = np.ascontiguousarray(idx, np.int32)
        w_c = np.ascontiguousarray(w, np.float64)
        lib.oracle_height_pass(
            buf.ctypes.data_as(lib.u8p),
            out_h,
            buf.shape[1] * buf.shape[2],
            idx_c.ctypes.data_as(lib.i32p),
            w_c.ctypes.data_as(lib.f64p),
            w.shape[1],
        )
        return buf
    for xx in range(out_h - 1, -1, -1):
        # explicit ascending tap accumulation: the exact summation order of
        # the reference C loop (full_TB.h:73-75); einsum/BLAS order is
        # implementation-defined and must not be used here
        acc = np.zeros(buf.shape[1:], np.float64)
        for j in range(w.shape[1]):
            acc += w[xx, j] * buf[idx[xx, j]].astype(np.float64)
        buf[xx] = _double_to_uint8(acc)
    return buf


def _oracle_native():
    from lanczos_tpu.ref._native import native_lib

    return native_lib()


def clean_resample_2d(img: np.ndarray, cfg: ResampleConfig) -> np.ndarray:
    """Straightforward fp64 separable resample honoring cfg's edge mode,
    normalization, and pass order.  Returns float64 (no quantization) unless
    ``cfg.intermediate_quantize`` which applies the oracle's uint8 rule to
    the intermediate and the output."""
    img = np.asarray(img)
    oh, ow = cfg.out_shape

    def pass_axis0(x, out_size):
        op = banded_weights(
            x.shape[0],
            out_size,
            cfg.a,
            cfg.filter,
            cfg.edge_mode,
            cfg.normalize,
            align=cfg.align.value,
        )
        acc = np.zeros((out_size,) + x.shape[1:], dtype=np.float64)
        for j in range(op.taps):
            acc += op.weights[:, j].reshape((-1,) + (1,) * (x.ndim - 1)) * x[
                op.idx[:, j]
            ].astype(np.float64)
        return acc

    def maybe_q(x):
        return _double_to_uint8(x).astype(np.float64) if cfg.intermediate_quantize else x

    x = img.astype(np.float64)
    if cfg.order == Order.WIDTH_FIRST:
        x = np.swapaxes(pass_axis0(np.swapaxes(x, 0, 1), ow), 0, 1)
        x = maybe_q(x)
        x = pass_axis0(x, oh)
    else:
        x = pass_axis0(x, oh)
        x = maybe_q(x)
        x = np.swapaxes(pass_axis0(np.swapaxes(x, 0, 1), ow), 0, 1)
    if cfg.intermediate_quantize:
        return _double_to_uint8(x)
    return x
