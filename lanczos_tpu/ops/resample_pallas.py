"""Fused separable resampling as one Pallas kernel for Hopper (Triton route).

The reference's 3-stage DATAFLOW pipeline (vertical fill ‖ horizontal fill ‖
stream-out over ping-pong tiles, ``lanczos.cpp:68-83``) maps to one fused
kernel: each program loads the uint8 input window its output block needs,
applies the vertical then horizontal banded operators in registers and
shared memory, and stores one uint8 output block — the float intermediate
never touches device memory.  Two XLA passes write and read that f32
intermediate (OH × IW × C × 4 bytes each way), ≈4× the uint8 traffic floor
at 4K→8K.

Both passes are dense tensor-core dots over per-row-tile / per-column-block
weight matrices built from :func:`banded_weights`, so EVERYTHING lives in
the weights — edge modes (incl. drop+normalize), per-phase structure for
any rational N/D, antialiased downscale stretch, align conventions —
generalizing the phase-LUT uniformity of ``kernel.cpp:50-59`` to per-tile
granularity.  The FSR dering clamp and the uint8-quantized intermediate
are fused via one-hot selector rows/cols stacked beside the weights
(height-first order only — they are nonlinear; width-first configs run the
height-first kernel on the transposed image).

Numerics: uint8 pixels are exact in bf16 and every dot accumulates in f32
(``preferred_element_type=jnp.float32``).  The fp32 tier splits weights and
the float intermediate into hi+lo bf16 parts (2 vertical + 3 horizontal
dots, ≤1 LSB vs the f32 gather path); the bf16 tier runs single dots.  No
dot runs in TF32, which cannot hold 1 LSB.

Grid: one program per (plane, output row tile, group of output column
blocks); each block loads its own (kv × kh) window with masked loads, so
nothing carries between programs, and the loop over a group's blocks lets
Triton pipeline the next window's loads against the current dots.  Triton
wants power-of-two block shapes, so the window extents are covered by a
sum of power-of-two pieces (e.g. 48 = 32 + 16 rows for a 64-row 2× tile)
instead of being padded to the next power of two.

Layout: the kernel is planar — (C, H, W) or (B, C, H, W).  Interleaved
(..., H, W, C) wrappers transpose at the boundary.
"""

from __future__ import annotations

import dataclasses
import functools
import types
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from lanczos_tpu import platform
from lanczos_tpu.core.config import Order, Precision, ResampleConfig
from lanczos_tpu.core.config import reduced_scale

# Triton's dot takes operands of at least 16 along every dimension
_MIN_PIECE = 16
# widest window the plan accepts per axis (registers hold the mid pieces)
_MAX_WINDOW = 256
# output block: rows × cols (powers of two), and warps per program
TILE_H = 64
TILE_W = 64
NUM_WARPS = 4
# Windows up to PIPELINE_WINDOW elements (upscales: 48 × 48 at 2×) run
# BLOCKS_PER_PROGRAM column blocks per program in a loop whose loads
# Triton pipelines NUM_STAGES deep: on an H100 that took 4K→8K from 0.236
# to 0.219 ms/frame at fp32 and 0.148 to 0.122 at bf16.  Larger windows
# (downscales: 144 × 144 at 1/2) run one block per program unpipelined:
# 3 stages took 4K→1080p from 0.063 to 0.106 ms/frame.
PIPELINE_WINDOW = 64 * 64
BLOCKS_PER_PROGRAM = 8
NUM_STAGES = 3


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def window_pieces(ext: int) -> tuple:
    """Power-of-two pieces covering ``ext`` window rows/cols, as
    ``((offset, size), ...)``: one piece when the next power of two wastes
    at most a quarter, else the binary decomposition of the 16-rounded
    extent (e.g. 37 → 48 = 32 + 16, 69 → 80 = 64 + 16, 100 → 112 → 128)."""
    k = _round_up(max(ext, 1), _MIN_PIECE)
    p2 = 1 << (k - 1).bit_length()
    if p2 * 4 <= k * 5:
        sizes = [p2]
    else:
        sizes = [1 << b for b in range(k.bit_length() - 1, -1, -1) if k >> b & 1]
    out, off = [], 0
    for s in sizes:
        out.append((off, s))
        off += s
    return tuple(out)


def _pieces_extent(pieces: tuple) -> int:
    return pieces[-1][0] + pieces[-1][1]


def _dedup(mats: list) -> tuple:
    """(unique stack, per-entry index into it)."""
    seen, uniq, idx = {}, [], []
    for W in mats:
        key = W.tobytes()
        if key not in seen:
            seen[key] = len(uniq)
            uniq.append(W)
        idx.append(seen[key])
    return np.stack(uniq), tuple(idx)


@dataclasses.dataclass
class _MXUPlan:
    """Plan for the fused dense-band kernel: both passes as tensor-core dots.

    Works on the UNPADDED image — edge handling (clamp/drop/reflect and
    per-row normalization) is folded into the weight matrices.

    Vertical: output rows tiled by ``tile_out``; tile ``i`` reads input rows
    ``[starts_v[i], starts_v[i] + kv)`` (starts from the exact rational
    coordinate floor, clipped into the image) and applies the dense
    ``(tile_out, kv)`` matrix ``wv[uniq_v[i]]``.

    Horizontal: output cols in blocks of ``cb``; block ``b`` multiplies
    ``mid[:, starts_h[b] : starts_h[b] + kh]`` by ``wh[uniq_h[b]]``, a dense
    ``(kh, cb)`` matrix.  Interior tiles and blocks share one matrix (the
    phase-LUT invariance, kernel.cpp:50-59) and are deduplicated.
    """

    tile_out: int
    kv_pieces: tuple  # power-of-two (offset, size) pieces of the row window
    num_tiles: int
    starts_v: tuple  # per-tile input row starts
    uniq_v: tuple  # per-tile index into wv
    cb: int
    kh_pieces: tuple
    n_cb: int
    starts_h: tuple  # per-block input col starts
    uniq_h: tuple  # per-block index into wh
    wv: np.ndarray  # (n_uniq_v, rows_v, kv) f64; rows_v = 3·tile with dering
    wh: np.ndarray  # (n_uniq_h, kh, cols_h) f64; cols_h = 3·cb with dering

    @property
    def kv(self) -> int:
        return _pieces_extent(self.kv_pieces)

    @property
    def kh(self) -> int:
        return _pieces_extent(self.kh_pieces)


@functools.lru_cache(maxsize=8)  # plans hold multi-MB f64 weight stacks
def _mxu_plan(
    cfg: ResampleConfig, tile_h: int = TILE_H, cb: int = TILE_W
) -> Optional[_MXUPlan]:
    """The fused-kernel plan for a whole-frame config, or None where it
    does not apply (width-first nonlinear configs, windows wider than
    ``_MAX_WINDOW``, images a window cannot cover).  Cached: the auto
    eligibility check and PallasOps ask for the same config's plan."""
    from lanczos_tpu.core.weights import banded_weights

    (ih, iw), (oh, ow) = cfg.in_shape, cfg.out_shape
    nv, dv = reduced_scale(ih, oh)
    kw = dict(
        a=cfg.a, filter_name=cfg.filter, edge_mode=cfg.edge_mode,
        normalize=cfg.normalize, coord_mode="exact", align=cfg.align.value,
    )
    op_v = banded_weights(ih, oh, **kw)
    op_h = banded_weights(iw, ow, **kw)
    off_v = 0 if cfg.align.value == "zero" else dv - nv
    return _build_mxu_plan(cfg, tile_h, op_v, op_h, nv, dv, off_v, cb)


def transposed_cfg(cfg: ResampleConfig) -> ResampleConfig:
    """The height-first config whose result, applied to the transposed
    image, equals this width-first config on the original: swapping both
    shape axes swaps which operator is "vertical", and the per-output-pixel
    nonlinearities (dering clamp, uint8-quantized intermediate) commute
    with the transpose because they act pointwise after each pass."""
    return dataclasses.replace(
        cfg,
        in_shape=(cfg.in_shape[1], cfg.in_shape[0]),
        out_shape=(cfg.out_shape[1], cfg.out_shape[0]),
        order=Order.HEIGHT_FIRST,
    )


def _build_mxu_plan(
    cfg: ResampleConfig,
    tile_h: int,
    op_v,
    op_h,
    nv: int,
    dv: int,
    off_v: int,
    cb: int = TILE_W,
    dedup_v: bool = True,
) -> Optional[_MXUPlan]:
    """Plan construction core, parameterized on prebuilt banded operators.

    ``cfg`` supplies shapes and the nonlinearity flags.  Row-tile starts
    come from the rational coordinate formula ``(2·lo·dv + off_v)//(2·nv)
    − (support − 1)``, so window-rebased operator slices (the sharded and
    streaming paths, with ``off_v`` shifted accordingly) get the same starts
    on every shard; every tile is validated against the real band indices
    either way.  ``tile_h`` and ``cb`` are powers of two ≥ 16.
    ``dedup_v=False`` keeps one vertical matrix per tile (per-shard stacks
    must share one index table)."""
    (ih, iw), (oh, ow) = cfg.in_shape, cfg.out_shape
    if (cfg.dering or cfg.intermediate_quantize) and cfg.order != Order.HEIGHT_FIRST:
        # the kernel runs vertical-then-horizontal; through a nonlinearity
        # (dering clamp / quantized intermediate) the pass order is
        # observable
        return None
    dering = cfg.dering
    s_v = op_v.a  # support per side (= a, or ceil(a·D/N) for downscale)
    s_h = op_h.a
    back_v = s_v - 1  # idx min for row y is floor((2yd+off)/2n) - (s-1)
    tile = tile_h

    def v_start_raw(lo: int) -> int:
        return (2 * lo * dv + off_v) // (2 * nv) - back_v

    # ---- vertical tiles ----
    num = -(-oh // tile)
    ext = 0
    for i in range(num):
        lo, hi = i * tile, min((i + 1) * tile, oh)
        ext = max(ext, int(op_v.idx[lo:hi].max()) - max(v_start_raw(lo), 0) + 1)
    kv_pieces = window_pieces(ext)
    kv = _pieces_extent(kv_pieces)
    rows_v = 3 * tile if dering else tile
    starts_v, mats_v = [], []
    for i in range(num):
        lo, hi = i * tile, min((i + 1) * tile, oh)
        start = min(max(v_start_raw(lo), 0), max(ih - kv, 0))
        band_idx = op_v.idx[lo:hi] - start
        if band_idx.min() < 0 or band_idx.max() >= kv:
            return None  # window cannot cover this tile (tiny image)
        W = np.zeros((rows_v, kv), np.float64)
        rr = np.arange(hi - lo)
        np.add.at(W, (rr[:, None], band_idx), op_v.weights[lo:hi])
        if dering:
            # rows [tile, 2·tile) / [2·tile, 3·tile) select the two central
            # taps (idx[:, s-1], idx[:, s]; worker.cpp:64-75) — uint8
            # values, exact in bf16
            W[tile + rr, band_idx[:, s_v - 1]] = 1.0
            W[2 * tile + rr, band_idx[:, s_v]] = 1.0
        starts_v.append(start)
        mats_v.append(W)
    if dedup_v:
        wv, uniq_v = _dedup(mats_v)
    else:
        wv, uniq_v = np.stack(mats_v), tuple(range(num))

    # ---- horizontal blocks ----
    n_cb = -(-ow // cb)
    ext_h = 0
    for b in range(n_cb):
        blk = op_h.idx[b * cb : min((b + 1) * cb, ow)]
        ext_h = max(ext_h, int(blk.max()) - int(blk.min()) + 1)
    kh_pieces = window_pieces(ext_h)
    kh = _pieces_extent(kh_pieces)
    if kv > _MAX_WINDOW or kh > _MAX_WINDOW:
        return None
    cols_h = 3 * cb if dering else cb
    starts_h, mats_h = [], []
    for b in range(n_cb):
        lo, hi = b * cb, min((b + 1) * cb, ow)
        start = min(max(int(op_h.idx[lo:hi].min()), 0), max(iw - kh, 0))
        band_idx = op_h.idx[lo:hi] - start
        if band_idx.min() < 0 or band_idx.max() >= kh:
            return None
        W = np.zeros((kh, cols_h), np.float64)
        cc = np.arange(hi - lo)
        np.add.at(W, (band_idx, cc[:, None]), op_h.weights[lo:hi])
        if dering:
            # cols [cb, 2·cb) / [2·cb, 3·cb) select the central taps of the
            # (vertically clamped) intermediate; the f32 bound is rebuilt
            # as m_hi·S + m_lo·S
            W[band_idx[:, s_h - 1], cb + cc] = 1.0
            W[band_idx[:, s_h], 2 * cb + cc] = 1.0
        starts_h.append(start)
        mats_h.append(W)
    wh, uniq_h = _dedup(mats_h)
    return _MXUPlan(
        tile_out=tile, kv_pieces=kv_pieces, num_tiles=num,
        starts_v=tuple(starts_v), uniq_v=uniq_v,
        cb=cb, kh_pieces=kh_pieces, n_cb=n_cb,
        starts_h=tuple(starts_h), uniq_h=uniq_h, wv=wv, wh=wh,
    )


# Weights are rounded onto fixed grids so every vertical dot sums exactly
# in f32: hi parts are multiples of 2^-13 (|Σ w·x| < 2^10 for Σ|w| < 4 and
# x ≤ 255, i.e. at most 24 significant bits) and lo parts multiples of
# 2^-21 (|Σ lo·x| < 2).  An exact sum does not depend on the order the
# tensor cores add the products in, so a window placed anywhere
# (row-sharded shards, streamed chunks) gives the bits the whole-frame
# kernel gives.  The grids cost ≤ 2^-22 per tap (≈4e-4 LSB per output);
# each output's hi+lo weights are then corrected to sum to its exact
# (grid-rounded) weight sum, so a constant image stays constant.
_GRID_HI = 2.0**-13
_GRID_LO = 2.0**-21


def _bf16(v: np.ndarray) -> np.ndarray:
    return np.asarray(jnp.asarray(v, jnp.bfloat16), np.float64)


def split_weights(w: np.ndarray, tap_axis: int):
    """(hi, lo) bf16 parts of ``w`` on the exact-sum grids; ``tap_axis``
    is the axis each output sums over."""
    w = np.moveaxis(np.asarray(w, np.float64), tap_axis, -1)
    # a bf16 value rounded to a multiple of g stays bf16-exact: only
    # values whose ulp is below g change, and those have < 8 bits over g
    hi = np.round(_bf16(w) / _GRID_HI) * _GRID_HI
    lo = np.round(_bf16(w - hi) / _GRID_LO) * _GRID_LO
    # put each output's weight-sum residual (a multiple of the lo grid) on
    # its smallest tap whose lo part can hold it exactly in bf16
    resid = np.round(w.sum(-1) / _GRID_LO) * _GRID_LO - (hi + lo).sum(-1)
    cand = lo + resid[..., None]
    fits = (w != 0) & (_bf16(cand) == cand)
    score = np.where(fits, np.abs(w), np.inf)
    j = score.argmin(-1)[..., None]
    fix = (resid != 0) & np.isfinite(score.min(-1))
    new = np.take_along_axis(cand, j, -1)
    old = np.take_along_axis(lo, j, -1)
    np.put_along_axis(lo, j, np.where(fix[..., None], new, old), -1)
    hi, lo = np.moveaxis(hi, -1, tap_axis), np.moveaxis(lo, -1, tap_axis)
    return jnp.asarray(hi, jnp.bfloat16), jnp.asarray(lo, jnp.bfloat16)


def make_mxu_ops(cfg: ResampleConfig, plan: _MXUPlan, interpret: bool = False):
    """Duck-typed stand-in for PallasOps carrying a hand-built plan —
    the single place that knows which attributes _fused_kernel_mxu /
    _fused_call_mxu read.  Used by the streaming chunk and row-sharded
    paths, whose plans come from window-rebased operator slices rather
    than a whole-frame config.  Set ``mxu_wv = None`` (and pass ``wv=`` at
    call time) when the vertical stacks are per-shard operands."""
    return types.SimpleNamespace(
        cfg=cfg,
        mxu=plan,
        mxu_wv=split_weights(plan.wv, -1),
        mxu_wh=split_weights(plan.wh, -2),
        split=cfg.precision != Precision.BF16,
        interpret=interpret,
    )


class PallasOps:
    """Precomputed plan + weight matrices for one fused 2D resample config."""

    def __init__(
        self,
        cfg: ResampleConfig,
        dtype=jnp.float32,
        interpret: Optional[bool] = None,
        tile_h: int = TILE_H,
        cb: int = TILE_W,
    ):
        if cfg.precision == Precision.FIXED:
            raise NotImplementedError("use ops.fixed_point for the HLS path")
        if cfg.c_faithful:
            raise NotImplementedError("c_faithful is XLA/ref-backend only")
        self.cfg = cfg
        self.interpret = platform.pallas_interpret() if interpret is None else interpret
        # Width-first nonlinear configs (dering / quantized intermediate
        # make the pass order observable) run as the height-first kernel on
        # the TRANSPOSED image: Y = (kernel_T(X^T))^T exactly.
        self.tr_ops = None
        if cfg.order == Order.WIDTH_FIRST and (
            cfg.dering or cfg.intermediate_quantize
        ):
            self.tr_ops = PallasOps(
                transposed_cfg(cfg), dtype, self.interpret, tile_h, cb
            )
            self.mxu = self.tr_ops.mxu
            return
        self.mxu = _mxu_plan(cfg, tile_h, cb)
        if self.mxu is None:
            raise NotImplementedError(
                "the fused kernel covers any float config whose windows fit "
                f"{_MAX_WINDOW} rows/cols and cover every tile; this one's "
                "plan is infeasible — use the shift_xla, block or xla backend"
            )
        self.split = cfg.precision != Precision.BF16
        self.mxu_wv = split_weights(self.mxu.wv, -1)
        self.mxu_wh = split_weights(self.mxu.wh, -2)


def _fused_kernel_mxu(
    tv_ref, th_ref, x_ref, wv_hi, wv_lo, wh_hi, wh_lo, o_ref, *, ops, group
):
    """One program: plane c, row tile i, column blocks
    ``[j·group, (j+1)·group)`` clipped to the frame, one loop step each.

    ``tv_ref[i] = (row start, vertical matrix)`` and ``th_ref[b] = (col
    start, horizontal matrix)``.  The input window loads are masked to the
    image, so windows that overhang a small image read zeros (their
    weights are zero there)."""
    mx = ops.mxu
    c, i, j = pl.program_id(0), pl.program_id(1), pl.program_id(2)
    sv, uv = tv_ref[i, 0], tv_ref[i, 1]
    _, ih, iw = x_ref.shape
    _, oh, ow = o_ref.shape
    t, cb = mx.tile_out, mx.cb
    der = ops.cfg.dering
    quant = ops.cfg.intermediate_quantize
    split_mid = ops.split and not quant

    def dot(a, w):
        return jnp.dot(a, w, preferred_element_type=jnp.float32)

    def iota(shape, axis):
        return jax.lax.broadcasted_iota(jnp.int32, shape, axis)

    # the row tile's vertical weights serve every block of the program
    wv_rows = [
        [wv_hi[uv, pl.ds(k * t, t), pl.ds(r0, rn)] for (r0, rn) in mx.kv_pieces]
        for k in range(3 if der else 1)
    ]
    if ops.split:
        wv_lo_p = [wv_lo[uv, pl.ds(0, t), pl.ds(r0, rn)] for (r0, rn) in mx.kv_pieces]

    def block(b):
        sh, uh = th_ref[b, 0], th_ref[b, 1]

        def load_x(r0, rn, c0, cn):
            rows = sv + r0 + iota((rn, cn), 0)
            cols = sh + c0 + iota((rn, cn), 1)
            x = plgpu.load(
                x_ref.at[c, pl.ds(sv + r0, rn), pl.ds(sh + c0, cn)],
                mask=(rows < ih) & (cols < iw),
                other=0,
            )
            # integers <= 255 are exact in bf16
            return x.astype(jnp.float32).astype(jnp.bfloat16)

        # ---- vertical pass: mid[:, piece q] = Wv @ X[:, piece q] ----
        mids = []
        for c0, cn in mx.kh_pieces:
            xs = [load_x(r0, rn, c0, cn) for (r0, rn) in mx.kv_pieces]
            mid = sum(dot(w, x) for w, x in zip(wv_rows[0], xs))
            if ops.split:
                mid = mid + sum(dot(w, x) for w, x in zip(wv_lo_p, xs))
            if der:
                # central-tap values (exact uint8): the FSR anti-ringing
                # clamp (worker.cpp:64-75)
                c0v = sum(dot(w, x) for w, x in zip(wv_rows[1], xs))
                c1v = sum(dot(w, x) for w, x in zip(wv_rows[2], xs))
                mid = jnp.clip(mid, jnp.minimum(c0v, c1v), jnp.maximum(c0v, c1v))
            if quant:
                # uint8-quantized intermediate (full_TB.h:63): integers
                # <= 255 are exact in bf16, so the mid split disappears
                mid = jnp.trunc(jnp.clip(mid, 0.0, 255.0))
            m_hi = mid.astype(jnp.bfloat16)
            m_lo = (
                (mid - m_hi.astype(jnp.float32)).astype(jnp.bfloat16)
                if split_mid else None
            )
            mids.append((m_hi, m_lo))

        # ---- horizontal pass: out = Σ_q mid_q @ Wh[piece q] ----
        def hdot(col0, lo_weights=False):
            src = wh_lo if lo_weights else wh_hi
            acc = None
            for (c0, cn), (m_hi, m_lo) in zip(mx.kh_pieces, mids):
                w = src[uh, pl.ds(c0, cn), pl.ds(col0, cb)]
                term = dot(m_hi, w)
                if m_lo is not None and not lo_weights:
                    term = term + dot(m_lo, w)
                acc = term if acc is None else acc + term
            return acc

        acc = hdot(0)
        if ops.split:
            acc = acc + hdot(0, lo_weights=True)
        if der:
            h0, h1 = hdot(cb), hdot(2 * cb)
            acc = jnp.clip(acc, jnp.minimum(h0, h1), jnp.maximum(h0, h1))
        q = jnp.trunc(jnp.clip(acc, 0.0, 255.0)).astype(jnp.uint8)
        rows = i * t + iota((t, cb), 0)
        cols = b * cb + iota((t, cb), 1)
        plgpu.store(
            o_ref.at[c, pl.ds(i * t, t), pl.ds(b * cb, cb)],
            q,
            mask=(rows < oh) & (cols < ow),
        )

    def step(g, carry):
        block(j * group + g)
        return carry

    jax.lax.fori_loop(0, jnp.minimum(group, mx.n_cb - j * group), step, 0)


def _tables(plan: _MXUPlan):
    tv = np.stack([plan.starts_v, plan.uniq_v], axis=1).astype(np.int32)
    th = np.stack([plan.starts_h, plan.uniq_h], axis=1).astype(np.int32)
    return jnp.asarray(tv), jnp.asarray(th)


def _fused_call_mxu(ops, img_planar: jnp.ndarray, wv=None) -> jnp.ndarray:
    """(NC, H, W) uint8 UNPADDED planar → (NC, OH, OW) uint8.

    ``wv`` optionally overrides the vertical (hi, lo) weight stacks — the
    row-sharded path passes each shard its own slice (edge-exact weights
    as sharded operands)."""
    mx = ops.mxu
    nc = img_planar.shape[0]
    oh, ow = ops.cfg.out_shape
    wv_hi, wv_lo = ops.mxu_wv if wv is None else wv
    wh_hi, wh_lo = ops.mxu_wh
    tv, th = _tables(mx)
    pipelined = mx.kv * mx.kh <= PIPELINE_WINDOW
    group = min(BLOCKS_PER_PROGRAM, mx.n_cb) if pipelined else 1
    return pl.pallas_call(
        functools.partial(_fused_kernel_mxu, ops=ops, group=group),
        grid=(nc, mx.num_tiles, -(-mx.n_cb // group)),
        out_shape=jax.ShapeDtypeStruct((nc, oh, ow), jnp.uint8),
        backend="triton",
        compiler_params=plgpu.CompilerParams(
            num_warps=NUM_WARPS, num_stages=NUM_STAGES if pipelined else 1
        ),
        interpret=ops.interpret,
        name="lanczos_fused",
    )(tv, th, img_planar, wv_hi, wv_lo, wh_hi, wh_lo)


def upscale_planar(img: jnp.ndarray, ops: PallasOps) -> jnp.ndarray:
    """Planar fast path: (C, H, W) or (B, C, H, W) uint8 → same rank uint8."""
    if ops.tr_ops is not None:  # width-first via the transposed kernel
        y = upscale_planar(jnp.swapaxes(img, -1, -2), ops.tr_ops)
        return jnp.swapaxes(y, -1, -2)
    batched = img.ndim == 4
    x = img if batched else img[None]
    b, c = x.shape[0], x.shape[1]
    y = _fused_call_mxu(ops, x.reshape(b * c, *x.shape[2:]))
    y = y.reshape(b, c, *ops.cfg.out_shape)
    return y if batched else y[0]


def resample_2d_pallas(img: jnp.ndarray, ops: PallasOps) -> jnp.ndarray:
    """Interleaved API: (..., H, W, C) uint8 → (..., OH, OW, C) uint8.

    Transposes to planar at the boundary; prefer :func:`upscale_planar` in
    throughput-critical pipelines to skip the output transpose.
    """
    if img.dtype != jnp.uint8:
        img = jnp.trunc(jnp.clip(img.astype(jnp.float32), 0.0, 255.0)).astype(
            jnp.uint8
        )
    lead = img.shape[:-3]
    x = img.reshape((-1,) + img.shape[-3:])  # (B, H, W, C)
    x = jnp.transpose(x, (0, 3, 1, 2))  # planar
    y = upscale_planar(x, ops)
    y = jnp.transpose(y, (0, 2, 3, 1))
    return y.reshape(lead + y.shape[1:])
