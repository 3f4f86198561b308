"""Row-streaming execution: unbounded image height under bounded memory.

The reference's entire reason for existing is processing an unbounded row
stream while holding only a 2a-row window + one tile (<4 MB budget,
``worker.h:140-142``, ``cyclic_buffer.h:63``).  This module is that
capability on an accelerator: output rows are produced in fixed-size chunks,
each computed from just the input-row window it needs (band start
``⌊y·D/N⌋−a+1`` … band end ``+a``), so device memory is bounded by the
chunk, not the frame.  The per-chunk index rebasing is the analog of the
reference's ``seek_write_index``/``curr_offset`` phase bookkeeping
(``worker.cpp:199-202``) and makes execution restartable at any output row
(checkpoint/resume, SURVEY.md §5).

All chunks share one compiled kernel: the banded gather tables are sliced
per chunk host-side and passed as same-shaped device arrays, so chunk k and
chunk k+1 hit the same jit cache entry.

Device formulations, fastest first (auto-selected):

1. **fused-kernel chunk path** — the fused Pallas kernel applied per chunk.
   With ``chunk ≡ 0 (mod N)`` every chunk shares one phase pattern, so an
   interior slice of a virtual tall operator serves all chunks (the
   ``seek_write_index``/``curr_offset`` analog becomes a constant shift of
   the kernel's rational-coordinate window formula); frame edges are
   reproduced by edge-mode padding the input window (hence DROP-edge
   configs are excluded).
2. **shift-FMA chunk path** — pure-XLA strided shifts (integer upscales).
3. **gather chunk path** — per-chunk sliced banded tables (any config).
"""

from __future__ import annotations

from typing import Callable, Iterator, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from lanczos_tpu import platform
from lanczos_tpu.core.config import Order, Precision, ResampleConfig
from lanczos_tpu.core.weights import banded_weights
from lanczos_tpu.ops.resample_xla import apply_banded, quantize_uint8


def _join_prefetch(pool, fut) -> None:
    """Tear down a chunks() prefetch pool: an abandoned generator must not
    leave get_rows running on the worker thread after control returns to
    the caller — cancel what hasn't started, then join anything in flight.
    The join is bounded so a get_rows stalled on a dead source (socket,
    pipe) cannot hang generator close/GC forever."""
    if fut is not None and not fut.cancel():
        try:
            fut.result(timeout=60.0)
        except Exception:
            pass  # surfaced to nobody — the generator is dead
    pool.shutdown(wait=False, cancel_futures=True)


class StreamingUpscaler:
    """Chunked 2D resample: full-width horizontal pass, row-chunked vertical.

    ``chunk_rows`` is the number of OUTPUT rows per device step (rounded up
    to a multiple of the vertical phase count N so every chunk shares one
    weight layout).
    """

    def __init__(
        self,
        cfg: ResampleConfig,
        chunk_rows: int = 512,
        dtype=jnp.float32,
        chunk_backend: str = "auto",
    ):
        if cfg.precision == Precision.FIXED or cfg.c_faithful:
            raise NotImplementedError(
                "streaming supports the precise float paths only"
            )
        if chunk_backend not in ("auto", "mxu", "shift", "gather"):
            raise ValueError(f"unknown chunk_backend {chunk_backend!r}")
        self.cfg = cfg
        self.dtype = dtype
        n, d = cfg.scale_h
        self.chunk = max(n, -(-min(chunk_rows, cfg.out_shape[0]) // n) * n)
        coord = "exact"
        self.op_v = banded_weights(
            cfg.in_shape[0], cfg.out_shape[0], cfg.a, cfg.filter,
            cfg.edge_mode, cfg.normalize, coord_mode=coord,
            align=cfg.align.value,
        )
        self.op_h = banded_weights(
            cfg.in_shape[1], cfg.out_shape[1], cfg.a, cfg.filter,
            cfg.edge_mode, cfg.normalize, coord_mode=coord,
            align=cfg.align.value,
        )
        self.idx_h = jnp.asarray(self.op_h.idx)
        self.w_h = jnp.asarray(self.op_h.weights, dtype)
        # uniform input-window size for every chunk (static jit shape)
        oh = cfg.out_shape[0]
        self.n_chunks = -(-oh // self.chunk)
        lo = np.minimum.reduce(self.op_v.idx, axis=1)
        hi = np.maximum.reduce(self.op_v.idx, axis=1)
        spans = []
        for k in range(self.n_chunks):
            y0, y1 = k * self.chunk, min((k + 1) * self.chunk, oh)
            spans.append((int(lo[y0:y1].min()), int(hi[y0:y1].max()) + 1))
        self.spans = spans
        self.win = max(b - a for a, b in spans)
        # fused-kernel chunk path (fastest device formulation): one
        # interior-phase plan serves every chunk; frame edges are
        # reproduced by edge-mode padding the window
        self.use_mxu = False
        self.use_shift = False
        if chunk_backend == "mxu" or (
            chunk_backend == "auto" and platform.auto_backend(cfg) == "pallas"
        ):
            self._setup_mxu()
        if chunk_backend == "mxu" and not self.use_mxu:
            raise NotImplementedError(
                "fused-kernel chunk path needs chunk % N == 0, height-first "
                "nonlinearities, a non-DROP edge mode, and a feasible plan"
            )
        if self.use_mxu:
            self._fn = jax.jit(self._chunk_fn_mxu)
            return
        # shift-FMA chunk path: needs the phase pattern chunk-invariant
        # and height-first linear semantics
        from lanczos_tpu.models.upscaler import _shift_eligible

        ih = cfg.in_shape[0]
        self.use_shift = chunk_backend in ("auto", "shift") and (
            _shift_eligible(cfg)
            and self.chunk % n == 0
            and cfg.order == Order.HEIGHT_FIRST
            and ih % d == 0
        )
        if chunk_backend == "shift" and not self.use_shift:
            raise NotImplementedError(
                "shift chunk path needs an integer upscale with "
                "height-first linear semantics"
            )
        if self.use_shift:
            from lanczos_tpu.ops.resample_shift_xla import ShiftOps

            self.shift = ShiftOps(cfg, dtype)
            m = self.chunk // n
            self.win = m * d + 2 * self.shift.sup_v
            # unpadded input row origin of chunk k: k·m·d − sup_v
            self.w0_step = m * d
            self._fn = jax.jit(self._chunk_fn_shift)
        else:
            self._fn = jax.jit(self._chunk_fn)

    def _setup_mxu(self) -> None:
        """Build the shared interior-chunk kernel plan, or leave use_mxu=False.

        With ``chunk ≡ 0 (mod N)``, ``y0·D/N`` is an integer for every
        chunk start, so ``fl(y0+y') − fl(y0)`` is one function of the
        chunk-local row y' — a middle slice of a virtual tall operator is
        the universal chunk operator, and the kernel's window-start
        formula picks it up through a constant offset shift
        ``off_eff = off + 2·D·chunk − 2·N·row0`` (the seek_write_index /
        curr_offset analog, worker.cpp:199-202)."""
        import dataclasses as _dc
        import types as _types

        from lanczos_tpu.core.config import EdgeMode
        from lanczos_tpu.ops.resample_pallas import _build_mxu_plan

        cfg = self.cfg
        n, d = cfg.scale_h
        if cfg.edge_mode == EdgeMode.DROP:
            return  # window padding cannot reproduce dropped-tap weights
        if (
            (cfg.dering or cfg.intermediate_quantize)
            and cfg.order != Order.HEIGHT_FIRST
        ):
            return  # nonlinearity makes the pass order observable
        chunk = self.chunk
        if chunk % n:
            return
        # virtual tall frame at the EXACT rational scale (banded_weights
        # derives N/D from its arguments); its middle slice is pure
        # interior pattern
        oh_v = 5 * chunk
        ih_v = oh_v * d // n  # exact: chunk ≡ 0 (mod n)
        op = banded_weights(
            ih_v, oh_v, cfg.a, cfg.filter, cfg.edge_mode, cfg.normalize,
            coord_mode="exact", align=cfg.align.value,
        )
        idx_s = op.idx[2 * chunk : 3 * chunk]
        w_s = op.weights[2 * chunk : 3 * chunk]
        if idx_s.min() <= 0 or idx_s.max() >= ih_v - 1:
            return  # slice touches the virtual edges (tiny chunk)
        row0 = int(idx_s.min())
        win = int(idx_s.max()) - row0 + 1
        if win > cfg.in_shape[0]:
            return  # frame shorter than one chunk window (np.pad limits)
        op_local = _types.SimpleNamespace(
            idx=(idx_s - row0).astype(np.int32), weights=w_s, a=int(op.a)
        )
        off = 0 if cfg.align.value == "zero" else d - n
        off_eff = off + 2 * d * (2 * chunk) - 2 * n * row0
        syn = _dc.replace(
            cfg,
            in_shape=(win, cfg.in_shape[1]),
            out_shape=(chunk, cfg.out_shape[1]),
        )
        plan = None
        for t in (64, 32, 16):
            plan = _build_mxu_plan(syn, t, op_local, self.op_h, n, d, off_eff)
            if plan is not None:
                break
        if plan is None:
            return
        from lanczos_tpu.ops.resample_pallas import make_mxu_ops

        self._mxu = make_mxu_ops(syn, plan, platform.pallas_interpret())
        # global input row of chunk k's window-local row 0 (may be < 0 for
        # k = 0 / beyond ih for the tail — edge-mode padded); the slice
        # was taken at virtual chunk index 2
        self.mxu_row0_step = chunk * d // n
        self.mxu_row0_base = row0 - 2 * self.mxu_row0_step
        self.win = win
        self.use_mxu = True

    def _chunk_fn_mxu(self, rows):
        """rows: (win, W, C) uint8 window, edge pads applied host-side."""
        from lanczos_tpu.ops.resample_pallas import _fused_call_mxu

        x = jnp.transpose(rows, (2, 0, 1))
        y = _fused_call_mxu(self._mxu, x)
        return jnp.transpose(y, (1, 2, 0))

    def _chunk_fn(self, rows, idx_v, w_v):
        """rows: (win, W, C) input window; idx_v rebased to the window."""
        x = rows.astype(self.dtype)
        cfg = self.cfg
        if cfg.order == Order.WIDTH_FIRST:
            x = apply_banded(x, self.idx_h, self.w_h, 1, dering=cfg.dering)
            if cfg.intermediate_quantize:
                x = quantize_uint8(x, self.dtype)
            out = apply_banded(x, idx_v, w_v, 0, dering=cfg.dering)
        else:
            x = apply_banded(x, idx_v, w_v, 0, dering=cfg.dering)
            if cfg.intermediate_quantize:
                x = quantize_uint8(x, self.dtype)
            out = apply_banded(x, self.idx_h, self.w_h, 1, dering=cfg.dering)
        return quantize_uint8(out)

    def _chunk_fn_shift(self, rows):
        """rows: (win, W, C) window already carrying the vertical support
        pad (real neighbor rows interiorly, edge-mode rows at frame ends)."""
        from lanczos_tpu.ops.resample_shift_xla import _axis_shift_pass

        cfg = self.cfg
        sh = self.shift
        x = rows.astype(self.dtype)
        x = _axis_shift_pass(
            x, sh.nv, sh.dv, sh.sup_v, sh.tbl_v, 0, cfg.dering, sh.off_v
        )
        x = jnp.pad(x, [(0, 0), (sh.sup_h, sh.sup_h), (0, 0)], mode=sh.pad_mode)
        x = _axis_shift_pass(
            x, sh.nh, sh.dh, sh.sup_h, sh.tbl_h, 1, cfg.dering, sh.off_h
        )
        return quantize_uint8(x)

    def _host_chunk_args(
        self, k: int, get_rows: Callable[[int, int], np.ndarray]
    ) -> Tuple[int, int, tuple]:
        """Host-side prep for chunk k: fetch + pad the input window and
        slice/rebase the per-chunk tables.  Returns
        ``(y0, n_valid_rows, device_fn_args)``; no device work happens
        here, so it can run on a prefetch thread."""
        oh = self.cfg.out_shape[0]
        ih = self.cfg.in_shape[0]
        y0, y1 = k * self.chunk, min((k + 1) * self.chunk, oh)
        if self.use_shift or self.use_mxu:
            if self.use_mxu:
                w0 = self.mxu_row0_base + k * self.mxu_row0_step
                mode = {
                    "clamp": "edge", "reflect": "reflect",
                }[self.cfg.edge_mode.value]
            else:
                w0 = k * self.w0_step - self.shift.sup_v
                mode = {
                    "edge": "edge", "constant": "constant",
                    "reflect": "reflect",
                }[self.shift.pad_mode]
            w1 = w0 + self.win  # unpadded origin may be < 0 / > ih
            lo2, hi2 = max(w0, 0), min(w1, ih)
            rows = np.asarray(get_rows(lo2, hi2))
            top, bot = lo2 - w0, w1 - hi2
            if top or bot:
                rows = np.pad(
                    rows,
                    [(top, bot)] + [(0, 0)] * (rows.ndim - 1),
                    mode=mode,
                )
            return y0, y1 - y0, (rows,)
        lo, hi = self.spans[k]
        hi_pad = lo + self.win  # uniform window: pad by repeating last row
        rows = get_rows(lo, min(hi_pad, ih))
        if rows.shape[0] < self.win:
            pad = np.repeat(rows[-1:], self.win - rows.shape[0], axis=0)
            rows = np.concatenate([rows, pad], axis=0)
        # rebase global tap indices into the window; pad chunk rows to
        # self.chunk (tail chunk) with row 0 (output discarded)
        idx = self.op_v.idx[y0:y1] - lo
        w = self.op_v.weights[y0:y1]
        if idx.shape[0] < self.chunk:
            padn = self.chunk - idx.shape[0]
            idx = np.concatenate([idx, np.zeros((padn, idx.shape[1]), idx.dtype)])
            w = np.concatenate([w, np.zeros((padn, w.shape[1]), w.dtype)])
        return y0, y1 - y0, (rows, idx, np.asarray(w, self._np_dtype()))

    def _np_dtype(self):
        return np.dtype(jnp.dtype(self.dtype).name)

    def chunks(
        self,
        get_rows: Callable[[int, int], np.ndarray],
        start_chunk: int = 0,
        depth: int = 3,
        prefetch: bool = True,
    ) -> Iterator[Tuple[int, np.ndarray]]:
        """Yield (y0, chunk_output) pairs; resume via ``start_chunk``.

        ``get_rows(lo, hi)`` must return input rows [lo, hi) as
        (hi-lo, W, C) uint8 — from RAM, disk, or a decoder.

        Pipelined (the reference drains output concurrently with compute
        inside its DATAFLOW region, ``lanczos.cpp:53-65``): up to
        ``depth`` chunks stay in flight on the device — JAX's async
        dispatch overlaps chunk k+1's upload/launch with chunk k's
        compute, and the blocking device→host readback only happens once
        the window is full.  With ``prefetch=True`` the NEXT chunk's
        ``get_rows`` host fetch additionally runs on a background thread
        while the device works; calls stay serialized and in ascending
        row order (safe for sequential decoders), but pass
        ``prefetch=False`` if the callback must run on the caller's
        thread.  Results are always yielded in order, byte-identical to
        the serial path.
        """
        import collections
        from concurrent.futures import ThreadPoolExecutor

        depth = max(1, depth)
        ks = range(start_chunk, self.n_chunks)
        inflight: collections.deque = collections.deque()
        pool = (
            ThreadPoolExecutor(max_workers=1)
            if prefetch and len(ks) > 1
            else None
        )
        try:
            fut = None
            for j, k in enumerate(ks):
                y0, n, args = (
                    self._host_chunk_args(k, get_rows)
                    if fut is None
                    else fut.result()
                )
                if pool is not None and j + 1 < len(ks):
                    fut = pool.submit(self._host_chunk_args, ks[j + 1], get_rows)
                else:
                    fut = None
                dev = self._fn(*(jnp.asarray(a) for a in args))
                inflight.append((y0, n, dev))
                if len(inflight) >= depth:
                    y0_, n_, d = inflight.popleft()
                    yield y0_, np.asarray(d)[:n_]
            while inflight:
                y0_, n_, d = inflight.popleft()
                yield y0_, np.asarray(d)[:n_]
        finally:
            if pool is not None:
                _join_prefetch(pool, fut)

    def __call__(self, img: np.ndarray) -> np.ndarray:
        """Whole-frame convenience wrapper over :meth:`chunks`."""
        img = np.asarray(img)
        oh, ow = self.cfg.out_shape
        out = np.empty((oh, ow, img.shape[-1]), dtype=np.uint8)
        for y0, chunk in self.chunks(lambda lo, hi: img[lo:hi]):
            out[y0 : y0 + chunk.shape[0]] = chunk
        return out


class ShardedStreamingUpscaler(StreamingUpscaler):
    """Rows-sharded chunked execution: frames taller than all cards' memory.

    The reference's bounded-window stream (``worker.h:140-142``,
    ``cyclic_buffer.h:63``) promoted twice: output rows are produced in
    super-chunks of ``R x chunk_rows`` — one ``chunk_rows`` slice per
    shard of the mesh's ``rows_axis`` — and each shard holds only the
    input-row window its own slice needs, so per-device memory is bounded
    by one sub-chunk window and total frame height is unbounded by device
    memory (a single frame may exceed all cards' memory combined; only the
    host stream sees it whole).

    Halo handling happens at host-scatter time: consecutive shards'
    windows overlap by the vertical support, so every shard's slice is
    self-contained and no ppermute is needed — streamed input originates
    on the host, so duplicating the overlap rows in the scatter is
    strictly cheaper than a device-side ring exchange round (the rows
    would cross the host boundary either way; compare
    :class:`~lanczos_tpu.parallel.sharded.ShardedUpscaler`, whose frames
    are device-resident and exchange halos over NVLink).

    Byte-identical to :class:`StreamingUpscaler` at the same
    ``chunk_backend``: each shard runs the identical per-chunk program on
    identical inputs (``tests/test_streaming.py``).

    Pass a mesh whose ``rows_axis`` spans the devices to use, e.g.
    ``jax.make_mesh((8,), ("rows",))``; other mesh axes replicate.
    """

    def __init__(
        self,
        cfg: ResampleConfig,
        mesh,
        rows_axis: str = "rows",
        chunk_rows: int = 512,
        dtype=jnp.float32,
        chunk_backend: str = "auto",
    ):
        from jax.sharding import NamedSharding, PartitionSpec as P

        self.mesh = mesh
        self.rows_axis = rows_axis
        self.R = int(mesh.shape[rows_axis])
        super().__init__(
            cfg, chunk_rows=chunk_rows, dtype=dtype,
            chunk_backend=chunk_backend,
        )
        self.n_groups = -(-self.n_chunks // self.R)
        self._shard1 = NamedSharding(mesh, P(rows_axis))

        def shard_fn(*stacked):
            args = tuple(a[0] for a in stacked)
            if self.use_mxu:
                out = self._chunk_fn_mxu(*args)
            elif self.use_shift:
                out = self._chunk_fn_shift(*args)
            else:
                out = self._chunk_fn(*args)
            return out[None]

        n_args = 1 if (self.use_mxu or self.use_shift) else 3
        self._sfn = jax.jit(
            jax.shard_map(
                shard_fn,
                mesh=mesh,
                in_specs=tuple(P(rows_axis) for _ in range(n_args)),
                out_specs=P(rows_axis),
                # pallas out ShapeDtypeStruct carries no vma annotation
                check_vma=not self.use_mxu,
            )
        )

    def _host_group_args(self, g: int, get_rows):
        """Host prep for super-chunk g: R stacked sub-chunk argsets.

        Tail groups pad with the last real sub-chunk's args (n = 0 rows
        kept), keeping one jit shape; ``get_rows`` calls stay ascending
        and serialized (prefetch-thread safe, like the base class)."""
        metas, arglists = [], []
        prev = None
        for r in range(self.R):
            k = g * self.R + r
            if k < self.n_chunks:
                y0, n, a = self._host_chunk_args(k, get_rows)
                prev = (y0, a)
            else:
                (y0, a), n = prev, 0
            metas.append((y0, n))
            arglists.append(a)
        stacked = tuple(
            np.stack([al[i] for al in arglists])
            for i in range(len(arglists[0]))
        )
        return metas, stacked

    def _drain(self, item):
        metas, dev = item
        host = np.asarray(dev)  # (R, chunk, OW, C)
        for r, (y0, n) in enumerate(metas):
            if n:
                yield y0, host[r, :n]

    def chunks(
        self,
        get_rows,
        start_chunk: int = 0,
        depth: int = 2,
        prefetch: bool = True,
    ):
        """Yield (y0, chunk_output) pairs, R sub-chunks per device step.

        Same contract as the base class; ``start_chunk`` (for resume)
        must align to a super-chunk boundary (a multiple of the rows-axis
        size R — each device step produces R sub-chunks atomically).
        """
        import collections
        from concurrent.futures import ThreadPoolExecutor

        if start_chunk % self.R:
            raise ValueError(
                f"start_chunk must be a multiple of the rows-axis size "
                f"{self.R} (one device step = {self.R} sub-chunks)"
            )
        depth = max(1, depth)
        gs = range(start_chunk // self.R, self.n_groups)
        inflight: collections.deque = collections.deque()
        pool = (
            ThreadPoolExecutor(max_workers=1)
            if prefetch and len(gs) > 1
            else None
        )
        try:
            fut = None
            for j, g in enumerate(gs):
                metas, stacked = (
                    self._host_group_args(g, get_rows)
                    if fut is None
                    else fut.result()
                )
                if pool is not None and j + 1 < len(gs):
                    fut = pool.submit(
                        self._host_group_args, gs[j + 1], get_rows
                    )
                else:
                    fut = None
                dev = self._sfn(
                    *(jax.device_put(a, self._shard1) for a in stacked)
                )
                inflight.append((metas, dev))
                if len(inflight) >= depth:
                    yield from self._drain(inflight.popleft())
            while inflight:
                yield from self._drain(inflight.popleft())
        finally:
            if pool is not None:
                _join_prefetch(pool, fut)
