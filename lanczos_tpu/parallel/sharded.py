"""Multi-chip row-partitioned resampling (mesh + shard_map + halo exchange).

The reference bounds its memory by streaming rows through a 2a-row cyclic
line buffer (``worker.h:140-142``, ``cyclic_buffer.h:63``).  Promoted to the
inter-chip level (SURVEY.md §2 "parallelism strategies"), the same idea is:
shard image **rows** across devices; each shard needs an ``a``-input-row
halo from each neighbor to compute its slice of the vertical pass, exchanged
with ``jax.lax.ppermute`` over the inter-card links (NVLink).  The
horizontal pass is row-local and needs no communication.  A second mesh axis shards the **batch** (frames)
data-parallel.

Key invariant making the halo exactly ``a`` rows: with reduced scale N/D and
``IN_H`` divisible by the rows-axis size R, shard r produces output rows
``[r·OUT_H/R, (r+1)·OUT_H/R)`` whose tap windows touch input rows
``[r·IN_H/R − a + 1, (r+1)·IN_H/R − 1 + a]`` — the local slice ± a.

Per-shard weight tables ride the same sharding: the (OUT_H, 2a) gather-index
table is itself row-sharded, and each shard rebases indices by its offset
(the multi-chip analog of the reference's ``seek_write_index`` /
``curr_offset`` phase bookkeeping, ``worker.cpp:199-202``).  Edge-clamped
global indices never reach the (wrap-around, invalid) halo of the first/last
shard, so a plain ring ppermute is sufficient — no special-casing at the
mesh boundary.

Design note: the float non-shift path deliberately stays on the gather
formulation (NOT the faster blocked-matmul backend) so sharded output is
BIT-IDENTICAL to the single-chip xla backend — the matmul's different
f32 summation order flips occasional truncation boundaries, and the
exactness guarantee (tested in test_sharded.py) is worth more here than
throughput we cannot benchmark on one chip.

The fused-kernel overlay (uint8 inputs, ``use_mxu``) keeps the same
exactness property against ITS single-chip twin: each shard applies the
same global banded rows as per-shard dense matrices (edge semantics
included — no padding tricks, the wrap-around halo rows are provably
never referenced by edge shards' weights), and a window-offset shift of
zero columns adds exact 0.0 terms, so sharded output is BIT-IDENTICAL to
the single-card pallas backend (tested incl. drop+normalize and
dering).
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from lanczos_tpu import platform
from lanczos_tpu.core.config import EdgeMode, Order, Precision, ResampleConfig
from lanczos_tpu.ops.resample_xla import SeparableOps, apply_banded, quantize_uint8


def choose_mesh_shape(n_devices: int) -> Tuple[int, int]:
    """Factor n into (data, rows): keep a real rows axis whenever possible."""
    for rows in (4, 2):
        if n_devices % rows == 0 and n_devices > rows:
            return n_devices // rows, rows
    if n_devices % 2 == 0:
        return n_devices // 2, 2
    return n_devices, 1


def halo_permutes(x: jnp.ndarray, halo: int, axis_name: str, axis: int = 1):
    """Issue the two ring ppermutes and return ``(top, bot)`` halo strips.

    Returning the strips *before* any concatenation keeps compute that
    does not depend on them (the interior rows) free of a data dependency
    on the collectives, so XLA's async collective-permute can run them
    while interior compute proceeds (the inter-chip DATAFLOW overlap,
    SURVEY.md §7 "halo exchange overlap").
    """
    n = jax.lax.axis_size(axis_name)

    def take(lo, hi):
        sl = [slice(None)] * x.ndim
        sl[axis] = slice(lo, hi)
        return x[tuple(sl)]

    if n == 1 or halo == 0:
        shape = list(x.shape)
        shape[axis] = halo
        z = jnp.zeros(shape, x.dtype)
        return z, z
    fwd = [(i, (i + 1) % n) for i in range(n)]  # send down: my tail → next's top
    bwd = [(i, (i - 1) % n) for i in range(n)]  # send up: my head → prev's bottom
    top = jax.lax.ppermute(take(-halo, None), axis_name, fwd)
    bot = jax.lax.ppermute(take(0, halo), axis_name, bwd)
    return top, bot


def halo_exchange_rows(x: jnp.ndarray, halo: int, axis_name: str, axis: int = 1):
    """Concatenate each shard's row block with `halo` rows from ring neighbors.

    x: (..., h_local, ...) with the sharded rows at ``axis``.
    Returns (..., h_local + 2*halo, ...).  The wrap-around rows received by
    the first/last shard are garbage by construction and are provably never
    read (gather indices are globally edge-resolved before rebasing).
    """
    top, bot = halo_permutes(x, halo, axis_name, axis)
    return jnp.concatenate([top, x, bot], axis=axis)


class ShardedUpscaler:
    """Row+batch sharded 2D resample over a Mesh.

    Input  (B, H, W, C) sharded (data, rows, -, -);
    output (B, OH, OW, C) sharded the same way.
    """

    def __init__(
        self,
        cfg: ResampleConfig,
        mesh: Mesh,
        data_axis: str = "data",
        rows_axis: str = "rows",
        dtype=jnp.float32,
        backend: str = "auto",
        overlap: bool = True,
    ):
        if backend not in ("auto", "mxu", "gather"):
            raise ValueError(f"unknown sharded backend {backend!r}")
        self._backend_req = backend
        self.overlap = overlap
        self.cfg = cfg
        self.mesh = mesh
        self.data_axis = data_axis
        self.rows_axis = rows_axis
        R = mesh.shape[rows_axis]
        in_h, out_h = cfg.in_shape[0], cfg.out_shape[0]
        if in_h % R or out_h % R:
            raise ValueError(
                f"in_h={in_h} and out_h={out_h} must divide rows axis size {R}"
            )
        self.rows_n = R
        self.in_h_local = in_h // R
        self.out_h_local = out_h // R
        n, d = cfg.scale_h
        # halo in input rows; covers upscale (d<=n: a) and downscale bands
        self.halo = -(-(cfg.a * d) // n) if n < d else cfg.a
        self.dtype = dtype
        self.fixed = cfg.precision == Precision.FIXED

        spec_in = P(data_axis, rows_axis, None, None)
        spec_tbl = P(rows_axis, None)

        def put_tbl(arr):
            return jax.device_put(
                jnp.asarray(arr), NamedSharding(mesh, spec_tbl)
            )

        self.c_exact = cfg.c_faithful and not self.fixed
        if self.c_exact:
            from lanczos_tpu.ops.c_exact import CExactOps

            n, d = cfg.scale_h
            if n < d:
                raise NotImplementedError("sharded c_faithful downscale")
            self.cx = CExactOps(cfg)
            self.halo = cfg.a
            if self.halo > self.in_h_local:
                raise ValueError(
                    f"halo {self.halo} exceeds {self.in_h_local} rows per "
                    "shard; use fewer shards"
                )
            # the oracle's in-place quirk rows read final rows above
            # themselves: statically verify every row a fix row touches is
            # resident on the fix row's owner shard (true unless shards
            # are tiny)
            for y in self.cx.fix_rows:
                owner = y // self.out_h_local
                for i in self.cx.tbl_v.idx[y]:
                    i = int(i)
                    if i > y and i // self.out_h_local != owner:
                        raise ValueError(
                            "c_faithful fix rows cross shard boundaries; "
                            "use fewer shards"
                        )
                    if i <= y and not (
                        0
                        <= i - (owner * self.in_h_local - self.halo)
                        < self.in_h_local + 2 * self.halo
                    ):
                        raise ValueError(
                            "c_faithful fix-row taps exceed the halo; "
                            "use fewer shards"
                        )
            tv = self.cx.tbl_v
            with jax.enable_x64(True):  # int64 lattice weights must not
                # silently truncate to int32 at device_put
                self._tables = (
                    put_tbl(tv.idx),
                    put_tbl(tv.w50),
                    put_tbl(tv.w70),
                    jax.device_put(
                        jnp.asarray(tv.is_walk),
                        NamedSharding(mesh, P(rows_axis)),
                    ),
                    jax.device_put(
                        jnp.asarray(tv.center),
                        NamedSharding(mesh, P(rows_axis)),
                    ),
                )
            shard_fn = self._shard_fn_c_exact
            tbl_specs = (spec_tbl,) * 3 + (P(rows_axis),) * 2
        elif self.fixed:
            from lanczos_tpu.ops.fixed_point import HLSOps

            self.hls = HLSOps.build(cfg)
            # The quantized step predicate makes the stream's gather
            # indices drift from the nominal y·D/N (by ~y·(D/N − q/2^P)),
            # so the float paths' a-row halo is NOT enough: compute the
            # exact halo each shard needs from the schedule itself.
            eff = np.asarray(self.hls.v_eff)
            need = self.halo
            for rr in range(R):
                rows = eff[rr * self.out_h_local : (rr + 1) * self.out_h_local]
                need = max(
                    need,
                    rr * self.in_h_local - int(rows.min()),
                    int(rows.max()) - ((rr + 1) * self.in_h_local - 1),
                )
            if need > self.in_h_local:
                raise ValueError(
                    f"HLS stream index drift needs a {need}-row halo but "
                    f"shards hold only {self.in_h_local} rows; use fewer "
                    "shards or a larger bit_precision"
                )
            self.halo = int(need)
            self._tables = (
                put_tbl(self.hls.v_eff),
                put_tbl(self.hls.v_w),
                put_tbl(self.hls.v_valid),
            )
            shard_fn = self._shard_fn_fixed
            tbl_specs = (spec_tbl,) * 3
        else:
            if self.halo > self.in_h_local:
                # Without this, halo_exchange_rows' neighbor slices silently
                # clamp to the shard height and the rebased gather indices
                # misalign (silently wrong output on the gather path, shape
                # error on the shift path).
                raise ValueError(
                    f"vertical halo of {self.halo} rows exceeds the "
                    f"{self.in_h_local} rows held per shard; use fewer "
                    "shards along the rows axis"
                )
            self.ops = SeparableOps(cfg, dtype)
            # shift-FMA fast path (the fastest non-Pallas formulation)
            # applies per shard when the phase pattern is shard-invariant:
            # local output rows a multiple of N, local input rows of D
            from lanczos_tpu.models.upscaler import _shift_eligible

            self.use_shift = (
                _shift_eligible(cfg)
                and self.out_h_local % n == 0
                and self.in_h_local % d == 0
            )
            if self.use_shift:
                from lanczos_tpu.ops.resample_shift_xla import ShiftOps

                self.shift = ShiftOps(cfg, dtype)
            self._tables = (
                put_tbl(self.ops.op_v.idx),
                put_tbl(np.asarray(self.ops.op_v.weights, self._np_dtype())),
            )
            self._compute_split_bounds()
            shard_fn = self._shard_fn
            tbl_specs = (spec_tbl,) * 2

        self._fn = jax.jit(
            jax.shard_map(
                shard_fn,
                mesh=mesh,
                in_specs=(spec_in,) + tbl_specs,
                out_specs=spec_in,
            )
        )

        # fused-kernel overlay (uint8 inputs): per-shard edge-exact weight
        # matrices as row-sharded operands; bit-identical to the
        # single-card pallas backend (same band values; the vertical sums
        # are exact, so the window placement cannot change them)
        self.use_mxu = False
        auto_fused = backend == "auto" and platform.auto_backend(cfg) == "pallas"
        if not self.fixed and not self.c_exact and (backend == "mxu" or auto_fused):
            self._setup_mxu()
        if backend == "mxu" and not self.use_mxu:
            raise NotImplementedError(
                "sharded fused-kernel path needs a float config with "
                "shard-local output rows ≡ 0 (mod N), height-first "
                "nonlinearities, and one plan shared by every shard"
            )

    def _compute_split_bounds(self) -> None:
        """Shard-invariant statics for the interior/boundary split of the
        gather vertical pass (the halo-overlap structure, SURVEY.md §7):

        - ``b_top``/``b_bot``: max over shards of leading/trailing local
          output rows whose tap window leaves the local row slab (these
          depend on the ppermuted halos);
        - ``wtop``/``wbot``: local input rows the boundary windows must
          carry beyond the halo strips.

        Interior rows [b_top, ol − b_bot) provably gather from the local
        slab alone on EVERY shard, so their compute carries no data
        dependency on the collectives.  Disabled (``b_top = −1``) when a
        boundary set is non-contiguous or the interior would be empty.
        """
        idxg = np.asarray(self.ops.op_v.idx)
        ol, il, R = self.out_h_local, self.in_h_local, self.rows_n
        b_top = b_bot = 0
        wtop = wbot = 1
        ok = True
        for rr in range(R):
            lo_r = idxg[rr * ol : (rr + 1) * ol].min(axis=1) - rr * il
            hi_r = idxg[rr * ol : (rr + 1) * ol].max(axis=1) - rr * il
            need_top = lo_r < 0
            need_bot = hi_r >= il
            t, b = int(need_top.sum()), int(need_bot.sum())
            if need_top[t:].any() or (b and need_bot[: ol - b].any()):
                ok = False  # non-contiguous boundary set
                break
            b_top, b_bot = max(b_top, t), max(b_bot, b)
        if ok and b_top + b_bot < ol:
            for rr in range(R):
                hi_r = idxg[rr * ol : (rr + 1) * ol].max(axis=1) - rr * il
                lo_r = idxg[rr * ol : (rr + 1) * ol].min(axis=1) - rr * il
                if b_top:
                    wtop = max(wtop, int(hi_r[:b_top].max()) + 1)
                if b_bot:
                    wbot = max(wbot, il - int(lo_r[ol - b_bot :].min()))
            self.b_top, self.b_bot = b_top, b_bot
            self.wtop, self.wbot = min(wtop, il), min(wbot, il)
        else:
            self.b_top = -1  # overlap structurally unavailable

    def _setup_mxu(self) -> None:
        """Build the per-shard fused-kernel plans, or leave use_mxu = False.

        Every shard covers output rows [r·OL, (r+1)·OL); with OL ≡ 0
        (mod N) the window-start formula is shard-invariant after the
        halo rebase (off_eff = off + 2·N·halo), and edge semantics ride
        in each shard's own matrices — the wrap-around ppermute halo rows
        of the first/last shard are provably never referenced (edge
        shards' band indices stay inside their valid rows)."""
        import dataclasses as _dc
        import types as _types

        from lanczos_tpu.ops.resample_pallas import (
            _build_mxu_plan,
            split_weights,
        )

        cfg = self.cfg
        n, d = cfg.scale_h
        if self.out_h_local % n:
            return
        if (cfg.dering or cfg.intermediate_quantize) and (
            cfg.order != Order.HEIGHT_FIRST
        ):
            return
        op_v, op_h = self.ops.op_v, self.ops.op_h
        if self.halo < op_v.a:
            return
        R, ol, il, halo = self.rows_n, self.out_h_local, self.in_h_local, self.halo
        syn = _dc.replace(
            cfg,
            in_shape=(il + 2 * halo, cfg.in_shape[1]),
            out_shape=(ol, cfg.out_shape[1]),
        )
        off = 0 if cfg.align.value == "zero" else d - n
        off_eff = off + 2 * n * halo
        plans = None
        for t in (64, 32, 16):
            cand = []
            for r in range(R):
                idx_r = op_v.idx[r * ol : (r + 1) * ol] - (r * il - halo)
                op_r = _types.SimpleNamespace(
                    idx=idx_r, weights=op_v.weights[r * ol : (r + 1) * ol],
                    a=int(op_v.a),
                )
                cand.append(_build_mxu_plan(
                    syn, t, op_r, op_h, n, d, off_eff, dedup_v=False
                ))
            if all(p is not None for p in cand):
                # one kernel (tables, window pieces, horizontal weights)
                # serves every shard; only the vertical stacks differ
                keys = {
                    (p.tile_out, p.kv_pieces, p.starts_v, p.cb, p.kh_pieces,
                     p.n_cb, p.starts_h, p.uniq_h, p.wh.shape)
                    for p in cand
                }
                if len(keys) == 1 and all(
                    np.array_equal(p.wh, cand[0].wh) for p in cand[1:]
                ):
                    plans = cand
                    break
        if plans is None:
            return
        wv_all = np.stack([p.wv for p in plans])  # (R, nt, rows_v, kv)
        wv_hi, wv_lo = split_weights(wv_all, -1)
        spec_w = P(self.rows_axis, None, None, None)
        put = lambda a: jax.device_put(a, NamedSharding(self.mesh, spec_w))
        self._mxu_tables = (put(wv_hi), put(wv_lo))
        from lanczos_tpu.ops.resample_pallas import make_mxu_ops

        self._mxu = make_mxu_ops(syn, plans[0], platform.pallas_interpret())
        self._mxu.mxu_wv = None  # per-shard operands, passed at call time
        spec_in = P(self.data_axis, self.rows_axis, None, None)
        self._fn_mxu = jax.jit(
            jax.shard_map(
                self._shard_fn_mxu,
                mesh=self.mesh,
                in_specs=(spec_in, spec_w, spec_w),
                out_specs=spec_in,
                check_vma=False,  # pallas out ShapeDtypeStruct carries no vma
            )
        )
        self.use_mxu = True

    def _shard_fn_mxu(self, x, wv_hi, wv_lo):
        """x: (B_local, h_local, W, C) uint8; wv_*: this shard's stacks."""
        from lanczos_tpu.ops.resample_pallas import _fused_call_mxu

        def one(group):
            ext = halo_exchange_rows(group, self.halo, self.rows_axis, axis=1)
            b, he, w, c = ext.shape
            planar = jnp.transpose(ext, (0, 3, 1, 2)).reshape(b * c, he, w)
            y = _fused_call_mxu(self._mxu, planar, wv=(wv_hi[0], wv_lo[0]))
            y = y.reshape(b, c, *self._mxu.cfg.out_shape)
            return jnp.transpose(y, (0, 2, 3, 1))

        if not self.overlap or x.shape[-1] < 2:
            return one(x)
        # the fused kernel consumes the whole halo-extended buffer in one
        # Pallas call, so the interior/boundary split cannot thread
        # through it; two channel groups give the DATAFLOW overlap
        # instead — group 2's ring exchange issues while group 1's kernel
        # runs (async collective permute), bit-identical by construction
        h = x.shape[-1] // 2
        return jnp.concatenate([one(x[..., :h]), one(x[..., h:])], axis=-1)

    def _np_dtype(self):
        return np.dtype(jnp.dtype(self.dtype).name)

    def _shard_fn_fixed(self, x, v_eff, v_w, v_valid):
        """HLS-faithful fixed-point path, row-sharded.

        The flattened stream schedule's gather indices are global and
        already encode the zero-pre-roll (valid mask) and bottom-replicate
        edge behavior, so the same rebase-into-halo trick as the float
        gather path applies verbatim — edge shards never read their
        (invalid, wrap-around) halo rows.
        """
        cfg = self.cfg
        from lanczos_tpu.ops.fixed_point import (
            hls_horizontal_pass,
            hls_vertical_pass,
        )

        r = jax.lax.axis_index(self.rows_axis)
        ext = halo_exchange_rows(x, self.halo, self.rows_axis, axis=1)
        local_eff = v_eff - (r * self.in_h_local - self.halo)
        a, Pb = cfg.a, cfg.bit_precision
        mid = hls_vertical_pass(
            ext.astype(jnp.int32), local_eff, v_w, v_valid, a, Pb, axis=1
        )
        return hls_horizontal_pass(
            mid,
            jnp.asarray(self.hls.h_eff),
            jnp.asarray(self.hls.h_w),
            jnp.asarray(self.hls.h_valid),
            a,
            Pb,
            axis=2,
        )

    def _shard_fn_c_exact(self, x, idx_v, w50_v, w70_v, walk_v, cen_v):
        """Bit-exact c_faithful path, row-sharded (ops/c_exact.py on shards).

        The width pass is row-local (global tables, no comm).  The height
        pass exchanges ``a`` rows of the uint8 intermediate and applies the
        locally-rebased exact pass; the oracle's in-place quirk rows are
        then recomputed on their (statically verified) owner shard and
        merged with a ``where`` — other shards compute a discarded copy,
        keeping the program SPMD.
        """
        from lanczos_tpu.ops.c_exact import (
            _AxisTables,
            _exact_pass_axis0,
            _exact_single_row,
        )

        r = jax.lax.axis_index(self.rows_axis)
        # width pass (axis 2), tables global/replicated
        mid = jnp.moveaxis(
            _exact_pass_axis0(jnp.moveaxis(x, 2, 0), self.cx.tbl_h), 0, 2
        )
        # height pass over halo-extended intermediate
        ext = halo_exchange_rows(mid, self.halo, self.rows_axis, axis=1)
        local_idx = idx_v - (r * self.in_h_local - self.halo)
        tblv = _AxisTables(local_idx, w50_v, w70_v, walk_v, cen_v, cen_v)
        extT = jnp.moveaxis(ext, 1, 0)  # (in_local+2h, B, OW, C)
        F = _exact_pass_axis0(extT, tblv)  # (out_local, B, OW, C)
        for y in self.cx.fix_rows:  # static, descending
            owner = y // self.out_h_local
            ly = y % self.out_h_local
            srcs = []
            for i in self.cx.tbl_v.idx[y]:
                i = int(i)
                if i > y:
                    srcs.append(F[i - owner * self.out_h_local])
                else:
                    srcs.append(
                        extT[i - (owner * self.in_h_local - self.halo)]
                    )
            new = _exact_single_row(y, srcs, self.cx.tbl_v)
            F = F.at[ly].set(jnp.where(r == owner, new, F[ly]))
        return jnp.moveaxis(F, 0, 1)

    def _edge_pad_rows(self, v, s: int, top: bool):
        """Edge-mode pad rows for the first/last shard's invalid halo."""
        mode = self.cfg.edge_mode
        if mode == EdgeMode.DROP:
            shape = list(v.shape)
            shape[1] = s
            return jnp.zeros(shape, v.dtype)
        if mode == EdgeMode.CLAMP:
            row = v[:, :1] if top else v[:, -1:]
            return jnp.broadcast_to(row, row.shape[:1] + (s,) + row.shape[2:])
        # REFLECT about the edge sample
        return v[:, s:0:-1] if top else v[:, -2 : -s - 2 : -1]

    def _shard_fn(self, x, idx_v, w_v):
        from lanczos_tpu.core.config import Order

        cfg = self.cfg
        r = jax.lax.axis_index(self.rows_axis)
        was_int = jnp.issubdtype(x.dtype, jnp.integer)
        x = x.astype(self.dtype)

        def vpass_gather(v):
            # the communicating pass (the horizontal pass is row-local).
            # Overlapped default: issue the ring ppermutes, compute the
            # halo-independent INTERIOR rows (no data dependency on the
            # collectives, so async collective-permute runs underneath),
            # then the b_top/b_bot boundary rows from halo+edge windows.
            # Bit-identical to exchange-then-compute: same taps, same
            # weights, same summation order, gathered from value-equal
            # buffers.  (Reference analog: DATAFLOW stage overlap,
            # lanczos.cpp:72-82.)
            base = r * self.in_h_local
            if not self.overlap or self.b_top < 0:
                ext = halo_exchange_rows(v, self.halo, self.rows_axis, axis=1)
                local_idx = idx_v - (base - self.halo)
                return apply_banded(
                    ext, local_idx, w_v, axis=1, dering=cfg.dering
                )
            top, bot = halo_permutes(v, self.halo, self.rows_axis, axis=1)
            bt, bb = self.b_top, self.b_bot
            il, ol = self.in_h_local, self.out_h_local
            mid = apply_banded(
                v, idx_v[bt : ol - bb] - base, w_v[bt : ol - bb],
                axis=1, dering=cfg.dering,
            )
            parts = []
            if bt:
                win = jnp.concatenate([top, v[:, : self.wtop]], axis=1)
                parts.append(apply_banded(
                    win, idx_v[:bt] - (base - self.halo), w_v[:bt],
                    axis=1, dering=cfg.dering,
                ))
            parts.append(mid)
            if bb:
                win = jnp.concatenate([v[:, il - self.wbot :], bot], axis=1)
                parts.append(apply_banded(
                    win, idx_v[ol - bb :] - (base + il - self.wbot),
                    w_v[ol - bb :], axis=1, dering=cfg.dering,
                ))
            return jnp.concatenate(parts, axis=1)

        def vpass_shift(v):
            # the ppermute halo doubles as the shift pass's support pad;
            # the first/last shard's wrap-around halo is overwritten with
            # edge-mode padding (it holds the other end of the image)
            from lanczos_tpu.ops.resample_shift_xla import _axis_shift_pass

            s = self.halo
            ext = halo_exchange_rows(v, s, self.rows_axis, axis=1)
            top = jnp.where(r == 0, self._edge_pad_rows(v, s, True), ext[:, :s])
            bot = jnp.where(
                r == self.rows_n - 1,
                self._edge_pad_rows(v, s, False),
                ext[:, -s:],
            )
            ext = jnp.concatenate([top, ext[:, s:-s], bot], axis=1)
            sh = self.shift
            return _axis_shift_pass(
                ext, sh.nv, sh.dv, sh.sup_v, sh.tbl_v, 1, cfg.dering,
                sh.off_v,
            )

        def hpass_shift(v):
            from lanczos_tpu.ops.resample_shift_xla import _axis_shift_pass

            sh = self.shift
            pad = [(0, 0)] * v.ndim
            pad[2] = (sh.sup_h, sh.sup_h)
            if self.cfg.edge_mode == EdgeMode.DROP:
                ext = jnp.pad(v, pad)
            else:
                ext = jnp.pad(
                    v, pad,
                    mode="edge" if cfg.edge_mode == EdgeMode.CLAMP else "reflect",
                )
            return _axis_shift_pass(
                ext, sh.nh, sh.dh, sh.sup_h, sh.tbl_h, 2, cfg.dering,
                sh.off_h,
            )

        def hpass_gather(v):
            return apply_banded(
                v, self.ops.idx_h, self.ops.w_h, axis=2, dering=cfg.dering
            )

        vpass = vpass_shift if self.use_shift else vpass_gather
        hpass = hpass_shift if self.use_shift else hpass_gather

        def maybe_q(v):
            return quantize_uint8(v, self.dtype) if cfg.intermediate_quantize else v

        def run(v):
            if cfg.order == Order.WIDTH_FIRST:
                return vpass(maybe_q(hpass(v)))
            return hpass(maybe_q(vpass(v)))

        if self.use_shift and self.overlap and x.shape[-1] >= 2:
            # the shift formulation consumes the whole halo-extended
            # buffer, so the interior/boundary split does not apply;
            # instead, run two channel groups so the second group's ring
            # exchange issues while the first group computes (channels
            # are independent — bit-identical by construction)
            h = x.shape[-1] // 2
            out = jnp.concatenate([run(x[..., :h]), run(x[..., h:])], -1)
        else:
            out = run(x)
        if was_int or cfg.intermediate_quantize:
            return quantize_uint8(out)
        return out

    def halo_spec(self, channels: int = 3, uint8_input: bool = True) -> dict:
        """Wire bytes per ppermute direction for this model's ACTUAL
        exchange path — the analytic-model input
        (``multihost.ici_halo_model``): the fused-kernel overlay (which only
        engages for uint8 frames — pass ``uint8_input=False`` when
        feeding floats, which fall back to the gather/shift path) and
        the fixed-point path exchange uint8 input rows; the c_exact
        path exchanges the uint8 OW-wide intermediate; the float
        gather/shift paths exchange compute-dtype rows, on the OW-wide
        intermediate when the vertical pass runs second (width-first)."""
        cfg = self.cfg
        if (self.use_mxu and uint8_input) or self.fixed:
            width, nbytes = cfg.in_shape[1], 1
        elif self.c_exact:
            width, nbytes = cfg.out_shape[1], 1
        else:
            width = (
                cfg.out_shape[1]
                if cfg.order == Order.WIDTH_FIRST
                else cfg.in_shape[1]
            )
            nbytes = jnp.dtype(self.dtype).itemsize
        return {
            "halo_rows": self.halo,
            "bytes": self.halo * width * channels * nbytes,
        }

    def __call__(self, img) -> jnp.ndarray:
        if np.dtype(getattr(img, "dtype", np.uint8)) == np.uint16:
            # the Upscaler dtype contract at 16-bit width (upscaler.py):
            # run the float path, then the same trunc-clip against 65535
            # (the gather path is bit-identical to the single-chip xla
            # backend on floats, so so is this)
            if self.fixed or self.c_exact:
                raise ValueError(
                    "uint16 input is not defined for the bit-exact uint8 "
                    "semantics profiles (hls/c_oracle); convert explicitly"
                )
            x = jax.device_put(
                np.asarray(img, np.float32),
                NamedSharding(
                    self.mesh, P(self.data_axis, self.rows_axis, None, None)
                ),
            )
            y = self._fn(x, *self._tables)
            return jnp.trunc(jnp.clip(y, 0.0, 65535.0)).astype(jnp.uint16)
        img = jax.device_put(
            img,
            NamedSharding(self.mesh, P(self.data_axis, self.rows_axis, None, None)),
        )
        if self.use_mxu and img.dtype == jnp.uint8:
            return self._fn_mxu(img, *self._mxu_tables)
        if self._backend_req == "mxu":
            raise TypeError(
                f"backend='mxu' processes uint8 frames; got {img.dtype} — "
                "cast the input or use the gather path (backend='auto')"
            )
        if self.c_exact:  # int64 lattice arithmetic needs a local x64 scope
            with jax.enable_x64(True):
                return self._fn(img, *self._tables)
        return self._fn(img, *self._tables)
