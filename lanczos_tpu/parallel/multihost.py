"""Multi-host execution helpers (the network across hosts, NVLink within).

The reference's communication fabric is point-to-point AXI-Stream
(``lanczos.cpp:94-95``); a GPU cluster is two-tier: NVLink among a host's
cards, the data-center network (DCN) between hosts (SURVEY.md §5
"distributed communication backend").  The design rule encoded here: the
``rows`` axis (halo exchange, latency-sensitive ring ppermute every step)
must stay on one host's NVLink, so it is laid out within a host's local
devices; the ``data`` axis (batch of frames, no inter-step communication)
spans hosts over the DCN.

Single-process multi-device (including the CPU-mesh tests and one host
with four cards) needs no initialization; call :func:`initialize` only in
true multi-process jobs (one process per host).
"""

from __future__ import annotations

from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """jax.distributed.initialize wrapper (no-op if already initialized).

    Pass ``coordinator_address`` (``host:port``), ``num_processes`` and
    ``process_id``: nothing discovers them on a plain GPU host.  On the
    CPU backend,
    cross-process collectives need an implementation selected before
    backend init — Gloo is configured here (guarded: older jax versions
    without the option just skip it).
    """
    import os

    if os.environ.get("JAX_PLATFORMS", "") == "cpu":
        try:
            jax.config.update("jax_cpu_collectives_implementation", "gloo")
        except Exception:
            pass
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    except RuntimeError as e:
        msg = str(e).lower()
        # jax <=0.8: "...already initialized"; jax 0.9: "distributed.
        # initialize should only be called once."
        if "already" not in msg and "only be called once" not in msg:
            raise


def dcn_aware_mesh(
    rows_per_host: Optional[int] = None,
    data_axis: str = "data",
    rows_axis: str = "rows",
) -> Mesh:
    """(data × rows) mesh with the rows axis contained in one host.

    ``rows_per_host`` defaults to the per-host (local) device count, so
    every ppermute halo hop stays on one host's NVLink; the data axis then spans
    host boundaries (DCN), where only input scatter / output gather cross.
    """
    devices = jax.devices()
    local = jax.local_device_count()
    rows_n = rows_per_host or local
    if len(devices) % rows_n:
        raise ValueError(
            f"device count {len(devices)} not divisible by rows axis {rows_n}"
        )
    # jax.devices() orders by (process, local id): reshaping to
    # (n_hosts·k, rows_n) keeps each rows group within one process as long
    # as rows_n divides the local device count.
    if local % rows_n:
        # rows_n > local (even as an exact multiple) would put one halo
        # ring across hosts — the DCN pathology this function prevents
        raise ValueError(
            f"rows_per_host {rows_n} must divide the local device count "
            f"{local} to stay on one host"
        )
    grid = np.array(devices).reshape(len(devices) // rows_n, rows_n)
    return Mesh(grid, (data_axis, rows_axis))


def scaling_efficiency(
    total_mpix_s: float, single_device_mpix_s: float, n_devices: int
) -> float:
    """Fraction of linear scaling achieved."""
    return total_mpix_s / (single_device_mpix_s * n_devices)


def ici_halo_model(
    cfg,
    rows_n: int,
    frame_s: float,
    *,
    channels: int = 3,
    dtype_bytes: int = 1,
    halo_bytes: Optional[int] = None,
    ici_bw: float,
    latency_s: float = 1.0e-6,
    boundary_fraction: Optional[float] = None,
) -> dict:
    """Analytic inter-card cost of the row-sharded halo exchange.

    Makes the multi-card perf story falsifiable: given the measured
    single-card frame time ``frame_s`` and the link bandwidth ``ici_bw``
    (bytes/s per direction — pass :func:`measure_ici_bw`'s number), the
    model predicts per-step exchange cost and scaling efficiency from
    first principles — bytes on the wire vs interior compute available to
    hide them under (the sharded path's interior/boundary split issues
    the ppermutes first and computes interior rows with no dependency on
    them; ``parallel/sharded.py``).

    The default byte model is the fused-kernel path's uint8 input-row
    exchange — pass ``halo_bytes`` from
    :meth:`ShardedUpscaler.halo_spec` to model the path actually
    measured (float gather/shift exchange 4-byte rows, and width-first
    orders exchange the OW-wide intermediate).  Returns a dict with:
    ``halo_bytes`` (per direction per shard), ``t_halo_s`` (wire time,
    both directions concurrent on a ring), ``t_shard_s`` (per-shard
    compute), ``t_hidden_s`` (interior window the exchange can hide
    under), ``exposed_s`` and ``efficiency``.
    """
    n, d = cfg.scale_h
    halo = -(-cfg.a * d // n) if n < d else cfg.a
    w = cfg.in_shape[1]
    if halo_bytes is None:
        halo_bytes = halo * w * channels * dtype_bytes
    t_halo = latency_s + halo_bytes / ici_bw
    t_shard = frame_s / rows_n
    if boundary_fraction is None:
        # boundary rows per side ≈ output rows whose tap window leaves
        # the local slab: ceil(a·N/D) at scale N/D
        out_local = cfg.out_shape[0] / rows_n
        boundary_fraction = min(1.0, 2 * -(-cfg.a * n // d) / out_local)
    t_hidden = t_shard * (1.0 - boundary_fraction)
    exposed = max(0.0, t_halo - t_hidden)
    return {
        "halo_rows": halo,
        "halo_bytes": halo_bytes,
        "t_halo_s": t_halo,
        "t_shard_s": t_shard,
        "t_hidden_s": t_hidden,
        "exposed_s": exposed,
        "efficiency": t_shard / (t_shard + exposed),
    }


def dcn_model(
    cfg,
    step_s: float,
    *,
    hosts: int = 2,
    frames_per_step: int = 1,
    channels: int = 3,
    in_bytes: int = 1,
    out_bytes: int = 1,
    dcn_bw: float = 1.25e10,
    latency_s: float = 1.0e-5,
    remote_fraction: Optional[float] = None,
) -> dict:
    """Analytic DCN cost of the host boundary (input scatter / output
    gather) — the multi-host analog of the reference's AXI-Stream host
    boundary (``lanczos.cpp:94-95``).

    Regime is everything here, so it is a parameter: with a CENTRAL
    stream source/sink (one host reads the video, one collects it — the
    default), a fraction ``(hosts-1)/hosts`` of every step's input bytes
    crosses DCN out and the same fraction of output bytes crosses back;
    with HOST-LOCAL striped I/O (each host reads/writes its own slice of
    the stream — how a production pipeline avoids this wall), pass
    ``remote_fraction=0.0`` and the host boundary cost vanishes, leaving
    the ICI halo term (:func:`ici_halo_model`) as the whole story.

    ``step_s`` is one pipeline step's compute time per host
    (``frames_per_step`` frames through the host's local row-sharded
    devices).  The frame pipeline keeps ``depth`` steps in flight
    (``models/video.py``), so one step of compute is available to hide
    the wire under; ``exposed = max(0, t_dcn - step_s)``.

    ``dcn_bw`` defaults to a 100 Gb/s-NIC-class 12.5 GB/s per host —
    pass your platform's measured number (the 2-process Gloo test
    measures a loopback anchor for exactly this slot,
    ``tests/test_multihost.py``).
    """
    in_b = frames_per_step * cfg.in_shape[0] * cfg.in_shape[1] * channels * in_bytes
    out_b = frames_per_step * cfg.out_shape[0] * cfg.out_shape[1] * channels * out_bytes
    if remote_fraction is None:
        remote_fraction = (hosts - 1) / hosts
    t_dcn = latency_s + remote_fraction * (in_b + out_b) / dcn_bw
    exposed = max(0.0, t_dcn - step_s)
    return {
        "in_bytes": in_b,
        "out_bytes": out_b,
        "remote_fraction": remote_fraction,
        "t_dcn_s": t_dcn,
        "t_hidden_s": step_s,
        "exposed_s": exposed,
        "efficiency": step_s / (step_s + exposed),
    }


def measure_ici_bw(
    mesh: Mesh,
    axis: str = "rows",
    nbytes: int = 8 << 20,
    iters: int = 10,
) -> float:
    """Measured per-direction ring-ppermute bandwidth (bytes/s) on the
    given mesh axis — the number :func:`ici_halo_model`'s ``ici_bw``
    slot takes (NVLink between the cards of one host).

    Needs a ring of ≥ 2 devices on ``axis`` — on one device the ppermute
    is a self-copy and the number would be device-memory noise, not a
    link (``ValueError``).  Each exchange is timed with its own
    ``block_until_ready``, which also keeps the collective queue shallow:
    hundreds of undrained in-process CPU collectives abort inside XLA's
    thunk executor.  The median of ``iters`` barriered calls is returned;
    on a virtual CPU mesh the number is host-memcpy noise (useful only to
    exercise the API).
    """
    import time

    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    n = int(mesh.shape[axis])
    if n < 2:
        raise ValueError(
            f"measure_ici_bw needs >= 2 devices on axis {axis!r} (got "
            f"{n}): a 1-ring ppermute is a self-copy, not a link hop"
        )
    x = jax.device_put(
        jnp.zeros((n, nbytes), jnp.uint8), NamedSharding(mesh, P(axis))
    )
    perm = [(i, (i + 1) % n) for i in range(n)]
    fn = jax.jit(
        jax.shard_map(
            lambda v: jax.lax.ppermute(v, axis, perm),
            mesh=mesh,
            in_specs=P(axis),
            out_specs=P(axis),
        )
    )
    jax.block_until_ready(fn(x))  # compile + connect
    times = []
    for _ in range(max(3, iters)):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(x))
        times.append(time.perf_counter() - t0)
    times.sort()
    return nbytes / times[len(times) // 2]
