"""The one place that knows which platform the program runs on.

Every platform-dependent decision goes through here:

- :func:`name` — the JAX backend in use (``"gpu"`` on the card, ``"cpu"``
  in tests); no other module calls ``jax.default_backend()``;
- :func:`auto_backend` — the formulation ``backend="auto"`` picks for a
  config on this platform (the sharded and streaming paths follow it);
- :func:`pallas_interpret` — whether Pallas kernels run in interpret mode
  (only on the CPU, i.e. tests: the Triton route needs the card);
- :func:`enable_compile_cache` — the persistent compilation cache.
"""

from __future__ import annotations

import os

import jax

# the fused Pallas kernel compiles through Triton, i.e. for this platform
_KERNEL_PLATFORM = "gpu"

# repo checkout root (this file lives in <root>/lanczos_tpu/)
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def name() -> str:
    """The JAX backend in use: ``"gpu"`` on the card, ``"cpu"`` otherwise."""
    return jax.default_backend()


def pallas_interpret() -> bool:
    """Pallas kernels run in interpret mode only where there is no card."""
    return name() == "cpu"


def auto_backend(cfg) -> str:
    """The formulation ``backend="auto"`` runs for ``cfg`` on this platform.

    On the card: the fused Pallas kernel wherever its plan exists (on an
    H100 it beats the plain-XLA formulations on every measured 4K config,
    dering included: 0.41 ms/frame against shift_xla's 0.47), else
    ``shift_xla``, then ``block``, then the gather path.  Off the card the
    kernel is never picked (its interpreter is for tests only).  The
    fixed-point and c_faithful profiles resolve to their own exact paths
    inside :class:`~lanczos_tpu.models.upscaler.Upscaler` whatever is
    returned here."""
    from lanczos_tpu.models.upscaler import (
        _block_eligible,
        _pallas_eligible,
        _shift_eligible,
    )

    if name() == _KERNEL_PLATFORM and _pallas_eligible(cfg):
        return "pallas"
    if _shift_eligible(cfg):
        return "shift_xla"
    if _block_eligible(cfg):
        return "block"
    return "xla"


def compile_cache_dir() -> str | None:
    """Where :func:`enable_compile_cache` points JAX's persistent cache:
    None when ``JAX_COMPILATION_CACHE_DIR`` is set (JAX reads it itself),
    else the fixed ``.jax_cache/`` inside the checkout — a stable path,
    since the path is part of the cache's key."""
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    return os.path.join(_ROOT, ".jax_cache")


def enable_compile_cache() -> None:
    """Turn on the persistent compilation cache (entry points call this)."""
    path = compile_cache_dir()
    if path is not None:
        jax.config.update("jax_compilation_cache_dir", path)
