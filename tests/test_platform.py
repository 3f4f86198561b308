"""The platform module: the one owner of platform-dependent choices."""

import os
import pathlib
import subprocess
import sys

import jax
import pytest

from lanczos_tpu import platform
from lanczos_tpu.core.config import ResampleConfig
from lanczos_tpu.models.upscaler import Upscaler

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _cfg(profile="precise", shape=(48, 64), **kw):
    kw.setdefault("scale", (2, 1))
    return ResampleConfig.from_profile(profile, shape, a=3, **kw)


# config class -> (auto on the card, auto on the CPU)
CASES = {
    "linear_fp32": (dict(), "pallas", "shift_xla"),
    "linear_bf16": (dict(precision="bf16"), "pallas", "shift_xla"),
    "rational_large_n": (
        dict(scale=None, out_shape=(97, 129)), "pallas", "block"
    ),
    "downscale": (dict(scale=(1, 2)), "pallas", "shift_xla"),
    "dering": (dict(dering=True), "pallas", "shift_xla"),
    "drop_dering": (
        dict(dering=True, edge_mode="drop", normalize=False), "pallas", "block"
    ),
    "drop_normalize": (
        dict(edge_mode="drop", normalize=True), "pallas", "block"
    ),
    "width_first_quantize": (
        dict(order="width_first", intermediate_quantize=True), "pallas", "block"
    ),
    "hls": (dict(profile="hls"), "xla", "xla"),
    "c_oracle": (dict(profile="c_oracle"), "xla", "xla"),
}


@pytest.mark.parametrize("where", ["gpu", "cpu"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_auto_backend_per_platform(monkeypatch, case, where):
    """``auto`` per (platform × config class): the fused kernel on the card
    wherever it plans and wins its measured cell, never off the card; the
    plain-XLA order shift_xla → block → gather otherwise."""
    kw, on_gpu, on_cpu = CASES[case]
    kw = dict(kw)
    profile = kw.pop("profile", "precise")
    if kw.get("scale", ()) is None:
        kw.pop("scale")
    cfg = _cfg(profile, **kw)
    monkeypatch.setattr(platform, "name", lambda: where)
    assert platform.auto_backend(cfg) == (on_gpu if where == "gpu" else on_cpu)


def test_upscaler_auto_follows_platform():
    """Upscaler resolves ``auto`` once, at construction, through the
    platform module (and the exact profiles to their own paths)."""
    for cfg in (_cfg(), _cfg(dering=True), _cfg(scale=(3, 2))):
        assert Upscaler(cfg).backend == platform.auto_backend(cfg)
    assert Upscaler(_cfg("c_oracle")).backend == "c_exact"


def test_pallas_interpret_only_without_card(monkeypatch):
    assert platform.pallas_interpret()  # tests run on the CPU
    monkeypatch.setattr(platform, "name", lambda: "gpu")
    assert not platform.pallas_interpret()


def test_compile_cache_follows_env(monkeypatch):
    """With JAX_COMPILATION_CACHE_DIR set the program sets no cache of its
    own (JAX reads the variable itself)."""
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/somewhere/else")
    before = jax.config.jax_compilation_cache_dir
    assert platform.compile_cache_dir() is None
    platform.enable_compile_cache()
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_fixed_dir_in_checkout(monkeypatch):
    """Without the variable the cache is the fixed .jax_cache/ inside the
    checkout — never a temp name, a pid or a time — and git ignores it."""
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = platform.compile_cache_dir()
    assert path == str(ROOT / ".jax_cache")
    assert path == platform.compile_cache_dir()  # stable across calls
    before = jax.config.jax_compilation_cache_dir
    try:
        platform.enable_compile_cache()
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
    assert ".jax_cache/" in (ROOT / ".gitignore").read_text().splitlines()


def test_only_platform_module_asks_for_the_backend():
    """One owner: no other module calls jax.default_backend()."""
    offenders = []
    for path in ROOT.rglob("*.py"):
        rel = path.relative_to(ROOT)
        if rel.parts[0].startswith((".", "_wip")) or rel.parts[0] == "tests":
            continue
        text = path.read_text()
        if "default_backend(" in text and rel != pathlib.Path(
            "lanczos_tpu/platform.py"
        ):
            offenders.append(str(rel))
    assert offenders == []


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_exits_nonzero_without_gpu(tmp_path, alone):
    """chip_smoke.py fails, printing no result line, with no GPU — and in
    a directory holding chip_smoke.py and nothing else of the repo."""
    script = ROOT / "chip_smoke.py"
    cwd = ROOT
    if alone:
        (tmp_path / "chip_smoke.py").write_text(script.read_text())
        script, cwd = tmp_path / "chip_smoke.py", tmp_path
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    r = subprocess.run(
        [sys.executable, str(script)], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
