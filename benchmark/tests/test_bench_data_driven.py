"""A configuration, a traffic mix and a per-layer metric are each one file
that the harness finds by name: in a temporary copy of the benchmark, a
throwaway configuration, mix and metric, plus their entries in
BENCHMARK.json and a limits file, make a cell that runs without an edit to
any file that was there."""

from __future__ import annotations

import json
import os
import shutil

from benchmark import run, spec

from .util import ROOT, SEED, small_limits, small_overrides


def test_new_cell_from_new_files_only(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "benchmark"), root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    before = {p: p.read_bytes() for p in root.rglob("*") if p.is_file()}

    b = root / "benchmark"
    cfg = json.loads((b / "configs" / "tum_fr1-pallas.json").read_text())
    cfg.update(name="throwaway-xla", align_backend="xla")
    (b / "configs" / "throwaway-xla.json").write_text(json.dumps(cfg))
    traffic = json.loads((b / "traffic" / "track.json").read_text())
    traffic["trajectory"] = {"kind": "loop", "frames": 8, "radius": 0.05,
                             "lift": 0.02, "yaw_amp": 0.03}
    traffic["warmup"] = {"frames": 2}
    (b / "traffic" / "slow_circle.json").write_text(json.dumps(traffic))
    (b / "metrics" / "max_frame_ms.py").write_text(
        '"""max_frame_ms: the slowest window frame."""\n\n\n'
        "def read(window, cvo):\n"
        "    lat = [f.latency_s for f in window.frames]\n"
        "    return 1e3 * max(lat) if lat else None\n")
    lim = json.loads((b / "limits" / "tum_fr1-pallas.track.json")
                     .read_text())
    (b / "limits" / "throwaway-xla.slow_circle.json").write_text(
        json.dumps(lim))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "throwaway-xla",
                             "source": "https://example.org/throwaway",
                             "file": "benchmark/configs/throwaway-xla.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "throwaway-xla.slow_circle",
                               "config": "throwaway-xla",
                               "traffic": "slow_circle", "chips": 1,
                               "why": "a test"})
    bench["per_layer"].append({"name": "max_frame_ms", "unit": "ms",
                               "better": "lower", "source": "host_clock",
                               "layer": "tracker", "moves": "fps",
                               "workloads": ["throwaway-xla.slow_circle"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = spec.load_cell("throwaway-xla.slow_circle", str(root))
    assert "max_frame_ms" in cell.readers
    ov = small_overrides(cell)
    res = run.run_cell(cell, SEED, 1.0, True, "cpu", overrides=ov,
                       root=str(root), limits=small_limits(cell, str(root)))
    assert res["metrics"]["max_frame_ms"]["value"] > 0
    assert res["correct"], res["check"]
    changed = [p for p, data in before.items() if p.read_bytes() != data]
    assert changed == [root / "BENCHMARK.json"]
