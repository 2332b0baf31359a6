"""Each cell of BENCHMARK.json at a small size on the CPU, through the
harness's own code, ends in a result of the contract's shape."""

from __future__ import annotations

import json

import pytest

from benchmark import run

from .util import (SEED, cell_names, small_cell, small_limits,
                   window_seconds)

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def check_result(res, cell, trace: bool):
    keys = [k for k in res if k not in ("setup_parts", "readings")]
    assert keys[:5] == KEYS and keys[-1] == "check"
    assert set(keys) <= set(KEYS) | {"breakdown", "check"}
    json.dumps({k: res[k] for k in keys}, allow_nan=False)
    want = ({m["name"] for m in cell.per_layer} if trace
            else {m["name"] for m in cell.end_to_end})
    got = set(res["metrics"])
    assert got <= want
    for m in res["metrics"].values():
        assert set(m) == {"value", "unit"}
    for row in res["check"].values():
        assert set(row) == {"value", "limit"}


@pytest.mark.parametrize("name", cell_names())
def test_cell_small_on_cpu(name):
    cell, ov = small_cell(name)
    res = run.run_cell(cell, SEED, window_seconds(cell), False, "cpu",
                       overrides=ov,
                       limits=small_limits(cell))
    check_result(res, cell, trace=False)
    assert res["correct"], res["check"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert set(res["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert res["metrics"]["fps"]["value"] > 0


def test_traced_run_small_on_cpu():
    """A --trace 1 run on the CPU: the host-clock and counter metrics are
    read; the device ones find no device trace and are left out."""
    cell, ov = small_cell("tum_fr1-pallas_mom.track")
    res = run.run_cell(cell, SEED, 2.0, True, "cpu", overrides=ov,
                       limits=small_limits(cell))
    check_result(res, cell, trace=True)
    assert res["correct"]
    assert {"frontend_wait_ms", "align_iters_per_frame"} <= set(
        res["metrics"])
    assert "device_idle_pct" not in res["metrics"]
