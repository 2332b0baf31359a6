"""On the card: one short run of a tracking cell through the command the
driver runs, its result line of the contract's shape and correct; the
faults of test_bench_faults.py at the cells' size against the cells'
limits; the SLAM cell's check on other noise draws. Skips without a CUDA
card (decided inside each test)."""

from __future__ import annotations

import copy
import json
import os
import subprocess
import sys

import pytest

from benchmark import run, spec

from .test_bench_faults import CELLS, FAULTS
from .util import ROOT, SEED


@pytest.mark.gpu
def test_short_run_on_the_card(tmp_path):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    env = dict(os.environ, TMPDIR=str(tmp_path))
    out = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload",
         "tum_fr1-pallas.track", "--seed", str(SEED), "--seconds", "3",
         "--trace", "0"], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(res)[-1] == "check"
    assert res["correct"], res["check"]
    assert res["device"]["platform"] == "gpu"
    assert out.stderr.strip().splitlines()[-1].startswith("check ")


def _card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _report(label, res):
    print(f"\n{label}: correct {res['correct']} attempted "
          f"{res['attempted']} check {json.dumps(res['check'])} readings "
          f"{json.dumps(res['readings'])}", flush=True)


# a window long enough for the cell's answers that the check samples:
# a few tracked frames, or (with the SLAM backend) loop-closure rounds
# and windowed BAs after the warm-up
CARD_SECONDS = {True: 4.0, False: 30.0}


@pytest.mark.gpu
@pytest.mark.parametrize("name,fault", [(c, f) for c in CELLS
                                        for f in sorted(FAULTS[c])])
def test_fault_on_the_card(name, fault, monkeypatch):
    """Each fault of test_bench_faults.py at the cell's own size, against
    the cell's limits: not correct."""
    _card()
    FAULTS[name][fault](monkeypatch)
    cell = spec.load_cell(name)
    res = run.run_cell(cell, SEED + 1, CARD_SECONDS[
        cell.traffic["tracking_only"]], False, "cuda:0")
    _report(f"{name} {fault}", res)
    assert not res["correct"], res["check"]


@pytest.mark.gpu
@pytest.mark.parametrize("seed", [SEED + 11, SEED + 12, SEED + 13])
def test_noise_draw_on_the_card(seed):
    """The SLAM cell's check on sensor noise drawn from the run's seed
    instead of the mix's own noise seed (a check-only pass: the timed runs
    keep the fixed draw): correct against the cell's limits."""
    _card()
    cell = spec.load_cell("tum_fr1-pallas.slam_loop")
    cell.traffic = copy.deepcopy(cell.traffic)
    del cell.traffic["scene"]["noise_seed"]
    res = run.run_cell(cell, seed, CARD_SECONDS[False], False, "cuda:0")
    _report(f"noise draw {seed}", res)
    assert res["correct"], res["check"]
