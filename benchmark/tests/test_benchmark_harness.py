"""CPU tests of the benchmark's harness and yardstick.

Run from the repository's root: ``python -m pytest benchmark/tests -q``.
"""

from __future__ import annotations

import json
import math
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from benchmark import compare as C
from benchmark import data as D
from benchmark import flops as F
from benchmark import harness as H

ROOT = H.ROOT

TOY_MIX = '''
from benchmark import harness as H


def run(cell, t_start):
    n = cell.params["requests"]
    return H.Outcome(end_to_end={"toy_rate": n / cell.seconds, "setup_s": 0.5},
                     attempted=n, failed=0, checks=[H.Check("toy_gap", 0.0, 1e-6)],
                     counters={"units": n * cell.config["width"]})
'''
TOY_METRIC = '''
def read(ctx):
    return ctx["counters"]["units"] / 2
'''


def test_a_new_config_cell_mix_and_metric_are_files_alone(tmp_path):
    """A toy configuration, cell, mix and per-layer metric dropped into a
    copy of the benchmark's folders run with no code edited."""
    repo = tmp_path / "repo"
    shutil.copytree(os.path.join(ROOT, "benchmark"), repo / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = H.benchmark_json()
    bench["configs"].append({"name": "toy", "source": "https://example.org/toy",
                             "file": "benchmark/configs/toy.json", "reduced": [], "why": "toy"})
    bench["workloads"].append({"name": "toy.cell", "config": "toy", "traffic": "toy",
                               "chips": 1, "why": "toy"})
    bench["end_to_end"].append({"name": "toy_rate", "unit": "1/s", "better": "higher",
                                "bound": 0.05, "source": "host_clock", "workloads": ["toy.cell"]})
    bench["per_layer"].append({"name": "toy_units", "unit": "units", "better": "higher",
                               "source": "program_counter", "layer": "toy", "moves": "toy_rate",
                               "workloads": ["toy.cell"]})
    (repo / "BENCHMARK.json").write_text(json.dumps(bench))
    (repo / "benchmark/configs/toy.json").write_text(json.dumps({"width": 3}))
    (repo / "benchmark/workloads/toy.cell.json").write_text(
        json.dumps({"mix": "toy_mix", "requests": 8}))
    (repo / "benchmark/mixes/toy_mix.py").write_text(TOY_MIX)
    (repo / "benchmark/metrics/toy_units.py").write_text(TOY_METRIC)
    code = ("import sys; from benchmark import run; "
            "sys.exit(run.main(sys.argv[1:], device='cpu'))")
    lines = {}
    for trace in ("0", "1"):
        out = subprocess.run([sys.executable, "-c", code, "--workload", "toy.cell", "--seed",
                              "4294967311", "--seconds", "2", "--trace", trace],
                             cwd=repo, capture_output=True, text=True, timeout=120)
        assert out.returncode == 0, out.stderr
        lines[trace] = json.loads(out.stdout.strip().splitlines()[-1])
        assert "compared toy_gap 0.0 limit 1e-06 ok" in out.stderr.strip().splitlines()[-1]
    assert lines["0"]["correct"] is True
    assert lines["0"]["metrics"] == {"toy_rate": {"value": 4.0, "unit": "1/s"},
                                     "setup_s": {"value": 0.5, "unit": "s"}}
    assert lines["1"]["metrics"] == {"toy_units": {"value": 12.0, "unit": "units"}}
    assert list(lines["0"])[-1] == "compared"


def test_a_run_without_a_card_prints_no_result():
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                          "mgnns-tumemo.train-b16", "--seed", "1", "--seconds", "1"],
                         cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 2 and out.stdout == ""


def test_a_run_outside_a_checkout_with_the_program_fails(tmp_path):
    """A directory holding only BENCHMARK.json and the benchmark's folder
    has no program to run: the run fails and prints no result."""
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    code = ("import sys; from benchmark import run; "
            "sys.exit(run.main(sys.argv[1:], device='cpu'))")
    out = subprocess.run([sys.executable, "-c", code, "--workload", "mgnns-tumemo.eval-b128",
                          "--seed", "1", "--seconds", "1"], cwd=tmp_path, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_benchmark_json_keeps_the_contract():
    bench = H.benchmark_json()
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(names) == len(set(names))
    cells = {w["name"] for w in bench["workloads"]}
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    for w in bench["workloads"]:
        assert len(w["why"]) <= 200
        assert os.path.exists(os.path.join(ROOT, "benchmark", "workloads", f"{w['name']}.json"))
        reported = [m for m in e2e.values() if w["name"] in m.get("workloads", cells)]
        assert "setup_s" in {m["name"] for m in reported} and len(reported) >= 2
    for m in bench["per_layer"]:
        assert os.path.exists(os.path.join(ROOT, "benchmark", "metrics", f"{m['name']}.py"))
        assert m["moves"] in e2e
        for cell in m.get("workloads", []):
            assert cell in e2e[m["moves"]].get("workloads", cells)
    for c in bench["configs"]:
        assert os.path.exists(os.path.join(ROOT, c["file"]))


def test_the_open_loop_schedule_repeats_from_its_seed():
    a, b = D.schedule(50.0, 10.0, 2 ** 33 + 5), D.schedule(50.0, 10.0, 2 ** 33 + 5)
    c = D.schedule(50.0, 10.0, 7)
    np.testing.assert_array_equal(a, b)
    assert len(a) == 500 and a[0] == 0.0 and np.all(np.diff(a) > 0) and a[-1] < 10.0
    assert not np.array_equal(a, c)
    # every seed offers the same gaps, in another order
    def gaps(t):
        return np.sort(np.diff(np.append(t, 10.0)))

    np.testing.assert_allclose(gaps(a), gaps(c), rtol=1e-9, atol=1e-12)


def test_percentiles_rank_failed_requests_as_slowest():
    lat = [0.01 * i for i in range(1, 96)]
    assert C.percentile(lat, 0, 50) == pytest.approx(0.48)
    assert C.percentile(lat, 5, 95) == pytest.approx(0.95)
    assert C.percentile(lat, 6, 95) == math.inf
    assert C.percentile([], 3, 50) == math.inf


def test_norm_gap_and_logit_gap():
    ref = {"a": 1.0, "b": 2.0, "c": 1e-9}
    assert C.norm_gap(ref, ref) == 0.0
    assert C.norm_gap({"a": 1.1, "b": 2.0, "c": 0.0}, ref) == pytest.approx(0.1)
    assert C.norm_gap({"a": 1.0, "b": 2.0}, ref) == 1.0  # a leaf it never moved
    logits = np.array([[0.0, 1.0, 0.5], [2.0, 0.0, 0.0]])
    assert C.logit_gap(logits, np.array([1, 0])) == 0.0
    assert C.logit_gap(logits, np.array([2, 0])) == pytest.approx(0.5)


def test_kernel_least_times_count_each_byte_once():
    lens = np.array([3, 0, 5])
    L, D_, g = 6, 4, 1
    pairs = (3 + 2 + 2) + 0 + (5 + 4 + 4)  # valid (position, slot) pairs at offsets 0, +-1
    k1_bytes = 8 * D_ * 4 + 8 * 3 * 4 + 3 * 4 + 3 * L * D_ * 4
    k2_bytes = 8 * D_ * 4 * 2 + 8 * 3 * 4 + 3 * 4 + 3 * L * (D_ + 3) * 4
    assert F.k1_least_seconds(lens, L, D_, g) == pytest.approx(
        max(k1_bytes / F.HBM_BYTES_PER_S, 2 * pairs * D_ / F.PEAK_FLOPS["float32"]))
    assert F.k2_least_seconds(lens, L, D_, g) == pytest.approx(
        max(k2_bytes / F.HBM_BYTES_PER_S, 12 * pairs * D_ / F.PEAK_FLOPS["float32"]))
    # at the cell's sizes K1 and K2 are bound by bytes
    full = np.full(16, 100)
    assert F.k1_least_seconds(full, 100, 300, 4) == pytest.approx(
        (16 * 100 * 300 * 4 * 2 + 16 * 100 * 9 * 4 + 16 * 4) / F.HBM_BYTES_PER_S)
