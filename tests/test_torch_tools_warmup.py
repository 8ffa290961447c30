"""The port's last measuring tools on the CPU at tiny widths (64 px, 5/6
label classes, L=16, 8 records): ``mgnns_tpu_torch/tools/{full_split_fused_
eval,eval_batch_ladder,warmup_breakdown}.py``.  Each ``main`` prints one
JSON line with the JAX tool's keys (the ladder a line per rung before it)
and writes it under ``results/torch/``; the ladder records a rung that ran
out of device memory and goes on; the warm-up breakdown's three modes
(warm, cold, pipelined) report their phases, and the cold mode builds into
a fresh directory that it removes.  On the CPU no card was measured, so the
ladder's TFLOP/s and share of peak are null."""

import json
import os

import numpy as np
import pytest
import torch

from mgnns_tpu_torch.config import TextGraphConfig
from mgnns_tpu_torch.kernels import build
from mgnns_tpu_torch.tools import _bench_util as U
from mgnns_tpu_torch.tools import eval_batch_ladder, full_split_fused_eval, warmup_breakdown


CPU = ["--platform", "cpu"]
N = 8


@pytest.fixture
def data():
    return U.flagship_data("synthetic", n_records=N, image_size=64,
                           graph_cfg=TextGraphConfig(max_len=16), label_classes=(5, 6))


@pytest.fixture
def results(tmp_path, monkeypatch):
    monkeypatch.setattr(U, "RESULTS_DIR", str(tmp_path))
    return tmp_path


def _printed(capsys) -> list[str]:
    return capsys.readouterr().out.splitlines()


def _written(results, name: str, out: dict) -> None:
    with open(results / f"{name}.json") as f:
        assert json.load(f) == out


def test_full_split_fused_eval(data, results, monkeypatch, capsys):
    """The whole split through the captured-eval path (eagerly on the CPU)
    from device tables: every record counted, both epochs fused."""
    monkeypatch.setenv("FSE_BATCH", "4")
    out = full_split_fused_eval.main(CPU, data=data)
    lines = _printed(capsys)
    assert len(lines) == 1 and json.loads(lines[0]) == out
    _written(results, "full_split_fused_eval", out)
    assert {"n_samples", "batch", "fused", "samples_per_sec", "epoch_seconds",
            "first_epoch_fused", "warmup_seconds_incl_table_upload_and_compile"} <= set(out)
    assert out["n_samples"] == N and out["batch"] == 4
    assert out["fused"] and out["first_epoch_fused"]
    assert out["samples_per_sec"] > 0 and out["epoch_seconds"] > 0
    assert out["warmup_seconds_incl_table_upload_and_compile"] > 0
    assert out["pixel_table_bytes"] == N * 64 * 64 * 3
    assert out["device"] == {"name": "cpu", "power_limit": None} and out["data"] == "synthetic"
    assert "peak_memory_bytes" not in out and "launches" not in out


@pytest.mark.parametrize("oom_at", [None, 2], ids=["all_rungs", "oom_rung"])
def test_eval_batch_ladder(data, results, monkeypatch, capsys, oom_at):
    """A rung per ``EVAL_LADDER`` batch with seconds and samples/s; a rung
    whose epoch raises ``torch.cuda.OutOfMemoryError`` is recorded with it
    and the next rung still runs."""
    monkeypatch.setenv("EVAL_LADDER", "2,4")
    monkeypatch.setattr(eval_batch_ladder, "ITERS", 1)
    timed = U.timed

    def maybe_oom(fn, args, iters, readback):
        if args[0].batch_size == oom_at:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory (injected)")
        return timed(fn, args, iters, readback)

    monkeypatch.setattr(U, "timed", maybe_oom)
    out = eval_batch_ladder.main(CPU, data=data)
    lines = _printed(capsys)
    assert len(lines) == 3 and json.loads(lines[-1]) == out
    assert lines[0].startswith("[ladder] B=2: ") and lines[1].startswith("[ladder] B=4: ")
    _written(results, "eval_batch_ladder", out)
    assert [r["batch"] for r in out["rungs"]] == [2, 4]
    assert out["peak_bf16_matmul_tflops"] is None and out["samples"] == N
    ok = out["rungs"][1:] if oom_at else out["rungs"]
    for r in ok:
        assert set(r) == {"batch", "seconds", "samples_per_sec", "tflops", "pct_of_peak"}
        assert r["seconds"] > 0 and r["samples_per_sec"] == pytest.approx(r["batch"] / r["seconds"])
        assert r["tflops"] is None and r["pct_of_peak"] is None
    if oom_at:
        assert out["rungs"][0] == {"batch": 2, "error": "OutOfMemoryError: CUDA out of memory "
                                                        "(injected)"}
    assert out["best"] == max(ok, key=lambda r: r["samples_per_sec"])


WARMUP_KEYS = {"setup_seconds", "text_table_upload_seconds", "h2d_probe_mb_per_s",
               "first_epoch_seconds", "capture_seconds", "epoch_seconds", "samples_per_sec",
               "fused", "time_to_first_result_seconds", "upload_mb", "n_samples", "batch",
               "cache_mode", "device", "data"}


@pytest.mark.parametrize("mode", ["warm", "cold", "pipelined"])
def test_warmup_breakdown(data, results, monkeypatch, capsys, mode):
    """The JAX tool's phases: decode and upload apart (warm, cold), or the
    loader's chunked table build (pipelined); the eval epochs over the
    resident tables; the copy probe last.  Cold points the build directory
    at a fresh temporary one for the run, then removes it and restores the
    old one."""
    monkeypatch.setenv("WB_BATCH", "4")
    monkeypatch.setattr(warmup_breakdown, "PROBE_MB", 2)
    monkeypatch.delenv("MGNNS_COLD", raising=False)
    monkeypatch.delenv("WB_PIPELINED", raising=False)
    if mode == "cold":
        monkeypatch.setenv("MGNNS_COLD", "1")
    if mode == "pipelined":
        monkeypatch.setenv("WB_PIPELINED", "1")
    warm_dir = build.BUILD_DIR
    seen = []
    model = U.flagship_model

    def recording(*a, **kw):
        seen.append(build.BUILD_DIR)
        return model(*a, **kw)

    monkeypatch.setattr(U, "flagship_model", recording)
    out = warmup_breakdown.main(CPU, data=data)
    lines = _printed(capsys)
    assert len(lines) == 1 and json.loads(lines[0]) == out
    _written(results, f"warmup_breakdown_{mode}", out)
    phases = ({"table_build_seconds", "table_build_mb_per_s"} if mode == "pipelined"
              else {"decode_seconds", "upload_seconds", "upload_mb_per_s"})
    assert set(out) == WARMUP_KEYS | phases
    assert out["cache_mode"] == ("cold" if mode == "cold" else "warm")
    assert out["n_samples"] == N and out["batch"] == 4 and out["fused"]
    assert out["upload_mb"] == pytest.approx(N * 64 * 64 * 3 / (1 << 20))
    assert all(out[k] >= 0 for k in WARMUP_KEYS | phases
               if isinstance(out[k], float))
    assert out["time_to_first_result_seconds"] > out["first_epoch_seconds"] > 0
    assert build.BUILD_DIR == warm_dir
    if mode == "cold":
        assert seen[0] != warm_dir and os.path.basename(seen[0]).startswith("mgnns_cold_build_")
        assert not os.path.exists(seen[0])
    else:
        assert seen == [warm_dir]


def test_warmup_breakdown_tables_feed_the_loader(data, monkeypatch, results, capsys):
    """The table the tool uploads is the one the loader's epochs gather
    from: equal to the loader's own build, row for row."""
    from mgnns_tpu_torch.data.loader import DeviceLoader

    monkeypatch.setenv("WB_BATCH", "4")
    monkeypatch.setattr(warmup_breakdown, "PROBE_MB", 2)
    monkeypatch.delenv("WB_PIPELINED", raising=False)
    monkeypatch.delenv("MGNNS_COLD", raising=False)
    warmup_breakdown.main(CPU, data=data)
    loader = DeviceLoader(data.ds, 4, device_images=True, device="cpu")
    table, row_shape = loader._ensure_image_table()
    assert row_shape == (64, 64, 3) and table.dtype == torch.uint8
    fresh = U.flagship_data("synthetic", n_records=N, image_size=64,
                            graph_cfg=TextGraphConfig(max_len=16), label_classes=(5, 6))
    want, _ = DeviceLoader(fresh.ds, 4, device_images=True, device="cpu")._ensure_image_table()
    np.testing.assert_array_equal(table.numpy(), want.numpy())
