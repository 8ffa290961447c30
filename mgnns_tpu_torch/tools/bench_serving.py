"""Serving latency and throughput of the port on one card.

The counterpart of the JAX package's ``tools/bench_serving.py``: the serving
path end to end (raw JSON records through preprocessing, the bucketed eval
forward and the softmax back to the host) for the text-only and the fusion
``Predictor``, and the HTTP micro-batching frontend under concurrent
clients.  Per model:

- ``direct``: ``predict`` at batch 1 and ``max_batch``, ``n_iters``
  sequential calls after a warm one: p50 / p99 latency, samples/s, and the
  medians of each call's ``serving.*`` spans (host encode, image decode,
  forward dispatch, readback; :mod:`mgnns_tpu_torch.tracing`);
- ``sustained``: ``BatchingFrontend`` under ``clients`` threads each
  submitting full batches, so that host encode overlaps the card;
- ``http``: ``cli.serve``'s handler and server in this process, ``clients``
  x ``reqs_per_client`` one-record requests over loopback: p50 / p99 wall
  latency and requests/s.

Every leg holds its answers to one in-process ``predict`` of the same
records (labels equal, probabilities within 1e-5: the frontend's batches
change the products' shapes) and reports the worst difference.

The checkpoints come from the port's training CLI on a synthetic 3-class
tree (:func:`mgnns_tpu_torch.tools._bench_util.cli_tree`): the text-only
model for 6 epochs, the fusion model for one epoch at bf16 on 32 records;
both are served as ``cli.serve`` serves them (float32, the fusion model at
the CLI's 448 px).

    python -m mgnns_tpu_torch.tools.bench_serving [--text-only]

It prints a line per leg and, last, one JSON line; it writes no file.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import shutil
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np

TEXTS = [
    "what a wonderful happy day full of joy and love",
    "sad terrible awful news today",
    "calm quiet evening by the lake",
    "this makes me so angry honestly",
]


def _records(n: int, with_image: bool) -> list[dict]:
    recs = [{"id": str(i), "text": TEXTS[i % len(TEXTS)]} for i in range(n)]
    if with_image:
        for r in recs:
            r["image"] = f"synthetic_{r['id']}.jpg"
    return recs


def _differ(got: list[dict], want: list[dict]) -> tuple[bool, float]:
    """(labels equal, max |probability difference|) of two answers."""
    labels = [g["label_id"] for g in got] == [w["label_id"] for w in want]
    diff = max(abs(g["probs"][k] - w["probs"][k]) for g, w in zip(got, want) for k in w["probs"])
    return labels, diff


def _pct(lat: list[float], q: float) -> float:
    return float(np.percentile(np.array(lat) * 1e3, q))


# the serving spans, by the stage names this tool reports
STAGE_SPANS = {"serving.encode_text": "encode_text_ms",
               "serving.decode_images": "decode_images_ms",
               "serving.dispatch": "forward_dispatch_ms", "serving.readback": "readback_ms"}


def _stage_ms(since_ns: int) -> dict:
    """Milliseconds of each serving span begun since ``since_ns``
    (``time.perf_counter_ns``), summed over the call's chunks."""
    from mgnns_tpu_torch import tracing

    out: dict = {}
    for s in tracing.spans("serving."):
        if s.start_ns >= since_ns:
            key = STAGE_SPANS[s.name]
            out[key] = out.get(key, 0.0) + (s.end_ns - s.start_ns) / 1e6
    return out


def bench_direct(pred, label: str, n_iters: int = 50) -> dict:
    out = {}
    for bs in (1, pred.max_batch):
        recs = _records(bs, not pred.text_only)
        want = pred.predict(recs)  # warm
        lat, stages, worst = [], [], (True, 0.0)
        for _ in range(n_iters):
            since = time.perf_counter_ns()
            t0 = time.perf_counter()
            got = pred.predict(recs)
            lat.append(time.perf_counter() - t0)
            stages.append(_stage_ms(since))
            eq, diff = _differ(got, want)
            worst = (worst[0] and eq, max(worst[1], diff))
        out[f"b{bs}"] = {
            "n": n_iters, "p50_ms": _pct(lat, 50), "p99_ms": _pct(lat, 99),
            "samples_per_sec": bs / float(np.median(lat)),
            "stage_p50_ms": {k: float(np.median([s[k] for s in stages if k in s]))
                             for k in sorted({k for s in stages for k in s})},
            "labels_equal": worst[0], "max_prob_diff": worst[1]}
    print(f"[serve-bench] {label} direct: {out}", file=sys.stderr, flush=True)
    return out


def bench_sustained(pred, label: str, clients: int = 3, reqs_per_client: int = 10) -> dict:
    """Full batches through the two-stage frontend: ``clients`` threads keep
    groups in flight, so host encode of group k+1 overlaps the card's
    forward of group k."""
    from mgnns_tpu_torch.serving import BatchingFrontend

    fe = BatchingFrontend(pred, max_queue=256)
    recs = _records(pred.max_batch, not pred.text_only)
    want = pred.predict(recs)
    answers: list = []
    try:
        fe.submit(recs, timeout=300)  # warm

        def client():
            for _ in range(reqs_per_client):
                answers.append(fe.submit(recs, timeout=300))

        t0 = time.perf_counter()
        threads = [threading.Thread(target=client) for _ in range(clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)
        wall = time.perf_counter() - t0
    finally:
        fe.close()
    checks = [_differ(a, want) for a in answers]
    n = len(answers) * pred.max_batch
    out = {"clients": clients, "batch": pred.max_batch, "samples": n,
           "samples_per_sec": n / wall, "requests": len(answers),
           "labels_equal": all(c[0] for c in checks),
           "max_prob_diff": max((c[1] for c in checks), default=0.0)}
    print(f"[serve-bench] {label} sustained: {out}", file=sys.stderr, flush=True)
    return out


def bench_http(pred, label: str, clients: int = 8, reqs_per_client: int = 25) -> dict:
    from mgnns_tpu_torch.cli.serve import Server, make_handler
    from mgnns_tpu_torch.serving import BatchingFrontend

    frontend = BatchingFrontend(pred, max_queue=256)
    server = Server(("127.0.0.1", 0), make_handler(frontend, label, pred.text_only, 60.0))
    server.frontend = frontend
    port = server.server_address[1]
    serving = threading.Thread(target=server.serve_forever, daemon=True)
    serving.start()
    rec = _records(1, not pred.text_only)[0]
    want = pred.predict([rec])
    body = json.dumps({"records": [rec]}).encode()
    lat: list = []
    checks: list = []
    errors = [0]
    lock = threading.Lock()

    def client():
        for _ in range(reqs_per_client):
            req = urllib.request.Request(f"http://127.0.0.1:{port}/predict", data=body,
                                         headers={"Content-Type": "application/json"})
            t0 = time.perf_counter()
            try:
                with urllib.request.urlopen(req, timeout=60) as r:
                    got = json.loads(r.read())["predictions"]
                with lock:
                    lat.append(time.perf_counter() - t0)
                    checks.append(_differ(got, want))
            except OSError:  # a refused, reset or timed-out request
                with lock:
                    errors[0] += 1

    try:
        client()  # warm through HTTP; its latencies and errors are dropped
        lat.clear()
        checks.clear()
        errors[0] = 0
        t_start = time.perf_counter()
        threads = [threading.Thread(target=client) for _ in range(clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)
        wall = time.perf_counter() - t_start
    finally:
        server.shutdown()
        server.server_close()
        serving.join(30)
    out = {"clients": clients, "requests": len(lat), "errors": errors[0],
           "p50_ms": _pct(lat, 50) if lat else None, "p99_ms": _pct(lat, 99) if lat else None,
           "requests_per_sec": len(lat) / wall,
           "labels_equal": all(c[0] for c in checks),
           "max_prob_diff": max((c[1] for c in checks), default=0.0)}
    print(f"[serve-bench] {label} http: {out}", file=sys.stderr, flush=True)
    return out


def floor_analysis(fusion: dict, image_size: int) -> dict:
    """Where the fusion model's batched serving stands: the pixel bytes a
    full batch copies to the card, the rate the sustained leg moved them at,
    and the direct leg's readback and decode medians at that batch.  The JAX
    tool's other entries read TPU records (its roofline's forward time) or
    a TPU-era target rate and are not ported."""
    batch = fusion["sustained"]["batch"]
    stage = fusion["direct"].get(f"b{batch}", {}).get("stage_p50_ms", {})
    mb = batch * image_size * image_size * 3 / 1e6  # uint8 pixels
    sps = fusion["sustained"]["samples_per_sec"]
    return {"pixel_mb_per_batch": mb, "sustained_samples_per_sec": sps,
            "effective_h2d_mb_per_s": sps / batch * mb,
            "readback_p50_ms": stage.get("readback_ms"),
            "decode_p50_ms": stage.get("decode_images_ms")}


def leg_ok(model: dict) -> bool:
    """Whether every leg of a model's results answered as in-process
    ``predict`` (labels equal, probabilities within 1e-5) with no HTTP
    error."""
    legs = [*model["direct"].values(), model["sustained"], model["http"]]
    return model["http"]["errors"] == 0 and all(
        leg["labels_equal"] and leg["max_prob_diff"] <= 1e-5 for leg in legs)


def _train(root: str, name: str, extra: list[str], platform: str) -> str:
    """The training CLI on ``root``; returns the checkpoint directory."""
    from mgnns_tpu_torch.cli import main as cli_main

    out = os.path.join(root, name)
    with contextlib.redirect_stdout(sys.stderr):
        cli_main.main(["--data_root_path", root, "--num_labels", "3", "--text_min_count", "1",
                       "--platform", platform, "--save_model_path", os.path.join(out, "ckpt"),
                       "--save_experiment_result_path", os.path.join(out, "exp"),
                       "--save_pred_result_path", os.path.join(out, "pred"),
                       "--metrics_path", os.path.join(out, "metrics.jsonl")] + extra)
    return os.path.join(out, "ckpt", "mgnns_tpu")


def main(argv=None) -> int:
    from mgnns_tpu_torch.serving import Predictor
    from mgnns_tpu_torch.tools._bench_util import cli_tree, device_info
    from mgnns_tpu_torch.utils import resolve_device

    p = argparse.ArgumentParser(description="serving latency of the PyTorch/CUDA port")
    p.add_argument("--platform", choices=["cuda", "cpu"], default="cuda")
    p.add_argument("--text-only", action="store_true", help="only the text-only model")
    args = p.parse_args(argv)
    dev = resolve_device(args.platform)
    root = tempfile.mkdtemp(prefix="mgnns_serve_bench_")
    results: dict = {"device": device_info(dev), "data": "synthetic 3-class tree"}
    try:
        with contextlib.redirect_stdout(sys.stderr):
            cli_tree(root)
        ckpt = _train(root, "text", ["--text_only", "--epochs", "6", "-b", "30", "--lr", "5e-2"],
                      args.platform)
        pred = Predictor.from_engine_artifacts(root, ckpt, text_only=True, max_batch=16,
                                               device=dev)
        pred.warm()
        results["text"] = {"direct": bench_direct(pred, "text"),
                           "sustained": bench_sustained(pred, "text"),
                           "http": bench_http(pred, "text")}
        pred.close()
        if not args.text_only:
            ckpt = _train(root, "fusion", ["--compute_dtype", "bfloat16", "--limit_samples",
                                           "32", "--epochs", "1", "-b", "16"], args.platform)
            pred = Predictor.from_engine_artifacts(
                root, ckpt, max_batch=16, image_backend="synthetic", strict_images=False,
                device=dev)
            pred.warm()
            fusion = {"image_size": pred.image_size,
                      "direct": bench_direct(pred, "fusion", n_iters=25),
                      "sustained": bench_sustained(pred, "fusion"),
                      "http": bench_http(pred, "fusion", clients=8, reqs_per_client=10)}
            fusion["floor_analysis"] = floor_analysis(fusion, pred.image_size)
            results["fusion"] = fusion
            pred.close()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(json.dumps(results))
    if not all(leg_ok(results[m]) for m in ("text", "fusion") if m in results):
        raise SystemExit("a serving leg failed or its answers differ from in-process predict")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
