"""Open-loop serving: one-post requests sent on a seeded Poisson schedule at
a fixed rate into ``BatchingFrontend.submit``, in front of a ``Predictor``
of the fusion model (a text and a JPEG) or of the text-only model.

Set-up writes the seed's JPEGs (fusion), draws the weights (the fusion
trunks' running statistics calibrated on some of those images), builds the
``Predictor`` from the vocabulary, PMI graph, label map and weights, warms
its batch buckets, and starts the front end.  The window sends every
request due in it from a pool of client threads; each is timed from its
due time to its delivered answer, so a stall counts against every request
behind it.  A request refused (``Busy``), timed out or failed counts in
``failed`` and ranks as the slowest in both percentiles.  The generator's
lateness is printed on standard error.

Once every request is answered or has failed and the program is freed,
the reference encodes a seeded sample of the posts answered (the longest
among them) from their text and image files, runs the model in IEEE
float32, and ``prob_gap`` reads the widest gap between a delivered
probability and the reference's; ``unanswered`` counts requests that never
got an answer (a refusal is an answer).
"""

from __future__ import annotations

import math
import os
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from benchmark import compare as C
from benchmark import data as D
from benchmark import harness as H
from benchmark import program as P
from benchmark import trace as TR
from benchmark import weights as W
from benchmark.reference import model as R
from benchmark.reference import text as T


def reference_probs(cfg, wl, weights, posts, images, root, vocab, keys, device,
                    tf32=False) -> np.ndarray:
    """[n, labels] float64 probabilities of the reference on ``posts``."""
    out = []
    with torch.no_grad(), R.precision(tf32):
        for s in range(0, len(posts), 16):
            enc = T.encode(posts[s:s + 16], vocab, keys, cfg["max_len"], cfg["ngram"])
            if images is not None:
                enc["image"] = np.stack([T.decoded_pixels(os.path.join(root, n),
                                                          cfg["image_size"])
                                         for n in images[s:s + 16]])
            batch = {k: torch.as_tensor(v, device=device) for k, v in enc.items()}
            if images is None:
                logits = R.text_forward(weights, batch)
            else:
                params, stats, consts = weights
                logits, _ = R.fusion_forward(params, stats, consts, batch, cfg)
            out.append(torch.softmax(logits.float(), -1).double().cpu().numpy())
    return np.concatenate(out)


class Served:
    """The program and the inputs of one serving cell, set up once."""

    def __init__(self, cell: H.Cell):
        from mgnns_tpu_torch.serving import BatchingFrontend, Predictor

        self.cell = cell
        cfg, wl, dev = cell.config, cell.params, cell.device
        self.fusion = cfg["model"] == "fusion"
        self.vocab, _, self.keys, pmi = D.text_side(cfg)
        E = len(self.keys) + 1
        wseed = cell.seed % 2 ** 63
        self.posts = D.posts(cfg, wl["posts"], wl["min_tokens"], wl["max_tokens"], cell.seed)
        self.tmp = tempfile.TemporaryDirectory()
        root = self.root = self.tmp.name
        common = dict(vocab=self.vocab, graph=P.pmi_graph(self.vocab, self.keys, pmi),
                      graph_cfg=P.graph_config(cfg), label_map=D.write_label_map(root, cfg),
                      max_batch=wl["max_batch"], device=dev)
        self.images = None
        if self.fusion:
            names = D.write_jpegs(root, wl["images"], wl["min_side"], wl["max_side"], cell.seed)
            self.images = [names[int(i)] for i in
                           D.rng(cell.seed, 8).integers(0, len(names), len(self.posts))]
            params, stats, consts = W.fusion_weights(cfg, E, D.constants(cfg, cell.seed), wseed,
                                                     dev)
            calib = np.stack([T.decoded_pixels(os.path.join(root, n), cfg["image_size"])
                              for n in names[:wl["calibration_images"]]])
            W.calibrate(params, stats, torch.as_tensor(calib, device=dev), torch.float32)
            # the reference's copy waits on the host, out of the program's memory
            self.host = [R.unflatten(t, [x.cpu() for x in R.leaves(t)])
                         for t in (params, stats, consts)]
            self.pred = Predictor(params=params, batch_stats=stats, consts=consts,
                                  cfg=P.model_config(cfg, wl, E), image_backend="pil",
                                  image_root=root, **common)
            del params, stats, consts
        else:
            weights = W.text_weights(cfg, E, wseed, dev)
            self.host = R.unflatten(weights, [x.cpu() for x in R.leaves(weights)])
            self.pred = Predictor(params=weights, text_only=True, **common)
            del weights
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        self.pred.warm()
        self.front = BatchingFrontend(self.pred, max_queue=wl["max_queue"])
        self.Busy = BatchingFrontend.Busy

    def window(self, rate: float, seconds: float, seed: int, trace: bool = False) -> dict:
        """Send the open loop's requests and wait for every answer."""
        wl = self.cell.params
        due = D.schedule(rate, seconds, seed)
        which = D.rng(seed, 7).integers(0, len(self.posts), len(due))
        r = {"due": due, "which": which, "lat": [math.nan] * len(due), "late": np.zeros(len(due)),
             "done_at": np.full(len(due), math.nan), "answers": {}, "refused": [],
             "unanswered": [], "depth": [], "traced": None, "span": None}
        lock = threading.Lock()

        def client(i: int, t_due: float) -> None:
            r["late"][i] = time.perf_counter() - t_due
            rec = {"text": self.posts[which[i]], "id": f"q{i}"}
            if self.fusion:
                rec["image"] = self.images[which[i]]
            try:
                out = self.front.submit([rec], timeout=wl["timeout_s"])
            except self.Busy:
                with lock:
                    r["refused"].append(i)
                return
            except Exception as e:  # noqa: BLE001 - any other failure: no answer came
                with lock:
                    r["unanswered"].append((i, repr(e)))
                return
            now = time.perf_counter()
            r["lat"][i] = now - t_due
            r["done_at"][i] = now
            with lock:
                r["answers"].setdefault(int(which[i]), out[0]["probs"])

        def dispatch(pool, t0: float) -> None:
            next_depth = 0.0
            for i, t in enumerate(due):
                if t >= next_depth:
                    r["depth"].append((t, self.front.stats()["queue_depth"]))
                    next_depth += 0.5
                wait = t0 + t - time.perf_counter()
                if wait > 0:
                    time.sleep(wait)
                pool.submit(client, i, t0 + t)  # no future kept: 10^4 of them slow the collector

        with ThreadPoolExecutor(wl["clients"]) as pool:
            t0 = time.perf_counter()
            sender = threading.Thread(target=dispatch, args=(pool, t0), name="dispatch")
            sender.start()
            if trace:  # started and stopped off the sending thread, which it would hold up
                time.sleep(max(0.0, t0 + wl["trace_start_s"] - time.perf_counter()))
                r["traced"] = TR.Traced(sync=False).__enter__()
                r["span"] = [time.perf_counter(), None]
                time.sleep(max(0.0, r["span"][0] + wl["trace_s"] - time.perf_counter()))
                r["traced"].__exit__(None, None, None)
                r["span"][1] = time.perf_counter()
            sender.join()
        if r["unanswered"] and not r["answers"]:  # nothing came back: say why at once
            raise RuntimeError(f"no request was answered: {r['unanswered'][0][1]}")
        r["ok_lat"] = [x for x in r["lat"] if x == x]
        r["failed"] = len(due) - len(r["ok_lat"])
        return r

    def close(self) -> None:
        self.front.close()
        self.pred.close()
        del self.front, self.pred
        H.free_device()


def run(cell: H.Cell, t_start: float) -> H.Outcome:
    cfg, wl, dev = cell.config, cell.params, cell.device
    s = Served(cell)
    H.settle()
    setup_s = time.perf_counter() - t_start
    r = s.window(wl["rate"], cell.seconds, cell.seed, cell.trace)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    s.close()
    late, due = r["late"], r["due"]
    print(f"generator: {len(due)} requests at {wl['rate']}/s over {cell.seconds} s; late by "
          f"median {np.median(late) * 1e3:.3f} ms, max {late.max() * 1e3:.3f} ms; "
          f"{len(r['refused'])} refused, {len(r['unanswered'])} unanswered"
          + (f" (first: {r['unanswered'][0][1]})" if r["unanswered"] else ""), file=sys.stderr)
    e2e = {"serve_p50_ms": C.percentile(r["ok_lat"], r["failed"], 50) * 1e3,
           "serve_p95_ms": C.percentile(r["ok_lat"], r["failed"], 95) * 1e3, "setup_s": setup_s}

    # the reference over a seeded sample of the posts answered, the longest first
    got = sorted(r["answers"])
    pick = []
    if got:
        longest = max(got, key=lambda k: s.posts[k].count(" "))
        rest = [k for k in D.rng(cell.seed, 9).permutation(got) if k != longest]
        pick = [longest] + [int(k) for k in rest[:wl["reference_sample"] - 1]]
    if s.fusion:
        weights = tuple(R.unflatten(t, [x.to(dev) for x in R.leaves(t)]) for t in s.host)
    else:
        weights = R.unflatten(s.host, [x.to(dev) for x in R.leaves(s.host)])
    posts = [s.posts[k] for k in pick]
    images = [s.images[k] for k in pick] if s.fusion else None
    names = D.labels(cfg)
    served = np.array([[r["answers"][k][n] for n in names] for k in pick]).reshape(len(pick), -1)
    ref = reference_probs(cfg, wl, weights, posts, images, s.root, s.vocab, s.keys, dev)
    checks = [H.Check("prob_gap", float(np.abs(served - ref).max()) if pick else math.inf,
                      wl["limits"]["prob_gap"]),
              H.Check("unanswered", float(len(r["unanswered"])), 0.0)]
    counters = {"requests": len(due), "answered": len(r["ok_lat"]), "window_s": cell.seconds}
    if r["span"] is not None:
        counters["traced_answered"] = int(((r["done_at"] >= r["span"][0])
                                           & (r["done_at"] <= r["span"][1])).sum())
    if "control" in wl.get("variants", []):
        low = reference_probs(cfg, wl, weights, posts, images, s.root, s.vocab, s.keys, dev,
                              tf32=True)
        counters["control"] = [H.Check("control.prob_gap", float(np.abs(low - ref).max()),
                                       wl["limits"]["prob_gap"])]
    s.tmp.cleanup()
    return H.Outcome(end_to_end=e2e, attempted=len(due), failed=r["failed"], checks=checks,
                     counters=counters, trace=r["traced"].trace if r["traced"] else None,
                     memory_peak_bytes=peak)
