"""Tiny cells of the benchmark's configurations, for the CPU tests."""

from __future__ import annotations

import copy

import torch

from benchmark import harness as H

TINY_CONFIG = {"vocab_size": 300, "corpus_docs": 400, "max_len": 16, "ngram": 2,
               "window_size": 3, "min_cooccurrence": 1, "image_size": 32,
               "object_num_classes": 5, "place_num_classes": 6, "gcn_hidden": 64,
               "n_head": 2, "d_kv": 16}
# the serving cells' configurations (BENCHMARK.json does not list those cells)
CONFIG = {"textgcn-tumemo.serve-poisson": "textgcn-tumemo",
          "mgnns-tumemo.serve-poisson": "mgnns-tumemo"}
TINY_PARAMS = {
    "mgnns-tumemo.train-b16": {"batch": 4, "records": 12},
    "mgnns-tumemo.eval-b128": {"batch": 4, "records": 12, "calibration_images": 4,
                               "reference_sample": 8},
    "textgcn-tumemo.serve-poisson": {"rate": 40.0, "posts": 16, "min_tokens": 2,
                                     "max_tokens": 14, "trace_start_s": 0.2, "trace_s": 0.3,
                                     "reference_sample": 8, "clients": 8},
    "mgnns-tumemo.serve-poisson": {"rate": 8.0, "posts": 8, "min_tokens": 2, "max_tokens": 14,
                                   "images": 3, "min_side": 20, "max_side": 48,
                                   "calibration_images": 2, "trace_start_s": 0.2,
                                   "trace_s": 0.5, "reference_sample": 4, "max_batch": 4,
                                   "clients": 8},
}


def tiny_cell(name: str, seed: int = 7, seconds: float = 1.0, trace: bool = False,
              **params) -> H.Cell:
    config = H.config_of(name, CONFIG.get(name))
    config.update({k: v for k, v in TINY_CONFIG.items() if k in config})
    wl = copy.deepcopy(H.load_json("workloads", name))
    wl.update(TINY_PARAMS[name])
    wl.update(params)
    return H.Cell(name=name, config=config, params=wl, seed=seed, seconds=seconds, trace=trace,
                  device=torch.device("cpu"))
