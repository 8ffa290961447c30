"""Whole runs of small cells on the CPU, with the timed path broken
underneath: ``correct`` has to come out false for each fault a cell can
have, under the cell's own limits, where the sound run comes out true.

Training: a step that returns its state unchanged; half of each batch
left out, the mean taken over the rest.  Eval and serving: an answer
altered where it is produced.  (One chip has no exchange between chips.)
The small training cell runs its trunks with frozen BatchNorm: at 32 px a
trunk's last stage is one pixel, and batch statistics over four of them
part two sound runs by percents.
"""

from __future__ import annotations

import time

import pytest
import torch

from benchmark import harness as H
from benchmark.tests.tiny import tiny_cell

torch.set_num_threads(2)


def correct(cell: H.Cell) -> bool:
    out = H.load_code("mixes", cell.params["mix"]).run(cell, time.perf_counter())
    return all(c.ok for c in out.checks)


def train_cell():
    return tiny_cell("mgnns-tumemo.train-b16", compute_dtype="float32", bn_mode="frozen",
                     seconds=0.5)


def test_train_sound():
    assert correct(train_cell())


def test_train_state_unchanged(monkeypatch):
    from mgnns_tpu_torch.engine import optim

    monkeypatch.setattr(optim.Optimizer, "_chain", lambda self, params, grads, state, ok: None)
    assert not correct(train_cell())


def test_train_half_batch(monkeypatch):
    from mgnns_tpu_torch.engine import train

    real = train.cross_entropy

    def half(logits, labels, weights, total=None):
        keep = torch.arange(len(weights), device=weights.device) < len(weights) // 2
        return real(logits, labels, weights * keep, total)

    monkeypatch.setattr(train, "cross_entropy", half)
    assert not correct(train_cell())


def eval_cell():
    return tiny_cell("mgnns-tumemo.eval-b128", compute_dtype="float32", seconds=0.5)


def test_eval_sound():
    assert correct(eval_cell())


def test_eval_answer_altered(monkeypatch):
    from mgnns_tpu_torch.engine.train import Engine

    real = Engine._eval_core

    def altered(self, batch, cm):
        loss, preds = real(self, batch, cm)
        return loss, (preds + 1) % self.num_classes

    monkeypatch.setattr(Engine, "_eval_core", altered)
    assert not correct(eval_cell())


@pytest.mark.parametrize("name", ["textgcn-tumemo.serve-poisson", "mgnns-tumemo.serve-poisson"])
def test_serve_sound(name):
    assert correct(tiny_cell(name))


@pytest.mark.parametrize("name", ["textgcn-tumemo.serve-poisson", "mgnns-tumemo.serve-poisson"])
def test_serve_answer_altered(name, monkeypatch):
    from mgnns_tpu_torch.serving import Predictor

    real = Predictor._format

    def altered(self, probs):
        return real(self, probs[:, ::-1])

    monkeypatch.setattr(Predictor, "_format", altered)
    assert not correct(tiny_cell(name))
