"""The controls: the reference one precision below the cell's (float8 trunk
convolutions for the bf16 cells), put in the program's place, has to come
out as not correct under the cell's limits; here on the CPU at a small
size.  At the cells' own sizes the readings are ``python3 -m
benchmark.controls``' on the card (PERF.md)."""

from __future__ import annotations

import time

import torch

from benchmark import harness as H
from benchmark.tests.tiny import tiny_cell

torch.set_num_threads(2)


def control_readings(cell: H.Cell) -> list:
    cell.params["variants"] = ["control"]
    out = H.load_code("mixes", cell.params["mix"]).run(cell, time.perf_counter())
    assert all(c.ok for c in out.checks)  # the program itself is sound
    return out.counters["control"]


def test_train_control_fails():
    cell = tiny_cell("mgnns-tumemo.train-b16", bn_mode="frozen", seconds=0.5)
    assert not all(c.ok for c in control_readings(cell))


def test_eval_control_fails():
    cell = tiny_cell("mgnns-tumemo.eval-b128", seconds=0.5)
    assert not all(c.ok for c in control_readings(cell))
