"""The comparison that decides `correct` sees a broken training step: a run
of the tiny cell on the CPU (the harness's look for a card skipped) with
the program's step broken underneath."""
import importlib
import time

import torch


def run(cell):
    from harness.cell import run_cell
    return run_cell(cell, 2 ** 31 + 17, 0.2, False, torch.device("cpu"),
                    time.monotonic(), say=lambda m: None)


def test_a_sound_step_is_correct(tiny_cell):
    assert run(tiny_cell)["correct"] is True


def test_a_step_that_returns_its_state_unchanged(tiny_cell, monkeypatch):
    monkeypatch.setattr(torch.optim.Adam, "step",
                        lambda self, closure=None: None)
    out = run(tiny_cell)
    assert out["correct"] is False
    assert out["compared"]["change_median"]["value"] > 0.9


def test_half_of_the_batch_left_out(tiny_cell, monkeypatch):
    train = importlib.import_module("signnet_basisnet_tpu_torch.training.train")
    masked_l1 = train.masked_l1

    def half(pred, target, mask):
        keep = mask.clone()
        keep[int(mask.sum()) // 2:] = 0
        return masked_l1(pred, target, keep)

    monkeypatch.setattr(train, "masked_l1", half)
    out = run(tiny_cell)
    assert out["correct"] is False
    assert out["compared"]["loss1"]["value"] > 1e-3
