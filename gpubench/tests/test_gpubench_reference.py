"""CPU tests of the plain reference at small sizes: the port's steps
agree with it under the cells' limits, the control (the
reference in TF32) does not, and a run whose timed path is broken comes out
not correct."""
from __future__ import annotations

import json
import os

import pytest
import torch

from conftest import ROOT
from gpubench import faults, run
from gpubench.readings import readings
from gpubench.reference import transe

SMALL = {"entities_per_kg": 2000, "triples": [8000, 7000],
         "relations": [12, 9]}
# cell -> (its traffic at a small size, per-slot draws, its traffic kind)
CELLS = {
    "rv-dwy100k-chunk-b80k": (dict(SMALL, config={"batch_size": 3000}),
                              False, "rel_view"),
    "rv-dwy100k-perslot-trunc": (dict(
        SMALL, config={"batch_size": 1500},
        neighbors={"useful_share": 0.3, "k": 40}), True, "rel_view"),
}


def _limits(cell):
    path = os.path.join(ROOT, "gpubench", "limits", cell + ".json")
    return json.load(open(path))


def _fails(numbers, limits):
    return [k for k, v in numbers.items() if v > limits[k]]


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_port_agrees_and_the_control_does_not(cell):
    limits = _limits(cell)
    for line in readings(cell, [5, 6], 2, torch.device("cpu"),
                         CELLS[cell][0], emit=lambda _: None):
        assert not _fails(line["program"], limits), line
        assert _fails(line["control"], limits), line


def test_tf32_round_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2 ** -11, 1.0 + 2 ** -10 + 2 ** -12, -3.0,
                      1.0 + 2 ** -12], dtype=torch.float32)
    assert transe.tf32_round(x).tolist() == [1.0 + 2 ** -10, 1.0 + 2 ** -10,
                                             -3.0, 1.0]


@pytest.mark.parametrize("cell,fault", [
    (cell, fault) for cell in sorted(CELLS)
    for fault in faults.FAULTS[CELLS[cell][2]]])
def test_a_broken_timed_path_is_not_correct(cell, fault):
    """The rest of a run, its look for a card skipped, with one fault
    planted in the program: a step that leaves its state unchanged, half
    of the batch left out with the mean taken over the rest, a drawn
    candidate altered where it is produced. (One
    card: no exchange between cards to leave out.)"""
    mix, per_slot, _ = CELLS[cell]
    with faults.planted(fault, per_slot):
        out = run.run_cell(cell, 9, 0.01, False, torch.device("cpu"),
                           mix_overrides=mix)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_a_sound_run_is_correct(cell):
    out = run.run_cell(cell, 9, 0.01, False, torch.device("cpu"),
                       mix_overrides=CELLS[cell][0])
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0


@pytest.mark.cuda
def test_a_cell_on_the_card():
    """A short run of each cell at a small size on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for cell, (mix, _, _) in CELLS.items():
        out = run.run_cell(cell, 11, 0.5, True, torch.device("cuda", 0),
                           mix_overrides=mix)
        assert out["correct"], out["checks"]
        assert out["device"]["busy_s"] > 0
