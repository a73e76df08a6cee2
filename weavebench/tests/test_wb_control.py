"""The control of the comparison comes out not correct: the reference
with one guarantee broken, put in the program's place, for every cell
at a small size on the CPU, and on the card at the same size.
``python -m weavebench.control`` runs it at the cells' own size."""

import pytest
import torch

from weavebench import check, control
from weavebench.tests.small import CELLS, small_cell


@pytest.mark.parametrize("broken", ["deletes", "order"])
@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name, broken):
    for seed in (1, 2, 3):
        n = control.control_numbers(small_cell(name), seed, broken, "cpu")
        assert not check.verdict(n), n
        field = "vis_mismatch" if broken == "deletes" else "rank_mismatch"
        assert n[field] > 0 and n["digest_mismatch"] > 0


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct_on_the_card(card, name):
    n = control.control_numbers(small_cell(name), 4, "deletes", card)
    assert not check.verdict(n), n


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_small_run_on_the_card_is_correct(card, name):
    import time

    from weavebench import run

    f = run.run_cell(small_cell(name), 5, 1.0, True, card,
                     time.perf_counter())
    assert f["correct"], f["numbers"]
    assert torch.cuda.max_memory_allocated(card) > 0
