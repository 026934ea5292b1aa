"""The control comes out not correct on the card: the plain reference
computed with float8 products in the program's place fails a number the
sound program passes.  Granite's training cell as it is, its set-up
steps; jamba's serving cell as it is, with a short window.  Run on the card with ``python -m pytest -m card
portbench/tests``.

Training is compared at one routing (from random weights, 24 MoE layers
routing top 8 of 32 nearly tied experts turn any rounding into other
experts): the program's step 1 against the reference's step 1 routed as
the program routed it, and the routing itself against the reference's
own top k."""
from __future__ import annotations

import copy

import pytest

from portbench.harness import common

SEEDS = (2_147_483_713, 2_147_483_719)
#: The numbers compared at one routing.
ROUTED = ("routed_grad_diff_median", "route_outside")


@pytest.mark.card
@pytest.mark.parametrize("seed", SEEDS)
def test_training_control_fails_where_the_program_passes(card, seed):
    import torch

    from portbench.harness.train import TrainCell, routed_numbers

    cell = copy.deepcopy(common.cell("granite_moe.train.solo"))
    lim = cell["workload"]["limits"]
    run = TrainCell(cell, seed, card)
    run.setup()
    run.close()
    run.free()
    torch.backends.cuda.matmul.allow_tf32 = False
    sound = routed_numbers(run.records,
                           run.routed_step(run.records["routes"]))
    ctl = run.reference(mm=run.ref.mm_fp8)
    control = routed_numbers(ctl, run.routed_step(ctl["routes"]))
    assert all(sound[k] <= lim[k] for k in ROUTED), sound
    assert any(control[k] > lim[k] for k in ROUTED), control


@pytest.mark.card
def test_serving_control_fails_where_the_program_passes(card):
    import torch

    from portbench.harness.serve import ServeCell

    cell = copy.deepcopy(common.cell("jamba.serve.prompt"))
    lim = cell["workload"]["limits"]
    run = ServeCell(cell, SEEDS[0], card)
    run.setup()
    run.window(4.0)
    run.close()
    run.free()
    torch.backends.cuda.matmul.allow_tf32 = False
    sound = run.gaps()
    control = run.gaps(control=run.ref.mm_fp8)
    assert sound["gap_mean"] <= lim["token_gap_mean"], sound
    assert control["gap_mean"] > lim["token_gap_mean"], control
