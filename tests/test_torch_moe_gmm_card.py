"""K5's backward kernels on the card (``csrc/moe_gmm.cu`` ``gmm_dx_bf16``,
``gmm_dw_bf16``), held against the gradient's plain forms at
granite-moe-1b-a400m's training launches: 8 x 512 tokens routed top 8,
32 768 rows over 32 experts, gate/up 1024 → 512 and down 512 → 1024.

Marked ``cuda``: the kernels run only on an NVIDIA card, so every test
here skips without one (``python -m pytest -m cuda tests`` on the card).
No JAX here: the plain PyTorch forms are the reference, and they are held
to the JAX package on the CPU in ``test_torch_moe_gmm.py``.  Tolerance:
rtol = atol = 2^-6 (bf16 step; one rounding apart reads 2^-8 relative).
"""
from __future__ import annotations

import pytest
import torch

from repro_torch.kernels import moe_gmm

pytestmark = pytest.mark.cuda

ROWS, EXPERTS = 8 * 512 * 8, 32
PROJECTIONS = {"gate/up": (1024, 512), "down": (512, 1024)}
TOL = 2 ** -6


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the backward kernels are CUDA "
                    "code with no CPU form")
    return torch.device("cuda")


def _sizes(gen, routing: str, device) -> torch.Tensor:
    """Group sizes of a routing: uniform, skewed over a softmax with five
    experts or more empty, or uniform over a row count off 64."""
    probs = torch.full((EXPERTS,), 1.0 / EXPERTS, device=device)
    rows = ROWS - 37 if routing == "off 64" else ROWS
    if routing == "skewed":
        probs = torch.softmax(3 * torch.randn(EXPERTS, generator=gen,
                                              device=device), 0)
        probs[torch.randperm(EXPERTS, generator=gen, device=device)[:5]] = 0
    ids = torch.multinomial(probs, rows, replacement=True, generator=gen)
    return torch.bincount(ids, minlength=EXPERTS)


def _backward(sizes, K, N, device, need=(True, True), seed=0):
    """One backward call under ``set_sync_debug_mode("error")``: the
    gradients, the inputs and the backward kernels it launched."""
    gen = torch.Generator(device=device).manual_seed(seed)
    M, E = int(sizes.sum()), sizes.numel()
    bf = torch.bfloat16
    xs = torch.randn((M, K), generator=gen, device=device).to(bf)
    w = (torch.randn((E, K, N), generator=gen, device=device)
         / K ** 0.5).to(bf)
    g = torch.randn((M, N), generator=gen, device=device).to(bf)
    leaves = [t.requires_grad_(n) for t, n in zip((xs, w), need)]
    y = moe_gmm.grouped_matmul(*leaves, sizes)
    torch.cuda.synchronize()
    before = moe_gmm.BACKWARD_LAUNCHES
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = torch.autograd.grad(y, [t for t in leaves if t.requires_grad],
                                  g)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return got, (xs.detach(), w.detach(), g), \
        moe_gmm.BACKWARD_LAUNCHES - before


@pytest.mark.parametrize("proj", list(PROJECTIONS))
@pytest.mark.parametrize("routing", ["uniform", "skewed", "off 64"])
def test_backward_kernels_match_the_plain_forms(card, routing, proj):
    gen = torch.Generator(device=card).manual_seed(1)
    sizes = _sizes(gen, routing, card)
    K, N = PROJECTIONS[proj]
    (dx, dw), (xs, w, g), launched = _backward(sizes, K, N, card)
    assert launched == 2
    torch.testing.assert_close(
        dx.float(), moe_gmm.grouped_matmul_dx_torch(g, w, sizes).float(),
        rtol=TOL, atol=TOL)
    torch.testing.assert_close(
        dw.float(), moe_gmm.grouped_matmul_dw_torch(xs, g, sizes).float(),
        rtol=TOL, atol=TOL)
    empty = sizes == 0
    assert int(empty.sum()) >= (5 if routing == "skewed" else 0)
    assert not dw[empty].any()


@pytest.mark.parametrize("need", [(True, False), (False, True)])
def test_one_input_launches_one_kernel(card, need):
    gen = torch.Generator(device=card).manual_seed(2)
    sizes = _sizes(gen, "uniform", card)
    (grad,), (xs, w, g), launched = _backward(sizes, *PROJECTIONS["gate/up"],
                                              card, need=need)
    assert launched == 1
    want = (moe_gmm.grouped_matmul_dx_torch(g, w, sizes) if need[0]
            else moe_gmm.grouped_matmul_dw_torch(xs, g, sizes))
    torch.testing.assert_close(grad.float(), want.float(), rtol=TOL,
                               atol=TOL)


def test_zero_rows_launch_nothing_and_give_zero_weights(card):
    """A participant of the sharded step may hold no routed row."""
    sizes = torch.zeros(EXPERTS, dtype=torch.int64, device=card)
    (dx, dw), _, launched = _backward(sizes, *PROJECTIONS["down"], card)
    assert launched == 0 and dx.shape == (0, 512)
    assert dw.shape == (EXPERTS, 512, 1024) and not dw.any()
