"""Each plain reference against the port at a small size on the host,
both given the same weights and inputs (the port in float32, its
kernels' plain versions)."""
from __future__ import annotations

import pytest
import torch

from portbench.harness import common, weights
from portbench.harness.common import port_config
from portbench.reference import adamw as ref_adamw
from portbench.tests import smoke
from portbench.traffic import tokens as token_traffic

CPU = smoke.CPU
ref_lm = common.load("reference", "lm")


def model(name: str, over: dict) -> dict:
    return dict(smoke.cell(name)["config"]["model"], **over)


@pytest.mark.parametrize("name,over", [
    ("granite_moe.train.solo", smoke.TRAIN_MODEL),
    ("jamba.serve.prompt", dict(smoke.SERVE_MODEL, n_layers=8)),
])
def test_logits_and_loss_match_the_port(name, over):
    from repro_torch.models import Model

    m = model(name, over)
    params = weights.make(ref_lm, m, 3, CPU, torch.float32)
    batch = {k: torch.from_numpy(v) for k, v in
             token_traffic.batch_at(3, 0, 2, 48, m["vocab"]).items()}
    port = Model(port_config(m, remat=False))
    with torch.no_grad():
        got, _ = port.forward(params, batch)
        want = ref_lm.logits_at(params, m, batch["tokens"], 0)
    got = got[..., :m["vocab"]]
    assert (got - want).abs().max() < 1e-4 * want.abs().max()
    with torch.no_grad():
        l_got = float(port.loss(params, batch)[0])
        l_want = float(ref_lm.loss(params, m, batch))
    assert l_got == pytest.approx(l_want, rel=1e-6)


def test_ssd_scan_matches_the_sequential_recurrence():
    g = torch.Generator().manual_seed(0)
    B, S, H, P, N = 2, 37, 4, 8, 16
    x = torch.randn(B, S, H, P, generator=g)
    dt = torch.rand(B, S, H, generator=g) * 0.1
    A = -torch.rand(H, generator=g) - 0.5
    Bm = torch.randn(B, S, 1, N, generator=g)
    Cm = torch.randn(B, S, 1, N, generator=g)
    y = ref_lm.ssd_scan(x, dt, A, Bm, Cm, Q=8, budget=B * 8 * 8 * H * 2)
    h = torch.zeros(B, H, P, N)
    for t in range(S):
        h = h * torch.exp(dt[:, t] * A)[:, :, None, None] + (
            dt[:, t, :, None, None] * x[:, t, :, :, None]
            * Bm[:, t, 0][:, None, None, :])
        want = torch.einsum("bhpn,bn->bhp", h, Cm[:, t, 0])
        assert torch.allclose(y[:, t], want, atol=1e-5, rtol=1e-4)


def test_adamw_matches_the_port():
    from repro_torch.train.optimizer import (
        AdamWConfig,
        adamw_init,
        adamw_update,
    )

    g = torch.Generator().manual_seed(1)
    params = {"w": torch.randn(4, 3, generator=g),
              "norm": torch.randn(3, generator=g),
              "b_x": torch.randn(2, 3, generator=g)}
    mine = {k: v.clone() for k, v in params.items()}
    opt = ref_adamw.AdamWRun(ref_adamw.AdamW(), mine)
    state = adamw_init(params)
    for _ in range(3):
        grads = {k: torch.randn(v.shape, generator=g) * 2 for k, v in
                 params.items()}
        params, state, _ = adamw_update(grads, state, params, AdamWConfig())
        opt.update(mine, grads)
    for k in params:
        assert torch.allclose(params[k], mine[k], atol=1e-7, rtol=1e-6)


def test_routing_to_its_own_choices_changes_nothing():
    m = model("granite_moe.train.solo", smoke.TRAIN_MODEL)
    params = weights.make(ref_lm, m, 4, CPU, torch.float32)
    batch = {k: torch.from_numpy(v) for k, v in
             token_traffic.batch_at(4, 0, 2, 32, m["vocab"]).items()}
    seen = ref_lm.Routing()
    free = ref_lm.loss(params, m, batch, routing=seen)
    assert sorted(seen.chosen) == ref_lm.moe_layer_keys(m)
    forced = ref_lm.Routing(forced=seen.chosen)
    assert float(ref_lm.loss(params, m, batch, routing=forced)) == float(free)
    assert all(float(v.max()) == 0.0 for v in forced.outside.values())
    other = {k: (v + 1) % m["moe_experts"] for k, v in seen.chosen.items()}
    moved = ref_lm.Routing(forced=other)
    assert float(ref_lm.loss(params, m, batch, routing=moved)) != float(free)
    assert all(float(v.max()) > 0.0 for v in moved.outside.values())


def test_the_port_routes_as_the_reference_at_float32():
    _, checks, run = smoke.run("granite_moe.train.solo", seed=2_147_483_693)
    routes = run.records["routes"]
    assert sorted(routes) == ref_lm.moe_layer_keys(run.m)
    got = {c["name"]: c["value"] for c in checks}
    assert got["routed_grad_diff_median"] < 1e-4
    assert got["route_outside"] == 0.0
