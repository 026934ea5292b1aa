"""A participant's block of the seeded parameters, drawn leaf by leaf.

``Model.init(generator, leaf=)`` hands each leaf to ``leaf(path, tensor)``
as soon as it is drawn; ``parallel.sharding.param_block`` cuts it to the
block a participant holds (``param_spec`` of its path) and casts it.  So a
rank builds its block of a model whose whole float32 tree would not fit
the card (jamba-v0.1-52b at 8 layers: 53 GB), one whole leaf at a time.
Here, on the CPU at smoke size, the tree it gives is bit for bit
``shard_tree``'s cut of ``Model(cfg).init(generator)`` cast as served
(``serve.engine.cast_params``), on every participant of each mesh, for a
decoder-only, a hybrid and the encoder-decoder arch; and the draws do not
depend on the hook.

Run: ``PYTHONPATH=src python -m pytest -q tests/test_torch_param_block.py``.
"""
from __future__ import annotations

import itertools
from dataclasses import replace

import pytest
import torch

from repro_torch import tree
from repro_torch.configs import get_config
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import Model, smoke_variant
from repro_torch.parallel.sharding import param_block, param_shardings, shard_tree
from repro_torch.serve.engine import cast_params, served_dtype

ARCHS = ("granite_moe_1b_a400m", "jamba_v0_1_52b", "seamless_m4t_medium")
MESHES = {"2x2": (2, 2), "1x4": (1, 4), "4x1": (4, 1)}


def cfg_of(arch: str):
    return replace(smoke_variant(get_config(arch)), dtype="bfloat16")


def seeded(cfg, leaf=None):
    return Model(cfg).init(torch.Generator().manual_seed(3), device="cpu",
                           leaf=leaf)


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_each_block_is_the_cut_of_the_whole_tree(arch, mesh_name):
    cfg = cfg_of(arch)
    mesh = make_mesh(MESHES[mesh_name], ("data", "model"))
    whole = cast_params(seeded(cfg), cfg, torch.device("cpu"))
    sh = param_shardings(whole, cfg, mesh)
    for c in itertools.product(*(range(n) for n in MESHES[mesh_name])):
        coord = dict(zip(("data", "model"), c))
        got = seeded(cfg, param_block(
            cfg, mesh, coord, lambda path, t: served_dtype(cfg, path[-1],
                                                           t.dtype)))
        want = shard_tree(whole, sh, coord)
        for (path, g), w in zip(tree.leaves_with_path(got),
                                tree.leaves(want), strict=True):
            assert g.dtype == w.dtype and g.shape == w.shape, path
            assert g.is_contiguous() and torch.equal(g, w), path


@pytest.mark.parametrize("arch", ARCHS)
def test_the_hook_sees_every_leaf_once(arch):
    """Every leaf passes through the hook once, with the path the tree
    holds it at, and the tree holds what the hook returned."""
    cfg = cfg_of(arch)
    seen = []

    def leaf(path, t):
        seen.append(path)
        return t + 1
    got = seeded(cfg, leaf)
    want = seeded(cfg)
    paths = [tuple(str(k) for k in p) for p, _ in tree.leaves_with_path(got)]
    assert sorted(seen) == sorted(paths) and len(seen) == len(set(seen))
    for g, w in zip(tree.leaves(got), tree.leaves(want), strict=True):
        assert torch.equal(g, w + 1)
