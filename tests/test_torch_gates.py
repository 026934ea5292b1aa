"""The port's Eq. 5 gate wrapper against the JAX package's numpy oracle.

On the CPU ``repro_torch.kernels.bigroots_gates.eval_gates(device="cpu")``
runs the kernel's plain PyTorch version; it must equal
``repro.core.fleet.eval_gates_np`` — the reference the JAX package pins
its own kernel to — **byte for byte** (int8 gate bits, tolerance 0).  The
CUDA kernel itself is held against the plain version on the GPU by
``chip_smoke.py``.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core.fleet import eval_gates_np
from repro_torch.convert import gate_batch_from_numpy
from repro_torch.kernels import bigroots_gates as port_gates

from _torch_port_util import gate_args, random_gate_batch, special_gate_batch


def port_eval(b, peer_mean=1.5):
    return port_gates.eval_gates(*gate_args(b), peer_mean=peer_mean,
                                 device="cpu")


@pytest.mark.parametrize("seed", range(20))
def test_randomized_bit_identical(seed):
    rng = np.random.default_rng(seed)
    b = random_gate_batch(rng)
    got = port_eval(b)
    assert got.dtype == np.int8
    np.testing.assert_array_equal(got, eval_gates_np(b, peer_mean=1.5))


@pytest.mark.parametrize("peer_mean", [1.0, 1.25, 2.0])
def test_peer_mean_values(peer_mean):
    b = random_gate_batch(np.random.default_rng(40), W=3, R=50, F=14)
    np.testing.assert_array_equal(port_eval(b, peer_mean),
                                  eval_gates_np(b, peer_mean=peer_mean))


def test_nan_values_and_zero_counts_never_fire():
    rng = np.random.default_rng(99)
    b = random_gate_batch(rng, W=2, R=16, F=6)
    b.v[0, :4] = np.nan
    b.inter_cnt[:, ::2] = 0.0
    b.intra_cnt[:, 1::2] = 0.0
    b.peer_vsum[0, ::2] = b.vsum[0]
    got = port_eval(b)
    np.testing.assert_array_equal(got, eval_gates_np(b, peer_mean=1.5))
    assert (got[0, :4] == 0).all()
    assert (got[:, ::2] & 1).sum() == 0
    assert (got[:, 1::2] & 2).sum() == 0


def test_padded_rows_masked():
    W, R, F = 3, 24, 5
    counts = np.array([5, 0, 24])
    b = random_gate_batch(np.random.default_rng(0), W=W, R=R, F=F)
    b.v[:] = 100.0
    b.peer_vsum[:] = 0.0
    b.inter_cnt[:] = 1.0
    b.intra_cnt[:] = 1.0
    b.rowmask[:] = 0.0
    for i, c in enumerate(counts):
        b.rowmask[i, :c, 0] = 1.0
    b.vsum[:] = 1.0
    b.q[:] = 0.0
    b.numok[:] = 1.0
    b.floor[:] = -np.inf
    got = port_eval(b)
    np.testing.assert_array_equal(got, eval_gates_np(b, peer_mean=1.5))
    for i, c in enumerate(counts):
        assert (got[i, :c] > 0).all()
        assert (got[i, c:] == 0).all()


@pytest.mark.parametrize("R", [1, 255, 257, 600])
def test_rows_not_a_multiple_of_the_bucket(R):
    """The port re-pads nothing: any R goes through as it is."""
    b = random_gate_batch(np.random.default_rng(R), W=2, R=R, F=14)
    got = port_eval(b)
    assert got.shape == (2, R, 14)
    np.testing.assert_array_equal(got, eval_gates_np(b, peer_mean=1.5))


def test_floor_mix_of_time_floor_and_minus_inf():
    b = random_gate_batch(np.random.default_rng(5), W=2, R=64, F=8)
    b.floor[0, 0, ::2] = 0.2
    b.floor[0, 0, 1::2] = -np.inf
    np.testing.assert_array_equal(port_eval(b),
                                  eval_gates_np(b, peer_mean=1.5))


def test_tensors_in_and_reference_batch_through_convert():
    """``gate_batch_from_numpy`` carries the *reference's* packed batch to
    the port's wrapper; tensors are used where they lie."""
    b = random_gate_batch(np.random.default_rng(8), W=4, R=33, F=14)
    tensors = gate_batch_from_numpy(b, device="cpu")
    assert all(t.dtype == torch.float64 for t in tensors)
    out = port_gates.gates_launch(*tensors, peer_mean=1.5)
    assert out.dtype == torch.int8 and out.device.type == "cpu"
    np.testing.assert_array_equal(out.numpy(),
                                  eval_gates_np(b, peer_mean=1.5))
    np.testing.assert_array_equal(
        port_gates.eval_gates(*tensors, peer_mean=1.5),
        eval_gates_np(b, peer_mean=1.5),
    )


def test_cpu_path_launches_no_kernel():
    before = port_gates.LAUNCHES
    port_eval(random_gate_batch(np.random.default_rng(3)))
    assert port_gates.LAUNCHES == before


@pytest.mark.parametrize("backend", ["numpy-oracle", "pallas-interpret"])
def test_against_reference_backends(backend):
    """The same batch through the JAX package's own wrapper.  The Pallas
    case runs the TPU kernel in interpret mode, as the JAX package's suite
    does on a CPU; it is skipped when that module cannot be imported."""
    b = random_gate_batch(np.random.default_rng(17), W=3, R=70, F=9)
    got = port_eval(b)
    if backend == "numpy-oracle":
        want = eval_gates_np(b, peer_mean=1.5)
    else:
        try:
            from repro.kernels.bigroots_gates import eval_gates as ref_eval
        except Exception as exc:  # the installed jax may lack enable_x64
            pytest.skip(f"repro.kernels.bigroots_gates not importable "
                        f"with the installed jax: {exc!r}")
        want = ref_eval(*gate_args(b), peer_mean=1.5, backend="pallas",
                        interpret=True)
    np.testing.assert_array_equal(got, want)


class TestWrapperChecks:
    def _args(self):
        return list(gate_args(
            random_gate_batch(np.random.default_rng(1), W=2, R=8, F=4)))

    def test_float32_raises(self):
        args = self._args()
        args[0] = args[0].astype(np.float32)
        with pytest.raises(TypeError, match="float64"):
            port_gates.eval_gates(*args, peer_mean=1.5, device="cpu")

    @pytest.mark.parametrize("which", [1, 2, 5, 8])
    def test_wrong_shape_raises(self, which):
        args = self._args()
        args[which] = args[which][..., :-1] if which in (1, 5, 8) \
            else args[which][:, :-1]
        args[which] = np.ascontiguousarray(args[which])
        with pytest.raises(ValueError, match="shape"):
            port_gates.eval_gates(*args, peer_mean=1.5, device="cpu")

    def test_not_three_dimensional_raises(self):
        args = self._args()
        args[0] = args[0][0]
        with pytest.raises(ValueError, match=r"\[W, R, F\]"):
            port_gates.eval_gates(*args, peer_mean=1.5, device="cpu")

    def test_non_contiguous_raises(self):
        args = self._args()
        args[0] = np.asfortranarray(args[0])
        with pytest.raises(ValueError, match="contiguous"):
            port_gates.eval_gates(*args, peer_mean=1.5, device="cpu")

    def test_default_device_needs_cuda(self):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present")
        with pytest.raises(RuntimeError, match="CUDA"):
            port_gates.eval_gates(*self._args(), peer_mean=1.5)


# ---------------------------------------------------------------------------
# the kernel's plan (K1): path, tiling, coverage, constants
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("F", range(1, 18))
@pytest.mark.parametrize("aligned", [True, False])
def test_plan_takes_the_vector_path_only_for_even_F_and_aligned(F, aligned):
    plan = port_gates.gate_plan(64, 3072, F, aligned)
    assert plan.path == ("vector" if aligned and F % 2 == 0 else "scalar")


def plan_coverage(plan, W, R, F):
    """How many times the kernel's thread → ``(w, r, f)`` mapping visits
    each element of a ``[W, R, F]`` batch under ``plan``: the index
    arithmetic of ``csrc/bigroots_gates.cu``'s ``gates_kernel``, over every
    block, thread and row of a thread."""
    per_row = F // 2 if plan.path == "vector" else F
    b = np.arange(plan.grid)[:, None, None]
    tid = np.arange(plan.threads)[None, :, None]
    k = np.arange(port_gates.ROWS_PER_THREAD)[None, None, :]
    chunk = b % plan.chunks
    w = (b // plan.chunks) // plan.tiles
    tile = (b // plan.chunks) % plan.tiles
    lane_row = tid // plan.units
    u = chunk * plan.units + tid % plan.units
    r = (tile * plan.rows_per_pass * port_gates.ROWS_PER_THREAD
         + k * plan.rows_per_pass + lane_row)
    w, r, u = np.broadcast_arrays(w, r, u)
    live = (u < per_row) & (r < R)
    w, r, u = w[live], r[live], u[live]
    seen = np.zeros((W, R, F), dtype=np.int64)
    if plan.path == "vector":
        np.add.at(seen, (w, r, 2 * u), 1)
        np.add.at(seen, (w, r, 2 * u + 1), 1)
    else:
        np.add.at(seen, (w, r, u), 1)
    return seen


#: Shapes for the coverage check: the main path's batch, W = 1, R = 1, R
#: around one pass and one tile of the F = 14 plans (18 / 9 rows a pass on
#: the vector / scalar path, 36 / 18 rows a tile), F = 2, odd F, F up to and
#: past a block's units (several column chunks).
COVERAGE_SHAPES = [
    (64, 3072, 14), (1, 1, 14), (1, 1, 1), (3, 1, 9), (1, 31, 14), (2, 35, 14),
    (2, 36, 14), (2, 37, 14), (2, 143, 14), (2, 144, 14), (2, 145, 14),
    (2, 8, 14), (2, 9, 14), (2, 10, 14), (2, 17, 14), (2, 18, 14), (2, 19, 14),
    (2, 71, 14), (2, 73, 14), (5, 257, 2), (1, 1024, 2), (3, 1025, 2),
    (4, 300, 9), (2, 129, 16), (2, 100, 64), (3, 33, 64), (2, 5, 510),
    (2, 7, 512), (2, 3, 514), (1, 9, 1030), (2, 4, 256), (2, 4, 258),
    (2, 6, 129), (2, 40, 255), (2, 40, 257), (7, 13, 6), (1, 2, 3),
    (65, 3, 14), (2, 1000, 1),
]


@pytest.mark.parametrize("shape", COVERAGE_SHAPES)
@pytest.mark.parametrize("aligned", [True, False])
def test_plan_covers_every_element_exactly_once(shape, aligned):
    W, R, F = shape
    plan = port_gates.gate_plan(W, R, F, aligned)
    # The kernel's __launch_bounds__ refuses a larger block.
    assert plan.threads <= port_gates.BLOCK_THREADS
    assert (plan_coverage(plan, W, R, F) == 1).all()


def test_plan_constants_are_the_kernels():
    """``csrc/bigroots_gates.cu`` derives its tiling from the same
    constants as :func:`gate_plan`."""
    src = (Path(port_gates.__file__).parent / "csrc"
           / "bigroots_gates.cu").read_text()
    for name in ("BLOCK_THREADS", "MAX_UNITS", "ROWS_PER_THREAD"):
        assert (f"constexpr int {name} = {getattr(port_gates, name)};"
                in src), name


def test_plan_for_reads_the_alignment_off_the_pointers():
    """A fresh tensor is aligned; a contiguous view one element into its
    storage is not, and takes the scalar path."""
    W, R, F = 2, 40, 14
    fresh = torch.zeros((W, R, F), dtype=torch.float64)
    shifted = torch.zeros(W * R * F + 1, dtype=torch.float64)[1:].view(W, R, F)
    out = torch.empty((W, R, F), dtype=torch.int8)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16 == 8
    assert port_gates.plan_for(fresh, fresh, out).path == "vector"
    assert port_gates.plan_for(shifted, fresh, out).path == "scalar"
    assert port_gates.plan_for(fresh, shifted, out).path == "scalar"
    odd_out = torch.empty(W * R * F + 1, dtype=torch.int8)[1:].view(W, R, F)
    assert port_gates.plan_for(fresh, fresh, odd_out).path == "scalar"
    assert port_gates.plan_for(fresh[..., :9].contiguous(),
                               fresh[..., :9].contiguous(),
                               out[..., :9]).path == "scalar"


@pytest.mark.parametrize("F", [2, 9, 14, 16, 64])
@pytest.mark.parametrize("seed", range(3))
def test_special_values_bit_identical(F, seed):
    """NaN, -0.0, ±inf, subnormals and the largest finite values in every
    input, counts and masks included: byte for byte the numpy oracle."""
    b = special_gate_batch(np.random.default_rng([seed, F]), W=8, R=70, F=F)
    with np.errstate(over="ignore"):  # the largest finite values overflow
        want = eval_gates_np(b, peer_mean=1.5)
    got = port_eval(b)
    np.testing.assert_array_equal(got, want)
    assert (got != 0).any()
