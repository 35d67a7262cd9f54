"""The launch plans of the redesigned K4 (ops/cuda/q8_matmul.plan) and K6
(ops/cuda/q4_matmul.splits_for), pinned at the main path's shapes on a
132-SM card with their invariants over a sweep; K6's split arithmetic in
plain PyTorch (the kernel's summation order, `q4mm_t_split_model`,
against the plain version within the summation-order limit and against
the JAX Pallas kernel in interpret mode); and the wrappers' refusals,
which the CUDA path raises before any launch."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as tp

from sparse_matrix_tuning_tpu.ops.pallas.q4_matmul import q4_matmul_t_pallas
from sparse_matrix_tuning_tpu_torch.ops import quant as pq
from sparse_matrix_tuning_tpu_torch.ops.cuda import _build
from sparse_matrix_tuning_tpu_torch.ops.cuda import q4_matmul as k6
from sparse_matrix_tuning_tpu_torch.ops.cuda import q8_matmul as k4

N_SM = 132
FP32_TOL = 1e-5  # tests/test_torch_q4.py: the same exact products, fp32 sums in another order

# (form, T, output width, contraction) -> (bm, bn, tiles, grid); the plan
# does not depend on the contraction: each CTA streams its tile's whole
# contraction (split-K lost at three of the four decode shapes on the card)
K4_PLANS = {
    ("t", 2048, 5632, 2048): (128, 256, 352, 132),   # gate/up, the main path
    ("g", 2048, 2048, 5632): (128, 128, 256, 132),
    ("t", 2048, 2048, 5632): (128, 256, 128, 128),   # down
    ("g", 2048, 5632, 2048): (128, 128, 704, 132),
    ("t", 2048, 256, 2048): (64, 128, 64, 64),       # k/v: the large tiles leave SMs idle
    ("t", 2048, 32000, 2048): (128, 256, 2000, 132),  # the head
    ("t", 2044, 4096, 2048): (128, 256, 256, 132),   # a chunk of the q8 loss
    ("t", 65, 5632, 2048): (64, 128, 88, 88),
    ("t", 64, 5632, 2048): (64, 128, 44, 44),        # the int8 eval decode (F2)
    ("g", 64, 2048, 5632): (64, 128, 16, 16),
    ("t", 64, 256, 2048): (64, 128, 2, 2),           # k/v at decode
    ("t", 64, 2048, 2048): (64, 128, 16, 16),        # q/o
    ("t", 64, 2048, 5632): (64, 128, 16, 16),        # down
    ("t", 37, 2048, 2048): (64, 128, 16, 16),        # ragged decode rows
}


@pytest.mark.parametrize("key", list(K4_PLANS), ids=[f"{f}-T{t}-N{n}-K{k}"
                                                    for f, t, n, k in K4_PLANS])
def test_k4_plan_at_the_main_path_shapes(key):
    form, t, n, _ = key
    p = k4.plan(form, t, n, N_SM)
    assert (p.bm, p.bn, p.tiles, p.grid) == K4_PLANS[key]


def test_k4_plan_invariants():
    cdiv = lambda a, b: -(-a // b)
    for form in ("t", "g"):
        for t in (1, 7, 16, 37, 64, 65, 128, 700, 2044, 2048, 8192):
            for n in (16, 256, 2048, 5632, 14336, 32000):
                p = k4.plan(form, t, n, N_SM)
                assert p.tiles == cdiv(t, p.bm) * cdiv(n, p.bn)
                assert p.grid == min(p.tiles, N_SM) and p.grid >= 1
                assert p.bn in (128, 256) and (p.bn == 128 or form == "t")
                if t <= k4.DECODE_ROWS:
                    assert (p.bm, p.bn) == (64, 128)


def test_k4_validation_refusals():
    i8 = lambda *s: torch.zeros(s, dtype=torch.int8)
    f32 = lambda *s: torch.zeros(s)
    ok = (i8(8, 64), f32(8, 1), i8(32, 64), f32(32))
    k4._validate("q8mm_t", *ok, torch.bfloat16, 64, 32)
    cases = [
        ((i8(8, 64).float(), f32(8, 1), i8(32, 64), f32(32)), TypeError),   # float activations
        ((i8(8, 64), f32(8, 1).double(), i8(32, 64), f32(32)), TypeError),  # fp64 scales
        ((i8(8, 48), f32(8, 1), i8(32, 64), f32(32)), ValueError),          # no contraction
        ((i8(8, 64), f32(7, 1), i8(32, 64), f32(32)), ValueError),          # a scale missing
        ((i8(8, 56), f32(8, 1), i8(32, 56), f32(32)), ValueError),          # K % 16
        ((i8(64, 8).t(), f32(8, 1), i8(32, 64), f32(32)), ValueError),      # not contiguous
        ((i8(8, 65)[:, 1:], f32(8, 1), i8(32, 64), f32(32)), ValueError),   # not contiguous
        ((i8(8 * 64 + 1)[1:].view(8, 64), f32(8, 1), i8(32, 64), f32(32)), ValueError),  # align
    ]
    for args, err in cases:
        with pytest.raises(err):
            k4._validate("q8mm_t", *args, torch.bfloat16, args[2].shape[1], args[2].shape[0])
    k4._validate("q8mm_t", *ok, torch.float16, 64, 32)  # the fp16 epilogue
    with pytest.raises(TypeError):
        k4._validate("q8mm_t", *ok, torch.float64, 64, 32)
    with pytest.raises(ValueError):  # the g form: the weight's row length a multiple of 16
        k4._validate("q8mm_g", i8(8, 32), f32(8, 1), i8(32, 40), None, torch.bfloat16, 32, 40)
    assert not any(k4.LAUNCHES.values())


def test_k6_plan_invariants_and_split_ranges():
    for o in range(128, 16384 + 1, 384):
        for k in (128, 512, 1024, 2816, 4096):
            s = k6.splits_for(o, k, N_SM)
            tiles = -(-o // k6.TILE_O)
            assert 1 <= s <= k // 128 and tiles * s <= max(N_SM, tiles)
            ranges = k6.split_ranges(k, s)
            assert ranges[0][0] == 0 and ranges[-1][1] == k // 128
            assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
            assert all(g1 - g0 >= 1 for g0, g1 in ranges)


def _q4_case(t, o, i, seed):
    w = tp.seeded_normal((o, i), seed=seed)
    x = tp.seeded_normal((t, i), seed=seed + 1)
    w4, s4 = pq.quantize_weight_int4(torch.from_numpy(w))
    return torch.from_numpy(x).to(torch.bfloat16), w4, s4


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("splits", [1, 2, 3, 8])
def test_k6_split_order_model_within_the_limit_of_the_plain_version(splits, dtype):
    x, w4, s4 = _q4_case(13, 256, 2048, seed=splits)
    dt = tp.TORCH_DTYPES[dtype]
    got = k6.q4mm_t_split_model(x, w4, s4, splits, dt)
    want = k6.q4mm_t_plain(x, w4, s4, dt)
    limit = k6.order_limit(x, w4, s4, splits, want)
    assert got.dtype == dt and bool(((got.float() - want.float()).abs() <= limit).all())


@pytest.mark.parametrize("splits", [1, 4])
def test_k6_split_order_model_matches_pallas_kernel(splits):
    """fp32 out: the kernel's order against the Pallas kernel (interpret
    mode) on the same quantized weight, within the K6 tests' fp32 tolerance."""
    x, w4, s4 = _q4_case(8, 128, 1024, seed=10 + splits)
    got = k6.q4mm_t_split_model(x, w4, s4, splits, torch.float32)
    # fp32 x (bf16 values): the Pallas kernel rounds it to bf16 and returns fp32
    want = q4_matmul_t_pallas(jnp.asarray(x.float().numpy()), jnp.asarray(w4.numpy()),
                              jnp.asarray(s4.numpy()), interpret=True)
    scale = float(np.abs(np.asarray(want, np.float32)).max())
    tp.assert_close(got, want, rtol=FP32_TOL, atol=FP32_TOL * scale)


def test_k6_validation_refusals():
    x, w4, s4 = torch.zeros((4, 256), dtype=torch.bfloat16), torch.zeros(
        (128, 128), dtype=torch.int8), torch.zeros((128, 2))
    k6._validate(x, w4, s4, torch.bfloat16)
    cases = [
        ((x.float(), w4, s4, torch.bfloat16), TypeError),
        ((x, w4, s4.double(), torch.bfloat16), TypeError),
        ((x, w4, s4, torch.float16), TypeError),
        ((x[:, :128], w4, s4, torch.bfloat16), ValueError),                       # I != 2K
        ((x, w4, torch.zeros((128, 3)), torch.bfloat16), ValueError),            # scales
        ((torch.zeros((65, 256), dtype=torch.bfloat16), w4, s4, torch.bfloat16), ValueError),
        ((torch.zeros((4, 192), dtype=torch.bfloat16), torch.zeros((128, 96), dtype=torch.int8),
          torch.zeros((128, 2)), torch.bfloat16), ValueError),                   # K % 128
        ((torch.zeros((256, 4), dtype=torch.bfloat16).t(), w4, s4, torch.bfloat16), ValueError),
    ]
    for args, err in cases:
        with pytest.raises(err):
            k6._validate(*args)
    for splits in (0, 3):  # the launcher's own split count: 1 to the groups of a plane
        with pytest.raises(ValueError, match="splits"):
            k6._launch(x, w4, s4, torch.bfloat16, splits)
    assert k6.LAUNCHES == 0


def test_library_path_is_keyed_by_the_hopper_header(tmp_path, monkeypatch):
    """csrc/hopper.cuh (mbarriers, TMA) is compiled into q8_matmul.cu and
    q4_matmul.cu, which include it: an edit to it rebuilds the library."""
    srcs = {p.name: p.read_text() for p in _build.sources()}
    assert all('#include "hopper.cuh"' in srcs[n] for n in ("q8_matmul.cu", "q4_matmul.cu"))
    for p in sorted(_build.CSRC.glob("*.cu")) + sorted(_build.CSRC.glob("*.cuh")):
        (tmp_path / p.name).write_bytes(p.read_bytes())
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    before = _build.library_path()
    header = tmp_path / "hopper.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    assert _build.library_path() != before
