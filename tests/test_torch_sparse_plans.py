"""The launch plans of the redesigned K1 (ops/cuda/block_grad.plan) and K5
(ops/cuda/correction.plan), pinned at the main path's shapes on a 132-SM
card with their invariants over a sweep; the kernels' summation orders in
plain PyTorch (K1's split sum, `block_grad_split_model`; K5's chunked
accumulation, `block_correction_order_model`) against the plain versions
and the JAX package (Pallas kernels in interpret mode, XLA forms); and the
wrappers' refusals, which the CUDA path raises before any launch."""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as tp

from sparse_matrix_tuning_tpu.ops import sparse_linear as jsl
from sparse_matrix_tuning_tpu.ops.pallas.block_grad import block_grad_weight
from sparse_matrix_tuning_tpu.ops.pallas.correction import block_correction as jax_block_correction
from sparse_matrix_tuning_tpu.ops.sparse_linear import _block_grad_weight_xla
from sparse_matrix_tuning_tpu.smt.plan import LinearPlan as JaxLinearPlan
from sparse_matrix_tuning_tpu_torch.ops.cuda import _build
from sparse_matrix_tuning_tpu_torch.ops.cuda import block_grad as k1
from sparse_matrix_tuning_tpu_torch.ops.cuda import correction as k5

N_SM = 132
BLOCK = 256
# the JAX suite's (rtol, atol); fp16 held to the bf16 one
K1_TOL = {"fp32": (1e-5, 1e-4), "bf16": (2e-2, 2e-1), "fp16": (2e-2, 2e-1)}
# chip_smoke.py's K5_TOL: one rounding of the output apart (fp16: 2^-10)
K5_TOL = {"fp32": (1e-5, 1e-5), "bf16": (2.0 ** -7, 1e-4), "fp16": (2.0 ** -10, 1e-4)}
cdiv = lambda a, b: -(-a // b)

# (T, n blocks) -> (bm, splits, grid). Run A: bs 4 x seq 512 = 2048 tokens
# through every linear (gate/up (5632, 2048), q (2048, 2048): the plan does
# not depend on the widths), at its plan's blocks per linear (min 1, median
# 4, max 140 over 26 linears; chip_smoke.py logs them), n 11 (the mean) and
# 24 (the timed shape); run B: 4096 tokens; a ragged T
K1_PLANS = {
    (2048, 1): (64, 4, 16),
    (2048, 4): (64, 4, 64),      # the median n of run A's plan
    (2048, 8): (64, 2, 64),
    (2048, 11): (64, 1, 44),
    (2048, 24): (64, 1, 96),
    (2048, 33): (64, 1, 132),    # 64-row tiles fill one wave
    (2048, 39): (128, 1, 78),    # the largest attention linear of run A's plan
    (2048, 140): (128, 1, 280),  # its MLP linear
    (4096, 4): (64, 4, 64),
    (4096, 11): (64, 1, 44),
    (700, 4): (64, 1, 16),       # 11 chunks: too few for two splits of 8
    (1024, 4): (64, 2, 32),      # 16 chunks: two splits of 8
    (64, 4): (64, 1, 16),        # one chunk
}


@pytest.mark.parametrize("key", list(K1_PLANS), ids=[f"T{t}-n{n}" for t, n in K1_PLANS])
def test_k1_plan_at_the_main_path_shapes(key):
    t, n = key
    p = k1.plan(n, t, N_SM)
    assert (p.bm, p.splits, p.grid) == K1_PLANS[key]


def test_k1_plan_invariants_and_split_ranges():
    for t in (1, 63, 64, 65, 511, 512, 700, 2044, 2048, 4096, 8192):
        chunks = cdiv(t, 64)
        for n in (1, 2, 3, 4, 7, 11, 16, 24, 33, 66, 67, 141):
            p = k1.plan(n, t, N_SM)
            tiles = n * BLOCK // p.bm
            assert p.bm == (64 if 4 * n <= N_SM else 128) and 1 <= p.splits <= chunks
            assert p.grid == tiles * p.splits
            if p.splits > 1:       # a split only while the grid stays within half the SMs
                assert p.bm == 64 and p.grid <= N_SM // 2
                assert chunks // p.splits >= k1.MIN_SPLIT_CHUNKS
            ranges = k1.split_ranges(t, p.splits)
            assert ranges[0][0] == 0 and ranges[-1][1] == t
            assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))   # in order
            assert all(t0 % 64 == 0 and t1 > t0 for t0, t1 in ranges)      # whole chunks
    assert k1.split_ranges(700, 3) == [(0, 192), (192, 448), (448, 700)]


def _k1_case(t, dtype, seed):
    """A 3 x 2-block weight; block coordinates with a shared row, a shared
    column and a repeated pair."""
    blocks = ((0, 1), (2, 0), (0, 0), (2, 0), (1, 1))
    jlp = JaxLinearPlan("q_proj", 0, 3 * BLOCK, 2 * BLOCK, blocks=blocks)
    g = tp.seeded_normal((t, 3 * BLOCK), seed)
    x = tp.seeded_normal((t, 2 * BLOCK), seed + 1)
    rb = torch.as_tensor(jlp.row_blocks())
    cb = torch.as_tensor(jlp.col_blocks())
    return jlp, g, x, rb, cb


@pytest.mark.parametrize("dtype", ["fp32", "bf16", "fp16"])
@pytest.mark.parametrize("t", [512, 700])
@pytest.mark.parametrize("splits", [1, 2, 3, 5])
def test_k1_split_order_model_matches_plain_and_jax(splits, t, dtype):
    """The kernel's order (fp32 partials per split, added in split order)
    against the plain version in fp32 on the same (bf16-exact) inputs, and
    against the JAX Pallas kernel (interpret mode) and XLA oracle at the
    JAX suite's tolerance; a repeated pair gets the same gradient."""
    jlp, g, x, rb, cb = _k1_case(t, dtype, seed=splits)
    g2, x2 = tp.to_torch(g, dtype), tp.to_torch(x, dtype)
    got = k1.block_grad_split_model(g2, x2, rb, cb, splits)
    assert got.shape == (5, BLOCK, BLOCK) and got.dtype == torch.float32
    want = k1.block_grad_plain(g2, x2, rb, cb)
    tp.assert_close(got, want, rtol=1e-5, atol=1e-4)
    rtol, atol = K1_TOL[dtype]
    jg, jx = tp.to_jax(g, dtype), tp.to_jax(x, dtype)
    tp.assert_close(got, block_grad_weight(jg, jx, jlp.row_blocks(), jlp.col_blocks()),
                    rtol=rtol, atol=atol)
    tp.assert_close(got, _block_grad_weight_xla(jlp, jg, jx), rtol=rtol, atol=atol)
    np.testing.assert_array_equal(tp.np32(got[1]), tp.np32(got[3]))


@pytest.mark.parametrize("splits", [2, 4])
def test_k1_dropped_split_is_rejected(splits):
    """chip_smoke.py's planted fault: one split's partial left out of the
    sum fails the tolerance the kernel is held to."""
    _, g, x, rb, cb = _k1_case(2048, "bf16", seed=7)
    g2, x2 = tp.to_torch(g, "bf16"), tp.to_torch(x, "bf16")
    want = k1.block_grad_plain(g2, x2, rb, cb)
    rtol, atol = K1_TOL["bf16"]
    assert torch.allclose(k1.block_grad_split_model(g2, x2, rb, cb, splits), want,
                          rtol=rtol, atol=atol)
    for drop in range(splits):
        fault = k1.block_grad_split_model(g2, x2, rb, cb, splits, drop=drop)
        assert not torch.allclose(fault, want, rtol=rtol, atol=atol)


# (runs, T) -> (bm, bn, grid). Run E: T 2048; the gate/up forward's runs at
# n 24 (14 of the 22 out blocks), its grad_input's (at most the 8 in
# blocks), a k/v linear (one out block: one run); run F3: the decode's 64
# rows (16 prompts x 4 beams) with a few runs per linear
K5_PLANS = {
    (14, 2048): (128, 256, 224),
    (8, 2048): (64, 256, 256),
    (5, 2048): (64, 256, 160),
    (2, 2048): (64, 128, 128),
    (1, 2048): (64, 64, 128),
    (1, 64): (64, 64, 4),
    (3, 64): (64, 64, 12),
    (40, 64): (64, 128, 80),
    (140, 64): (64, 256, 140),   # decode rows never take 128-row tiles
    (3, 37): (64, 64, 12),
}


@pytest.mark.parametrize("key", list(K5_PLANS), ids=[f"R{r}-T{t}" for r, t in K5_PLANS])
def test_k5_plan_at_the_main_path_shapes(key):
    runs, t = key
    p = k5.plan(runs, t, N_SM)
    assert (p.bm, p.bn, p.grid) == K5_PLANS[key]


def test_k5_plan_invariants():
    for t in (1, 37, 64, 65, 128, 700, 2044, 2048, 4096):
        for runs in (1, 2, 3, 5, 8, 14, 22, 33, 34, 66, 67, 132, 200):
            p = k5.plan(runs, t, N_SM)
            assert (p.bm, p.bn) in ((128, 256), (64, 256), (64, 128), (64, 64))
            assert p.grid == runs * cdiv(t, p.bm) * (BLOCK // p.bn)
            if p.bm == 128:        # the 128-row tiles alone fill the SMs
                assert t > 64 and runs * cdiv(t, 128) >= N_SM
            if p.bn < BLOCK:       # columns split only while the grid stays within the SMs
                assert p.grid <= N_SM


IDX_OUT = (2, 0, 2, 1, 0, 2)   # repeated out blocks, unsorted
IDX_IN = (1, 0, 0, 1, 0, 1)    # a repeated in block and a repeated (o, i) pair


def _k5_case(t, dtype, seed):
    out = tp.seeded_normal((t, 3 * BLOCK), seed=seed)
    src = tp.seeded_normal((t, 2 * BLOCK), seed=seed + 1)
    delta = tp.seeded_normal((len(IDX_OUT), BLOCK, BLOCK), seed=seed + 2, scale=0.02)
    return out, src, delta


def _k5_close(got, want, dtype):
    rtol, atol = K5_TOL[dtype]
    got, want = tp.np32(got), tp.np32(want)
    assert bool((np.abs(got - want) <= atol + rtol * np.abs(want)).all()), \
        float(np.abs(got - want).max())


@pytest.mark.parametrize("dtype", ["fp32", "bf16", "fp16"])
@pytest.mark.parametrize("t", [64, 37, 130])
@pytest.mark.parametrize("transpose", [True, False], ids=["Dt", "D"])
def test_k5_order_model_matches_plain_and_jax(transpose, t, dtype):
    """The kernel's order (the out tile seeded in fp32, each j of a run and
    each 64-element chunk of its contraction added in order, one rounding)
    against the plain version, the JAX Pallas kernel (interpret mode) and
    the JAX decode's chain `_dyn_correction`, within K5_TOL's rule: equal
    or one rounding of the output apart."""
    out, src, delta = _k5_case(t, dtype, seed=3 + t)
    args = (tp.to_torch(src, dtype), tp.to_torch(delta, dtype), IDX_OUT, IDX_IN, transpose)
    got = k5.block_correction_order_model(tp.to_torch(out, dtype), *args)
    assert got.dtype == tp.TORCH_DTYPES[dtype]
    _k5_close(got, k5.block_correction_plain(tp.to_torch(out, dtype), *args), dtype)
    # the JAX forms take D_j itself: delta[j]^T for the forward
    mats = np.ascontiguousarray(delta.transpose(0, 2, 1)) if transpose else delta
    jout, jsrc, jmats = tp.to_jax(out, dtype), tp.to_jax(src, dtype), tp.to_jax(mats, dtype)
    _k5_close(got, jax_block_correction(jout, jsrc, jmats, IDX_OUT, IDX_IN), dtype)
    # the chain rounds to the output type after every j; run it in fp32 on
    # the same values (exact for bf16), so that only the model rounds
    exact = [tp.to_jax(tp.np32(tp.to_torch(a, dtype)), "fp32") for a in (out, src, mats)]
    chain = jsl._dyn_correction(*exact, jnp.asarray(IDX_OUT, jnp.int32),
                                jnp.asarray(IDX_IN, jnp.int32))
    _k5_close(got, chain, dtype)


def test_k5_order_model_dropped_j_is_rejected():
    """chip_smoke.py's planted fault: a run's last j dropped fails K5_TOL."""
    out, src, delta = _k5_case(64, "bf16", seed=1)
    src_t, delta_t = tp.to_torch(src, "bf16"), tp.to_torch(delta, "bf16")
    want = k5.block_correction_order_model(tp.to_torch(out, "bf16"), src_t, delta_t,
                                           IDX_OUT, IDX_IN, True)
    keep = [0, 1, 3, 4, 5]  # the run of out block 2 loses j = 2
    fault = k5.block_correction_order_model(tp.to_torch(out, "bf16"), src_t, delta_t[keep],
                                            [IDX_OUT[j] for j in keep],
                                            [IDX_IN[j] for j in keep], True)
    with pytest.raises(AssertionError):
        _k5_close(fault, want, "bf16")


def test_k1_validation_refusals():
    bf = lambda *s: torch.zeros(s, dtype=torch.bfloat16)
    i32 = lambda *v: torch.tensor(v, dtype=torch.int32)
    ok = (bf(64, 512), bf(64, 256), i32(0, 1), i32(0, 0))
    k1._validate(*ok)
    cases = [
        ((bf(64, 512).double(), bf(64, 256).double(), i32(0), i32(0)), TypeError),  # fp64
        ((bf(64, 512).half(), bf(64, 256), i32(0), i32(0)), TypeError),          # fp16 + bf16
        ((bf(64, 512), bf(64, 256).float(), i32(0), i32(0)), TypeError),        # mixed
        ((bf(64, 500), bf(64, 256), i32(0), i32(0)), ValueError),                # O % 256
        ((bf(64, 512), bf(63, 256), i32(0), i32(0)), ValueError),                # T differs
        ((bf(512, 64).t(), bf(64, 256), i32(0), i32(0)), ValueError),            # not contiguous
        ((bf(64 * 512 + 1)[1:].view(64, 512), bf(64, 256), i32(0), i32(0)), ValueError),  # align
        ((bf(64, 512), bf(64, 256), i32(0).long(), i32(0)), ValueError),         # int64 index
        ((bf(64, 512), bf(64, 256), i32(0, 1), i32(0)), ValueError),             # rb/cb lengths
    ]
    for args, err in cases:
        with pytest.raises(err):
            k1._validate(*args)
    g2, x2, rb, cb = ok
    for bm, splits in ((96, 1), (128, 0), (128, 2), (64, 5)):  # T 64: one chunk
        with pytest.raises(ValueError, match="splits"):
            k1._launch(g2, x2, rb, cb, bm, splits)
        with pytest.raises(ValueError, match="splits"):  # the fp16 body takes the same plans
            k1._launch(g2.half(), x2.half(), rb, cb, bm, splits)
    k1._validate(g2.half(), x2.half(), rb, cb)
    assert not any(k1.LAUNCHES.values())


def test_k5_validation_refusals():
    bf = lambda *s: torch.zeros(s, dtype=torch.bfloat16)
    sched = k5.correction_schedule([1, 0], [0, 1], "cpu")
    ok = (bf(64, 512), bf(64, 512), bf(2, 256, 256))
    k5._validate(*ok, sched)
    cases = [
        ((bf(64, 512), bf(64, 512).float(), bf(2, 256, 256)), TypeError),        # mixed
        ((bf(64, 512).half(), bf(64, 512).half(), bf(2, 256, 256)), TypeError),  # fp16 + bf16
        ((bf(64, 512).double(), bf(64, 512).double(), bf(2, 256, 256).double()), TypeError),
        ((bf(64, 512), bf(63, 512), bf(2, 256, 256)), ValueError),               # T differs
        ((bf(64, 500), bf(64, 512), bf(2, 256, 256)), ValueError),               # O % 256
        ((bf(64, 512), bf(64, 512), bf(3, 256, 256)), ValueError),               # n differs
        ((bf(64, 256), bf(64, 512), bf(2, 256, 256)), ValueError),               # o out of range
        ((bf(512, 64).t(), bf(64, 512), bf(2, 256, 256)), ValueError),           # not contiguous
        ((bf(64, 512), bf(64 * 512 + 1)[1:].view(64, 512), bf(2, 256, 256)), ValueError),  # align
    ]
    for args, err in cases:
        with pytest.raises(err):
            k5._validate(*args, sched)
    for bm, bn in ((128, 128), (64, 32), (256, 256)):
        with pytest.raises(ValueError, match="tiles"):
            k5._launch(*ok, sched, True, bm, bn)
        with pytest.raises(ValueError, match="tiles"):  # the fp16 body's tile shapes
            k5._launch(*(t.half() for t in ok), sched, True, bm, bn)
    k5._validate(*(t.half() for t in ok), sched)
    assert not any(k5.LAUNCHES.values())


def test_k1_k5_bf16_bodies_are_wgmma_fed_by_tma():
    """The bf16 bodies are the Hopper designs: wgmma from TMA-filled
    shared memory (csrc/hopper.cuh, which keys the build), no WMMA left;
    the fp32 bodies stay."""
    srcs = {p.name: p.read_text() for p in _build.sources()}
    for name, kern in (("block_grad.cu", "block_grad_wgmma_kernel"),
                       ("correction.cu", "correction_wgmma_kernel")):
        text = srcs[name]
        assert '#include "hopper.cuh"' in text and kern in text
        assert "wgmma_bf16<" in text and "tma_load_2d(" in text and "mbar_wait(" in text
        assert "wmma::" not in text and "<mma.h>" not in text
        assert "_f32_kernel" in text
    hopper = (_build.CSRC / "hopper.cuh").read_text()
    assert "m64n256k16.f32.bf16.bf16" in hopper and "m64n64k16.f32.bf16.bf16" in hopper


def test_profile_steps_names_catch_every_k1_k5_kernel():
    """utils/profile_steps.py sums a kernel's device time by a part of its
    name: every __global__ function of K1's and K5's sources (their split
    sums run inside them) carries its kernel's part, and no other
    kernel's."""
    from sparse_matrix_tuning_tpu_torch.utils.profile_steps import OWN_KERNELS
    pattern = re.compile(r"__global__ void.*?^(\w+)\(", re.S | re.M)  # the name opens a line
    for name, label in (("block_grad.cu", "K1 block_grad"),
                        ("correction.cu", "K5 block_correction")):
        kernels = pattern.findall((_build.CSRC / name).read_text())
        assert len(kernels) == 2, kernels
        for kern in kernels:
            assert [k for k, part in OWN_KERNELS.items() if part in kern] == [label], kern
