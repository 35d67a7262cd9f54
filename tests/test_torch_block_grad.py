"""K1 block_grad: the port's plain version (what the wrapper runs on CPU
tensors) against the JAX Pallas kernel (interpret mode) and the JAX XLA
oracle, on the same seeded inputs. Tolerances are the JAX suite's
(tests/test_pallas_kernels.py): 1e-5 fp32, 2e-2 bf16, atol 10x."""
import ctypes
import re

import numpy as np
import pytest
import torch

import torch_parity as tp

from sparse_matrix_tuning_tpu.ops.pallas.block_grad import block_grad_weight
from sparse_matrix_tuning_tpu.ops.sparse_linear import _block_grad_weight_xla
from sparse_matrix_tuning_tpu.smt.plan import LinearPlan as JaxLinearPlan
from sparse_matrix_tuning_tpu_torch.ops.cuda import _build
from sparse_matrix_tuning_tpu_torch.ops.cuda import block_grad as k1
from sparse_matrix_tuning_tpu_torch.smt.plan import BLOCK, LinearPlan

TOL = {"fp32": 1e-5, "bf16": 2e-2}


def _inputs(t, out_dim, in_dim, dtype, seed):
    g = tp.seeded_normal((t, out_dim), seed)
    x = tp.seeded_normal((t, in_dim), seed + 1)
    return (tp.to_jax(g, dtype), tp.to_jax(x, dtype),
            tp.to_torch(g, dtype), tp.to_torch(x, dtype))


def _idx(lp):
    return (torch.as_tensor(lp.row_blocks()), torch.as_tensor(lp.col_blocks()))


@pytest.mark.parametrize("t", [512, 700])  # aligned and ragged T
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_block_grad_matches_jax(t, dtype):
    blocks = ((0, 1), (2, 0), (1, 1))  # on a 3x2-block weight
    jlp = JaxLinearPlan("q_proj", 0, 3 * BLOCK, 2 * BLOCK, blocks=blocks)
    lp = LinearPlan("q_proj", 0, 3 * BLOCK, 2 * BLOCK, blocks=blocks)
    jg, jx, g, x = _inputs(t, 3 * BLOCK, 2 * BLOCK, dtype, seed=0)
    rb, cb = _idx(lp)

    got = k1.block_grad(g, x, rb, cb)  # CPU tensors -> the plain version
    assert got.shape == (3, BLOCK, BLOCK) and got.dtype == torch.float32
    tol = TOL[dtype]
    tp.assert_close(got, block_grad_weight(jg, jx, jlp.row_blocks(), jlp.col_blocks()),
                    rtol=tol, atol=tol * 10)
    tp.assert_close(got, _block_grad_weight_xla(jlp, jg, jx), rtol=tol, atol=tol * 10)
    assert not any(k1.LAUNCHES.values())  # the CPU path launches nothing


@pytest.mark.parametrize("blocks", [((0, 0), (0, 1), (1, 0)),
                                    ((1, 1), (1, 1), (0, 1))],
                         ids=["shared-row-and-col", "repeated-pair"])
def test_repeated_block_coords(blocks):
    jlp = JaxLinearPlan("q_proj", 0, 2 * BLOCK, 2 * BLOCK, blocks=blocks)
    jg, jx, g, x = _inputs(512, 2 * BLOCK, 2 * BLOCK, "fp32", seed=1)
    got = k1.block_grad_plain(g, x, *_idx(jlp))
    tp.assert_close(got, _block_grad_weight_xla(jlp, jg, jx), rtol=1e-5, atol=1e-4)
    for i, j in ((0, 1), (0, 2), (1, 2)):
        if blocks[i] == blocks[j]:  # a repeated pair gets the same gradient
            np.testing.assert_array_equal(tp.np32(got[i]), tp.np32(got[j]))


def test_output_orientation():
    """out[i][r][c] = sum_t g[t, rb_i*256 + r] * x[t, cb_i*256 + c]."""
    t = 8
    g = torch.zeros((t, 2 * BLOCK))
    x = torch.zeros((t, 3 * BLOCK))
    g[3, 1 * BLOCK + 5] = 2.0
    x[3, 2 * BLOCK + 7] = 3.0
    out = k1.block_grad_plain(g, x, torch.tensor([1], dtype=torch.int32),
                              torch.tensor([2], dtype=torch.int32))
    assert out[0, 5, 7] == 6.0 and float(out.abs().sum()) == 6.0


def test_kernel_sources_export_the_bound_entry_points():
    """Every ctypes binding names an extern "C" entry of csrc/*.cu with the
    same parameters (pointers, int, float), and the library path is keyed
    by the sources (an edit rebuilds)."""
    srcs = {p.name: p.read_text() for p in _build.sources()}
    assert set(srcs) == {"attention.cu", "block_grad.cu", "cached_attention.cu",
                         "correction.cu", "masked_adam.cu", "q4_matmul.cu", "q8_matmul.cu",
                         "row_quant.cu"}
    text = "\n".join(srcs.values())
    for name, argtypes in _build.SIGNATURES.items():
        m = re.search(rf'extern "C" int {name}\(([^)]*)\)', text)
        assert m, name
        params = [p.strip() for p in m.group(1).split(",")]
        want = [ctypes.c_void_p if "*" in p else
                ctypes.c_float if p.startswith("float ") else
                ctypes.c_int if p.startswith("int ") else None for p in params]
        assert want == list(argtypes), name
    assert "sm_90a" in " ".join(_build.NVCC_FLAGS)
    path = _build.library_path()
    assert path.parent == _build.BUILD_DIR and path == _build.library_path()


def test_library_path_is_keyed_by_the_shared_header(tmp_path, monkeypatch):
    """csrc/tiles.cuh is compiled into attention.cu and cached_attention.cu:
    an edit to it must rebuild the library too."""
    for p in sorted(_build.CSRC.glob("*.cu")) + sorted(_build.CSRC.glob("*.cuh")):
        (tmp_path / p.name).write_bytes(p.read_bytes())
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    before = _build.library_path()
    header = tmp_path / "tiles.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    assert _build.library_path() != before
