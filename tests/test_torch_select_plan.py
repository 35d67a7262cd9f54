"""Selection and plans: the same saliency statistics (with ties) give the
same SMTPlan JSON and fingerprint through the JAX compute_matrix_selection
and the port's, in both saliency-accumulation modes. Integer-valued
gradients keep every block reduction exact in fp32, so both frameworks see
bit-identical stats and the tie order (select.py's total order) decides."""
import jax
import numpy as np
import pytest
import torch

import torch_parity as tp

from sparse_matrix_tuning_tpu.config import SMTConfig as JaxSMTConfig
from sparse_matrix_tuning_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from sparse_matrix_tuning_tpu.models.llama import all_2d_param_shapes, init_params
from sparse_matrix_tuning_tpu.smt import select as jselect
from sparse_matrix_tuning_tpu.smt.plan import SMTPlan as JaxSMTPlan
from sparse_matrix_tuning_tpu.train import convert as jconvert
from sparse_matrix_tuning_tpu_torch.config import SMTConfig
from sparse_matrix_tuning_tpu_torch.models.from_jax import plan_from_jax
from sparse_matrix_tuning_tpu_torch.smt import select
from sparse_matrix_tuning_tpu_torch.smt.plan import SMTPlan
from sparse_matrix_tuning_tpu_torch.train import convert

JAX_CFG = JaxLlamaConfig.tiny(vocab_size=256)
SHAPES = {"q_proj": (256, 256), "k_proj": (128, 256), "v_proj": (128, 256),
          "gate_proj": (512, 256), "up_proj": (512, 256), "down_proj": (256, 512)}


@pytest.fixture(scope="module")
def all_2d():
    return all_2d_param_shapes(init_params(jax.random.PRNGKey(0), JAX_CFG))


def _grad_sums(seed):
    """Integer-valued grad sums, block-constant on a few blocks (exact ties
    across modules and layers), noisy elsewhere."""
    rng = np.random.default_rng(seed)
    acc = {}
    for layer in range(2):
        for mod, shape in SHAPES.items():
            if shape[0] % 256 or shape[1] % 256:
                continue
            g = rng.integers(-3, 4, shape).astype(np.float32)
            g[:256, :256] = 2.0  # a tie shared by every module's first block
            acc[f"{layer}.{mod}"] = g
    return acc


def _cfgs(**kw):
    base = dict(data_path=["x"], model_name_or_path="m", matrix_sparsity=True,
                downsample_attention_blocks_ratio=0.15,
                downsample_mlp_blocks_ratio=0.15)
    base.update(kw)
    return JaxSMTConfig(**base), SMTConfig(**base)


@pytest.mark.parametrize("strategy", ["mean_abs", "abs_mean", "L1", "L2"])
@pytest.mark.parametrize("selection", ["no_restriction", "norm_dist"])
def test_grad_sum_selection_matches_jax(strategy, selection, all_2d):
    jcfg, pcfg = _cfgs(saliency_accumulation="grad_sum", calculate_strategy=strategy,
                       selection_strategy=selection)
    acc = _grad_sums(0)
    want = jconvert.compute_matrix_selection(jcfg, {k: jax.numpy.asarray(v)
                                                    for k, v in acc.items()}, all_2d)
    got = convert.compute_matrix_selection(pcfg, {k: torch.from_numpy(v)
                                                  for k, v in acc.items()}, all_2d)
    assert got == want
    dims = {(m, l): SHAPES[m] for l in range(2) for m in SHAPES}
    jplan = JaxSMTPlan.from_selection("matrix", want, dims)
    plan = SMTPlan.from_selection("matrix", got, dims)
    assert plan.to_json() == jplan.to_json()
    assert plan.fingerprint() == jplan.fingerprint()
    assert plan_from_jax(jplan).fingerprint() == jplan.fingerprint()
    assert SMTPlan.from_json(plan.to_json()).to_json() == plan.to_json()


@pytest.mark.parametrize("strategy", ["mean_abs", "abs_mean"])
def test_per_step_stats_selection_matches_jax(strategy, all_2d):
    """Accumulated per-step block stats (signed means for mean_abs), with
    ties, finalised and selected by both packages."""
    jcfg, pcfg = _cfgs(saliency_accumulation="per_step_stats", calculate_strategy=strategy)
    rng = np.random.default_rng(1)
    acc = {}
    for layer in range(2):
        for mod, shape in SHAPES.items():
            acc[f"{layer}.{mod}"] = rng.integers(-2, 3, (shape[0] // 256, shape[1] // 256)
                                                 ).astype(np.float32) / 4
    want = jconvert.compute_matrix_selection(jcfg, {k: jax.numpy.asarray(v)
                                                    for k, v in acc.items()}, all_2d)
    got = convert.compute_matrix_selection(pcfg, {k: torch.from_numpy(v)
                                                  for k, v in acc.items()}, all_2d)
    assert got == want and sum(len(v) for v in got.values()) > 0


def test_torch_block_stats_twins_match_numpy():
    """The on-device harvest reducers (torch tensors) against the numpy
    originals, and the numpy selection code is the JAX package's."""
    g = tp.seeded_normal((512, 768), 0)
    for strategy in ("mean_abs", "abs_mean", "L1", "L2"):
        for fn in (select.block_stats, select.block_stats_step):
            tp.assert_close(fn(torch.from_numpy(g), strategy),
                            jselect.block_stats_step(g, strategy) if fn is select.block_stats_step
                            else jselect.block_stats(g, strategy), 1e-5, 1e-7)
        acc = select.block_stats_step(torch.from_numpy(g), strategy)
        tp.assert_close(select.block_stats_final(acc, strategy),
                        jselect.block_stats_final(tp.np32(acc), strategy), 0, 0)
    stats = {("q_proj", 0): np.ones((2, 2), np.float32), ("k_proj", 1): np.ones((1, 2), np.float32)}
    for n in (1, 3, 6):
        assert select.select_submatrices(stats, n) == jselect.select_submatrices(stats, n)
    assert select.count_total_blocks([(512, 256), (7,)]) == jselect.count_total_blocks([(512, 256), (7,)])


def test_harvest_strategy_quirk_matches_jax():
    jcfg, pcfg = _cfgs(calculate_strategy="L1")
    for mod in SHAPES:
        assert convert.harvest_strategy(pcfg, mod) == jconvert.harvest_strategy(jcfg, mod)
    assert convert.harvest_strategy(pcfg, "q_proj") == "mean_abs"
