"""K2 masked_adam: the port's plain version (what the wrapper runs on CPU
tensors) against the JAX Pallas kernel (interpret mode) and the functional
adam_step, over two steps (bias correction), with the JAX suite's
tolerances (tests/test_masked_adam.py). Also the sparse step's fused-update
helper against the JAX one, and the port's adam_step against JAX's."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as tp

from sparse_matrix_tuning_tpu.ops.pallas.masked_adam import fused_block_adam_impl
from sparse_matrix_tuning_tpu.smt import optimizer as jopt
from sparse_matrix_tuning_tpu.train.steps import _fused_block_adam_update as jax_fused_update
from sparse_matrix_tuning_tpu_torch.ops.cuda import masked_adam as k2
from sparse_matrix_tuning_tpu_torch.smt import optimizer as popt
from sparse_matrix_tuning_tpu_torch.train.steps import _fused_block_adam_update

B1, B2, EPS = 0.9, 0.95, 1e-8


def _scalars(lr, wd, step):
    return np.asarray([lr, B1, B2, EPS, wd, 1 - B1 ** step, 1 - B2 ** step], np.float32)


@pytest.mark.parametrize("wd", [0.0, 0.1])
def test_plain_matches_pallas_and_adam_step_over_two_steps(wd):
    n = 3
    p0 = tp.seeded_normal((n, 256, 256), 0)
    grads = [tp.seeded_normal((n, 256, 256), 1, 0.1), tp.seeded_normal((n, 256, 256), 2, 0.1)]
    cfg = jopt.AdamConfig(betas=(B1, B2), eps=EPS, weight_decay=wd)

    # JAX: the Pallas kernel (interpret) and the functional oracle
    jp, jm, jv = jnp.asarray(p0), jnp.zeros_like(p0), jnp.zeros_like(p0)
    tree = {"t": jnp.asarray(p0)}
    opt = jopt.adam_init(tree)
    # port: the wrapper on CPU tensors (-> plain version), in place
    p, m, v = torch.from_numpy(p0.copy()), torch.zeros(p0.shape), torch.zeros(p0.shape)
    for step, g in enumerate(grads, start=1):
        s = _scalars(0.01, wd, step)
        jp, jm, jv = fused_block_adam_impl(jp, jnp.asarray(g), jm, jv, jnp.asarray(s))
        tree, opt = jopt.adam_step({"t": jnp.asarray(g)}, opt, tree, jnp.asarray(0.01), cfg)
        k2.masked_adam(p, torch.from_numpy(g), m, v, torch.from_numpy(s))
        for got, want in ((p, jp), (m, jm), (v, jv)):
            tp.assert_close(got, want, rtol=1e-6, atol=1e-7)
        tp.assert_close(p, tree["t"], rtol=1e-6, atol=1e-6)
    assert k2.LAUNCHES == 0  # the CPU path launches nothing


@pytest.mark.parametrize("qk", [False, True])
def test_fused_update_helper_matches_jax(qk):
    """steps._fused_block_adam_update: device-side bias corrections from the
    step count, per-linear LR scale folded into lr, one K2 call per linear."""
    keys = ["0.q_proj", "1.up_proj"]
    p0 = {k: tp.seeded_normal((2, 256, 256), i) for i, k in enumerate(keys)}
    grads = {k: tp.seeded_normal((2, 256, 256), 10 + i, 0.1) for i, k in enumerate(keys)}
    cfg_j = jopt.AdamConfig(betas=(B1, B2), eps=EPS, weight_decay=0.1)
    cfg_p = popt.AdamConfig(betas=(B1, B2), eps=EPS, weight_decay=0.1)
    scale_j = jopt.make_qk_lr_scale(2) if qk else None
    scale_p = popt.make_qk_lr_scale(2) if qk else None

    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    jstate = {"m": {k: jnp.zeros_like(v) for k, v in jp.items()},
              "v": {k: jnp.zeros_like(v) for k, v in jp.items()},
              "count": jnp.zeros((), jnp.int32)}
    pp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    pstate = {"m": {k: torch.zeros_like(v) for k, v in pp.items()},
              "v": {k: torch.zeros_like(v) for k, v in pp.items()},
              "count": torch.zeros((), dtype=torch.int32)}
    consts = torch.tensor([B1, B2, EPS, 0.1], dtype=torch.float32)
    for _ in range(2):
        jg = {k: jnp.asarray(v) for k, v in grads.items()}
        jp, jstate = jax_fused_update(jg, jstate, jp, jnp.asarray(3e-3), cfg_j, scale_j)
        _fused_block_adam_update({k: torch.from_numpy(v) for k, v in grads.items()},
                                 pstate, pp, torch.tensor(3e-3), cfg_p, scale_p, consts)
    assert int(pstate["count"]) == int(jstate["count"]) == 2
    for k in keys:
        tp.assert_close(pp[k], jp[k], rtol=1e-6, atol=1e-6)
        tp.assert_close(pstate["v"][k], jstate["v"][k], rtol=1e-6, atol=1e-7)


def test_adam_step_matches_jax_with_param_groups():
    """The full-FT warm-up optimizer: decay mask (norms/biases excluded) and
    the q/k LR boost, keyed by the JAX tree's "/"-joined paths."""
    shapes = {"layers/0/q_proj": (4, 8), "layers/0/input_layernorm": (8,),
              "embed_tokens": (16, 8)}
    params = {k: tp.seeded_normal(s, i) for i, (k, s) in enumerate(shapes.items())}
    grads = {k: tp.seeded_normal(s, 20 + i, 0.1) for i, (k, s) in enumerate(shapes.items())}
    jtree = {"layers": {"0": {"q_proj": jnp.asarray(params["layers/0/q_proj"]),
                              "input_layernorm": jnp.asarray(params["layers/0/input_layernorm"])}},
             "embed_tokens": jnp.asarray(params["embed_tokens"])}
    jgrads = {"layers": {"0": {"q_proj": jnp.asarray(grads["layers/0/q_proj"]),
                               "input_layernorm": jnp.asarray(grads["layers/0/input_layernorm"])}},
              "embed_tokens": jnp.asarray(grads["embed_tokens"])}
    jcfg = jopt.AdamConfig(weight_decay=0.1)
    jstate = jopt.adam_init(jtree)
    pflat = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    pstate = popt.adam_init(pflat)
    for _ in range(2):
        jtree, jstate = jopt.adam_step(jgrads, jstate, jtree, jnp.asarray(1e-2), jcfg,
                                       lr_scale=jopt.make_qk_lr_scale(3),
                                       wd_mask=jopt.full_ft_wd_mask)
        popt.adam_step({k: torch.from_numpy(v) for k, v in grads.items()}, pstate, pflat,
                       torch.tensor(1e-2), popt.AdamConfig(weight_decay=0.1),
                       lr_scale=popt.make_qk_lr_scale(3), wd_mask=popt.full_ft_wd_mask)
    tp.assert_close(pflat["layers/0/q_proj"], jtree["layers"]["0"]["q_proj"], 1e-6, 1e-6)
    tp.assert_close(pflat["layers/0/input_layernorm"],
                    jtree["layers"]["0"]["input_layernorm"], 1e-6, 1e-6)
    tp.assert_close(pflat["embed_tokens"], jtree["embed_tokens"], 1e-6, 1e-6)


def test_clip_and_schedules_match_jax():
    grads = {"a": tp.seeded_normal((5, 7), 0, 3.0), "b": tp.seeded_normal((11,), 1, 3.0)}
    jg, jnorm = jopt.clip_by_global_norm({k: jnp.asarray(v) for k, v in grads.items()}, 1.0)
    pg, pnorm = popt.clip_by_global_norm({k: torch.from_numpy(v.copy())
                                          for k, v in grads.items()}, 1.0)
    tp.assert_close(pnorm, jnorm, 1e-6, 0)
    for k in grads:
        tp.assert_close(pg[k], jg[k], 1e-6, 1e-7)
    for kind in ("linear", "cosine", "constant"):
        js = jopt.make_lr_schedule(kind, 1e-3, 3, 10)
        ps = popt.make_lr_schedule(kind, 1e-3, 3, 10)
        for step in range(0, 12):
            tp.assert_close(ps(torch.tensor(step, dtype=torch.int32)),
                            js(jnp.asarray(step, jnp.int32)), 1e-6, 0)
