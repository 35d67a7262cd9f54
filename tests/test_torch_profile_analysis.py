"""--do_gradient_distribution_analysis (utils/analysis.py, called at matrix
selection by train/convert.compute_matrix_selection) and --profile_dir
(SMTTrainer._maybe_profile, torch.profiler) against the JAX package: the
histograms decode to JAX's pixels, the statistics handed to them at each
call site are JAX's, nothing is drawn without an output_dir or in channel
mode; the trace covers JAX's window of steps, is written and parses, and a
run that ends inside the window still writes it. On a (1, 2, 1) mesh of
ranks run as threads (tests/test_torch_tensor.py's _on_threads) fit
matches one process and rank 0 alone draws and traces."""
import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as tp
from test_torch_parallel import D1_RTOL
from test_torch_tensor import _RANK, _on_threads

from sparse_matrix_tuning_tpu.config import SMTConfig as JaxSMTConfig
from sparse_matrix_tuning_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from sparse_matrix_tuning_tpu.models.llama import init_params as jax_init_params
from sparse_matrix_tuning_tpu.train.trainer import SMTTrainer as JaxSMTTrainer
from sparse_matrix_tuning_tpu.utils import analysis as janalysis
from sparse_matrix_tuning_tpu_torch.config import SMTConfig
from sparse_matrix_tuning_tpu_torch.data.sft import SFTDataset
from sparse_matrix_tuning_tpu_torch.models import llama
from sparse_matrix_tuning_tpu_torch.train.trainer import SMTTrainer
from sparse_matrix_tuning_tpu_torch.utils import analysis

JAX_CFG = JaxLlamaConfig.tiny(vocab_size=256)
CFG = llama.LlamaConfig.tiny(vocab_size=256)
# block statistics of the fp32 grads two trainers in two frameworks summed
# over two warm-up steps on the CPU: held at the training bound of
# tests/test_torch_train_e2e.py (LOSS_RTOL, 1e-4); measured worst
# 1.6e-5 (a block whose statistic is ~1e-6)
STATS_RTOL = 1e-4


def _read_png(path):
    import matplotlib.image
    return matplotlib.image.imread(path)


def _stats(modules, layers=3, seed=0):
    rng = np.random.default_rng(seed)
    return {(m, li): np.abs(rng.standard_normal((2, 2))).astype(np.float32) * (li + 1)
            for li in range(layers) for m in modules}


@pytest.mark.parametrize("modules", [
    ("q_proj", "k_proj", "v_proj"), ("gate_proj", "up_proj", "down_proj"),
    ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj", "down_proj"),
], ids=["attention", "mlp", "merged"])
def test_histograms_decode_to_jax_pixels(modules, tmp_path):
    """The same statistics give the same file name, and the PNG decodes to
    the same pixels as JAX's analyze_gradient_distribution's."""
    stats = _stats(modules)
    got = analysis.analyze_gradient_distribution(stats, str(tmp_path / "port"))
    want = janalysis.analyze_gradient_distribution(stats, str(tmp_path / "jax"))
    assert os.path.basename(got) == os.path.basename(want) == \
        f"gradient_histograms_{'_'.join(modules)}.png"
    a, b = _read_png(got), _read_png(want)
    assert a.shape == b.shape and a.shape[0] > 100
    np.testing.assert_array_equal(a, b)


def test_histograms_without_matplotlib_draw_numpys_counts(tmp_path, monkeypatch):
    """Where matplotlib is not installed (the GPU machine) the same file is
    drawn with Pillow: three 750-pixel panels a row, and in each module's
    panel bin b's bar is round(count / max count * height) pixels high,
    count np.histogram(values, 150)'s."""
    from PIL import Image
    modules = ("gate_proj", "up_proj", "down_proj", "q_proj")
    stats = _stats(modules, layers=40, seed=3)
    monkeypatch.setattr(analysis, "has_matplotlib", lambda: False)
    path = analysis.analyze_gradient_distribution(stats, str(tmp_path))
    assert os.path.basename(path) == f"gradient_histograms_{'_'.join(modules)}.png"
    img = np.asarray(Image.open(path).convert("RGB"))
    assert img.shape == (2 * analysis.PANEL, 3 * analysis.PANEL, 3)
    for i, m in enumerate(modules):
        values = np.concatenate([v.reshape(-1) for (mod, _), v in stats.items() if mod == m])
        counts, _ = np.histogram(values, bins=analysis.BINS)
        left, top, width, height = analysis.plot_box(i)
        bar = width // analysis.BINS
        drawn = [int((img[top:top + height, left + bar * b] == analysis.BAR_RGB).all(-1).sum())
                 for b in range(analysis.BINS)]
        assert drawn == [round(int(c) / counts.max() * height) for c in counts], m


def _spy(monkeypatch, module, calls, rank=False):
    """Record each call's statistics (and with `rank` the calling thread's
    rank), then draw them."""
    real = module.analyze_gradient_distribution

    def spy(stats, output_dir):
        calls.append({"keys": list(stats), "values": [np.asarray(v) for v in stats.values()],
                      "rank": getattr(_RANK, "r", None) if rank else None})
        return real(stats, output_dir)
    monkeypatch.setattr(module, "analyze_gradient_distribution", spy)


def _cfg_kwargs(**kw):
    base = dict(data_path=["x.json"], model_name_or_path="tiny", dtype="fp32",
                matrix_sparsity=True, full_ft_steps=2, downsample_attention_blocks_ratio=0.05,
                downsample_mlp_blocks_ratio=0.05, ft_learning_rate=1e-3, smt_lr=1e-2,
                lr_scheduler_type="constant", eval_step=0, save_steps=0,
                gradient_checkpointing=False, max_seq_len=32, seq_buckets=[32], seed=0)
    if kw.get("channel_sparsity"):
        base.update(matrix_sparsity=False, num_attention_channel=8, num_mlp_channel=8)
    base.update(kw)
    return base


@pytest.mark.parametrize("kw,n_calls", [
    (dict(), 2), (dict(no_limit_mixture=True), 1),
    (dict(saliency_accumulation="per_step_stats"), 2),
], ids=["attention and mlp", "no_limit_mixture", "per_step_stats"])
def test_stats_at_the_call_sites_are_jax(kw, n_calls, tmp_path, monkeypatch):
    """Two warm-up steps and the conversion in the JAX trainer and the
    port's from the same weights and batches: at each call site
    (attention's and the MLP's statistics, or the merged ones under
    no_limit_mixture) the port hands the analysis the statistics JAX hands
    its own (the same keys in the same order, values within STATS_RTOL),
    and the same files result."""
    jcalls, pcalls = [], []
    _spy(monkeypatch, janalysis, jcalls)
    _spy(monkeypatch, analysis, pcalls)
    batches = tp.lm_batches(3, pad_from=24)
    jparams = jax_init_params(jax.random.PRNGKey(0), JAX_CFG)
    pparams = tp.port_params(jparams)
    full = _cfg_kwargs(do_gradient_distribution_analysis=True, **kw)
    jt = JaxSMTTrainer(JaxSMTConfig(**{**full, "output_dir": str(tmp_path / "jax")}), JAX_CFG,
                       jparams, total_steps=3)
    pt = SMTTrainer(SMTConfig(**{**full, "output_dir": str(tmp_path / "port")}), CFG, pparams,
                    total_steps=3)
    for b in batches:
        jt.train_step(b)
        pt.train_step(b)
    assert pt.phase == "sparse" and len(jcalls) == len(pcalls) == n_calls
    for got, want in zip(pcalls, jcalls):
        assert got["keys"] == want["keys"]
        for g, w in zip(got["values"], want["values"]):
            np.testing.assert_allclose(g, w, rtol=STATS_RTOL, atol=0)
    assert sorted(os.listdir(tmp_path / "port")) == sorted(
        f for f in os.listdir(tmp_path / "jax") if f.endswith(".png"))
    assert pt.plan.fingerprint() == jt.plan.fingerprint()


@pytest.mark.parametrize("kw", [
    dict(output_dir=None),
    dict(channel_sparsity=True),
], ids=["no output_dir", "channel mode"])
def test_nothing_is_drawn_without_output_dir_or_in_channel_mode(kw, tmp_path, monkeypatch):
    """With the flag but no output_dir, or in channel mode (JAX's channel
    selection calls no analysis), the conversion draws nothing."""
    calls = []
    _spy(monkeypatch, analysis, calls)
    full = _cfg_kwargs(do_gradient_distribution_analysis=True,
                       **{"output_dir": str(tmp_path / "out"), **kw})
    pt = SMTTrainer(SMTConfig(**full), CFG, llama.init_params(CFG, seed=0), total_steps=3)
    for b in tp.lm_batches(3):
        pt.train_step(b)
    assert pt.phase == "sparse" and calls == []
    assert not list(tmp_path.rglob("*.png"))


# ---------------------------------------------------------------------------
# --profile_dir
# ---------------------------------------------------------------------------

def _datasets(n=8, seed=4):
    rng = np.random.default_rng(seed)
    ids = [rng.integers(3, 256, int(rng.integers(10, 33))).astype(np.int32) for _ in range(n)]
    return SFTDataset(ids, [i.copy() for i in ids])


def _jax_window(start, steps, n):
    """Which of n steps JAX's SMTTrainer._maybe_profile traces, called as
    JAX's fit calls it (before each step), on a stand-in trainer whose
    start_trace / stop_trace are recorded, not run."""
    events = []
    cfg = JaxSMTConfig(**_cfg_kwargs(profile_dir="prof", profile_start=start,
                                     profile_steps=steps))
    stub = types.SimpleNamespace(cfg=cfg, step=0, state={"x": jnp.zeros(1)})
    traced = []
    real = jax.profiler.start_trace, jax.profiler.stop_trace
    jax.profiler.start_trace = lambda d: events.append(("start", stub.step))
    jax.profiler.stop_trace = lambda: events.append(("stop", stub.step))
    try:
        for _ in range(n):
            JaxSMTTrainer._maybe_profile(stub)
            traced.append(getattr(stub, "_profiling", False))
            stub.step += 1
    finally:
        jax.profiler.start_trace, jax.profiler.stop_trace = real
    return traced, events


@pytest.mark.parametrize("window,want_file", [
    ((1, 2), "trace_steps_1_3.json"),    # steps 1 and 2 of 0..3
    ((0, 3), "trace_steps_0_3.json"),    # the warm-up's first step to the first sparse
    ((2, 10), "trace_steps_2_4.json"),   # the run ends inside the window
    (None, None),                        # no --profile_dir: no trace
])
def test_profile_window_is_jax_and_the_trace_parses(window, want_file, tmp_path, monkeypatch,
                                                    capsys):
    """fit over 4 steps (2 warm-up, 2 sparse): the steps run while the
    torch.profiler traces are the steps JAX's _maybe_profile traces; the
    trace is written into profile_dir as trace_steps_{start}_{stop}.json
    and parses as a Chrome trace holding the steps' aten ops (a run that
    ends inside the window stops and writes it after the last step, where
    JAX's leaves it running); without the flag no profiler is made."""
    made = []
    real_profile = torch.profiler.profile
    monkeypatch.setattr(torch.profiler, "profile",
                        lambda **kw: made.append(kw) or real_profile(**kw))
    prof = str(tmp_path / "prof")
    kw = {} if window is None else dict(profile_dir=prof, profile_start=window[0],
                                        profile_steps=window[1])
    t = SMTTrainer(SMTConfig(**_cfg_kwargs(per_device_ft_batch_size=2, num_ft_epochs=1, **kw)),
                   CFG, llama.init_params(CFG, seed=0), total_steps=4)
    traced = []
    step_of = t.train_step
    t.train_step = lambda b: (traced.append(t._profiler is not None), step_of(b))[1]
    t.fit(_datasets(), _datasets(n=2), pad_token_id=0)
    assert t.step == 4 and t._profiler is None
    if window is None:
        assert made == [] and traced == [False] * 4 and not os.path.exists(prof)
        return
    want_traced, events = _jax_window(*window, 4)
    assert traced == want_traced and sum(traced) == min(window[1], 4 - window[0])
    assert events[0] == ("start", window[0])
    assert events[1:] == ([("stop", window[0] + window[1])] if window[0] + window[1] < 4
                          else [])
    assert len(made) == 1 and made[0]["activities"] == [torch.profiler.ProfilerActivity.CPU]
    assert os.listdir(prof) == [want_file]
    with open(os.path.join(prof, want_file)) as f:
        trace = json.load(f)
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert any(n.startswith("aten::") for n in names), sorted(names)[:20]
    out = capsys.readouterr().out
    assert f"[profile] tracing steps {window[0]}..{window[0] + window[1]} -> {prof}" in out


# ---------------------------------------------------------------------------
# a (1, 2, 1) mesh of thread ranks through fit
# ---------------------------------------------------------------------------

MESH_FIT = dict(num_ft_epochs=1, do_gradient_distribution_analysis=True, profile_start=1,
                profile_steps=2)


@pytest.fixture(scope="module")
def mesh_fit(tmp_path_factory):
    """fit at the global batch 4 in one process and over (1, 2, 1) thread
    ranks (2 rows a rank), each with an output_dir and --profile_dir,
    --do_gradient_distribution_analysis on: histories, plans, the
    analysis's calls with their rank, and the files written."""
    root = tmp_path_factory.mktemp("mesh_fit")
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        calls = []
        _spy(mp, analysis, calls, rank=True)
        made = []
        real_profile = torch.profiler.profile
        mp.setattr(torch.profiler, "profile",
                   lambda **kw: made.append(getattr(_RANK, "r", None)) or real_profile(**kw))
        for name, shape, bs in (("one", None, 4), ("ranks", (1, 2, 1), 2)):
            kw = _cfg_kwargs(per_device_ft_batch_size=bs, per_device_eval_batch_size=bs,
                             output_dir=str(root / name / "out"),
                             profile_dir=str(root / name / "prof"), **MESH_FIT)
            calls.clear()
            made.clear()

            def run(mesh, kw=kw, shape=shape):
                cfg = SMTConfig(**kw, mesh_shape=list(shape) if shape else None)
                t = SMTTrainer(cfg, CFG, llama.init_params(CFG, seed=0), total_steps=4,
                               device="cpu", mesh=mesh)
                hist = t.fit(_datasets(n=16), _datasets(n=4), pad_token_id=0)
                return {"hist": hist, "fingerprint": t.plan.fingerprint()}
            got = [run(None)] if shape is None else _on_threads(shape, mp, run)
            out[name] = {"runs": got, "calls": list(calls), "made": list(made),
                         "dir": root / name}
    return out


def test_fit_on_thread_ranks_matches_one_process(mesh_fit):
    """The (1, 2, 1) ranks' fit at one process's global batch: equal on
    every rank, within D1_RTOL of one process (losses and eval loss), the
    same plan."""
    one = mesh_fit["one"]["runs"][0]
    ranks = mesh_fit["ranks"]["runs"]
    assert len(ranks) == 2
    for r in ranks:
        assert r["hist"] == ranks[0]["hist"] and r["fingerprint"] == one["fingerprint"]
    h, h1 = ranks[0]["hist"], one["hist"]
    assert len(h["train_loss"]) == 4
    np.testing.assert_allclose(h["train_loss"], h1["train_loss"], rtol=D1_RTOL, atol=0)
    np.testing.assert_allclose(h["eval_loss"], h1["eval_loss"], rtol=D1_RTOL)


def test_rank_0_alone_draws_the_histograms(mesh_fit):
    """Both ranks select from the same statistics; rank 0 alone draws
    them, attention's and the MLP's, as one process does, into the shared
    output_dir."""
    got, one = mesh_fit["ranks"], mesh_fit["one"]
    assert [c["rank"] for c in got["calls"]] == [0, 0]
    assert [c["keys"] for c in got["calls"]] == [c["keys"] for c in one["calls"]]
    for c, c1 in zip(got["calls"], one["calls"]):
        for g, w in zip(c["values"], c1["values"]):
            np.testing.assert_allclose(g, w, rtol=STATS_RTOL)
    pngs = sorted(p.name for p in (got["dir"] / "out").glob("*.png"))
    assert pngs == sorted(p.name for p in (one["dir"] / "out").glob("*.png")) and len(pngs) == 2


def test_rank_0_alone_traces(mesh_fit):
    """Rank 0 alone makes a profiler, and writes one trace of steps 1..3."""
    assert mesh_fit["ranks"]["made"] == [0] and mesh_fit["one"]["made"] == [None]
    for name in ("one", "ranks"):
        assert os.listdir(mesh_fit[name]["dir"] / "prof") == ["trace_steps_1_3.json"]
