"""The C++ collator and its prefetch thread (data/native.py, built from
csrc/collate.cpp) against the JAX package's (sparse_matrix_tuning_tpu/
data/native.py) and the port's numpy collator (data/sft.py), bit for bit;
the library's build; and `fit`, which trains from them: its training
batches come from the prefetcher, its eval batches from batch_iterator,
its two-phase run agrees with JAX's SMTTrainer.fit, and a resume mid-epoch
continues bit for bit."""
import threading

import jax
import numpy as np
import pytest
import torch

import torch_parity as tp

from sparse_matrix_tuning_tpu.config import SMTConfig as JaxSMTConfig
from sparse_matrix_tuning_tpu.data import native as jnative
from sparse_matrix_tuning_tpu.data.sft import SFTDataset as JaxSFTDataset
from sparse_matrix_tuning_tpu.models import llama as jllama
from sparse_matrix_tuning_tpu.train.trainer import SMTTrainer as JaxSMTTrainer
from sparse_matrix_tuning_tpu_torch.config import SMTConfig
from sparse_matrix_tuning_tpu_torch.data import native, sft
from sparse_matrix_tuning_tpu_torch.data.sft import SFTDataset
from sparse_matrix_tuning_tpu_torch.models import llama
from sparse_matrix_tuning_tpu_torch.ops.cuda import _build
from sparse_matrix_tuning_tpu_torch.train.checkpoint import restore_checkpoint
from sparse_matrix_tuning_tpu_torch.train.trainer import SMTTrainer

CFG = llama.LlamaConfig.tiny(vocab_size=256)
# the port's fit against the JAX trainer's (tests/test_torch_train_e2e.py)
LOSS_RTOL = 1e-4
KEYS = ("input_ids", "labels", "attention_mask")


def _examples(n=23, seed=0, longest=80):
    """Token ids 1..999 (labels: the first half of each masked), lengths
    0..longest: an empty example and ones longer than the largest bucket
    (truncated) among them."""
    rng = np.random.default_rng(seed)
    ids, labels = [], []
    for i in range(n):
        length = 0 if i == 5 else longest if i == 9 else int(rng.integers(1, longest))
        a = rng.integers(1, 1000, length).astype(np.int32)
        b = a.copy()
        b[: length // 2] = -100
        ids.append(a)
        labels.append(b)
    return ids, labels


def _assert_batches_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w) == set(KEYS)
        for k in KEYS:
            assert g[k].dtype == w[k].dtype == np.int32 and g[k].shape == w[k].shape, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


# ---------------------------------------------------------------------------
# the collator
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,epoch,buckets,drop_last,bs", [
    (3, 0, [16, 32, 64], True, 4),
    (3, 1, [16, 32, 64], True, 4),
    (7, 2, [24, 48], False, 4),     # wrap-pad of the last short batch
    (0, 0, [32], False, 5),         # one bucket: every batch truncated to it
    (11, 5, [8, 128], True, 3),
])
def test_native_iterator_is_jax_native_and_numpy(seed, epoch, buckets, drop_last, bs):
    """The port's native_batch_iterator over one epoch equals JAX's
    native_batch_iterator and the port's batch_iterator bit for bit on
    every array: the same order, buckets, wrap-pad, truncation and pads."""
    ids, labels = _examples()
    kw = dict(batch_size=bs, pad_token_id=9, buckets=buckets, seed=seed, epoch=epoch,
              drop_last=drop_last)
    got = list(native.native_batch_iterator(native.TokenArena(ids, labels), **kw))
    _assert_batches_equal(got, list(jnative.native_batch_iterator(
        jnative.TokenArena(ids, labels), **kw)))
    _assert_batches_equal(got, list(sft.batch_iterator(SFTDataset(ids, labels), **kw)))
    assert len(got) == (len(ids) // bs if drop_last else -(-len(ids) // bs))


@pytest.mark.parametrize("indices,seq_len", [
    ([3, 0, 7, 19], 48), ([5, 5, 9], 80), ([9, 22, 1], 8), ([5], 4), ([22, 21, 20, 0, 1], 100),
])
def test_collate_native_on_indices(indices, seq_len):
    """collate_native at arbitrary indices (repeats, the empty example,
    truncation, pads past the longest) equals JAX's collate_native and the
    port's sft.collate."""
    ids, labels = _examples()
    got = native.collate_native(native.TokenArena(ids, labels), np.array(indices), 5, seq_len)
    want = jnative.collate_native(jnative.TokenArena(ids, labels), np.array(indices, np.int64),
                                  5, seq_len)
    _assert_batches_equal([got], [want])
    plain = sft.collate([{"input_ids": ids[i], "labels": labels[i]} for i in indices], 5, seq_len)
    _assert_batches_equal([got], [plain])
    arena = native.TokenArena(ids, labels)
    assert native.max_len(arena, indices) == max(len(ids[i]) for i in indices)


@pytest.mark.parametrize("bad", [-1, 23, 10 ** 9])
def test_index_outside_the_arena_raises(bad):
    arena = native.TokenArena(*_examples())
    with pytest.raises(IndexError):
        native.collate_native(arena, [0, bad], 0, 8)
    with pytest.raises(IndexError):
        native.max_len(arena, [bad, 1])


def test_library_builds_into_build_torch_native():
    """The library is built from csrc/collate.cpp into build/torch_native/
    at the repo's root, under a name hashed over the source and the flags;
    the kernels' nvcc build (csrc/*.cu) leaves the C++ source out."""
    path = native.library_path()
    assert path.parent == native.BUILD_DIR == _build.BUILD_DIR.parent / "torch_native"
    assert path.name.startswith("libsmt_collate_") and path.suffix == ".so"
    native.load()
    assert path.exists()
    assert native.SOURCE.parent == _build.CSRC and native.SOURCE not in _build.sources()


def test_second_load_reuses_the_library(tmp_path, monkeypatch):
    """A first load compiles once; a second process's load (the module's
    library handle dropped) finds the library and compiles nothing."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "_lib", None)
    compiles = []
    real = native._compile
    monkeypatch.setattr(native, "_compile", lambda out: (compiles.append(out), real(out)))
    native.load()
    built = native.library_path()
    stamp = built.stat().st_mtime_ns
    monkeypatch.setattr(native, "_lib", None)
    native.load()
    assert compiles == [built] and built.stat().st_mtime_ns == stamp
    assert sorted(p.name for p in tmp_path.iterdir()) == [".lock", built.name]


@pytest.mark.parametrize("patch,named", [
    (dict(CXX_FLAGS=native.CXX_FLAGS + ("-fno-such-flag-in-any-gcc",)),
     "-fno-such-flag-in-any-gcc"),
    (dict(CXX="no-such-compiler-on-the-path"), "no-such-compiler-on-the-path"),
])
def test_failed_build_raises(patch, named, tmp_path, monkeypatch):
    """A build that fails raises RuntimeError naming the compiler's output
    (no numpy fallback), and leaves no library behind; so does fit."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "_lib", None)
    for name, value in patch.items():
        monkeypatch.setattr(native, name, value)
    with pytest.raises(RuntimeError, match="collator's build failed") as err:
        native.load()
    assert named in str(err.value)
    assert not list(tmp_path.glob("*.so")) and not list(tmp_path.glob("*.tmp"))
    ds = _datasets()
    with pytest.raises(RuntimeError, match="collator's build failed"):
        _fresh().fit(ds, ds.subset([0]), pad_token_id=0)


# ---------------------------------------------------------------------------
# the prefetcher (as tests/test_round2_fixes.py holds JAX's)
# ---------------------------------------------------------------------------

def test_prefetch_loader_early_abandon_leaks_no_thread():
    def factory():
        i = 0
        while True:   # an endless producer
            yield {"i": np.full((4,), i)}
            i += 1

    n_before = threading.active_count()
    loader = native.PrefetchLoader(factory, depth=2)
    it = iter(loader)
    assert next(it)["i"][0] == 0 and next(it)["i"][0] == 1
    it.close()   # the consumer breaks off (fit's break, an exception)
    loader._thread.join(timeout=5)
    assert not loader._thread.is_alive()
    assert threading.active_count() <= n_before


def test_prefetch_loader_full_iteration_and_error():
    items = [{"i": np.full((2,), k)} for k in range(5)]
    assert [b["i"][0] for b in native.PrefetchLoader(lambda: iter(items), depth=2)] == \
        [0, 1, 2, 3, 4]

    def bad():
        yield items[0]
        raise RuntimeError("boom")

    loader = native.PrefetchLoader(bad, depth=2)
    with pytest.raises(RuntimeError, match="boom"):
        list(loader)
    assert not loader._thread.is_alive()


def test_prefetch_loader_keeps_the_collators_order():
    arena = native.TokenArena(*_examples())
    kw = dict(batch_size=4, pad_token_id=0, buckets=[64], seed=0, epoch=0)
    _assert_batches_equal(
        list(native.PrefetchLoader(lambda: native.native_batch_iterator(arena, **kw))),
        list(native.native_batch_iterator(arena, **kw)))


# ---------------------------------------------------------------------------
# fit
# ---------------------------------------------------------------------------

def _cfg(**kw):
    base = dict(data_path=["x.json"], model_name_or_path="tiny", dtype="fp32",
                matrix_sparsity=True, full_ft_steps=2, downsample_attention_blocks_ratio=0.05,
                downsample_mlp_blocks_ratio=0.05, ft_learning_rate=1e-3, smt_lr=1e-2,
                lr_scheduler_type="constant", eval_step=0, save_steps=0,
                gradient_checkpointing=False, max_seq_len=32, seq_buckets=[16, 32], seed=0,
                per_device_ft_batch_size=2, per_device_eval_batch_size=2)
    base.update(kw)
    return base


def _fresh(total=8, **kw):
    return SMTTrainer(SMTConfig(**_cfg(**kw)), CFG, llama.init_params(CFG, seed=0),
                      total_steps=total)


def _datasets(cls=SFTDataset, n=10):
    """Examples of 6..40 tokens (the 16 and 32 buckets; truncation at 32),
    the first third of each label masked."""
    rng = np.random.default_rng(4)
    ids, labels = [], []
    for _ in range(n):
        a = rng.integers(3, 256, int(rng.integers(6, 41))).astype(np.int32)
        b = a.copy()
        b[: len(a) // 3] = -100
        ids.append(a)
        labels.append(b)
    return cls(ids, labels)


def test_fit_trains_from_the_prefetcher_and_evaluates_from_batch_iterator(monkeypatch):
    """A spy on native.PrefetchLoader and on sft.batch_iterator: every
    training batch fit steps on is one the prefetcher yielded (the C++
    collator's, in order: equal to batch_iterator's at the same seed), and
    batch_iterator is called for the eval set alone (unshuffled, not
    dropping the last batch), as JAX's fit does."""
    yielded, stepped, calls = [], [], []

    class Spy(native.PrefetchLoader):
        def __iter__(self):
            for b in super().__iter__():
                yielded.append(b)
                yield b

    real_bi = sft.batch_iterator

    def spy_bi(dataset, *args, **kw):
        calls.append((dataset, kw))
        return real_bi(dataset, *args, **kw)

    monkeypatch.setattr(native, "PrefetchLoader", Spy)
    monkeypatch.setattr(sft, "batch_iterator", spy_bi)
    train, ev = _datasets(), _datasets(n=3)
    t = _fresh(total=10, num_ft_epochs=2)
    step_of = t.train_step
    t.train_step = lambda b: (stepped.append(b), step_of(b))[1]
    t.fit(train, ev, pad_token_id=0)
    assert len(stepped) == t.step == 10 and all(s is y for s, y in zip(stepped, yielded))
    want = [b for e in range(2) for b in real_bi(train, 2, 0, [16, 32], 0, e)]
    _assert_batches_equal(stepped, want)
    assert calls and all(d is ev and kw == dict(shuffle=False, drop_last=False)
                         for d, kw in calls)


def test_fit_matches_jax_fit():
    """Two epochs of 5 steps (2 warm-up, 8 sparse; the 16 and 32 buckets)
    through the port's fit and JAX's SMTTrainer.fit from the same weights:
    losses and the eval loss within 1e-4, the same plan fingerprint."""
    jcfg = jllama.LlamaConfig.tiny(vocab_size=256)
    jparams = jllama.init_params(jax.random.PRNGKey(0), jcfg)
    pparams = tp.port_params(jparams)   # before the JAX trainer donates them
    kw = _cfg(num_ft_epochs=2)
    jt = JaxSMTTrainer(JaxSMTConfig(**kw), jcfg, jparams, total_steps=10)
    jds = _datasets(JaxSFTDataset)
    hist_j = jt.fit(jds, jds.subset([0, 1, 2]), pad_token_id=0)
    pt = SMTTrainer(SMTConfig(**kw), CFG, pparams, total_steps=10)
    ds = _datasets()
    hist_p = pt.fit(ds, ds.subset([0, 1, 2]), pad_token_id=0)
    assert len(hist_p["train_loss"]) == 10 and pt.phase == "sparse"
    np.testing.assert_allclose(hist_p["train_loss"], hist_j["train_loss"], rtol=LOSS_RTOL,
                               atol=0)
    np.testing.assert_allclose(hist_p["eval_loss"], hist_j["eval_loss"], rtol=LOSS_RTOL)
    assert pt.plan.fingerprint() == jt.plan.fingerprint()


class _Stop(Exception):
    pass


def test_fit_resumed_mid_epoch_matches_the_straight_run(tmp_path):
    """A run stopped after step 3 (a checkpoint at save_steps 3, mid the
    first 5-step epoch; the next step's exception breaks off fit and its
    prefetch thread), restored into a fresh trainer whose fit skips the 3
    batches already consumed: losses and every state leaf bit for bit the
    straight run's."""
    kw = dict(num_ft_epochs=2, total=10)
    straight = _fresh(**kw)
    hist = straight.fit(_datasets(), _datasets(n=3), pad_token_id=0)

    part = _fresh(output_dir=str(tmp_path / "part"), save_steps=3, **kw)
    n_threads = threading.active_count()

    def stop_after_3(step, metrics):
        if step == 4:
            raise _Stop

    with pytest.raises(_Stop):
        part.fit(_datasets(), _datasets(n=3), pad_token_id=0, on_metrics=stop_after_3)
    assert threading.active_count() <= n_threads
    resumed = _fresh(**kw)
    restore_checkpoint(str(tmp_path / "part" / "ckpt"), resumed)
    assert resumed.step == 3
    rest = resumed.fit(_datasets(), _datasets(n=3), pad_token_id=0)
    assert rest["train_loss"] == hist["train_loss"][3:]
    assert rest["eval_loss"] == hist["eval_loss"]
    a, b = (llama.flatten_tree({k: v for k, v in t.state.items() if k != "sched"})
            for t in (resumed, straight))
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert resumed.plan.fingerprint() == straight.plan.fingerprint()
