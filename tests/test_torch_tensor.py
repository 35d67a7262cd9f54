"""The tensor axis (`--mesh_shape D,F,T`, T > 1; parallel/tensor.py) without
a spawn: the layout against JAX's state_shardings leaf for leaf, the rank
order against JAX's make_mesh, block statistics, the block scatter and the
sliced block grads where 256-blocks straddle tensor (and fsdp) shards, the
vocabulary-parallel cross-entropy (full and chunked, fp32 and fp16) over T
ranks run as threads (the tensor group's all-reduce replaced by one over
the threads) against one process, the HF load's two-dim slices, the
refusals; and the chunked loss's grad_hidden against jax.grad of the JAX
twin (summed in the hidden dtype, chunks in reverse). The spawned runs are
tests/test_torch_tensor_meshes.py.
"""
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as tp
from test_cli import tiny_hf_dir  # noqa: F401
from test_torch_fsdp import _state_of_shapes
from test_torch_parallel import MODEL, _cfg

from sparse_matrix_tuning_tpu.parallel.mesh import make_mesh as jax_make_mesh
from sparse_matrix_tuning_tpu_torch.parallel.mesh import Mesh, axis_groups, rank_rows

MESHES = [(1, 1, 2), (1, 2, 2), (1, 4, 2), (1, 2, 4), (2, 2, 2)]


def _jax_dims(state, shape, mode):
    """{path: (fsdp dim, tensor dim)} of JAX's state_shardings, None for an
    axis of one device (which splits nothing)."""
    from sparse_matrix_tuning_tpu.parallel.mesh import state_shardings
    n = int(np.prod(shape))
    sh = state_shardings(state, jax_make_mesh(shape, jax.devices()[:n]), mode)
    out = {}
    for path, s in jax.tree_util.tree_flatten_with_path(sh)[0]:
        def dim(axis, size):
            ds = [i for i, a in enumerate(s.spec)
                  if a == axis or (isinstance(a, tuple) and axis in a)]
            return ds[0] if ds and size > 1 else None
        out["/".join(p.key for p in path)] = (dim("fsdp", shape[1]), dim("tensor", shape[2]))
    return out


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: "".join(map(str, s)))
@pytest.mark.parametrize("mode", ["matrix", "channel"])
@pytest.mark.parametrize("dims", [(256, 512, 256, False), (2048, 5632, 32000, True)],
                         ids=["tiny", "tinyllama"])
def test_two_axis_dims_are_jax_state_shardings(shape, mode, dims):
    """Sharding.split_dims (shard_dim, tensor_dim) of every leaf of the
    warm-up and sparse states equals the (fsdp, tensor) dims of JAX's
    state_shardings (its PartitionSpecs and _fit) on the same mesh, at the
    tiny widths (k/v's 128 rows over T 4: 32 a rank) and TinyLlama's."""
    from sparse_matrix_tuning_tpu_torch.parallel.fsdp import Sharding
    d, ff, v, acc_blocks = dims
    sh = Sharding(Mesh(shape, 0, torch.device("cpu")))
    for state in _state_of_shapes(mode, d=d, f=ff, v=v, acc_blocks=acc_blocks):
        want = _jax_dims(state, shape, mode)
        got = {"/".join(p.key for p in path): sh.split_dims(
                   "/".join(p.key for p in path), leaf.shape, mode)
               for path, leaf in jax.tree_util.tree_flatten_with_path(state)[0]}
        assert got == want
        assert any(t is not None for _, t in got.values())


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: "".join(map(str, s)))
def test_rank_order_is_jax_make_mesh(shape):
    """Rank r sits where JAX's make_mesh puts device r: (data, fsdp,
    tensor) index = unravel(r, shape); each axis group is the devices of
    JAX's mesh along that axis; a tensor group shares its batch rows (JAX
    splits the batch over data and fsdp only)."""
    n = int(np.prod(shape))
    devices = jax_make_mesh(shape, jax.devices()[:n]).devices
    ids = np.vectorize(lambda dev: dev.id)(devices)
    base = min(dev.id for dev in jax.devices()[:n])
    groups = axis_groups(shape)
    rows = np.arange(2 * shape[0] * shape[1])[:, None] * np.ones((1, 3), np.int64)
    for r in range(n):
        m = Mesh(shape, r, torch.device("cpu"))
        idx = (m.data_index, m.fsdp_index, m.tensor_index)
        assert ids[idx] - base == r and idx == np.unravel_index(r, shape)
        d, f, t = idx
        want = {"data": ids[:, f, t], "fsdp": ids[d, :, t], "tensor": ids[d, f, :],
                "batch": ids[:, :, t].reshape(-1)}
        for axis, members in groups.items():
            mine = [g for g in members if r in g]
            assert len(mine) == 1 and mine[0] == [int(i) - base for i in want[axis]], axis
        got = rank_rows({"x": rows}, m)["x"][:, 0]
        assert got.tolist() == [2 * m.batch_index, 2 * m.batch_index + 1]


def _slices(full, f, fdim, t, tdim):
    """The (f, t) slices of a full tensor split over fsdp on fdim and tensor
    on tdim, with their first rows and columns."""
    out = []
    for i in range(f):
        for j in range(t):
            s, first = full, [0, 0]
            for dim, k, parts in ((fdim, i, f), (tdim, j, t)):
                n = full.shape[dim] // parts
                s = s.narrow(dim, k * n, n)
                first[dim] = k * n
            out.append((s.contiguous(), tuple(first)))
    return out


SPLITS = [(2, 1, 2, 0), (1, 0, 2, 1), (3, 0, 2, 1), (2, 0, 4, 1), (4, 1, 3, 0)]


@pytest.mark.parametrize("f,fdim,t,tdim", SPLITS)
@pytest.mark.parametrize("strategy", ["mean_abs", "L2"])
def test_block_stats_from_two_axis_slices(f, fdim, t, tdim, strategy):
    """The partial sums of every (fsdp, tensor) slice of a 768 x 768
    tensor, where 384- or 256-wide shards (and 192 at T 4) cut the
    256-blocks on both dims, combined, then finished, equal block_stats of
    the whole tensor."""
    from sparse_matrix_tuning_tpu_torch.parallel.fsdp import (
        PARTIAL_KIND, block_partials, finish_block_stat)
    from sparse_matrix_tuning_tpu_torch.smt.select import block_stats
    full = torch.from_numpy(tp.seeded_normal((768, 768), 7 + f + t))
    total = 0
    for s, (r0, c0) in _slices(full, f, fdim, t, tdim):
        total = total + block_partials(s, (r0, s.shape[0]), (c0, s.shape[1]), full.shape,
                                          PARTIAL_KIND[strategy])
    np.testing.assert_allclose(finish_block_stat(total, strategy).numpy(),
                               block_stats(full, strategy).numpy(), rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("f,fdim,t,tdim", SPLITS)
def test_scatter_into_two_axis_slices(f, fdim, t, tdim):
    """plan.scatter over a Sharding's two-axis slices equals the slice of
    the scatter over the whole weight bit for bit, where both kinds of
    shard cut through the blocks and blocks lie in other ranks' slices."""
    from sparse_matrix_tuning_tpu_torch.parallel.fsdp import block_window, write_blocks
    from sparse_matrix_tuning_tpu_torch.smt.plan import LinearPlan, SMTPlan
    w = torch.from_numpy(tp.seeded_normal((768, 768), 3)).to(torch.bfloat16)
    lp = LinearPlan("q_proj", 0, 768, 768, blocks=((2, 1), (0, 0), (1, 2), (2, 2), (1, 0)))
    blocks = torch.from_numpy(tp.seeded_normal((5, 256, 256), 11))
    want = w.clone()
    SMTPlan("matrix", {"0.q_proj": lp}).scatter({"0": {"q_proj": want}}, {"0.q_proj": blocks})
    rb, cb = lp.row_blocks().astype(np.int64), lp.col_blocks().astype(np.int64)
    for (s, first), (goal, _) in zip(_slices(w, f, fdim, t, tdim),
                                     _slices(want, f, fdim, t, tdim)):
        rows, cols = (first[0], s.shape[0]), (first[1], s.shape[1])
        win = block_window(rb, cb, rows, cols, "cpu")
        write_blocks(s, first, blocks, win)
        assert torch.equal(s, goal), first


@pytest.mark.parametrize("module,t", [("q_proj", 2), ("q_proj", 3), ("down_proj", 2),
                                      ("down_proj", 4)])
def test_slice_block_grads_sum_to_the_blocks(module, t):
    """smt_linear on each tensor rank's slice of a 768-wide weight
    (a column-parallel module's output rows, a row-parallel one's input
    columns; 384, 256 or 192 wide, so blocks straddle the slices): the
    outputs concatenate (or sum) to smt_linear's, and the ranks' block
    grads sum to its block grads (fp32, 1e-5), each rank's zero for the
    blocks it does not touch."""
    from sparse_matrix_tuning_tpu_torch.ops.sparse_linear import smt_linear
    from sparse_matrix_tuning_tpu_torch.smt.plan import LinearPlan, SMTPlan
    lp = LinearPlan(module, 0, 768, 768, blocks=((2, 1), (0, 0), (1, 2), (2, 2), (1, 0)))
    plan = SMTPlan("matrix", {"0.q": lp})
    w = torch.from_numpy(tp.seeded_normal((768, 768), 5, 0.05))
    x = torch.from_numpy(tp.seeded_normal((3, 10, 768), 6))
    g = torch.from_numpy(tp.seeded_normal((3, 10, 768), 8))
    blocks = torch.zeros((5, 256, 256), requires_grad=True)
    xf = x.clone().requires_grad_(True)
    y = smt_linear(xf, blocks, w, lp)
    (y * g).sum().backward()
    col = module == "q_proj"
    total, outs, grad_x = 0, [], []
    for i in range(t):
        window, first = tensor = plan.tensor_window("0.q", "cpu", i, t)
        ws = w.chunk(t, 0 if col else 1)[i]
        xi = (x if col else x.chunk(t, -1)[i]).clone().requires_grad_(True)
        bi = torch.zeros((5, 256, 256), requires_grad=True)
        yi = smt_linear(xi, bi, ws, lp, tensor=tensor)
        (yi * (g.chunk(t, -1)[i] if col else g)).sum().backward()
        outs.append(yi.detach())
        grad_x.append(xi.grad)
        total = total + bi.grad
        touched = set(window[0].tolist()) if window is not None else set()
        assert all(not bi.grad[j].any() for j in range(5) if j not in touched)
    # column-parallel: outputs concatenate, grad_x sums; row-parallel: the reverse
    torch.testing.assert_close(torch.cat(outs, -1) if col else sum(outs), y.detach(),
                               rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(sum(grad_x) if col else torch.cat(grad_x, -1), xf.grad,
                               rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(total, blocks.grad, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# ranks as threads; the vocabulary-parallel cross-entropy
# ---------------------------------------------------------------------------

_RANK = threading.local()   # the global rank of the thread running it


class _Groups:
    """torch.distributed's collectives over the threads of a (D, F, T)
    world, one a rank: a group is named by the tuple of its ranks (None:
    the world). all_reduce stacks the members' values in rank order and
    takes the SUM or MAX; all_gather_object and barrier likewise."""

    def __init__(self, world):
        self.world = tuple(range(world))
        self.lock = threading.Lock()
        self.groups = {}

    def _group(self, group):
        ranks = group or self.world
        with self.lock:
            if ranks not in self.groups:
                self.groups[ranks] = (threading.Barrier(len(ranks), timeout=120), {})
        return ranks, self.groups[ranks]

    def all_reduce(self, x, op=torch.distributed.ReduceOp.SUM, group=None, async_op=False):
        ranks, (barrier, slots) = self._group(group)
        slots[_RANK.r] = x.clone()
        barrier.wait()
        stack = torch.stack([slots[r] for r in ranks])
        out = stack.amax(0) if op == torch.distributed.ReduceOp.MAX else stack.sum(0)
        barrier.wait()
        x.copy_(out)

    def all_gather_object(self, out, value, group=None):
        ranks, (barrier, slots) = self._group(group)
        slots[_RANK.r] = value
        barrier.wait()
        out[:] = [slots[r] for r in ranks]
        barrier.wait()

    def barrier(self, group=None):
        self._group(group)[1][0].wait()

    def abort(self):
        with self.lock:
            for barrier, _ in self.groups.values():
                barrier.abort()


def _thread_mesh(shape, r):
    """Rank r's Mesh of `shape`, its axis groups named by their ranks (as
    parallel/mesh.make_mesh makes them: none for an axis of one rank or of
    the whole world)."""
    mesh = Mesh(tuple(shape), r, torch.device("cpu"))
    world = int(np.prod(shape))
    for axis, members in axis_groups(shape).items():
        if 1 < len(members[0]) < world:
            setattr(mesh, f"{axis}_group", next(tuple(g) for g in members if r in g))
    return mesh


def _on_threads(shape, monkeypatch, fn):
    """fn(mesh) on one thread a rank of a `shape` mesh (an int T: (1, 1,
    T)), with every torch.distributed collective the port calls replaced
    by one over the threads of its group; their results in rank order."""
    shape = (1, 1, shape) if isinstance(shape, int) else tuple(shape)
    world = int(np.prod(shape))
    groups = _Groups(world)
    dist = torch.distributed
    for name, f in (("all_reduce", groups.all_reduce), ("barrier", groups.barrier),
                    ("all_gather_object", groups.all_gather_object),
                    ("get_backend", lambda group=None: "gloo")):
        monkeypatch.setattr(dist, name, f)
    out, errors = [None] * world, []

    def run(r):
        _RANK.r = r
        try:
            out[r] = fn(_thread_mesh(shape, r))
        except BaseException as e:  # reported below, in the test's thread
            errors.append(e)
            groups.abort()

    threads = [threading.Thread(target=run, args=(r,)) for r in range(world)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    if errors:
        raise errors[0]
    return out


def _lm_inputs(dtype, v=384, seed=0):
    rng = np.random.default_rng(seed)
    h = tp.to_torch(rng.standard_normal((2, 17, 64)).astype(np.float32), dtype)
    head = tp.to_torch(rng.standard_normal((v, 64)).astype(np.float32) * 0.2, dtype)
    labels = torch.from_numpy(rng.integers(0, v, (2, 17)))
    labels[1, 9:] = -100
    return h, head, labels


@pytest.mark.parametrize("t", [2, 3])
@pytest.mark.parametrize("dtype", ["fp32", "fp16"])
def test_vocab_parallel_full_loss_matches_one_process(t, dtype, monkeypatch):
    """vocab_parallel_causal_lm_loss over each rank's V/T logits: the loss
    equals causal_lm_loss of the whole logits (fp32, rtol 1e-6), and the
    ranks' logit grads concatenate to its grad, on every rank."""
    from sparse_matrix_tuning_tpu_torch.models.llama import causal_lm_loss
    from sparse_matrix_tuning_tpu_torch.ops.loss import vocab_parallel_causal_lm_loss
    h, head, labels = _lm_inputs(dtype)
    logits = torch.matmul(h, head.t()).float().requires_grad_(True)
    want = causal_lm_loss(logits, labels)
    want.backward()

    def rank(mesh):
        part = logits.detach().chunk(t, -1)[mesh.tensor_index].clone().requires_grad_(True)
        loss = vocab_parallel_causal_lm_loss(part, labels, mesh)
        loss.backward()
        return loss.detach(), part.grad

    got = _on_threads(t, monkeypatch, rank)
    for loss, _ in got:
        np.testing.assert_allclose(loss.item(), want.item(), rtol=1e-6)
    torch.testing.assert_close(torch.cat([g for _, g in got], -1), logits.grad, rtol=1e-5,
                               atol=1e-7)


@pytest.mark.parametrize("t", [2, 3])
@pytest.mark.parametrize("dtype", ["fp32", "fp16"])
def test_vocab_parallel_chunked_loss_matches_one_process(t, dtype, monkeypatch):
    """chunked_causal_lm_loss over each rank's V/T head rows (chunks of 48:
    several a rank, the last shorter), its hidden through to_tensor_region:
    the loss equals one process's (rtol 1e-6), the hidden's grad (each
    rank's part summed over the group) and the head rows' grads equal one
    process's (fp32 1e-5; fp16, where the ranks' parts are summed in fp16,
    as one process sums its chunks, 2e-3 of the largest)."""
    from sparse_matrix_tuning_tpu_torch.ops.loss import chunked_causal_lm_loss
    from sparse_matrix_tuning_tpu_torch.parallel.tensor import to_tensor_region
    h, head, labels = _lm_inputs(dtype)
    hw, headw = h.clone().requires_grad_(True), head.clone().requires_grad_(True)
    want = chunked_causal_lm_loss(hw, headw, labels, 48)
    want.backward()

    def rank(mesh):
        hi = h.clone().requires_grad_(True)
        part = head.chunk(t, 0)[mesh.tensor_index].clone().requires_grad_(True)
        loss = chunked_causal_lm_loss(to_tensor_region(hi, mesh), part, labels, 48, tensor=mesh)
        loss.backward()
        return loss.detach(), hi.grad, part.grad

    got = _on_threads(t, monkeypatch, rank)
    tol = (dict(rtol=1e-5, atol=1e-7) if dtype == "fp32" else
           dict(rtol=0, atol=2e-3 * float(hw.grad.abs().max())))
    for loss, gh, _ in got:
        np.testing.assert_allclose(loss.item(), want.item(), rtol=1e-6)
        torch.testing.assert_close(gh.float(), hw.grad.float(), **tol)
    torch.testing.assert_close(torch.cat([g for _, _, g in got]).float(), headw.grad.float(),
                               **(dict(rtol=1e-5, atol=1e-7) if dtype == "fp32" else
                                  dict(rtol=1e-2, atol=1e-3)))


# ---------------------------------------------------------------------------
# the chunked loss's grad_hidden against JAX's (fp16 / bf16)
# ---------------------------------------------------------------------------

def _jax_and_port_grad_h(h, w, labels, dtype, chunk):
    from sparse_matrix_tuning_tpu.ops.loss import chunked_causal_lm_loss as jax_loss
    from sparse_matrix_tuning_tpu_torch.ops.loss import chunked_causal_lm_loss
    jdt = tp.JAX_DTYPES[dtype]
    want = tp.np32(jax.grad(lambda a: jax_loss(a, jnp.asarray(w, jdt), jnp.asarray(labels),
                                               chunk))(jnp.asarray(h, jdt)))
    ht = tp.to_torch(h, dtype).requires_grad_(True)
    chunked_causal_lm_loss(ht, tp.to_torch(w, dtype), torch.from_numpy(labels), chunk).backward()
    return tp.np32(ht.grad), want


def _inputs(exact, seed=0, v=1000):
    rng = np.random.default_rng(seed)
    if exact:  # every logit a multiple of 1/32 below 4: exact in fp16 and bf16
        h = (rng.integers(-1, 2, (2, 33, 64)) / 4).astype(np.float32)
        w = (rng.integers(-1, 2, (v, 64)) / 8).astype(np.float32)
    else:
        h = rng.standard_normal((2, 33, 64)).astype(np.float32)
        w = (rng.standard_normal((v, 64)) * 0.3).astype(np.float32)
    labels = rng.integers(0, v, (2, 33))
    labels[0, 20:] = -100
    return h, w, labels


@pytest.mark.parametrize("dtype", ["fp16", "bf16"])
def test_chunked_grad_hidden_is_summed_as_jax_sums_it(dtype):
    """At a chunked vocabulary (1,000 over chunks of 128: 8 chunks, the last
    padded by JAX and shorter here) the port's grad_hidden equals jax.grad
    of the JAX chunked loss: the sum is carried in the hidden dtype over the
    chunks in reverse, each chunk's fp32 term cast first, as JAX's scan
    transpose carries it. With logits exact in the dtype (so that the
    forward's rounding is out of the question) >= 99.9% of the entries
    are equal bit for bit and the rest one unit in the last place apart
    (measured: fp16 99.93%, bf16 99.98%); an fp32 sum cast once, as the
    port summed before, left ~60% equal and entries ~30 units apart."""
    g, want = _jax_and_port_grad_h(*_inputs(exact=True), dtype, 128)
    assert (g == want).mean() >= 0.999, (g == want).mean()
    mantissa, emin = (10, -14) if dtype == "fp16" else (7, -126)
    exp = np.maximum(np.floor(np.log2(np.maximum(np.abs(want), 2.0 ** emin))), emin)
    assert np.all(np.abs(g - want) <= 2.0 ** (exp - mantissa))


@pytest.mark.parametrize("dtype", ["fp16", "bf16"])
def test_chunked_loss_logits_rounding_gap(dtype):
    """The difference that stays by design: the port's chunk logits come
    from a matmul in the hidden dtype, rounded to it, where JAX's dot asks
    for fp32 (preferred_element_type). On random inputs that moves
    grad_hidden by at most 2^-7 (fp16) or 2^-4 (bf16) of its largest entry
    (measured: 1.9e-5 and 1.8e-4 against grads of ~1e-2; ROADMAP,
    "Differences by design")."""
    g, want = _jax_and_port_grad_h(*_inputs(exact=False), dtype, 128)
    bound = (2.0 ** -7 if dtype == "fp16" else 2.0 ** -4) * np.abs(want).max()
    assert np.abs(g - want).max() <= bound


# ---------------------------------------------------------------------------
# the HF load's two-dim slices, the refusals
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(1, 1, 2), (1, 2, 2), (1, 4, 2)],
                         ids=lambda s: "".join(map(str, s)))
def test_sharded_load_reads_two_dim_blocks(shape, tiny_hf_dir):  # noqa: F811
    """Each rank's load_hf_params_sharded equals its (fsdp, tensor) block of
    load_hf_params' tensors bit for bit, and the JAX package's sharded load
    on the same mesh shard for shard."""
    from sparse_matrix_tuning_tpu.models.hf_io import (
        load_hf_params_sharded as jax_load_sharded)
    from sparse_matrix_tuning_tpu_torch.models.hf_io import (
        load_hf_config, load_hf_params, load_hf_params_sharded)
    from sparse_matrix_tuning_tpu_torch.models.llama import flatten_tree
    cfg = load_hf_config(tiny_hf_dir)
    full = flatten_tree(load_hf_params(tiny_hf_dir, cfg, dtype=torch.float32))
    n = int(np.prod(shape))
    jmesh = jax_make_mesh(shape, jax.devices()[:n])
    jax_flat = {"/".join(p.key for p in path): a for path, a in
                jax.tree_util.tree_flatten_with_path(
                    jax_load_sharded(tiny_hf_dir, jmesh, None, dtype=np.float32))[0]}
    both = 0
    for r in range(n):
        mesh = Mesh(shape, r, torch.device("cpu"))
        params, sh = load_hf_params_sharded(tiny_hf_dir, mesh, cfg, dtype=torch.float32)
        device = jmesh.devices[np.unravel_index(r, shape)]
        for k, t in flatten_tree(params).items():
            assert torch.equal(t, sh.local(f"master/{k}", full[k])), k
            shard = [s for s in jax_flat[k].addressable_shards if s.device == device][0]
            np.testing.assert_array_equal(t.numpy(), np.asarray(shard.data), err_msg=k)
            both += f"master/{k}" in sh.dims and f"master/{k}" in sh.tdims
    assert both > 0 or shape[1] == 1


REFUSED = {
    "frozen_quant int8": (dict(frozen_quant="int8"), None),
    "head_quant int8": (dict(head_quant="int8"), None),
    "channel": (dict(channel_sparsity=True, matrix_sparsity=False), None),
    "scan_layers on": (dict(scan_layers="on"), None),
    "scan_layers on int8": (dict(scan_layers="on", frozen_quant="int8"), None),
    "dropout": (dict(dropout=0.1), None),
    "sparse_from_plan": (dict(sparse_from_plan="plan.json"), "--sparse_from_plan"),
}


@pytest.mark.parametrize("name", list(REFUSED))
def test_config_refuses_what_tensor_does_not_run(name):
    """Each option the tensor axis does not run raises NotImplementedError
    naming the flag and the mesh; the same config without it builds. The
    int8 base and head, the scan layout over either base, channel mode and
    dropout (flag None) build."""
    from sparse_matrix_tuning_tpu_torch.config import SMTConfig
    kw, flag = REFUSED[name]
    if flag is None:
        assert SMTConfig(**{**_cfg(), **kw, "mesh_shape": [1, 2, 2]}).mesh_shape == [1, 2, 2]
    else:
        with pytest.raises(NotImplementedError, match=rf"\(1, 2, 2\).*{flag}.*tensor 2"):
            SMTConfig(**{**_cfg(), **kw, "mesh_shape": [1, 2, 2]})
    assert SMTConfig(**{**_cfg(), "mesh_shape": [1, 2, 2]}).mesh_shape == [1, 2, 2]


@pytest.mark.parametrize("change,match", [
    (dict(num_key_value_heads=1), None),
    (dict(num_attention_heads=1, num_key_value_heads=1), None),
    (dict(intermediate_size=769), "intermediate_size 769"),
    (dict(vocab_size=255), "vocab_size 255"),
    (dict(tie_word_embeddings=True), None),
    ("bias", None),
], ids=["hkv", "hq-hkv", "intermediate", "vocab", "tied", "bias"])
def test_trainer_refuses_models_tensor_does_not_split(change, match, monkeypatch):
    """A model whose intermediate width or vocabulary T does not divide (a
    leaf dim JAX keeps whole) raises NotImplementedError by name when the
    trainer is built on a tensor mesh (before any collective). Head counts
    that T cuts (one kv head; one head of 256 for q and kv), a tied head
    and q/k/v biases (match None) build and take a warm-up step on two
    thread ranks at (1, 1, 2), their losses equal (tests/test_torch_tensor_
    qwen.py holds the tied and biased ones to one process, tests/test_torch_
    tensor_cut_heads.py the cut heads)."""
    from sparse_matrix_tuning_tpu_torch.config import SMTConfig
    from sparse_matrix_tuning_tpu_torch.models.llama import LlamaConfig, init_params
    from sparse_matrix_tuning_tpu_torch.train.trainer import SMTTrainer
    from test_torch_parallel import batches
    model = LlamaConfig(**{**MODEL, "num_attention_heads": 4, "num_key_value_heads": 2})
    params = init_params(model, seed=0)
    if change == "bias":
        params["layers"]["0"]["q_proj_bias"] = torch.linspace(-1, 1, 256)
    else:
        model = LlamaConfig(**{**MODEL, **change})
        params = init_params(model, seed=0)
    cfg = SMTConfig(**_cfg(), mesh_shape=[1, 1, 2])
    if match is not None:
        mesh = Mesh((1, 1, 2), 0, torch.device("cpu"))
        with pytest.raises(NotImplementedError, match=match):
            SMTTrainer(cfg, model, params, 4, device="cpu", mesh=mesh)
        return

    def rank(mesh):
        trainer = SMTTrainer(cfg, model, params, 4, device="cpu", mesh=mesh)
        return float(trainer.train_step(batches(1)[0])["loss"])

    losses = _on_threads(2, monkeypatch, rank)
    assert np.isfinite(losses[0]) and losses[0] == losses[1]


def _k4_calls_on_threads(cfg, model, monkeypatch):
    """A (1, 1, 2) trainer on each of two thread ranks through its
    conversion and one sparse step (parallel/tensor's and torch.
    distributed's collectives over the threads): each rank's calls of K4's
    wrappers (ops/quant's q8mm_t / q8mm_g) and K5's (ops/sparse_linear's
    block_correction), their plain versions on the CPU, in that step, the
    state's int8 leaves, the step's loss and whether it ran over the scan
    state."""
    from sparse_matrix_tuning_tpu_torch.config import SMTConfig
    from sparse_matrix_tuning_tpu_torch.models.llama import init_params
    from sparse_matrix_tuning_tpu_torch.ops import quant, sparse_linear
    from sparse_matrix_tuning_tpu_torch.train.trainer import SMTTrainer
    from test_torch_parallel import batches
    calls = [{"q8mm_t": 0, "q8mm_g": 0, "block_correction": 0} for _ in range(2)]
    for mod, name in ((quant, "q8mm_t"), (quant, "q8mm_g"), (sparse_linear, "block_correction")):
        def counted(*a, _f=getattr(mod, name), _n=name, **kw):
            calls[_RANK.r][_n] += 1
            return _f(*a, **kw)
        monkeypatch.setattr(mod, name, counted)
    bs = batches(cfg["full_ft_steps"] + 1)

    def rank(mesh):
        trainer = SMTTrainer(SMTConfig(**cfg), model, init_params(model, seed=0),
                             len(bs), device="cpu", mesh=mesh)
        for b in bs[:-1]:
            trainer.train_step(b)
        before = dict(calls[mesh.tensor_index])
        loss = float(trainer.train_step(bs[-1])["loss"])
        return ({k: calls[mesh.tensor_index][k] - before[k] for k in before},
                sorted(k for k in ("q", "q_head") if k in trainer.state), loss, trainer._scan)

    return _on_threads(2, monkeypatch, rank)


@pytest.mark.parametrize("name", list(REFUSED))
def test_trainer_refuses_what_tensor_does_not_run(name, monkeypatch):
    """A config that names no mesh_shape, handed to the trainer with a
    tensor mesh built in code, meets the same refusals by name (before
    any collective). The int8 base and head, the scan layout and channel
    mode (flag None) build and train: on two thread ranks at (1, 1, 2) the
    sparse step calls K4 on every rank, the base's forward and grad_input
    forms and K5 on the planned linears under --frozen_quant int8, the
    head's K4 under --head_quant int8 (over the dense base in the
    per-layer layout: no K5); over the scan state (--scan_layers on) K5
    on the planned linears over either base (smt_linear_dyn), K4 only over
    the int8 one; channel mode per layer and dropout neither K4 nor K5; and
    the ranks' losses agree."""
    from sparse_matrix_tuning_tpu_torch.config import SMTConfig
    from sparse_matrix_tuning_tpu_torch.models.llama import LlamaConfig, init_params
    from sparse_matrix_tuning_tpu_torch.train.trainer import SMTTrainer
    kw, flag = REFUSED[name]
    # the CLI sets the model's attention dropout from --dropout
    model = LlamaConfig(**{**MODEL, "num_attention_heads": 4, "num_key_value_heads": 2,
                           "attention_dropout": kw.get("dropout", 0.0)})
    cfg = SMTConfig(**{**_cfg(), **kw})
    assert cfg.mesh_shape is None
    if flag is None:
        got = _k4_calls_on_threads({**_cfg(), **kw}, model, monkeypatch)
        base, scan = "frozen_quant" in kw, "scan_layers" in kw
        int8 = base or "head_quant" in kw
        for calls, leaves, loss, scanned in got:
            assert (calls["q8mm_t"] > 0 and calls["q8mm_g"] > 0) == int8, calls
            assert (calls["block_correction"] > 0) == (base or scan), calls
            assert leaves == (["q"] if base else []) + (["q_head"] if int8 else [])
            assert loss == got[0][2] and scanned == scan
        return
    mesh = Mesh((1, 1, 2), 0, torch.device("cpu"))
    with pytest.raises(NotImplementedError, match=rf"\(1, 1, 2\).*{flag}.*tensor 2"):
        SMTTrainer(cfg, model, init_params(model, seed=0), 4, device="cpu", mesh=mesh)
