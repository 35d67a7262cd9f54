"""The scan layouts under fsdp at (2, 2, 1) and (1, 4, 1)
(tests/test_torch_fsdp_scan.py holds (1, 2, 1), the checkpoint and
shard_dim, and the checks): --scan_layers on over the fp32 and the int8
base, gloo ranks on the CPU against JAX's SMTTrainer on the same mesh and
the port in one process. At (2, 2, 1) a trainable's grad is reduce-
scattered over the fsdp pair, then summed over the data pair; at (1, 4, 1)
hidden 256 splits into four 64-wide shards, so every 256-block of the
stacked trainables and of a column-parallel weight straddles them."""
import pytest

from test_torch_fsdp_scan import (
    WIDE_MESHES, _id, check_jax_mesh, check_one_process, check_share, scan_runs)

CASES = [(shape, name) for shape, sc in WIDE_MESHES.items() for name in sc]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return scan_runs(tmp_path_factory.mktemp("fsdp_scan_meshes"), WIDE_MESHES)


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_scan_ranks_match_jax_mesh(runs, case):
    check_jax_mesh(runs, case)


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_scan_ranks_match_one_process(runs, case):
    check_one_process(runs, case)


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_scan_rank_holds_its_share(runs, case):
    check_share(runs, case)
