"""The port's multi-device layer (``cmdiad_tpu_torch.parallel``) on CPU ranks.

Ranks are spawned with gloo on the CPU by ``parallel.launch.spawn`` and run
the functions of ``torch_parallel_workers``; the JAX side runs in this
process on ``tests/conftest.py``'s 8-device virtual mesh, on the same
numpy inputs.

* ``sharded_bank_min_dist`` at world 2 and 4: under the exact ``l1`` the
  values and rows of the port's one-rank ``bank_min_dist``; a query equal
  to a row duplicated on several shards takes the lowest shard's row, under
  every metric; ``l1`` equal to the JAX package's ``sharded_bank_min_dist``,
  and ``l2``/``l2_int8`` to its per-shard kernel path (the bf16 and int8
  bank-min kernels interpreted, as on a TPU) on a mesh of the same size;
* ``dp_score_batch`` against the JAX package's, its l2 scoring through the
  bf16 kernel (interpreted) as ``test_torch_slice.py`` routes it, at the
  port's single-device scoring tolerances (``test_torch_ops.py``);
* ``dryrun_multichip(4)`` on a 2 x 2 mesh;
* the refusals: a mesh without a process group names torchrun, a world
  size that is not the mesh's, NCCL with one card for two ranks.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from cmdiad_tpu.parallel.eval import _sharded_min_fn
from cmdiad_tpu.parallel.eval import dp_score_batch as jax_dp_score_batch
from cmdiad_tpu.parallel.eval import sharded_bank_min_dist as jax_sharded_bank_min_dist
from cmdiad_tpu.parallel.mesh import make_mesh as jax_make_mesh
import cmdiad_tpu.ops.scoring as jax_scoring
from cmdiad_tpu_torch.ops.scoring import PAD_VALUE, bank_min_dist
from cmdiad_tpu_torch.parallel import launch, mesh as port_mesh
from cmdiad_tpu_torch.parallel.dryrun import dryrun_multichip

import torch_parallel_workers as workers

torch.set_num_threads(2)

LOCAL_ROWS = 1024     # a shard: the JAX bank-min kernel's tile


def _bank(rng, world, d=64):
    """A bank of ``world`` shards whose row 10 recurs on every later shard
    (rows 10 + s * LOCAL_ROWS), padded on its last shard; queries 7 and 8
    equal row 10 and a row of shard 1."""
    bank = rng.normal(size=(world * LOCAL_ROWS, d)).astype(np.float32)
    for s in range(1, world):
        bank[10 + s * LOCAL_ROWS] = bank[10]
    n_valid = world * LOCAL_ROWS - 40
    bank[n_valid:] = PAD_VALUE
    q = rng.normal(size=(100, d)).astype(np.float32)
    q[7] = bank[10]
    q[8] = bank[LOCAL_ROWS + 3]
    return bank, q, n_valid


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_bank_min_dist(rng, world):
    bank, q, n_valid = _bank(rng, world)
    got = launch.spawn(workers.sharded_min, world, "gloo", ["cpu"] * world,
                       args=(bank, q, ("l1", "l2", "l2_int8"), n_valid))
    for res in got[1:]:                    # every rank holds the same answer
        for m, (v, i) in res.items():
            np.testing.assert_array_equal(v, got[0][m][0])
            np.testing.assert_array_equal(i, got[0][m][1])
    got = got[0]
    # exact metric: the one-rank exact scan, values and rows
    v1, i1 = bank_min_dist(torch.from_numpy(q), torch.from_numpy(bank), "l1", n_valid=n_valid)
    np.testing.assert_array_equal(got["l1"][1], i1.numpy())
    np.testing.assert_array_equal(got["l1"][0], v1.numpy())
    for m, (v, i) in got.items():
        assert i[7] == 10 and v[7] == 0.0, m           # the lowest shard's copy
        assert i[8] == LOCAL_ROWS + 3, m

    mesh = jax_make_mesh((world,), ("data",))
    jv, ji = jax_sharded_bank_min_dist(mesh, jnp.asarray(q), jnp.asarray(bank), "l1")
    np.testing.assert_array_equal(got["l1"][1], np.asarray(ji))
    np.testing.assert_allclose(got["l1"][0], np.asarray(jv), rtol=1e-6)
    for m in ("l2", "l2_int8"):
        with mesh:
            jv, ji = _sharded_min_fn(mesh, False, m, True)(jnp.asarray(q), jnp.asarray(bank))
        np.testing.assert_array_equal(got[m][1], np.asarray(ji))
        np.testing.assert_allclose(got[m][0], np.asarray(jv), rtol=1e-6, atol=1e-6)


@pytest.fixture
def jax_bf16_selection(monkeypatch):
    """The JAX package's l2 scoring through its bf16 bank-min kernel
    (interpreted), as ``test_torch_slice.py`` routes it."""
    monkeypatch.setattr(jax_scoring, "use_scoring_kernel",
                        lambda rows, metric: metric in ("l2", "l2_int8") and rows % 1024 == 0)
    jax.clear_caches()
    yield
    jax.clear_caches()


def test_dp_score_batch_matches_jax(rng, jax_bf16_selection):
    patches = rng.normal(size=(4, 64, 16)).astype(np.float32)
    bank = rng.normal(size=(1024, 16)).astype(np.float32)
    got = launch.spawn(workers.dp_score, 2, "gloo", ["cpu"] * 2,
                       args=(patches, bank, (8, 8), 32))
    js, jm = jax_dp_score_batch(jax_make_mesh((2,), ("data",)), jnp.asarray(patches),
                                jnp.asarray(bank), feat_hw=(8, 8), out_size=32)
    js, jm = np.asarray(js), np.asarray(jm)
    for s, m in got:
        np.testing.assert_allclose(s, js, rtol=1e-5)
        np.testing.assert_allclose(m, jm, rtol=1e-5, atol=1e-5 * float(np.abs(jm).max()))


def test_dryrun_multichip_on_a_two_by_two_mesh():
    out = dryrun_multichip(4, "gloo", ["cpu"] * 4)
    assert np.isfinite(out["loss"]) and out["grad_err"] <= 1e-4


def test_mesh_without_a_process_group_names_torchrun():
    with pytest.raises(RuntimeError, match="torchrun --nproc_per_node 2"):
        port_mesh.make_mesh((2,), "cpu")


def test_init_from_env_without_torchrun_joins_nothing(monkeypatch):
    monkeypatch.delenv("RANK", raising=False)
    assert port_mesh.init_from_env("cpu") == torch.device("cpu")
    assert not torch.distributed.is_initialized()


def test_world_size_mismatch_raises():
    got = launch.spawn(workers.mesh_of, 2, "gloo", ["cpu"] * 2, args=([(3,), (2,), (1, 2)],))
    for bad, good, two_d in got:
        assert "needs 3 ranks, but the process group has 2" in bad, bad
        assert good == two_d == 2


@pytest.mark.parametrize("devices", [["cuda:0", "cuda:0"], ["cuda", "cuda:0"], ["cpu", "cpu"]])
def test_nccl_refuses_two_ranks_on_one_card(devices):
    with pytest.raises(ValueError, match="NCCL"):
        launch.spawn(workers.mesh_of, 2, "nccl", devices, args=([(2,)],))


def test_mesh_blocks_pad_as_the_jax_package():
    """Batch blocks pad with copies of sample 0, bank blocks with PAD_VALUE
    rows to a multiple of the bank-min kernels' 64-row tile, in rank order;
    a 2-D mesh's 'model' ranks share their data block."""
    x = np.arange(5 * 2).reshape(5, 2)
    blocks = [port_mesh.shard_batch(x, port_mesh.Mesh((2,), r, torch.device("cpu")))
              for r in range(2)]
    assert [b[1] for b in blocks] == [5, 5]
    np.testing.assert_array_equal(np.concatenate([b[0] for b in blocks]),
                                  np.concatenate([x, x[:1]]))
    m22 = [port_mesh.Mesh((2, 2), r, torch.device("cpu")) for r in range(4)]
    got = [port_mesh.shard_batch(x[:4], m, 2)[0] for m in m22]
    np.testing.assert_array_equal(got[0], got[1])
    np.testing.assert_array_equal(got[2], x[2:4])
    bank = torch.ones(100, 3)
    shards = [port_mesh.shard_rows(bank, port_mesh.Mesh((2,), r, torch.device("cpu")))
              for r in range(2)]
    assert [s.shape[0] for s in shards] == [64, 64]
    assert float(shards[1][36:].min()) == PAD_VALUE and float(shards[1][:36].max()) == 1.0
