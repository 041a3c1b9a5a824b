"""The mesh module of mit_tpu_torch (``parallel/mesh.py``) against
``mit_tpu.parallel.mesh`` on the CPU, and the dropout kernels' cell map.

- ``create_mesh`` gives JAX's shapes and raises JAX's errors over the
  conftest's 8 virtual devices (8 CPU devices on the port's side).
- The spec rules are JAX's, leaf for leaf, and their trees are the port's
  parameter trees.
- Sharding a tree in gloo ranks and gathering it back gives the tree bit
  for bit; batches split into each data rank's rows.
- Under the cell map (b_offset, h_total, h_offset) the plain keep-mask of
  a rank equals its slice of the global mask and JAX's ``_keep_mask`` at
  the global cell, bit for bit, and the plain dropout attention forward
  and backward of a rank equal their slices of the global call.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec

from mit_tpu.models import decoder as jdec
from mit_tpu.ops.pallas_dropout_attention import _keep_mask
from mit_tpu.parallel import mesh as jmesh
from mit_tpu_torch.models import decoder as tdec
from mit_tpu_torch.models import model as tmodel
from mit_tpu_torch.models import vision as tvis
from mit_tpu_torch.ops import dropout_attention as da
from mit_tpu_torch.parallel import mesh as pmesh
from mit_tpu_torch.train import steps as tsteps

DEC = dict(vocab_size=64, embed_dim=32, num_heads=8, num_layers=2, ff_dim=64,
           max_seq_len=12, dropout=0.0, pad_idx=0)
VIS = dict(family="vit", image_size=32, patch_size=16, hidden_size=48,
           num_layers=1, num_heads=8, intermediate_size=64, hidden_act="gelu",
           layer_norm_eps=1e-12, patch_bias=True, ln_pre=False, ln_post=True)
CPUS = [torch.device("cpu")] * 8


@pytest.mark.parametrize("shape", [(-1, 1), (4, 2), (2, -1), (8, 1), (1, 8),
                                   (-1, 4), (1, -1)])
def test_create_mesh_shapes_match_jax(shape):
    ours = pmesh.create_mesh(shape, CPUS)
    want = jmesh.create_mesh(shape)
    assert ours.devices.shape == want.devices.shape
    assert ours.shape == dict(want.shape)
    assert not ours.distributed and ours.size == 8


@pytest.mark.parametrize("shape", [(3, 2), (-1, -1), (5, 1), (1, 3), (16, 1)])
def test_create_mesh_errors_match_jax(shape):
    with pytest.raises(ValueError) as jerr:
        jmesh.create_mesh(shape)
    with pytest.raises(ValueError) as terr:
        pmesh.create_mesh(shape, CPUS)
    assert str(terr.value) == str(jerr.value)


def _spec_tuple(spec):
    return tuple(spec) if isinstance(spec, PartitionSpec) else spec


def _same_specs(ours, jax_specs):
    """The two spec trees, key by key, entry by entry (JAX's trailing Nones
    are implicit in a PartitionSpec)."""
    if isinstance(ours, dict):
        assert set(ours) == set(jax_specs)
        for k in ours:
            _same_specs(ours[k], jax_specs[k])
        return
    want = _spec_tuple(jax_specs)
    assert ours[:len(want)] == want and all(x is None
                                            for x in ours[len(want):])


@pytest.mark.parametrize("tp", [False, True])
def test_decoder_specs_are_jaxs_and_fit_the_port_tree(tp):
    _same_specs(pmesh.decoder_param_specs(tp), jmesh.decoder_param_specs(tp))
    params = tdec.init_decoder_params(torch.Generator().manual_seed(0),
                                      tdec.DecoderConfig(**DEC))
    specs = pmesh.decoder_param_specs(tp)
    # same keys, and a spec entry for every dimension of its leaf
    tsteps.tree_map(lambda p, s: None if len(s) == p.dim() else
                    pytest.fail(f"{s} does not fit {tuple(p.shape)}"),
                    params, specs)
    assert set(tsteps.tree_map(lambda p, s: 0, params, specs)) == set(params)


@pytest.mark.parametrize("tp", [False, True])
def test_model_specs_are_jaxs_on_the_model_tree(tp):
    mcfg = tmodel.ModelConfig("tiny", tvis.VisionConfig(**VIS),
                              tdec.DecoderConfig(**DEC))
    params = tmodel.init_model_params(torch.Generator().manual_seed(0), mcfg)
    ours = pmesh.model_param_specs(params, tp)
    from mit_tpu.models import model as jmodel
    from mit_tpu.models import vision as jvis

    jparams = jmodel.init_model_params(jax.random.PRNGKey(0), jmodel.ModelConfig(
        "tiny", jvis.VisionConfig(**VIS), jdec.DecoderConfig(**DEC), "cls"))
    _same_specs(ours, jmesh.model_param_specs(jparams, tp))
    tsteps.tree_map(lambda p, s: None if len(s) == p.dim() else
                    pytest.fail(f"{s} does not fit {tuple(p.shape)}"),
                    params, ours)
    assert set(pmesh.BATCH_SPECS) == set(jmesh.BATCH_SPECS)
    for k, v in pmesh.BATCH_SPECS.items():
        assert v == _spec_tuple(jmesh.BATCH_SPECS[k])


@pytest.mark.parametrize("shape", [(1, 2), (2, 2), (1, 4), (4, 1)])
def test_shard_then_gather_round_trips(tmp_path, shape):
    """In gloo ranks spawned as ``tests/test_torch_parallel.py`` spawns
    them: each rank's shards of the TP specs, the tree gathered back bit
    for bit, and the replicated tree."""
    from test_torch_parallel import run_ranks

    d, m = shape
    res = run_ranks("check_round_trips", d * m, tmp_path, shape=list(shape))
    assert sorted(r["coords"] for r in res) == [
        (i, j) for i in range(d) for j in range(m)]
    for r in res:
        assert r["wq"] == (2, 32, 32 // m) and r["w2"] == (2, 64 // m, 32)
        assert r["bq"] and r["embedding"]
        assert r["round_trip"] and r["replicated"]


def _rank_mesh(shape, i, j):
    """The distributed form's view of rank (i, j) of ``shape``, without a
    process group (enough for what needs no collective)."""
    d, m = shape
    return pmesh.Mesh(ranks=np.arange(d * m).reshape(d, m), coords=(i, j),
                      device=torch.device("cpu"))


def test_shard_batch_gives_each_data_index_its_rows():
    b = {"features": torch.arange(8 * 3.0).reshape(8, 1, 3),
         "decoder_input_tokens": np.arange(8 * 5).reshape(8, 5),
         "target_tokens": torch.arange(8 * 5).reshape(8, 5), "valid": 8}
    for i in range(4):
        for j in range(2):
            r = pmesh.shard_batch(b, _rank_mesh((4, 2), i, j))
            assert torch.equal(r["features"], b["features"][2 * i:2 * i + 2])
            np.testing.assert_array_equal(
                r["decoder_input_tokens"],
                b["decoder_input_tokens"][2 * i:2 * i + 2])
            assert r["valid"] == 8
    with pytest.raises(ValueError, match="split"):
        pmesh.shard_batch({"features": torch.zeros(6, 1)},
                          _rank_mesh((4, 2), 0, 0))
    # the tree and batch functions take the distributed form only
    with pytest.raises(ValueError, match="distributed mesh"):
        pmesh.shard_batch(b, pmesh.create_mesh((4, 2), CPUS))


# ----------------------------------------------------------------------
# the cell map of the dropout kernels
# ----------------------------------------------------------------------
B, H, T, S, RATE, SEED = 4, 6, 7, 9, 0.3, 1234


def _rank_maps():
    """(rows, heads, cell map) of each rank of a (2, 3) mesh of the
    (B, H) cells."""
    for i in range(2):
        for j in range(3):
            b0, h0 = i * B // 2, j * H // 3
            yield (slice(b0, b0 + B // 2), slice(h0, h0 + H // 3),
                   (b0, H, h0))


def test_cell_map_masks_are_slices_of_the_global_mask_and_jaxs():
    whole = da.dump_dropout_mask(B, H, T, S, SEED, RATE)
    for rows, heads, cells in _rank_maps():
        mine = da.dump_dropout_mask(B // 2, H // 3, T, S, SEED, RATE,
                                    cells=cells)
        assert torch.equal(mine, whole[rows, heads])
        for b in range(B // 2):
            for h in range(H // 3):
                cell = (cells[0] + b) * H + cells[2] + h
                want = np.asarray(_keep_mask((T, S), RATE, jnp.uint32(SEED),
                                             jnp.uint32(cell)))
                np.testing.assert_array_equal(mine[b, h].numpy(), want)
    # the identity map is today's mask
    assert torch.equal(da.dump_dropout_mask(B, H, T, S, SEED, RATE,
                                            cells=(0, H, 0)), whole)
    with pytest.raises(ValueError, match="cell map"):
        da.dump_dropout_mask(B, H, T, S, SEED, RATE, cells=(0, H, 1))


def test_cell_map_forward_and_backward_are_slices_of_the_global_call():
    r = np.random.default_rng(0)
    q, k, v, do = (torch.from_numpy(r.normal(size=(B, H, n, 16))
                                    .astype(np.float32))
                   for n in (T, S, S, T))
    pad = torch.zeros(B, S)
    pad[1, -3:] = -1e9
    out = da.flash_attention_dropout_reference(q, k, v, pad, SEED, False, RATE)
    grads = da.flash_attention_dropout_reference_backward(
        q, k, v, pad, do, SEED, False, RATE)
    for rows, heads, cells in _rank_maps():
        part = lambda x: x[rows, heads].contiguous()
        mine = da.flash_attention_dropout_fwd(
            part(q), part(k), part(v), pad[rows].contiguous(), SEED, False,
            RATE, cells)
        torch.testing.assert_close(mine, part(out), rtol=0, atol=0)
        for g, want in zip(da.flash_attention_dropout_bwd(
                part(q), part(k), part(v), pad[rows].contiguous(), part(do),
                SEED, False, RATE, cells), grads):
            torch.testing.assert_close(g, part(want), rtol=0, atol=0)


# ----------------------------------------------------------------------
# the device and the backend: nothing falls back
# ----------------------------------------------------------------------
def test_rank_device_is_local_rank_or_the_given_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setenv("LOCAL_RANK", "1")
    assert pmesh.rank_device() == torch.device("cuda", 1)
    monkeypatch.setenv("LOCAL_RANK", "2")
    with pytest.raises(RuntimeError, match="LOCAL_RANK 2 has no CUDA device"):
        pmesh.rank_device()
    assert pmesh.rank_device("cuda:0") == torch.device("cuda", 0)
    assert pmesh.rank_device("cpu") == torch.device("cpu")
    assert pmesh.default_backend("cuda:1") == "nccl"
    assert pmesh.default_backend("cpu") == "gloo"


def test_a_backend_that_fails_raises_and_nothing_else_starts(tmp_path):
    """nccl cannot start on a CPU-only machine: the mesh raises, and no
    process group (gloo or other) is left up."""
    import torch.distributed as dist

    if dist.is_nccl_available() and torch.cuda.is_available():
        pytest.skip("nccl starts here")
    with pytest.raises(Exception):
        pmesh.init_distributed_mesh((1, 1), "cpu", backend="nccl",
                                    init_method=f"file://{tmp_path}/pg",
                                    rank=0, world_size=1)
    assert not dist.is_initialized()


def test_train_cli_passes_the_mesh_the_backend_and_the_device(monkeypatch):
    """``--mesh``, ``--dist_backend`` and ``--device`` reach ``train()``;
    without ``--device`` each rank takes its LOCAL_RANK device there."""
    from mit_tpu_torch.train import cli
    from mit_tpu_torch.train import loop

    seen = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(loop, "train", lambda cfg, **kw: seen.append(
        (cfg.MESH_SHAPE, kw["backend"], kw["device"]))
        or {"best_val_loss": 1.0})
    assert cli.main(["--mesh", "2,2", "--dist_backend", "gloo",
                     "--no_prepare", "--no_wandb"]) == 0
    assert cli.main(["--mesh=-1,1", "--device", "cuda:0"]) == 0
    assert seen == [((2, 2), "gloo", None), ((-1, 1), None, "cuda:0")]
