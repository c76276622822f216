"""The port's mesh and sharding rules in one process, against the JAX
package's on its 8 virtual CPU devices (tests/conftest.py):

- ``make_mesh``'s shapes and its ``ValueError`` (tests/test_parallel.py:
  55-61); a mesh without ``torch.distributed`` is one process;
- ``param_spec`` gives JAX's ``PartitionSpec`` dim, case for case
  (tests/test_parallel.py:63-68 and the rule's other branches);
- ``tp_param_spec`` through ``shard_params_tp`` gives JAX's spec for every
  leaf of bf16, int8-storage and packed-BitNet trees (:194-218);
- each rank's ``shard_state`` slice (``convert.rank_slice``) and
  ``shard_batch`` rows equal the shard that JAX's ``shard_state`` /
  ``shard_batch`` put on that rank's device;
- ``kv_cache_spec`` and ``shard_kv_cache``.

The ranks' meshes are made by hand here (``Mesh`` with no process groups),
one for each coordinate; the collectives run in
tests/test_torch_parallel_ranks.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from quantized_training_tpu import optim as joptim
from quantized_training_tpu import parallel as jparallel
from quantized_training_tpu import quant as jquant
from quantized_training_tpu.models import llama as jllama
from quantized_training_tpu.train import init_train_state
from quantized_training_tpu_torch import parallel, quant, train
from quantized_training_tpu_torch.convert import adamw_state_from_jax, params_from_jax, rank_slice
from quantized_training_tpu_torch.models import llama_infer
from quantized_training_tpu_torch.models.llama import LlamaConfig
from quantized_training_tpu_torch.parallel.mesh import AXES, Mesh
from quantized_training_tpu_torch.utils.tree import map_tensors, tree_leaves

torch.set_num_threads(1)

TINY = dict(vocab_size=256, hidden_size=128, intermediate_size=128, num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=4, max_position_embeddings=64)


def rank_mesh(axes: dict, rank: int) -> Mesh:
    """Rank ``rank``'s view of a mesh of ``axes``, without process groups."""
    sizes = [axes.get(a, 1) for a in AXES]
    d, f, m = sizes
    coords = dict(data=rank // (f * m), fsdp=rank // m % f, model=rank % m)
    return Mesh(dict(zip(AXES, sizes)), coords, dict.fromkeys((*AXES, "dp")))


def jax_dim(spec: P, axis: str):
    """The dim of a JAX PartitionSpec that names ``axis``, or None."""
    return next((d for d, a in enumerate(spec) if a == axis or (isinstance(a, tuple) and axis in a)), None)


def test_make_mesh_shapes():
    mesh = parallel.make_mesh()
    assert mesh.shape == {"data": 1, "fsdp": 1, "model": 1} and mesh.dp_size == 1 and mesh.dp_index == 0
    assert mesh.device_mesh is None and all(g is None for g in mesh.groups.values())
    assert parallel.make_mesh({"fsdp": 1}).shape == dict(jax.tree.map(int, jparallel.make_mesh({"fsdp": 1}).shape))
    with pytest.raises(ValueError, match="needs 64 ranks"):
        parallel.make_mesh({"data": 64})
    with pytest.raises(ValueError, match="axes"):
        parallel.make_mesh({"pipeline": 1})
    m = rank_mesh({"data": 2, "fsdp": 4}, 6)
    assert m.coords == {"data": 1, "fsdp": 2, "model": 0} and m.dp_index == 6 and m.dp_size == 8


@pytest.mark.parametrize("shape", [(2, 128, 64), (2, 65, 64), (2, 65, 63), (256, 64), (255, 64), (64,), (63,), (),
                                   (3, 8, 16, 4)])
def test_param_spec_matches_jax(shape):
    jmesh = jparallel.make_mesh({"fsdp": 4})
    want = jax_dim(jparallel.param_spec(jnp.zeros(shape), jmesh), "fsdp")
    assert parallel.param_spec(shape, rank_mesh({"fsdp": 4}, 0)) == want
    assert parallel.param_spec(torch.zeros(shape), rank_mesh({"fsdp": 4}, 0)) == want
    assert parallel.param_spec(shape, rank_mesh({"data": 4}, 0)) is None


def _tp_trees():
    cfg = jllama.LlamaConfig(**TINY)
    params = jllama.init_params(jax.random.PRNGKey(0), cfg)
    packed = jax.tree.map(lambda x: jquant.BitNetPackedWeight.from_weight(x.data)
                          if isinstance(x, jquant.BitNetWeight) else x,
                          jquant.quantize_params(params, "bitnet"), is_leaf=jquant.is_quant_weight)
    return {"bf16": params, "int8_storage": jquant.quantize_params(params, "int8_quantized_training"),
            "bitnet_packed": packed}


@pytest.mark.parametrize("scheme", ["bf16", "int8_storage", "bitnet_packed"])
def test_tp_param_spec_matches_jax(scheme):
    tree = _tp_trees()[scheme]
    jmesh = jparallel.make_mesh({"model": 4})
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    want = [jax_dim(jparallel.tp_param_spec(path, leaf, jmesh), "model") for path, leaf in flat]
    mesh = rank_mesh({"model": 4}, 1)
    local, specs = rank_slice(params_from_jax(jax.tree.map(np.asarray, tree)), mesh, tp=True)
    got = [s.dim for s in tree_leaves(specs)]
    assert got == want
    if scheme == "bf16":
        keyed = {jax.tree_util.keystr(p): d for (p, _), d in zip(flat, got)}
        assert keyed["['layers']['q']['w']"] == 1 and keyed["['layers']['o']['w']"] == 2
        assert keyed["['layers']['down']['w']"] == 2 and keyed["['lm_head']['w']"] == 0
        assert keyed["['final_norm']['g']"] is None
        assert tuple(local["layers"]["q"]["w"].shape) == (2, 32, 128)
        assert parallel.tp_param_spec(("layers", "q", "w"), (2, 128, 128), mesh) == 1


@pytest.mark.parametrize("axes", [{"fsdp": 4}, {"data": 2, "fsdp": 2}])
def test_rank_slices_are_jax_device_shards(axes):
    """Every leaf of a mixed-precision TrainState: rank r's slice is what
    JAX's shard_state puts on device r (and every rank's slice of a
    replicated leaf is the leaf)."""
    cfg = jllama.LlamaConfig(**TINY)
    opt = joptim.adamw_bf16_sr(bf16_stochastic_rounding=False)
    jstate = init_train_state(jquant.quantize_params(jllama.init_params(jax.random.PRNGKey(0), cfg),
                                                     "mixed_precision"), opt)
    jmesh = jparallel.make_mesh(axes)
    sharded = jparallel.shard_state(jstate, jmesh)
    n = jmesh.devices.size
    host = jax.tree.map(np.asarray, jstate)
    for r in range(n):
        state = train.TrainState(params_from_jax(host.params), adamw_state_from_jax(host.opt_state), 0)
        local, _ = rank_slice(state, rank_mesh(axes, r))
        ours = []
        map_tensors(lambda t: ours.append(t.float().numpy()), local)
        device = jmesh.devices.flat[r]
        theirs = [np.asarray(next(s.data for s in leaf.addressable_shards if s.device == device)).astype(np.float32)
                  for leaf in jax.tree.leaves(sharded) if leaf.ndim > 0]
        assert len(ours) == len(theirs)
        for a, b in zip(ours, theirs):
            assert a.shape == b.shape and np.array_equal(a, b)


@pytest.mark.parametrize("axes", [{"data": 4}, {"data": 2, "fsdp": 2}])
def test_shard_batch_rows_are_jax_device_rows(axes):
    rng = np.random.default_rng(0)
    batch = (rng.integers(0, 256, (8, 32)).astype(np.int32), rng.integers(0, 256, (2, 8, 32)).astype(np.int32))
    jmesh = jparallel.make_mesh(axes)
    jax_rows = [jparallel.shard_batch((jnp.asarray(x),), jmesh)[0] for x in batch]
    for r in range(jmesh.devices.size):
        device = jmesh.devices.flat[r]
        for x, ours in zip(jax_rows, parallel.shard_batch(batch, rank_mesh(axes, r))):
            theirs = next(s.data for s in x.addressable_shards if s.device == device)
            assert np.array_equal(ours.numpy(), np.asarray(theirs))
    with pytest.raises(ValueError, match="does not split"):
        parallel.shard_batch((np.zeros((6, 4)),), rank_mesh({"data": 4}, 0))


def test_kv_cache_spec_and_shard():
    mesh = rank_mesh({"model": 2}, 1)
    jmesh = jparallel.make_mesh({"model": 2})
    for heads in (None, 4, 3):
        assert parallel.kv_cache_spec(mesh, heads) == jax_dim(jparallel.kv_cache_spec(jmesh, heads), "model")
    cfg = LlamaConfig(**TINY)
    cache = llama_infer.KVCache.zeros(cfg, 2, 16)
    cache.k[..., 2:, :] = 1
    local = parallel.shard_kv_cache(cache, mesh)
    assert tuple(local.k.shape) == (2, 2, 16, 2, 32) and bool((local.k == 1).all())
    assert tuple(local.k_scale.shape) == (2, 2, 16, 2, 1)


def test_bitnet_fsdp_params_routes_only_above_one():
    params = quant.quantize_params({"layers": {"q": {"w": torch.zeros(2, 128, 128)}}}, "bitnet")
    on = parallel.bitnet_fsdp_params(params, rank_mesh({"fsdp": 2}, 0))
    off = parallel.bitnet_fsdp_params(params, rank_mesh({"data": 2}, 0))
    assert on["layers"]["q"]["w"].mesh.shape["fsdp"] == 2 and off["layers"]["q"]["w"].mesh is None
    assert parallel.bitnet_fsdp_params(on, None)["layers"]["q"]["w"].mesh is None
