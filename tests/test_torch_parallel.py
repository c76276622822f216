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


# ---- the 8-bit optimizer state, int4 weights and the views under a mesh -----


def _filled_8bit(shape, seed: int = 0):
    """An 8-bit state of ``shape`` holding a random second moment."""
    from quantized_training_tpu_torch.optim import OptimState8bit

    g = torch.Generator().manual_seed(seed)
    return OptimState8bit.zeros(shape).requantize(torch.rand(shape, generator=g) * 1e-3)


@pytest.mark.parametrize("shape", [(2, 128, 128), (2, 128, 256), (256, 128)])
@pytest.mark.parametrize("fsdp", [2, 4])
def test_8bit_state_pieces_are_the_global_blocks(shape, fsdp):
    """A rank's piece of an 8-bit state (``shard_state``) dequantizes to its
    slice of the global state, its requantize of a new slice gives the
    global requantize's codes and scales of that piece bit for bit (the
    blocks lie whole in one rank's runs), and every rank's checkpointed
    pieces materialize into the global flat codes and scales."""
    from quantized_training_tpu_torch.utils import checkpoint

    st = _filled_8bit(shape)
    new = torch.rand(shape, generator=torch.Generator().manual_seed(1)) * 1e-3
    global_next = st.requantize(new)
    saved = []
    for r in range(fsdp):
        mesh = rank_mesh({"fsdp": fsdp}, r)
        (piece,), specs = parallel.shard_state([st], mesh)
        dim = parallel.param_spec(shape, mesh)
        mine = lambda t: t.chunk(fsdp, dim)[r]  # noqa: E731
        assert piece.shard.dim == dim and piece.local_shape == tuple(mine(new).shape)
        assert torch.equal(piece.dequantize(), mine(st.dequantize()))
        nxt = piece.requantize(mine(new))
        assert torch.equal(nxt.codes, specs[0].codes.take(global_next.codes))
        assert torch.equal(nxt.scale, specs[0].scale.take(global_next.scale))
        saved.append(map_tensors(checkpoint._sharded_leaf, [piece], specs))
    merged = map_tensors(lambda a, *rest: checkpoint.ShardedLeaf(a.global_shape, a.dtype,
                                                                 [p for l in (a, *rest) for p in l.shards]),
                         *saved, is_leaf=lambda t: isinstance(t, checkpoint.ShardedLeaf))
    (full,) = checkpoint.materialize(merged)
    assert full.shard is None and torch.equal(full.codes, st.codes) and torch.equal(full.scale, st.scale)


def test_8bit_state_pieces_where_blocks_cross_ranks():
    """[2, 8, 96] split on dim 1 over fsdp 4: a rank's runs of 192
    elements end inside the blocks of 256. Each rank keeps its elements'
    codes and every block's scale: its piece dequantizes to its slice of
    the global state bit for bit, every rank's checkpointed pieces
    materialize into the global codes and scales, and a requantize outside
    the span that all-reduces the blocks' maxima is refused (the 4-rank
    requantize: tests/test_torch_parallel_ranks.py)."""
    from quantized_training_tpu_torch.utils import checkpoint

    shape, fsdp = (2, 8, 96), 4
    st = _filled_8bit(shape)
    saved = []
    for r in range(fsdp):
        (piece,), specs = parallel.shard_state([st], rank_mesh({"fsdp": fsdp}, r))
        assert piece.straddles and torch.equal(piece.scale, st.scale)
        assert torch.equal(piece.dequantize(), st.dequantize().chunk(fsdp, 1)[r])
        saved.append(map_tensors(checkpoint._sharded_leaf, [piece], specs))
        with pytest.raises(RuntimeError, match="span 'blocks'"):
            piece.requantize(piece.dequantize())
    merged = map_tensors(lambda a, *rest: checkpoint.ShardedLeaf(a.global_shape, a.dtype,
                                                                 [p for l in (a, *rest) for p in l.shards]),
                         *saved, is_leaf=lambda t: isinstance(t, checkpoint.ShardedLeaf))
    (full,) = checkpoint.materialize(merged)
    assert torch.equal(full.codes, st.codes) and torch.equal(full.scale, st.scale)


@pytest.mark.parametrize("name,sliced", [("q", (slice(None), slice(32, 64), slice(None))),
                                         ("o", (slice(None), slice(None), slice(64, 128)))])
def test_int4_weights_split_by_their_matrix(name, sliced):
    """An int4 weight-only weight under {"model": 4} (rank 1): a
    column-parallel weight by whole rows, a row-parallel one by K blocks of
    every row; the rank's weight dequantizes to its slice of the global
    dequantized matrix bit for bit, with its ``mat_shape`` in the weight and
    in the layout; a group that a rank's share would cut is refused."""
    from quantized_training_tpu_torch.quant.int4 import Int4Weight

    w = Int4Weight.from_float(torch.randn(2, 128, 256, generator=torch.Generator().manual_seed(0)).bfloat16())
    p, specs = parallel.shard_params_tp({"layers": {name: {"w": w}}}, rank_mesh({"model": 4}, 1))
    mine = p["layers"][name]["w"]
    assert torch.equal(mine.dequantize(), w.dequantize()[sliced])
    assert mine.mat_shape == specs["layers"][name]["w"].mat_shape == tuple(w.dequantize()[sliced].shape[1:])
    odd = Int4Weight.from_float(torch.randn(2, 128, 64).bfloat16(), group_size=32)
    with pytest.raises(ValueError, match="inside a group"):
        parallel.shard_params_tp({"layers": {"o": {"w": odd}}}, rank_mesh({"model": 4}, 0))


def test_prequant_specs_gather_each_view_with_its_weight():
    """The layout of the pre-quantized views of a weight split on its rows
    (dim 1): the master, both int8 views and the row scales split as the
    master, the column scales whole; split on its columns (dim 2) the row
    scales whole; the 0-sized placeholders of a one-view mode whole."""
    from quantized_training_tpu_torch.parallel.fsdp import prequant_specs
    from quantized_training_tpu_torch.parallel.mesh import Shard
    from quantized_training_tpu_torch.quant.mixed_precision import MixedPrecisionWeight, prequantize_weight

    w = MixedPrecisionWeight(torch.randn(2, 16, 32).bfloat16(), quant.MixedPrecisionConfig())
    for dim, whole in ((1, "col_s"), (2, "row_s")):
        spec = {"w": MixedPrecisionWeight(Shard(dim, 0, 2), w.config)}
        views = prequant_specs({"w": prequantize_weight(w)}, spec)["w"]
        for f in ("orig", "row_q", "row_s", "col_q", "col_s"):
            assert getattr(views, f).dim == (None if f == whole else dim), (dim, f)
    views = prequant_specs({"w": prequantize_weight(w, mode="row")}, {"w": MixedPrecisionWeight(Shard(1, 0, 2),
                                                                                                 w.config)})["w"]
    assert views.col_q.dim is None and views.col_s.dim is None and views.row_q.dim == 1


def test_scaled_mm_over_keeps_int32_sums_past_fp32s_integers(monkeypatch):
    """A rank's int8 sums past 2**24 (K = 2816 products of 127 x 127, as
    Llama2-1B's down projection under TP 2 could reach) go into the
    all-reduce exact: ``scaled_mm_over`` runs K2 on ``EXACT_K`` slices of
    the contraction, whose fp32 sums are exact, and adds them as int32. The
    all-reduce is stood in for by another rank's partial of 5 - S, so the
    output is 5 only where the rank's sum S was exact."""
    from quantized_training_tpu_torch.parallel import collectives
    from quantized_training_tpu_torch.quant import core

    K = 2816
    a = torch.full((2, K), 127, dtype=torch.int8)
    a[0, 0] = 1
    b = torch.full((16, K), 127, dtype=torch.int8)
    exact = a.long() @ b.long().T
    assert (exact.abs() > 2**24).all() and (exact[0].float().long() != exact[0]).all()
    monkeypatch.setitem(collectives._SPANS, "features", (None, "model"))
    monkeypatch.setattr(collectives, "all_reduce", lambda x, mesh, axis: x - exact.to(x.dtype) + 5)
    out = core.scaled_mm_over(a, b, torch.ones(2), torch.ones(16), dims=(1, 1), out_dtype=torch.float32,
                              over="features")
    assert torch.equal(out, torch.full((2, 16), 5.0)), out
