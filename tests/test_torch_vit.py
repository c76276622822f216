"""The port's ViT (``models/vit.py``), its data and its trainer
(``vit_train.py``) on the CPU, against the JAX package's ``models/vit.py``
and ``vit_train.py`` on the same numpy inputs and the same parameters
(``convert.params_from_jax`` of JAX's init), at a small size: 2 blocks,
hidden 128, 2 heads, 32 x 32 images in 8 x 8 patches (17 tokens), 32 images
a batch, so that the 544 tokens are a multiple of 32 and the fused linears
engage under ``set_impl('interpret')``.

Bounds, each above the floor it is stated with (measured on the CPU; the
floor is JAX against itself with the images moved by one ulp, random sign):

- forward, loss and gradients against JAX's: loss within 1e-3 relative,
  logits and every gradient leaf within 5e-2 relative RMS;
- two train steps against JAX's (adamw_bf16_sr without the SR writeback):
  loss within 1e-3, every parameter leaf within 1e-2 relative RMS (the
  bounds of tests/test_torch_train.py);
- the figures each test measured are in its docstring.
"""

import dataclasses
import importlib
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantized_training_tpu import optim as joptim
from quantized_training_tpu import quant as jquant
from quantized_training_tpu.data import BatchLoader as JBatchLoader
from quantized_training_tpu.data import SyntheticImageDataset as JSynthetic
from quantized_training_tpu.models import vit as jvit
from quantized_training_tpu.quant import fused as jfused
from quantized_training_tpu_torch import ops, optim, quant
from quantized_training_tpu_torch import vit_train
from quantized_training_tpu_torch.convert import adamw_state_from_jax, params_from_jax
from quantized_training_tpu_torch.data import BatchLoader, SyntheticImageDataset, get_dataset
from quantized_training_tpu_torch.models import vit
from quantized_training_tpu_torch.ops.random import fold_in
from quantized_training_tpu_torch.quant import fused
from quantized_training_tpu_torch.train import value_and_grad
from quantized_training_tpu_torch.utils.tree import tree_leaves
from test_torch_train import _counting

# One intra-op thread: the suite runs in several worker processes at once.
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
KW = dict(image_size=32, patch_size=8, hidden_size=128, num_layers=2, num_heads=2, num_classes=10)
B = 32  # images: 32 x 17 = 544 tokens
_JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
_TDT = {"f32": torch.float32, "bf16": torch.bfloat16}


@pytest.fixture(params=["interpret", "off"])
def impl(request):
    """Both packages' fused ops in one mode for one test."""
    jfused.set_impl(request.param)
    fused.set_impl(request.param)
    yield request.param
    jfused.set_impl("auto")
    fused.set_impl("auto")


def _applies(monkeypatch) -> dict:
    counts = {"ln": 0, "gelu": 0}
    for name, cls in (("ln", fused._LNMM), ("gelu", fused._GeluMM)):
        def counted(*args, _apply=cls.apply, _name=name):
            counts[_name] += 1
            return _apply(*args)

        monkeypatch.setattr(cls, "apply", counted)
    return counts


def _batch(seed, n=B, size=32, classes=10):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, size, size, 3)).astype(np.float32), rng.integers(0, classes, n)


def _models(dtn, scheme="mixed_precision", remat=False, **cfg_kw):
    """JAX's init, quantized, and the same parameters in the port."""
    jcfg = jvit.ViTConfig(**KW, remat=remat, **cfg_kw)
    cfg = vit.ViTConfig(**KW, remat=remat, **cfg_kw)
    jp = jquant.quantize_params(jvit.init_params(jax.random.PRNGKey(0), jcfg, dtype=_JDT[dtn]), scheme)
    return jcfg, cfg, jp, params_from_jax(jax.tree.map(np.asarray, jp))


def _rms(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def test_patchify_vs_jax():
    imgs, _ = _batch(0, n=2)
    got = vit.patchify(torch.from_numpy(imgs), 8)
    assert got.shape == (2, 16, 192)
    assert np.array_equal(got.numpy(), np.asarray(jvit.patchify(jnp.asarray(imgs), 8)))


def _paths(tree, path=()):
    """The key paths of the tree's leaves, in tree_leaves' order."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _paths(tree[k], path + (k,))]
    return [path]


def _shapes(tree):
    return {k: _shapes(v) for k, v in tree.items()} if isinstance(tree, dict) else tuple(tree.shape)


def test_init_tree_and_convert_match_jax():
    """init_params builds JAX's tree (names, shapes, bf16; the numbers come
    from another RNG), and params_from_jax carries JAX's tree over as it is:
    the cls token, the position embedding, the stacked layers."""
    jcfg, cfg, jp, tp = _models("bf16", scheme=None)
    mine = vit.init_params(torch.Generator().manual_seed(0), cfg)
    assert _shapes(mine) == _shapes(jp) == _shapes(tp)
    assert all(t.dtype == torch.bfloat16 for t in tree_leaves(mine) + tree_leaves(tp))
    for jv, tv in zip(jax.tree.leaves(jp), tree_leaves(tp)):
        assert np.array_equal(tv.float().numpy(), np.asarray(jv, np.float32))
    assert tp["cls_token"].shape == (1, 1, 128) and tp["pos_embed"].shape == (1, 17, 128)
    assert tp["layers"]["fc1"]["w"].shape == (2, 512, 128)


def test_default_filter_leaves_patch_embed_and_head_bf16():
    """At ViT-Giant's shapes (meta tensors) the default filter wraps every
    block weight and leaves the patch embedding [1536, 588] (588 % 32 != 0)
    and the [45, 1536] head in bf16; ViT-Giant has 1.13B parameters."""
    cfg = dataclasses.replace(vit.VIT_GIANT, num_classes=45)
    D, L, P, F = cfg.hidden_size, cfg.num_layers, cfg.patch_size, cfg.mlp_dim
    meta = lambda *s: torch.empty(s, device="meta", dtype=torch.bfloat16)
    params = {"patch_embed": {"w": meta(D, 3 * P * P), "b": meta(D)}, "cls_token": meta(1, 1, D),
              "pos_embed": meta(1, cfg.num_patches + 1, D),
              "layers": {"norm1": {"g": meta(L, D), "b": meta(L, D)}, "qkv": {"w": meta(L, 3 * D, D), "b": meta(L, 3 * D)},
                         "proj": {"w": meta(L, D, D), "b": meta(L, D)}, "norm2": {"g": meta(L, D), "b": meta(L, D)},
                         "fc1": {"w": meta(L, F, D), "b": meta(L, F)}, "fc2": {"w": meta(L, D, F), "b": meta(L, D)}},
              "final_norm": {"g": meta(D), "b": meta(D)}, "head": {"w": meta(45, D), "b": meta(45)}}
    q = quant.quantize_params(params, "mixed_precision")
    assert all(isinstance(q["layers"][k]["w"], quant.MixedPrecisionWeight) for k in ("qkv", "proj", "fc1", "fc2"))
    assert isinstance(q["patch_embed"]["w"], torch.Tensor) and isinstance(q["head"]["w"], torch.Tensor)
    n = sum(t.numel() for t in tree_leaves(params))
    assert 1.12e9 < n < 1.14e9 and abs(sum(t[0].numel() for t in tree_leaves(params["layers"])) - 28.3e6) < 0.1e6


@pytest.mark.parametrize("dtn", ["f32", "bf16"])
def test_forward_loss_grads_vs_jax(dtn, impl, monkeypatch):
    """A 2-block ViT on JAX's parameters: logits, loss and every gradient
    leaf against JAX's, both packages fused (``'interpret'``: B18's plain
    versions and the Pallas kernels in interpret mode) or both unfused.
    Measured over images from seeds 1 and 2, port then floor: fp32 loss
    2.0e-5 / 2.0e-5, worst leaf 3.2e-3 / 3.3e-3; bf16 loss 5.1e-4 / 3.8e-4,
    worst weight or norm leaf 3.9e-2 / 4.0e-2. The bias leaves in bf16 are
    held to 1.5e-1 (measured 1.1e-1): JAX's CPU autodiff sums a bias's
    cotangent over the tokens in bf16 (2.7e-2 from the exact sum at 544
    tokens, measured; the port sums in fp32, 1.6e-3), and the k third of
    qkv's bias grad is near zero, since softmax ignores a shift of k's
    bias."""
    counts = _applies(monkeypatch)
    jcfg, cfg, jp, tp = _models(dtn)
    imgs, labels = _batch(1)
    jlogits = jvit.forward(jp, jnp.asarray(imgs), jcfg, key=jax.random.PRNGKey(5))
    jl, jg = jax.value_and_grad(lambda p: jvit.loss_fn(p, jnp.asarray(imgs), jnp.asarray(labels), jcfg,
                                                       key=jax.random.PRNGKey(5)))(jp)
    logits = vit.forward(tp, torch.from_numpy(imgs), cfg, key=5)
    assert logits.shape == (B, 10) and logits.dtype == _TDT[dtn]
    assert _rms(logits.float().numpy(), np.asarray(jlogits, np.float32)) <= 5e-2
    tl, tg = value_and_grad(lambda p: vit.loss_fn(p, torch.from_numpy(imgs), torch.from_numpy(labels), cfg, key=5),
                            tp)
    assert abs(tl.item() - float(jl)) <= 1e-3 * abs(float(jl))
    for path, a, b in zip(_paths(tg), tree_leaves(tg), jax.tree.leaves(jg)):
        bound = 1.5e-1 if dtn == "bf16" and path[-1] == "b" else 5e-2
        assert a.shape == b.shape and a.dtype == _TDT[dtn] and _rms(a.float().numpy(), b) <= bound, path
    n = 2 * KW["num_layers"] if impl == "interpret" else 0  # forward and loss_fn's forward
    assert counts == {"ln": 2 * n, "gelu": n}


def test_train_steps_vs_jax(impl):
    """Two steps of ``vit_train.make_train_step`` (bf16, remat,
    adamw_bf16_sr without the SR writeback, lr 1e-4) against the JAX
    driver's step (vit_train.py:145-156) from one state and one key per
    step: losses within 1e-3, every parameter within 1e-2 relative RMS.
    The biases and the cls token start from normal(0.02) draws here, not
    zeros: Adam's first update is lr * sign(g), and where a gradient is
    rounding noise in both packages (the k third of qkv's bias: softmax
    ignores a shift of k's bias) either sign comes out, which would decide
    the whole of a leaf that starts at zero. Measured, worst of both modes
    and steps, port then floor (JAX's step with the images moved by one bf16
    ulp): loss 2.5e-4 / 4.6e-4, parameters 6.4e-3 / 6.6e-3."""
    jcfg, cfg, jp, _ = _models("bf16", remat=True)
    rng = np.random.default_rng(7)
    jp = jax.tree.map(lambda l: l if np.any(np.asarray(l, np.float32)) else
                      jnp.asarray(rng.standard_normal(l.shape) * 0.02, l.dtype), jp)
    tp = params_from_jax(jax.tree.map(np.asarray, jp))
    jopt, topt = (o.adamw_bf16_sr(bf16_stochastic_rounding=False) for o in (joptim, optim))
    jstate = jopt.init(jquant.virtual_params(jp))
    tstate = adamw_state_from_jax(jax.tree.map(np.asarray, jstate))

    @jax.jit
    def jstep(qparams, opt_state, images, labels, lr, skey):  # vit_train.py's train_step
        v = jquant.virtual_params(qparams)
        l, g = jax.value_and_grad(
            lambda v: jvit.loss_fn(jquant.merge_masters(v, qparams), images, labels, jcfg, key=skey))(v)
        v2, opt_state2 = jopt.step(g, opt_state, v, lr, jax.random.fold_in(skey, 1))
        return jquant.commit_params(v2, qparams, jax.random.fold_in(skey, 2)), opt_state2, l

    tstep = vit_train.make_train_step(cfg, topt)
    for i in range(2):
        imgs, labels = _batch(10 + i)
        jp, jstate, jl = jstep(jp, jstate, jnp.asarray(imgs), jnp.asarray(labels), 1e-4, jax.random.PRNGKey(i))
        tp, tstate, tl = tstep(tp, tstate, torch.from_numpy(imgs), torch.from_numpy(labels), 1e-4, i)
        assert np.isfinite(tl.item()) and abs(tl.item() - float(jl)) <= 1e-3 * abs(float(jl)), (tl, jl)
        for path, a, b in zip(_paths(tp), tree_leaves(tp), jax.tree.leaves(jp)):
            assert _rms(a.float().numpy(), np.asarray(b, np.float32)) <= 1e-2, path
    assert all(t.dtype == torch.bfloat16 for t in tree_leaves(tstate.exp_avg))


def test_sr_remat_on_off_bit_identical(monkeypatch):
    """Hazard 5: with SR on the fused blocks (``'interpret'``), a key fixes
    every draw: the same key gives the same loss and grads bit for bit with
    the whole-block checkpoint (its key an argument, so the replay draws the
    forward's noise) and without it; another key gives other grads."""
    fused.set_impl("interpret")
    counts = _applies(monkeypatch)
    imgs, labels = (torch.from_numpy(a) for a in _batch(3))
    runs = []
    try:
        for remat, key in ((True, 11), (True, 11), (True, 12), (False, 11)):
            cfg = vit.ViTConfig(**KW, remat=remat)
            raw = vit.init_params(torch.Generator().manual_seed(4), cfg, dtype=torch.float32)
            params = quant.quantize_params(raw, "mixed_precision", stochastic_rounding=True)
            runs.append(value_and_grad(lambda p: vit.loss_fn(p, imgs, labels, cfg, key=key), params))
    finally:
        fused.set_impl("auto")
    n = (3 * 2 + 1) * KW["num_layers"]  # the three remat runs replay each block
    assert counts == {"ln": 2 * n, "gelu": n}
    leaves = [(loss, tree_leaves(grads)) for loss, grads in runs]
    for i in (1, 3):
        assert torch.equal(leaves[i][0], leaves[0][0])
        assert all(torch.equal(a, b) for a, b in zip(leaves[i][1], leaves[0][1]))
    assert not all(torch.equal(a, b) for a, b in zip(leaves[2][1], leaves[0][1]))


def per_step(L: int, n_leaves: int, sr: bool = False, patch_embed: bool = False) -> dict:
    """Kernel launches of one remat train step of L fused blocks on one
    micro-batch, from the code: per block the forward launches B18
    LayerNorm-row 2 (qkv, fc1), GELU-row 1 (fc2), K1 5 (the four weights
    and proj's input), K2 4, and the remat replay all of it but fc2's K2
    and its weight's K1 (no backward reads the block's output; fc2's GELU
    row kernel runs for its column maxima); the backward B18 LayerNorm-column 2 and
    GELU-column 1 (given the forward's scales), B5 4 (each output grad), B4
    5 (the four weights and proj's input), B1 4, B2 4; then B6 once per
    parameter leaf. The head stays bf16, and so does the patch embedding
    where 3 * P * P is no multiple of 32 (ViT-Giant's 588); with
    ``patch_embed`` it is quantized, outside the checkpoints: K1 2, K2 1,
    B5 1, B4 2, B1 1, B2 1."""
    t = "_sr" if sr else ""
    p = int(patch_embed)
    counts = dict.fromkeys(ops.KERNELS, 0)
    counts.update({f"layernorm_quant_rowwise{t}": 4 * L, f"gelu_quant_rowwise{t}": 2 * L,
                   f"layernorm_quant_colwise{t}": 2 * L, f"gelu_quant_colwise{t}": L,
                   f"quantize_int8_rowwise{t}": 9 * L + 2 * p, "scaled_mm_rhs_t": 7 * L + p,
                   f"quantize_int8_both{t}": 4 * L + p, f"quantize_int8_colwise{t}": 5 * L + 2 * p,
                   "scaled_mm": 4 * L + p, "scaled_mm_lhs_t": 4 * L + p, "fused_adamw_update": n_leaves})
    return counts


@pytest.mark.parametrize("sr", [False, True])
def test_kernel_calls_per_step(monkeypatch, sr):
    """The launch counts chip_smoke.py holds ViT-Giant's step to (phase 11),
    per block of one remat step on the fused path (``per_step``): for 40
    blocks B18 LayerNorm-row 160, GELU-row 80, LayerNorm-column 80,
    GELU-column 40. Under SR every quantize takes its SR form."""
    counts = _counting(monkeypatch)
    fused.set_impl("interpret")
    try:
        cfg = vit.ViTConfig(**KW, remat=True)
        raw = vit.init_params(torch.Generator().manual_seed(0), cfg)
        params = quant.quantize_params(raw, "mixed_precision", stochastic_rounding=sr)
        opt = optim.adamw_bf16_sr(bf16_stochastic_rounding=False)
        imgs, labels = (torch.from_numpy(a) for a in _batch(2))
        vit_train.make_train_step(cfg, opt)(params, opt.init(quant.virtual_params(params)), imgs, labels, 1e-4, 0)
    finally:
        fused.set_impl("auto")
    # here 3 * 8 * 8 = 192 inputs: the default filter quantizes the patch embedding
    assert isinstance(params["patch_embed"]["w"], quant.MixedPrecisionWeight)
    assert counts == per_step(KW["num_layers"], len(tree_leaves(raw)), sr, patch_embed=True)
    assert len(tree_leaves(raw)) == 20


def test_synthetic_images_match_jax(monkeypatch):
    """The same seed gives the JAX package's images and labels; the
    prefetching batcher gives the synchronous one's batches and drops a
    ragged tail; ``hf_image`` builds its streaming set (``load_dataset``
    stubbed: nothing is fetched) and ``wds`` its tar stream."""
    for eval_ in (False, True):
        ours, theirs = SyntheticImageDataset(size=16, num_classes=7, eval=eval_, n_samples=10), JSynthetic(
            size=16, num_classes=7, eval=eval_, n_samples=10)
        for (a, la), (b, lb) in zip(ours, theirs):
            assert np.array_equal(a, b) and la == lb
    sync = list(BatchLoader(SyntheticImageDataset(size=8, n_samples=10), 4, prefetch=0))
    ahead = list(BatchLoader(SyntheticImageDataset(size=8, n_samples=10), 4))
    theirs = list(JBatchLoader(JSynthetic(size=8, n_samples=10), 4))
    assert len(sync) == len(ahead) == len(theirs) == 2
    for (a, la), (b, lb), (c, lc) in zip(sync, ahead, theirs):
        assert np.array_equal(a, b) and np.array_equal(a, c) and np.array_equal(la, lb) and np.array_equal(la, lc)
    loader = BatchLoader(SyntheticImageDataset(size=8), 4)
    it = iter(loader)
    next(it)
    assert loader.state_dict() == {"ds": {"_i": 4}}
    assert isinstance(get_dataset("synthetic_image", size=8), SyntheticImageDataset)
    monkeypatch.setattr("datasets.load_dataset", lambda name, split, streaming: ("set", name, split, streaming))
    assert get_dataset("hf_image", dataset="x", split="train").ds == ("set", "x", "train", True)
    assert get_dataset("wds", urls=["a.tar"]).urls == ["a.tar"]
    with pytest.raises(ValueError, match="unknown"):
        get_dataset("nope")


def test_cosine_schedule_and_config_match_jax():
    """vit_train's CosineSchedule is the JAX driver's, step by step, and
    model_config applies the driver's overrides (remat, num_classes,
    image_size, then model_kwargs)."""
    sys.path.insert(0, str(REPO))
    jdriver = importlib.import_module("vit_train")  # the JAX driver; it imports jax only inside main()
    for lr, n in ((1e-4, 100), (3e-4, 7)):
        ours, theirs = vit_train.CosineSchedule(lr, n), jdriver.CosineSchedule(lr, n)
        assert [ours.get_lr(s) for s in range(n + 2)] == [theirs.get_lr(s) for s in range(n + 2)]
    cfg = vit_train.model_config("vit_giant", 45, 224, num_layers=2)
    assert (cfg.remat, cfg.num_classes, cfg.image_size, cfg.num_layers, cfg.hidden_size) == (True, 45, 224, 2, 1536)


def test_cli_smoke_on_the_cpu(tmp_path):
    """``python -m quantized_training_tpu_torch.vit_train --cpu`` trains a
    tiny ViT for three steps on synthetic images and logs images/s; without
    ``--cpu`` and without a card it raises."""
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    args = [sys.executable, "-m", "quantized_training_tpu_torch.vit_train", "--model", "vit_tiny", "--model_kwargs",
            '{"hidden_size": 128, "num_layers": 2, "num_heads": 2, "patch_size": 8}', "--image_size", "32",
            "--train_ds", '{"type": "synthetic_image"}', "--quantize", "mixed_precision", "--n_steps", "3",
            "--batch_size", "4", "--log_interval", "1", "--optim", "adamw_bf16_sr", "--cosine_lr_scheduler"]
    proc = subprocess.run([*args, "--cpu"], cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    lines = [l for l in proc.stdout.splitlines() if l.startswith("step ")]
    assert len(lines) == 3 and all("images_per_second=" in l and "loss=" in l for l in lines)
    assert len(list(tmp_path.glob("runs/vit_train/*/metrics.jsonl"))) == 1
    if not torch.cuda.is_available():
        proc = subprocess.run(args, cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
        assert proc.returncode != 0 and "--cpu" in proc.stderr


def test_step_keys_fold_as_the_driver_folds_them(monkeypatch):
    """The step's key seeds the model as it is; the optimizer takes
    fold_in(key, 1) and commit_params fold_in(key, 2) (vit_train.py:153-155)."""
    seen = {}
    loss_fn, commit = vit.loss_fn, quant.commit_params

    def recording_loss(p, images, labels, cfg, key=None):
        seen["model"] = key
        return loss_fn(p, images, labels, cfg, key=key)

    def recording_commit(v, q, key=None):
        seen["commit"] = key
        return commit(v, q, key)

    monkeypatch.setattr(vit, "loss_fn", recording_loss)
    monkeypatch.setattr(quant, "commit_params", recording_commit)
    opt = optim.adamw()

    def opt_step(g, state, p, lr, key=None):
        seen["opt"] = key
        return opt.step(g, state, p, lr, key)

    cfg = vit.ViTConfig(**KW)
    raw = vit.init_params(torch.Generator().manual_seed(0), cfg)
    imgs, labels = (torch.from_numpy(a) for a in _batch(0, n=2))
    step = vit_train.make_train_step(cfg, optim.Optimizer(opt.init, opt_step))
    step(raw, opt.init(raw), imgs, labels, 1e-4, 77)
    assert seen == {"model": 77, "opt": fold_in(77, 1), "commit": fold_in(77, 2)}
