"""The remat policy's train step against the JAX package's under each knob
(``QT_SAVE_POSTATTN=1``, ``save_qkv_residuals``, both), on the fused layer
at tests/test_torch_remat.py's small Llama (2 layers, hidden 256, [2, 128]
tokens, the grouped pipeline forced, both packages' fused ops in interpret
mode): one step (remat, adamw) from one state, its loss, grad norm and
every parameter within (1e-3, 5e-3, 1e-2) of JAX's, the bounds of
tests/test_torch_fused.py's step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantized_training_tpu import optim as joptim
from quantized_training_tpu import quant as jquant
from quantized_training_tpu import train as jtrain
from quantized_training_tpu.models import llama as jllama
from quantized_training_tpu_torch import ops, optim, train
from quantized_training_tpu_torch.convert import adamw_state_from_jax, params_from_jax
from quantized_training_tpu_torch.models import llama
from quantized_training_tpu_torch.utils.tree import tree_leaves
from test_torch_remat import KNOBS, KW, _batch, _ids, knob  # noqa: F401  (knob: the fixture)

torch.set_num_threads(1)


@pytest.mark.parametrize("knob", [("fused", n) for n in KNOBS], ids=_ids, indirect=True)
def test_train_step_under_policy_vs_jax(knob):
    """One train step (remat, adamw) of each package under the same knob on
    the fused layer from one state: loss, grad norm and every parameter
    within (1e-3, 5e-3, 1e-2) of JAX's, tests/test_torch_fused.py's step
    bounds."""
    save_qkv = KNOBS[knob[1]][1]
    jcfg = jllama.LlamaConfig(**KW, remat=True, attention_impl="xla", save_qkv_residuals=save_qkv)
    cfg = llama.LlamaConfig(**KW, remat=True, attention_impl="xla", save_qkv_residuals=save_qkv)
    jp = jquant.quantize_params(jllama.init_params(jax.random.PRNGKey(0), jcfg), "mixed_precision")
    jopt = joptim.adamw(weight_decay=1e-2)
    jstate = jtrain.init_train_state(jp, jopt)
    np_state = jax.tree.map(np.asarray, jstate)
    tstate = train.TrainState(params_from_jax(np_state.params), adamw_state_from_jax(np_state.opt_state), 0)
    tok, lab = _batch()
    jstate, jm = jtrain.make_train_step(jcfg, jopt, donate=False)(
        jstate, jnp.asarray(tok, jnp.int32), jnp.asarray(lab, jnp.int32), 3e-4, jax.random.PRNGKey(1))
    tstate, tm = train.make_train_step(cfg, optim.adamw(weight_decay=1e-2))(
        tstate, torch.from_numpy(tok), torch.from_numpy(lab), 3e-4, 1)
    jl, tl, jg, tg = float(jm["loss"]), float(tm["loss"]), float(jm["grad_norm"]), float(tm["grad_norm"])
    assert np.isfinite(tl) and abs(tl - jl) <= 1e-3 * abs(jl), (tl, jl)
    assert abs(tg - jg) <= 5e-3 * jg, (tg, jg)
    for a, b in zip(tree_leaves(tstate.params), jax.tree.leaves(jstate.params)):
        b = np.asarray(b, np.float64)
        assert np.linalg.norm(a.double().numpy() - b) <= 1e-2 * np.linalg.norm(b)
    assert ops.sdpa_forwards() == 0  # the CPU's einsum attention
