"""The storage schemes through the port's entry points on the CPU: the train
step under every scheme (tests/test_model_train.py::
test_train_step_all_schemes), and serving with int8 and int4 storage
(tests/test_inference.py:91-110) against the JAX package's inference and
the port's own Server. The whole step against the JAX step is
tests/test_torch_train.py::test_train_steps_vs_jax, its launch counts
``test_kernel_calls_per_step_storage`` there.

Tolerances: serving as tests/test_torch_serving.py holds mixed precision
in fp32, 1e-3 of max|logit| on prefill and teacher-forced decode (the int8
values are exact, fp32 sum order differs, which moves an int8 rounding of
an activation or of the KV cache only at a tie); greedy streams of the
port's Server equal to its generate().
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantized_training_tpu import quant as jquant
from quantized_training_tpu.models import llama as jllama
from quantized_training_tpu.models import llama_infer as jinfer
from quantized_training_tpu_torch import optim, quant, train
from quantized_training_tpu_torch.convert import params_from_jax
from quantized_training_tpu_torch.models import llama, llama_infer
from quantized_training_tpu_torch.models.serving import Server

# One intra-op thread: the suite runs in several worker processes at once,
# and a torch thread pool per worker oversubscribes the cores many times
# over (a heavy test here took 10-20x longer that way).
torch.set_num_threads(1)

KW = dict(vocab_size=256, hidden_size=128, intermediate_size=256, num_hidden_layers=2,
          num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=64)


@pytest.mark.parametrize("scheme,kwargs", [
    (None, {}), ("mixed_precision", {}), ("mixed_precision", {"stochastic_rounding": True}),
    ("int8_quantized_training", {"activation": "int8"}), ("int4_weight_only", {}), ("bitnet", {})])
def test_train_step_all_schemes(scheme, kwargs):
    """Five steps of make_train_step with adamw_bf16_sr and clipping at 1.0
    under each scheme, a fresh batch a step: finite losses and grad norms,
    the step counted, the wrappers kept."""
    cfg = llama.LlamaConfig(**KW, bitnet=scheme == "bitnet")
    qparams = quant.quantize_params(llama.init_params(torch.Generator().manual_seed(0), cfg), scheme, **kwargs)
    opt = optim.adamw_bf16_sr()
    state = train.init_train_state(qparams, opt)
    step = train.make_train_step(cfg, opt, clip_grad_norm=1.0)
    for i in range(5):
        rng = np.random.default_rng(100 + i)
        tok = torch.from_numpy(rng.integers(0, KW["vocab_size"], (2, 32)))
        state, m = step(state, tok, torch.roll(tok, -1, 1), 1e-3, i)
        assert np.isfinite(m["loss"].item()) and np.isfinite(m["grad_norm"].item())
    assert state.step == 5
    assert type(state.params["layers"]["q"]["w"]) is type(qparams["layers"]["q"]["w"])


def _both(scheme, dtype=jnp.float32, **kw):
    """One storage for both packages: the JAX quantize, carried over."""
    jcfg, cfg = jllama.LlamaConfig(**KW), llama.LlamaConfig(**KW)
    jp = jquant.quantize_params(jllama.init_params(jax.random.PRNGKey(0), jcfg, dtype=dtype), scheme, **kw)
    return jcfg, cfg, jp, params_from_jax(jax.tree.map(np.asarray, jp))


@pytest.mark.parametrize("scheme,kw", [("int8_quantized_training", {}),
                                       ("int8_quantized_training", {"activation": "int8"}),
                                       ("int4_weight_only", {})])
def test_generate_with_quantized_weights_vs_jax(scheme, kw):
    """test_inference.py::test_generate_with_quantized_weights: prefill and
    four teacher-forced decode steps on int8 (weight-only and int8
    activations) and int4 storage within 1e-3 of JAX's max|logit| (fp32),
    then generate() from the storage: [1, 8] tokens."""
    jcfg, cfg, jp, tp = _both(scheme, **kw)
    rng = np.random.default_rng(0)
    jcache, tcache = jinfer.KVCache.zeros(jcfg, 1, 32), llama_infer.KVCache.zeros(cfg, 1, 32)
    for tk, pos in [(rng.integers(1, 256, (1, 12)), 0)] + [(rng.integers(1, 256, (1, 1)), 12 + i) for i in range(4)]:
        ref, jcache = jinfer.forward_with_cache(jp, jnp.asarray(tk, jnp.int32), jcache, pos, jcfg)
        got = llama_infer.forward_with_cache(tp, torch.from_numpy(tk), tcache, pos, cfg)
        r, g = np.asarray(ref), got.numpy()
        assert np.abs(r - g).max() <= 1e-3 * np.abs(r).max(), (pos, np.abs(r - g).max() / np.abs(r).max())
    out = llama_infer.generate(tp, torch.zeros((1, 4), dtype=torch.long), cfg, 4)
    assert out.shape == (1, 8)


@pytest.mark.parametrize("scheme", ["int8_quantized_training", "bitnet_packed"])
def test_server_streams_match_generate(scheme):
    """The port's Server on int8 storage (int8 activations) and on packed
    BitNet answers requests of two prompt lengths, one joining mid-flight;
    each greedy stream equals generate() on its prompt."""
    cfg = llama.LlamaConfig(**KW, bitnet=scheme == "bitnet_packed")
    raw = llama.init_params(torch.Generator().manual_seed(1), cfg, dtype=torch.float32)
    if scheme == "bitnet_packed":
        params = quant.quantize_params(raw, "bitnet")
        params = {**params, "layers": {k: {n: quant.BitNetPackedWeight.from_weight(w.data)
                                           if isinstance(w, quant.BitNetWeight) else w for n, w in v.items()}
                                       for k, v in params["layers"].items()}}
    else:
        params = quant.quantize_params(raw, scheme, activation="int8")
    srv = Server(params, cfg, n_slots=2, max_len=64, decode_chunk=4)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(1, 256, 7).tolist(), rng.integers(1, 256, 19).tolist(), rng.integers(1, 256, 3).tolist()]
    rids = [srv.add_request(prompts[0], 6), srv.add_request(prompts[1], 5)]
    srv.step()
    rids.append(srv.add_request(prompts[2], 4))
    while srv.pending():
        srv.step()
    for prompt, rid in zip(prompts, rids):
        got = srv.result(rid)
        ref = llama_infer.generate(params, torch.tensor([prompt]), cfg, len(got))[0, len(prompt):].tolist()
        assert got == ref
