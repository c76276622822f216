"""The port's ``benchmark_serving`` and ``benchmark_inference`` against the
JAX repository's: the mixed request set token for token, the windowed,
full-window and static baseline's token counts, windows and batches at a
tiny model from JAX's weights, each static row against the server on its
padded prompt; inference's JSON line against JAX's, and its
greedy tokens against JAX's ``generate``; the entry points on the CPU and
their failures."""

import argparse
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import benchmark_inference as jinference
import benchmark_serving as jserving_bench
from quantized_training_tpu.models import llama as jllama
from quantized_training_tpu.models import llama_infer as jinfer
from quantized_training_tpu.models import serving as jserving
from quantized_training_tpu_torch import benchmark_inference as inference
from quantized_training_tpu_torch import benchmark_serving as serving
from quantized_training_tpu_torch import llm_pretrain
from quantized_training_tpu_torch.convert import params_from_jax
from quantized_training_tpu_torch.models import llama
from quantized_training_tpu_torch.models.serving import Server

# One intra-op thread: the suite runs in several worker processes at once,
# and a torch thread pool per worker oversubscribes the cores.
torch.set_num_threads(1)

BUDGETS = (3, 5, 7, 9)  # the mixed load's budgets (64, 160, 320, 448), cut for the CPU
KW = dict(vocab_size=512, hidden_size=256, intermediate_size=512, num_hidden_layers=2,
          num_attention_heads=4, num_key_value_heads=2)


@pytest.mark.parametrize("vocab", [32000, 256])
def test_mixed_requests_are_jax_token_for_token(vocab):
    assert serving._mixed_requests(24, vocab) == jserving_bench._mixed_requests(24, vocab)
    assert (serving.MIX_PROMPTS, serving.MIX_BUDGETS) == (jserving_bench.MIX_PROMPTS, jserving_bench.MIX_BUDGETS)


def test_tiny_is_jax_tiny():
    jtiny = jllama.LlamaConfig(vocab_size=256, hidden_size=128, intermediate_size=256, num_hidden_layers=2,
                               num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=1024)
    assert {f: getattr(serving.tiny(1024), f) for f in vars(jtiny)} == vars(jtiny)


@pytest.fixture
def tiny(monkeypatch):
    """JAX's tiny config and weights for both packages, both drivers' mixed
    budgets cut to BUDGETS."""
    monkeypatch.setattr(serving, "MIX_BUDGETS", BUDGETS)
    monkeypatch.setattr(jserving_bench, "MIX_BUDGETS", BUDGETS)
    cfg, jcfg = serving.tiny(1024), jllama.LlamaConfig(**vars(serving.tiny(1024)))
    jp = jllama.init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, jp, cfg, params_from_jax(jax.tree.map(np.asarray, jp))


@pytest.mark.parametrize("windows", [None, (1024,)], ids=["windowed", "full-window"])
def test_server_drains_equal_jax(tiny, windows):
    """The mixed load (3 x 4 requests) through JAX's server and the port's:
    the same tokens streamed and the same (window, tokens a call) decode
    steps made."""
    jcfg, jp, cfg, tp = tiny
    reqs = serving._mixed_requests(12, cfg.vocab_size)
    jsrv = jserving.Server(jp, jcfg, n_slots=4, max_len=1024, window_buckets=windows, decode_chunk=16)
    srv = Server(tp, cfg, n_slots=4, max_len=1024, window_buckets=windows, decode_chunk=16)
    assert serving.drain_mixed(srv, reqs) == jserving_bench.drain_mixed(jsrv, reqs) == sum(b for _, b in reqs)
    assert sorted(srv._decode_fns) == sorted(jsrv._decode_fns)


def test_static_baseline_equals_jax(tiny, monkeypatch):
    """JAX's static batched generate and the port's over the mixed load: the
    same left-padded batches, each run to the largest budget (the same
    count of generated tokens)."""
    jcfg, jp, cfg, tp = tiny
    args = argparse.Namespace(n_slots=4, max_len=1024, decode_chunk=16)
    seen, generate = [], jinfer.generate

    def recorded(params, prompt, cfg, n, **kw):
        out = generate(params, prompt, cfg, n, **kw)
        seen.append((np.asarray(prompt), out.shape))
        return out

    monkeypatch.setattr(jinfer, "generate", recorded)
    jserving_bench.measure_static_generate(jp, jcfg, args)
    tok_s, outs = serving.measure_static_generate(tp, cfg, args)
    batches = serving.static_batches(serving._mixed_requests(12, cfg.vocab_size), 4, "cpu")
    assert len(seen) == 2 * len(batches) == 2 * len(outs) == 6 and tok_s > 0
    for (jbatch, jshape), batch, out in zip(seen[len(batches):], batches, outs):
        assert np.array_equal(jbatch, batch.numpy()) and tuple(out.shape) == tuple(jshape) == (4, 480 + max(BUDGETS))
        assert torch.equal(out[:, :480], batch)


def test_static_rows_are_the_servers_on_their_padded_prompts(tiny):
    """Each row of the static baseline continues its left-padded prompt as
    the server does given that same prompt (the pads are tokens attended
    to): the first ``budget`` tokens equal (chip_smoke.py phase 4 holds
    the card to it, up to a near-tie)."""
    _, _, cfg, tp = tiny
    args = argparse.Namespace(n_slots=4, max_len=1024, decode_chunk=16)
    reqs = serving._mixed_requests(12, cfg.vocab_size)
    _, outs = serving.measure_static_generate(tp, cfg, args)
    rows = [row.tolist() for batch in serving.static_batches(reqs, 4, "cpu") for row in batch]
    srv = Server(tp, cfg, n_slots=4, max_len=1024)
    rids = [srv.add_request(row, budget) for row, (_, budget) in zip(rows, reqs)]
    while srv.pending():
        srv.step()
    for i, ((_, budget), rid) in enumerate(zip(reqs, rids)):
        assert outs[i // 4][i % 4, 480:480 + budget].tolist() == srv.result(rid), i


def test_entry_point_mixed_and_uniform(tiny, capsys):
    got = serving.main(["--cpu", "--model", "tiny", "--load", "mixed", "--n_slots", "4", "--max_len", "1024"])
    assert {"windowed", "full", "static", "windows", "static_tokens"} <= set(got)
    assert min(got["windowed"], got["full"], got["static"]) > 0
    got = serving.main(["--cpu", "--model", "tiny", "--n_slots", "2", "--max_len", "256", "--new_tokens", "5"])
    assert got["windowed"] > 0 and got["full"] > 0 and got["windows"][0][0] == 128
    err = capsys.readouterr().err
    assert "windowed server (mixed load)" in err and "windowed / full = " in err


def test_serving_has_no_fallback(monkeypatch):
    """JAX's serving script catches nothing: an out-of-memory error
    propagates as any other."""
    def oom(*a):
        raise torch.OutOfMemoryError("oom")

    monkeypatch.setattr(serving, "measure_mixed", oom)
    with pytest.raises(torch.OutOfMemoryError):
        serving.main(["--cpu", "--model", "tiny", "--load", "mixed"])


# ---- benchmark_inference ----------------------------------------------------------


@pytest.fixture
def small(monkeypatch):
    monkeypatch.setattr(jllama, "LLAMA2_1B", jllama.LlamaConfig(**KW))
    monkeypatch.setitem(llm_pretrain.MODELS, "llama2-1b", llama.LlamaConfig(**KW))


def test_inference_line_equals_jax(small, monkeypatch, capsys):
    """JAX's main and the port's on the same flags print the same keys,
    batches and settings (the rates aside)."""
    flags = ["--bs", "1", "2", "--prompt_len", "8", "--new_tokens", "3", "--quantize", "mixed_precision"]
    monkeypatch.setattr(sys, "argv", ["benchmark_inference.py", *flags])
    jinference.main()
    jline = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    line = inference.main(["--cpu", *flags])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == line
    assert list(line) == list(jline) and {k: line[k] for k in line if k != "results"} == \
        {k: jline[k] for k in jline if k != "results"}
    assert [list(r) for r in line["results"]] == [list(r) for r in jline["results"]]
    assert [r["batch"] for r in line["results"]] == [r["batch"] for r in jline["results"]] == [1, 2]


@pytest.mark.parametrize("scheme", [None, "mixed_precision"])
def test_greedy_tokens_equal_jax(scheme):
    """``timed_generate`` on JAX's fp32 weights carried over, against JAX's
    ``generate`` on a prompt from a numpy seed: the same greedy tokens."""
    from quantized_training_tpu import quant as jquant
    from quantized_training_tpu_torch import quant

    jcfg, cfg = jllama.LlamaConfig(**KW, max_position_embeddings=24), llama.LlamaConfig(**KW, max_position_embeddings=24)
    jp = jllama.init_params(jax.random.PRNGKey(0), jcfg, dtype=jnp.float32)
    tp = quant.quantize_params(params_from_jax(jax.tree.map(np.asarray, jp)), scheme)
    prompt = np.random.default_rng(1).integers(0, KW["vocab_size"], (2, 16))
    want = np.asarray(jinfer.generate(jquant.quantize_params(jp, scheme), jnp.asarray(prompt, jnp.int32), jcfg, 8))
    out, dt = inference.timed_generate(tp, torch.from_numpy(prompt), cfg, 8)
    assert dt > 0 and np.array_equal(out.numpy(), want)


def test_inference_failures(small, monkeypatch):
    """A batch out of device memory is left out (JAX's catch-all, narrowed);
    any other error propagates."""
    def timed(params, prompt, cfg, n):
        if prompt.shape[0] == 2:
            raise torch.OutOfMemoryError("oom")
        return None, 1.0

    monkeypatch.setattr(inference, "timed_generate", timed)
    line = inference.main(["--cpu", "--bs", "1", "2", "3", "--prompt_len", "4", "--new_tokens", "2"])
    assert [r["batch"] for r in line["results"]] == [1, 3]

    def broken(*a):
        raise ValueError("a kernel failed")

    monkeypatch.setattr(inference, "timed_generate", broken)
    with pytest.raises(ValueError, match="a kernel failed"):
        inference.main(["--cpu", "--bs", "1", "--prompt_len", "4", "--new_tokens", "2"])
