"""The port's Llama inference and continuous-batching server against the JAX
package's (models/llama.py, llama_infer.py, serving.py), and the port's
Server against its own generate() (mirrors tests/test_serving.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantized_training_tpu import quant as jquant
from quantized_training_tpu.models import llama as jllama
from quantized_training_tpu.models import llama_infer as jinfer
from quantized_training_tpu.models import serving as jserving
from quantized_training_tpu_torch import quant
from quantized_training_tpu_torch.convert import params_from_jax
from quantized_training_tpu_torch.models import llama, llama_infer
from quantized_training_tpu_torch.models.serving import Server

# One intra-op thread: the suite runs in several worker processes at once,
# and a torch thread pool per worker oversubscribes the cores many times
# over (a heavy test here took 10-20x longer that way).
torch.set_num_threads(1)

KW = dict(vocab_size=256, hidden_size=128, intermediate_size=256, num_hidden_layers=2,
          num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=64)
JCFG, CFG = jllama.LlamaConfig(**KW), llama.LlamaConfig(**KW)
_JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}


def _both_params(dtype="f32", scheme="mixed_precision"):
    """One set of weights for both packages: the JAX init, carried over
    through params_from_jax, then quantized by each package's own API."""
    jp = jllama.init_params(jax.random.PRNGKey(0), JCFG, dtype=_JDT[dtype])
    tp = params_from_jax(jax.tree.map(np.asarray, jp))
    return jquant.quantize_params(jp, scheme), quant.quantize_params(tp, scheme)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def test_params_from_jax_round_trip():
    """Same names, shapes, dtypes and values (bf16 passes exactly through
    fp32); the port's own init gives the same tree of shapes."""
    jp = jllama.init_params(jax.random.PRNGKey(0), JCFG)
    np_tree = jax.tree.map(np.asarray, jp)
    tp = params_from_jax(np_tree)
    flat_j = dict(jax.tree_util.tree_flatten_with_path(np_tree)[0])
    for path, a in flat_j.items():
        t = tp
        for p in path:
            t = t[p.key]
        assert t.dtype == torch.bfloat16 and tuple(t.shape) == a.shape
        np.testing.assert_array_equal(t.float().numpy(), a.astype(np.float32))
    own = llama.init_params(torch.Generator().manual_seed(0), CFG)
    shapes = lambda tree: {k: shapes(v) if isinstance(v, dict) else tuple(v.shape) for k, v in tree.items()}
    assert shapes(own) == shapes(tp)


def test_rms_norm_and_rope_match_jax():
    """fp32 math on both sides: rms_norm and the rope tables within a few
    fp32 ulps (sum order, pow/cos/sin implementations); the bf16 rotation
    within one bf16 ulp of the rotated values."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 12, 128)).astype(np.float32)
    g = (1 + 0.1 * rng.standard_normal(128)).astype(np.float32)
    for jdt, tdt in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        ref = jllama.rms_norm(jnp.asarray(x, jdt), jnp.asarray(g, jdt), 1e-5)
        got = llama.rms_norm(torch.from_numpy(x).to(tdt), torch.from_numpy(g).to(tdt), 1e-5)
        assert got.dtype == tdt
        tol = 1e-6 if tdt == torch.float32 else 2 ** -7
        np.testing.assert_allclose(_f32(got), _f32(ref), rtol=tol, atol=tol)
    cj, sj = jllama.rope_tables(JCFG, 64)
    ct, st = llama.rope_tables(CFG, 64)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=0, atol=2e-7)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=0, atol=2e-7)
    q = rng.standard_normal((2, 12, 4, 32)).astype(np.float32)
    for jdt, tdt, tol in ((jnp.float32, torch.float32, 1e-6), (jnp.bfloat16, torch.bfloat16, 2 ** -7)):
        ref = jllama.apply_rope(jnp.asarray(q, jdt), cj[:12], sj[:12])
        got = llama.apply_rope(torch.from_numpy(q).to(tdt), ct[:12], st[:12])
        np.testing.assert_allclose(_f32(got), _f32(ref), rtol=tol, atol=tol)
    # a per-sequence position table ([B, S, hd]) rotates like the shared one
    per_seq = llama.apply_rope(torch.from_numpy(q), ct[:12].expand(2, 12, 32), st[:12].expand(2, 12, 32))
    torch.testing.assert_close(per_seq, llama.apply_rope(torch.from_numpy(q), ct[:12], st[:12]), rtol=0, atol=0)


def test_causal_attention_matches_jax_einsum():
    """Both fp32 scores and softmax: within fp32 rounding."""
    rng = np.random.default_rng(1)
    q, k, v = (rng.standard_normal(s).astype(np.float32) for s in ((2, 12, 4, 32), (2, 12, 2, 32), (2, 12, 2, 32)))
    ref = jllama.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), "xla")
    got = llama.attention(*(torch.from_numpy(a) for a in (q, k, v)))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-6)


@pytest.mark.parametrize("dtype,tol", [("f32", 1e-3), ("bf16", 3e-2)])
def test_forward_with_cache_teacher_forced(dtype, tol):
    """Prefill of 12 tokens then 4 teacher-forced decode steps, batch 2.

    Tolerance, relative to max|logit|: f32 1e-3 — the int8 values are bit
    exact, so only fp32 sum order differs, unless it moves an activation
    across an int8 rounding boundary; bf16 3e-2 — XLA keeps some bf16
    intermediates in fp32 (excess precision) where torch rounds each op,
    which flips int8 roundings of activations by 1 LSB.
    In f32 the int8 KV caches agree to 1 LSB on at most 1% of entries (the
    same boundary effect) and the bf16 scales to one bf16 ulp."""
    jp, tp = _both_params(dtype)
    rng = np.random.default_rng(0)
    toks = rng.integers(1, 256, (2, 12))
    jcache = jinfer.KVCache.zeros(JCFG, 2, 32)
    tcache = llama_infer.KVCache.zeros(CFG, 2, 32)
    steps = [(toks, 0)] + [(rng.integers(1, 256, (2, 1)), 12 + i) for i in range(4)]
    for tk, pos in steps:
        ref, jcache = jinfer.forward_with_cache(jp, jnp.asarray(tk, jnp.int32), jcache, pos, JCFG)
        got = llama_infer.forward_with_cache(tp, torch.from_numpy(tk), tcache, pos, CFG)
        assert got.shape == tuple(ref.shape)
        assert got.dtype == (torch.float32 if dtype == "f32" else torch.bfloat16)
        r, g = _f32(ref), _f32(got)
        assert np.abs(r - g).max() <= tol * np.abs(r).max(), (pos, np.abs(r - g).max() / np.abs(r).max())
        assert (r.argmax(-1) == g.argmax(-1)).mean() >= 0.9
    if dtype == "f32":
        for name in ("k", "v"):
            d = np.abs(np.asarray(getattr(jcache, name), np.int32) - getattr(tcache, name).numpy().astype(np.int32))
            assert d.max() <= 1 and (d > 0).mean() <= 0.01
            sj, st = _f32(getattr(jcache, name + "_scale")), _f32(getattr(tcache, name + "_scale"))
            np.testing.assert_allclose(st, sj, rtol=2 ** -8, atol=0)


def _first_mismatch(a, b):
    return next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)


def test_server_greedy_streams_match_jax_server_f32():
    """Both servers take the same requests (two joining mid-flight). Their
    greedy streams must be equal, except that a stream may part from the
    JAX one at a step where the JAX logits' top-2 margin is below 1e-3 of
    max|logit| (the f32 logit tolerance above): there the argmax is a
    near-tie that rounding may decide either way; the streams are compared
    up to that step only."""
    jp, tp = _both_params("f32")
    reqs = [([3, 14, 15, 92, 6, 53], 12), ([101, 7, 55, 21, 91, 87, 60, 35, 68, 11], 9),
            ([9, 10], 20), ([42, 43, 44, 45, 46], 7)]
    runs = []
    for srv in (jserving.Server(jp, JCFG, n_slots=3, max_len=64), Server(tp, CFG, n_slots=3, max_len=64)):
        rids = [srv.add_request(p, b) for p, b in reqs[:2]]
        srv.step()
        rids += [srv.add_request(p, b) for p, b in reqs[2:]]
        while srv.pending():
            srv.step()
        runs.append([srv.result(r) for r in rids])
    for (prompt, budget), ref, got in zip(reqs, *runs):
        assert len(got) == len(ref) == budget
        j = _first_mismatch(ref, got)
        if j is None:
            continue
        seq = jnp.asarray([prompt + ref[:j]], jnp.int32)
        logits, _ = jinfer.forward_with_cache(jp, seq, jinfer.KVCache.zeros(JCFG, 1, 64), 0, JCFG)
        top2 = np.sort(np.asarray(logits[0, -1]))[-2:]
        assert top2[1] - top2[0] < 1e-3 * np.abs(np.asarray(logits[0, -1])).max(), (prompt, j)


def _params():
    return quant.quantize_params(llama.init_params(torch.Generator().manual_seed(0), CFG), "mixed_precision")


def _ref_generate(params, prompt_list, n_new):
    out = llama_infer.generate(params, torch.tensor([prompt_list]), CFG, n_new)
    return out[0, len(prompt_list):].tolist()


def test_generate_sampled_uses_the_generator():
    """temperature > 0 draws from the given generator: same seed, same
    tokens; and a generator is required."""
    params = _params()
    prompt = torch.tensor([[3, 14, 15, 92]])
    a = llama_infer.generate(params, prompt, CFG, 6, temperature=1.0, generator=torch.Generator().manual_seed(5))
    b = llama_infer.generate(params, prompt, CFG, 6, temperature=1.0, generator=torch.Generator().manual_seed(5))
    assert torch.equal(a, b) and a.shape == (1, 10)
    with pytest.raises(ValueError, match="generator"):
        llama_infer.generate(params, prompt, CFG, 2, temperature=1.0)


def test_server_single_request_matches_generate():
    params = _params()
    prompt = [3, 14, 15, 92, 6, 53]
    ref = _ref_generate(params, prompt, 8)
    srv = Server(params, CFG, n_slots=4, max_len=64)
    rid = srv.add_request(prompt, max_new_tokens=8)
    events = []
    while srv.pending():
        events.extend(srv.step())
    assert srv.result(rid) == ref
    assert [t for r, t in events if r == rid] == ref  # the first token streams too


def test_server_concurrent_requests_isolated():
    params = _params()
    p1 = [3, 14, 15, 92, 6, 53]
    p2 = [101, 7, 55, 21, 91, 87, 60, 35, 68, 11]
    srv = Server(params, CFG, n_slots=4, max_len=64)
    r1 = srv.add_request(p1, max_new_tokens=6)
    r2 = srv.add_request(p2, max_new_tokens=6)
    while srv.pending():
        srv.step()
    assert srv.result(r1) == _ref_generate(params, p1, 6)
    assert srv.result(r2) == _ref_generate(params, p2, 6)


def test_server_admission_mid_flight_and_queue():
    """A request admitted while another decodes (and one queued behind a
    full pool) does not disturb it, and each matches its reference."""
    params = _params()
    p1, p2, p3 = [3, 14, 15, 92, 6, 53], [101, 7, 55, 21], [9, 10]
    srv = Server(params, CFG, n_slots=2, max_len=64)
    r1 = srv.add_request(p1, max_new_tokens=8)
    srv.step()
    srv.step()  # r1 partway through
    r2 = srv.add_request(p2, max_new_tokens=5)
    r3 = srv.add_request(p3, max_new_tokens=4)  # queued: both slots busy
    assert len(srv._queue) == 1
    while srv.pending():
        srv.step()
    assert srv.result(r1) == _ref_generate(params, p1, 8)
    assert srv.result(r2) == _ref_generate(params, p2, 5)
    assert srv.result(r3) == _ref_generate(params, p3, 4)


def test_server_chunked_decode_and_mid_chunk_eos():
    """decode_chunk 16 is token-identical to single steps and to generate()
    across window buckets; an EOS inside a chunk truncates the stream there
    and frees the slot for the queued request."""
    params = _params()
    prompt = [3, 14, 15, 92, 6, 53]
    n_new = 23  # not a power of two: exercises the chunk ladder 16/4/2/1
    ref = _ref_generate(params, prompt, n_new)
    for chunk in (1, 16):
        srv = Server(params, CFG, n_slots=2, max_len=64, decode_chunk=chunk, window_buckets=(16, 32, 64))
        rid = srv.add_request(prompt, max_new_tokens=n_new)
        while srv.pending():
            srv.step()
        assert srv.result(rid) == ref
        # positions reach 6 + 23 = 29: single steps cross window 16 -> 32,
        # a first chunk of 16 already needs the 32-row window
        assert {w for w, _ in srv._decode_fns} == ({16, 32} if chunk == 1 else {32})
    eos = ref[2]
    srv = Server(params, CFG, n_slots=1, max_len=64, decode_chunk=16, eos_token=eos)
    ra = srv.add_request(prompt, max_new_tokens=n_new)
    rb = srv.add_request(prompt, max_new_tokens=5)  # queued
    while srv.pending():
        srv.step()
    assert srv.result(ra) == ref[: ref.index(eos) + 1]
    assert srv.result(rb) and len(srv.result(rb)) <= 5


def test_server_rejects_oversized_prompt():
    srv = Server(_params(), CFG, n_slots=2, max_len=32)
    with pytest.raises(ValueError, match="exceeds limit 31"):
        srv.add_request(list(range(32)), max_new_tokens=4)
    with pytest.raises(ValueError):
        srv.add_request([], max_new_tokens=4)
