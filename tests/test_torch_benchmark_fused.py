"""The port's ``benchmark_fused`` and ``benchmark_step_components`` against the
JAX repository's: each chain's fused and unfused outputs against JAX's on the
same inputs, JAX's Pallas kernels in interpret mode (its composites
transcribed from ``benchmark_fused.py:93-141, 187-246``); the traffic models
against JAX's formulas (:123-126, :248-249); the step's dense work against
JAX's ``llama.num_params``; the entry points on the CPU and their
failures."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantized_training_tpu.models import llama as jllama
from quantized_training_tpu.ops import pallas_fused as pf
from quantized_training_tpu.ops import pallas_quant as pq
from quantized_training_tpu.ops import pallas_rope as pr
from quantized_training_tpu.quant.core import quantize_int8_both as jquantize_int8_both
from quantized_training_tpu_torch import benchmark_fused as fused
from quantized_training_tpu_torch import benchmark_step_components as components
from quantized_training_tpu_torch import llm_pretrain
from quantized_training_tpu_torch.convert import params_from_jax
from quantized_training_tpu_torch.models import llama

# One intra-op thread: the suite runs in several worker processes at once,
# and a torch thread pool per worker oversubscribes the cores.
torch.set_num_threads(1)

M, K, F = 256, 256, 512
EPS = 1e-5
CHAINS = fused.chains(M, K, F, "cpu") + fused.round4_chains(M, K, F, "cpu")


def _jax(t: torch.Tensor):
    return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)


def _torch(a) -> torch.Tensor:
    a = np.asarray(a.astype(jnp.float32) if a.dtype == jnp.bfloat16 else a)
    return torch.from_numpy(a.copy())


def jax_chains() -> dict:
    """JAX's composites and fused chains (interpret mode) on the port's
    chains' inputs."""
    (x, g), (a, b) = (tuple(_jax(t) for t in CHAINS[i].args) for i in (0, 2))
    a4, b4, dy4 = (_jax(t) for t in CHAINS[4].args)
    xq, yg = _jax(CHAINS[5].args[0]), _jax(CHAINS[6].args[0])
    B, S, H, KV, hd = 8, M // 8, 32, 4, 64
    inv = 1.0 / (10000.0 ** (jnp.arange(0, hd, 2, jnp.float32) / hd))
    emb = jnp.concatenate([jnp.outer(jnp.arange(S, dtype=jnp.float32), inv)] * 2, -1)
    cos, sin = jnp.cos(emb), jnp.sin(emb)
    c2, s2 = pr.pair_tables(cos, sin)
    row = lambda y: pq.quantize_int8_rowwise(y, interpret=True)
    col = lambda y: pq.quantize_int8_colwise(y, interpret=True)

    def silu_bwd_unfused():
        da, db = pf.silu_mul_bwd_f32(a4, b4, dy4)
        return jquantize_int8_both(da.astype(a4.dtype)) + jquantize_int8_both(db.astype(a4.dtype))

    def silu_bwd_fused():
        r = pf.silu_mul_bwd_quant_rowwise(a4, b4, dy4, interpret=True)
        return r + pf.silu_mul_bwd_quant_colwise(a4, b4, dy4, r[4] * (1 / 127.0), r[5] * (1 / 127.0), interpret=True)

    def out_quant_unfused():
        x2d = pr.rope_ungroup_ref(yg, jnp.ones_like(cos), jnp.zeros_like(sin), KV).reshape(B * S, H * hd)
        return row(x2d)

    def out_quant_fused():
        rows, cols = pr.ungroup_amax(yg, interpret=True)
        return pr.ungroup_quant(yg, rows * (1 / 127.0), axis=1, interpret=True), rows, cols

    return {
        "norm+row": (lambda: row(pf.rms_norm_ref(x, g[0], EPS)),
                     lambda: pf.rmsnorm_quant_rowwise(x, g, norm_eps=EPS, interpret=True)),
        "norm+col": (lambda: col(pf.rms_norm_ref(x, g[0], EPS)),
                     lambda: pf.rmsnorm_quant_colwise(x, g, norm_eps=EPS, interpret=True)),
        "silu+row": (lambda: row(pf.silu_mul_ref(a, b)), lambda: pf.silu_mul_quant_rowwise(a, b, interpret=True)),
        "silu+col": (lambda: col(pf.silu_mul_ref(a, b)), lambda: pf.silu_mul_quant_colwise(a, b, interpret=True)),
        "silu-bwd both-q": (silu_bwd_unfused, silu_bwd_fused),
        "rope+group (q)": (lambda: pr.rope_group_ref(xq, cos, sin, KV),
                           lambda: pr.rope_group_kernel(xq, c2, s2, kv=KV, interpret=True)),
        "ungroup+rope (dq)": (lambda: pr.rope_ungroup_ref(yg, cos, sin, KV, inverse=True),
                              lambda: pr.rope_ungroup_kernel(yg, c2, s2, inverse=True, interpret=True)),
        "attn-out -> int8 row": (out_quant_unfused, out_quant_fused),
    }


def _as_torch(out):
    return tuple(_torch(v) for v in out) if isinstance(out, tuple) else _torch(out)


@pytest.mark.parametrize("chain", CHAINS, ids=[c.name for c in CHAINS])
def test_chain_vs_jax(chain):
    """The port's fused side against JAX's fused kernel and its unfused side
    against JAX's composite, output for output: int8 within one step (XLA's
    CPU rounds the composite's producer in its own order; the fused kernels'
    bar against their fp32 oracle), a bf16 output within one bf16 ulp."""
    ju, jf = (fn() for fn in jax_chains()[chain.name])
    with torch.no_grad():
        tf, tu = chain.fused(*chain.args), chain.unfused(*chain.args)
    ours, theirs = chain.pairs(tf, tu), chain.pairs(_as_torch(jf), _as_torch(ju))
    assert [w for w, _, _ in ours] == [w for w, _, _ in theirs]
    for (what, f, u), (_, jfv, juv) in zip(ours, theirs):
        for mine, ref in ((f, jfv), (u, juv)):
            ref = ref.reshape(mine.shape)
            if mine.dtype == torch.int8:
                assert (mine.int() - ref.int()).abs().max() <= 1, (chain.name, what)
            else:
                assert ((mine.float() - ref).abs() <= 2 ** -7 * ref.abs()).all(), (chain.name, what)


@pytest.mark.parametrize("chain", CHAINS, ids=[c.name for c in CHAINS])
def test_fused_within_the_bound_of_unfused(chain):
    """``gaps``: the fused output within ``STEP_BOUND`` int8 steps of the
    composite's, B13's equal to its plain version."""
    exact = chain.name.startswith(("rope", "ungroup"))
    assert all(g <= (0 if exact else fused.STEP_BOUND) for _, g in fused.gaps(chain))


def test_traffic_models_are_jax_formulas():
    """JAX's models: the first table (n_inputs * passes * 2 + 1) * M * width
    bytes (:123-126), the second (:248-249, :252-258)."""
    width = {"norm+row": (1, K, 1), "norm+col": (1, K, 2), "silu+row": (2, F, 1), "silu+col": (2, F, 2)}
    for c in CHAINS[:4]:
        n_in, w, passes = width[c.name]
        assert c.gbytes == (n_in * passes * 2 + 1) * M * w / 1e9
    B, S, H, hd = 8, M // 8, 32, 64
    gb_silu, gb_rope = 3 * M * F * 2 / 1e9, 2 * B * S * H * hd * 2 / 1e9
    assert [c.gbytes for c in CHAINS[4:]] == [2 * gb_silu + 4 * M * F / 1e9, gb_rope, gb_rope,
                                              gb_rope + B * S * H * hd / 1e9]


def test_fused_entry_point_prints_both_tables(capsys):
    got = fused.main(["--cpu", "--M", str(M), "--K", str(K), "--F", str(F)])
    assert list(got) == [c.name for c in CHAINS] and all(min(v) > 0 for v in got.values())
    tables = [line for line in capsys.readouterr().out.splitlines() if line.startswith("| ")]
    assert tables[0].startswith("| chain | unfused ms | fused ms | speedup | fused GB/s |")
    assert tables[5].startswith("| round-4 chain | unfused ms |") and len(tables) == 10


def test_fused_has_no_fallback(monkeypatch):
    """JAX's script catches nothing: an out-of-memory error propagates."""
    def oom(*a, **k):
        raise torch.OutOfMemoryError("oom")

    monkeypatch.setattr(fused.fp, "rmsnorm_quant_rowwise", oom)
    with pytest.raises(torch.OutOfMemoryError):
        fused.main(["--cpu", "--M", str(M), "--K", str(K), "--F", str(F)])


# ---- benchmark_step_components ----------------------------------------------------

KW = dict(vocab_size=512, hidden_size=256, intermediate_size=512, num_hidden_layers=2,
          num_attention_heads=4, num_key_value_heads=2)


def test_step_flops_vs_jax_num_params():
    """6 x parameters x tokens (JAX :131-133), the parameters counted as
    JAX's ``llama.num_params`` counts them, on JAX's init carried over."""
    jp = jllama.init_params(jax.random.PRNGKey(0), jllama.LlamaConfig(**KW))
    tp = params_from_jax(jax.tree.map(np.asarray, jp))
    assert components.step_flops(tp, 1024) == 6 * jllama.num_params(jp) * 1024


def test_gemm_shapes_are_jax_shapes():
    assert components.gemm_shapes(16384) == [(16384, 2048, 2048), (16384, 2048, 5632), (4096, 4096, 4096)]


@pytest.fixture
def small(monkeypatch):
    monkeypatch.setitem(llm_pretrain.MODELS, "llama2-1b", llama.LlamaConfig(**KW, attention_impl="xla"))
    monkeypatch.setattr(components, "gemm_shapes", lambda T: [(T, 256, 256)])


def test_components_entry_point(small):
    """Every part runs at the small Llama; the variants are JAX's, its two
    int8 backends one (the ops backends are TPU-only)."""
    got = components.main(["--cpu", "--bs", "1", "--seq", "64"])
    assert [tag for tag, _, _ in components.VARIANTS] == ["bf16", "bf16/no-remat", "int8mp"]
    assert list(got["variants"]) == ["bf16", "bf16/no-remat", "int8mp"] and all(got["variants"].values())
    assert set(got["matmul"]) == {((64, 256, 256), "bfloat16"), ((64, 256, 256), "int8")}
    assert got["quantize_int8"][0] > 0


def test_components_failures(small, monkeypatch):
    """A variant out of device memory is printed as failed and the next
    runs; any other error propagates."""
    def run_variant(tag, *a):
        if tag == "bf16/no-remat":
            raise torch.OutOfMemoryError("oom")
        return 1.0, 1.0, 1.0

    monkeypatch.setattr(components, "run_variant", run_variant)
    got = components.main(["--cpu", "--bs", "1", "--seq", "64", "--only_model"])
    assert got["variants"] == {"bf16": (1.0, 1.0, 1.0), "bf16/no-remat": None, "int8mp": (1.0, 1.0, 1.0)}
    assert got["matmul"] == {} and got["quantize_int8"] is None

    def broken(*a):
        raise ValueError("a kernel failed")

    monkeypatch.setattr(components, "run_variant", broken)
    with pytest.raises(ValueError, match="a kernel failed"):
        components.main(["--cpu", "--bs", "1", "--seq", "64", "--only_model"])
