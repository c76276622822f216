"""Kernel-level ops of the port.

Counterpart of ``quantized_training_tpu/ops/__init__.py``. Hand-written CUDA
kernels, each with a plain PyTorch version that CPU tensors take:

- K1 :func:`quantize_int8_rowwise` (``csrc/int8_quant.cu``), replacing
  ``ops/pallas_quant.py::quantize_int8_rowwise``; on the persistent row
  walk again in ``quantize_int8_rowwise_sm90`` (and ``_sr_sm90``);
- B4 :func:`quantize_int8_colwise` (``csrc/int8_quant.cu``), replacing
  ``ops/pallas_quant.py::quantize_int8_colwise``; on thread-block clusters
  again in ``quantize_int8_colwise_sm90`` (and ``_sr_sm90``);
- B5 :func:`quantize_int8_both` (``csrc/int8_quant.cu``), replacing
  ``ops/pallas_quant.py::quantize_int8_both``;
- the mesh forms of K1, B4 and B5 (``csrc/int8_quant.cu``): each quantize
  as a maxima form and a given-maxima form, for a mesh that all-reduces the
  maxima between them (``quantize_int8_rowwise_maxima`` / ``..._given``;
  ``quantize_int8_colwise_maxima`` and ``quantize_int8_both_maxima``, each
  with ``quantize_int8_colwise_given``);
- K2 :func:`scaled_mm_rhs_t` (``csrc/scaled_mm.cu``), replacing
  ``ops/pallas_mm.py::scaled_mm_dims`` with dims (1, 1); above the decode
  sizes on the TMA + wgmma mainloop again in ``scaled_mm_rhs_t_sm90``, at
  them on the split-K weight stream in ``scaled_mm_rhs_t_decode``;
- B1 :func:`scaled_mm` (``csrc/scaled_mm.cu``), replacing
  ``ops/pallas_mm.py::scaled_mm``;
- B2 :func:`scaled_mm_lhs_t` (``csrc/scaled_mm.cu``), replacing
  ``ops/pallas_mm.py::scaled_mm_dims`` with dims (0, 0);
- B15 :func:`tile_scaled_mm` (``csrc/tile_scaled_mm.cu``), the tile-scaled
  two-accumulator GEMM on int8 or e4m3 operands, replacing
  ``ops/pallas_mm.py::tile_scaled_mm``: fp8 ``mixed_precision`` with
  ``scale='tile'``;
- B16 :func:`scaled_int4_mm` (``csrc/scaled_mm.cu``), the packed-int4 GEMM
  that unpacks on chip, replacing
  ``ops/pallas_mm.py::scaled_int4_mm``: int4 ``mixed_precision``;
- B6 :func:`fused_adamw_update` (``csrc/fused_adamw.cu``), replacing
  ``ops/pallas_optim.py::fused_adamw_update``;
- B7 :func:`rmsnorm_quant_rowwise`, B8 :func:`rmsnorm_quant_colwise`, B9
  :func:`silu_mul_quant_rowwise` and :func:`silu_mul_quant_colwise`, and B10
  :func:`rmsnorm_bwd` (``csrc/fused_producers.cu``), replacing the functions
  of the same names in ``ops/pallas_fused.py``: RMSNorm and silu(a) * b run
  inside the int8 quantizes, and the RMSNorm backward in one pass; B7, B8
  given scales, B9's row form and its given-scales column form, and B10 on
  the persistent row walk again in ``rmsnorm_quant_rowwise_sm90``,
  ``rmsnorm_quant_colwise_sm90``, ``silu_mul_quant_rowwise_sm90``,
  ``silu_mul_quant_colwise_sm90`` (and ``_sr_sm90``) and
  ``rmsnorm_bwd_sm90``;
- B11 :func:`silu_mul_bwd_quant_rowwise` and B12
  :func:`silu_mul_bwd_quant_colwise` (``csrc/fused_producers.cu``), the
  silu backward inside the quantizes of (dgate, dup), replacing the
  functions of the same names in ``ops/pallas_fused.py``; B11 and B12
  given scales on the persistent row walk again in
  ``silu_mul_bwd_quant_rowwise_sm90`` and
  ``silu_mul_bwd_quant_colwise_sm90`` (and ``_sr_sm90``);
- B13 :func:`rope_group_kernel` / :func:`rope_ungroup_kernel` and B14
  :func:`ungroup_amax` / :func:`ungroup_quant` (``csrc/rope.cu``), RoPE with
  grouped-query head grouping and the attention output's ungrouping inside
  its int8 quantize, replacing the functions of the same names in
  ``ops/pallas_rope.py``;
- B18 :func:`layernorm_quant` and :func:`gelu_quant`
  (``csrc/fused_producers.cu``), affine LayerNorm or tanh-GELU inside the
  int8 quantize along rows or columns, replacing
  ``ops/pallas_fused.py::_producer_quant_call`` through its
  ``layernorm_quant`` and ``gelu_quant``: the ViT's fused linears; each form
  counts apart (``layernorm_quant_rowwise``, ``layernorm_quant_colwise``,
  ``gelu_quant_rowwise``, ``gelu_quant_colwise``), the row forms and the
  given-scales column forms on the persistent row walk again (``..._sm90``,
  ``..._sr_sm90``);
- B17 :func:`matmul` (``csrc/matmul.cu``), the plain tiled matmul (bf16 ->
  fp32 accumulator -> fp32 or bf16, int8 -> int32), replacing
  ``ops/pallas_mm.py::matmul``: ``benchmark_mm``'s ``pallas_bf16`` row; the
  forms count apart (``matmul`` bf16, ``matmul_s8`` int8), and those on the
  sm90 mainloop again (``matmul_sm90``, ``matmul_s8_sm90``);
- B19 :func:`int8_flash_fwd` (``csrc/int8_attention.cu``), the causal int8
  flash-attention forward, with its input quantize :func:`quantize_qkv` and
  oracle :func:`attention_ref`, replacing
  ``ops/int8_attention.py::int8_flash_fwd``: an op, wired into no model, as
  in the JAX package; its launches on the sm90 design (TMA, wgmma) count
  again (``int8_flash_fwd_sm90``).

The JAX package's other ops, on those kernels or in plain torch:

- :mod:`conv`: :func:`conv2d` (plain ``F.conv2d`` on floats),
  :func:`int8_conv2d` (im2col, then B17's int8 form) and
  :func:`scaled_int8_conv2d` (im2col, then K2 with the channel scale as its
  column scale), NHWC / HWIO as in the JAX package; :func:`int8_mm` is B17's
  int8 form;
- :mod:`mx`: the MX and NVFP4 quantizes, dequantizes and scale layouts in
  plain torch, bit for bit with the JAX package's, and the block-scaled
  products :func:`mxfp4_mm` / :func:`nvfp4_mm` on B17's bf16 form;
- :mod:`fp8`: the e4m3 quantizes (row, 1 x 128 tile, 128 x 128 block) and
  the fp8 products, plain torch.

:func:`sdpa.sdpa` is PyTorch's fused attention (the counterpart of the JAX
package's splash kernel) through an ``autograd.Function`` that keeps its
out and log-sum-exp for the remat policy (:mod:`remat`); not a kernel of
the port, so not in :data:`KERNELS`: its forward launches on a card have a
counter of their own, :func:`sdpa_forwards`.

K1, B4, B5, B7, B8, B9, B11, B12, B14's quantize and B18 also have a
stochastic-rounding form, and B6 an SR writeback,
drawn from the Philox stream of ``random.py`` (``csrc/philox.cuh``). The
int4 and fp8 quantizes (``quant/core.py``, :mod:`fp8`) and the fp8
row-scaled product are plain torch on every device, as XLA ran them.

Each wrapper counts its kernel launches (:func:`launch_counts`), an SR form
apart from its plain form, so a run can show that its path went through the
kernels and which form ran. A CUDA graph's replay runs no wrapper: the
graph (``utils/graphs.py``) keeps the counts its capture added
(:func:`launch_totals`) and adds them again at each replay
(:func:`add_launch_counts`). Importing this package builds nothing: the
kernels compile at their first launch (``ops/_build.py``).
"""

from . import conv, fp8, mx, random
from .conv import conv2d, int8_conv2d, scaled_int8_conv2d
from .fp8 import fp8_mm, quantize_fp8, quantize_fp8_block, quantize_fp8_tile, scaled_fp8_mm
from .fused_adamw import fused_adamw_plain, fused_adamw_update
from .fused_producers import (
    gelu_quant,
    gelu_quant_colwise,
    gelu_quant_plain,
    gelu_quant_rowwise,
    layernorm_quant,
    layernorm_quant_colwise,
    layernorm_quant_plain,
    layernorm_quant_rowwise,
    rmsnorm_bwd,
    silu_mul_bwd_quant_colwise,
    silu_mul_bwd_quant_colwise_plain,
    silu_mul_bwd_quant_rowwise,
    silu_mul_bwd_quant_rowwise_plain,
    rmsnorm_bwd_plain,
    rmsnorm_quant_colwise,
    rmsnorm_quant_colwise_plain,
    rmsnorm_quant_rowwise,
    rmsnorm_quant_rowwise_plain,
    silu_mul_quant_colwise,
    silu_mul_quant_colwise_plain,
    silu_mul_quant_rowwise,
    silu_mul_quant_rowwise_plain,
)
from .int4_mm import int4_mm, scaled_int4_mm, scaled_int4_mm_plain, unpack_int4
from .int8_attention import attention_ref, int8_flash_fwd, int8_flash_fwd_plain, quantize_qkv
from .int8_quant import (
    quantize_int8_both,
    quantize_int8_both_maxima,
    quantize_int8_both_plain,
    quantize_int8_colwise,
    quantize_int8_colwise_given,
    quantize_int8_colwise_maxima,
    quantize_int8_maxima_plain,
    quantize_int8_plain,
    quantize_int8_rowwise,
    quantize_int8_rowwise_given,
    quantize_int8_rowwise_maxima,
)
from .matmul import int8_mm, matmul, matmul_plain
from .mx import (
    dequantize_mxfp4,
    dequantize_nvfp4,
    mxfp4_mm,
    nvfp4_mm,
    pack_block_scales_nv,
    quantize_mx,
    quantize_nvfp4,
)
from .rope import (
    rope_group_kernel,
    rope_group_ref,
    rope_ungroup_kernel,
    rope_ungroup_ref,
    ungroup_amax,
    ungroup_amax_plain,
    ungroup_quant,
    ungroup_quant_plain,
)
from .scaled_mm import (
    scaled_mm,
    scaled_mm_general,
    scaled_mm_lhs_t,
    scaled_mm_lhs_t_plain,
    scaled_mm_plain,
    scaled_mm_ref,
    scaled_mm_rhs_t,
    scaled_mm_rhs_t_plain,
)
from .tile_scaled_mm import tile_scaled_mm, tile_scaled_mm_plain
from . import sdpa

# counter name -> (wrapper, the attribute it counts in)
KERNELS = {
    "quantize_int8_rowwise": (quantize_int8_rowwise, "launches"),
    "quantize_int8_rowwise_sr": (quantize_int8_rowwise, "sr_launches"),
    "quantize_int8_rowwise_sm90": (quantize_int8_rowwise, "sm90_launches"),
    "quantize_int8_rowwise_sr_sm90": (quantize_int8_rowwise, "sr_sm90_launches"),
    "quantize_int8_colwise": (quantize_int8_colwise, "launches"),
    "quantize_int8_colwise_sr": (quantize_int8_colwise, "sr_launches"),
    "quantize_int8_colwise_sm90": (quantize_int8_colwise, "sm90_launches"),
    "quantize_int8_colwise_sr_sm90": (quantize_int8_colwise, "sr_sm90_launches"),
    "quantize_int8_both": (quantize_int8_both, "launches"),
    "quantize_int8_both_sr": (quantize_int8_both, "sr_launches"),
    "quantize_int8_rowwise_maxima": (quantize_int8_rowwise_maxima, "launches"),
    "quantize_int8_rowwise_maxima_sm90": (quantize_int8_rowwise_maxima, "sm90_launches"),
    "quantize_int8_rowwise_given": (quantize_int8_rowwise_given, "launches"),
    "quantize_int8_rowwise_given_sr": (quantize_int8_rowwise_given, "sr_launches"),
    "quantize_int8_rowwise_given_sm90": (quantize_int8_rowwise_given, "sm90_launches"),
    "quantize_int8_rowwise_given_sr_sm90": (quantize_int8_rowwise_given, "sr_sm90_launches"),
    "quantize_int8_colwise_maxima": (quantize_int8_colwise_maxima, "launches"),
    "quantize_int8_colwise_given": (quantize_int8_colwise_given, "launches"),
    "quantize_int8_colwise_given_sr": (quantize_int8_colwise_given, "sr_launches"),
    "quantize_int8_both_maxima": (quantize_int8_both_maxima, "launches"),
    "quantize_int8_both_maxima_sr": (quantize_int8_both_maxima, "sr_launches"),
    "scaled_mm_rhs_t": (scaled_mm_rhs_t, "launches"),
    "scaled_mm_rhs_t_sm90": (scaled_mm_rhs_t, "sm90_launches"),
    "scaled_mm_rhs_t_decode": (scaled_mm_rhs_t, "decode_launches"),
    "scaled_mm": (scaled_mm, "launches"),
    "scaled_mm_sm90": (scaled_mm, "sm90_launches"),
    "scaled_mm_lhs_t": (scaled_mm_lhs_t, "launches"),
    "scaled_mm_lhs_t_sm90": (scaled_mm_lhs_t, "sm90_launches"),
    "fused_adamw_update": (fused_adamw_update, "launches"),
    "fused_adamw_update_sr": (fused_adamw_update, "sr_launches"),
    "rmsnorm_quant_rowwise": (rmsnorm_quant_rowwise, "launches"),
    "rmsnorm_quant_rowwise_sr": (rmsnorm_quant_rowwise, "sr_launches"),
    "rmsnorm_quant_rowwise_sm90": (rmsnorm_quant_rowwise, "sm90_launches"),
    "rmsnorm_quant_rowwise_sr_sm90": (rmsnorm_quant_rowwise, "sr_sm90_launches"),
    "rmsnorm_quant_colwise": (rmsnorm_quant_colwise, "launches"),
    "rmsnorm_quant_colwise_sr": (rmsnorm_quant_colwise, "sr_launches"),
    "rmsnorm_quant_colwise_sm90": (rmsnorm_quant_colwise, "sm90_launches"),
    "rmsnorm_quant_colwise_sr_sm90": (rmsnorm_quant_colwise, "sr_sm90_launches"),
    "silu_mul_quant_rowwise": (silu_mul_quant_rowwise, "launches"),
    "silu_mul_quant_rowwise_sr": (silu_mul_quant_rowwise, "sr_launches"),
    "silu_mul_quant_rowwise_sm90": (silu_mul_quant_rowwise, "sm90_launches"),
    "silu_mul_quant_rowwise_sr_sm90": (silu_mul_quant_rowwise, "sr_sm90_launches"),
    "silu_mul_quant_colwise": (silu_mul_quant_colwise, "launches"),
    "silu_mul_quant_colwise_sr": (silu_mul_quant_colwise, "sr_launches"),
    "silu_mul_quant_colwise_sm90": (silu_mul_quant_colwise, "sm90_launches"),
    "silu_mul_quant_colwise_sr_sm90": (silu_mul_quant_colwise, "sr_sm90_launches"),
    "rmsnorm_bwd": (rmsnorm_bwd, "launches"),
    "rmsnorm_bwd_sm90": (rmsnorm_bwd, "sm90_launches"),
    "silu_mul_bwd_quant_rowwise": (silu_mul_bwd_quant_rowwise, "launches"),
    "silu_mul_bwd_quant_rowwise_sr": (silu_mul_bwd_quant_rowwise, "sr_launches"),
    "silu_mul_bwd_quant_rowwise_sm90": (silu_mul_bwd_quant_rowwise, "sm90_launches"),
    "silu_mul_bwd_quant_rowwise_sr_sm90": (silu_mul_bwd_quant_rowwise, "sr_sm90_launches"),
    "silu_mul_bwd_quant_colwise": (silu_mul_bwd_quant_colwise, "launches"),
    "silu_mul_bwd_quant_colwise_sr": (silu_mul_bwd_quant_colwise, "sr_launches"),
    "silu_mul_bwd_quant_colwise_sm90": (silu_mul_bwd_quant_colwise, "sm90_launches"),
    "silu_mul_bwd_quant_colwise_sr_sm90": (silu_mul_bwd_quant_colwise, "sr_sm90_launches"),
    "rope_group": (rope_group_kernel, "launches"),
    "rope_ungroup": (rope_ungroup_kernel, "launches"),
    "ungroup_amax": (ungroup_amax, "launches"),
    "ungroup_amax_sm90": (ungroup_amax, "sm90_launches"),
    "ungroup_quant": (ungroup_quant, "launches"),
    "ungroup_quant_sr": (ungroup_quant, "sr_launches"),
    "ungroup_quant_sm90": (ungroup_quant, "sm90_launches"),
    "ungroup_quant_sr_sm90": (ungroup_quant, "sr_sm90_launches"),
    "scaled_int4_mm": (scaled_int4_mm, "launches"),
    "scaled_int4_mm_sm90": (scaled_int4_mm, "sm90_launches"),
    "tile_scaled_mm": (tile_scaled_mm, "launches"),
    "tile_scaled_mm_sm90": (tile_scaled_mm, "sm90_launches"),
    "tile_scaled_mm_s8": (tile_scaled_mm, "s8_launches"),
    "tile_scaled_mm_s8_sm90": (tile_scaled_mm, "s8_sm90_launches"),
    "layernorm_quant_rowwise": (layernorm_quant_rowwise, "launches"),
    "layernorm_quant_rowwise_sr": (layernorm_quant_rowwise, "sr_launches"),
    "layernorm_quant_rowwise_sm90": (layernorm_quant_rowwise, "sm90_launches"),
    "layernorm_quant_rowwise_sr_sm90": (layernorm_quant_rowwise, "sr_sm90_launches"),
    "layernorm_quant_colwise": (layernorm_quant_colwise, "launches"),
    "layernorm_quant_colwise_sr": (layernorm_quant_colwise, "sr_launches"),
    "layernorm_quant_colwise_sm90": (layernorm_quant_colwise, "sm90_launches"),
    "layernorm_quant_colwise_sr_sm90": (layernorm_quant_colwise, "sr_sm90_launches"),
    "gelu_quant_rowwise": (gelu_quant_rowwise, "launches"),
    "gelu_quant_rowwise_sr": (gelu_quant_rowwise, "sr_launches"),
    "gelu_quant_rowwise_sm90": (gelu_quant_rowwise, "sm90_launches"),
    "gelu_quant_rowwise_sr_sm90": (gelu_quant_rowwise, "sr_sm90_launches"),
    "gelu_quant_colwise": (gelu_quant_colwise, "launches"),
    "gelu_quant_colwise_sr": (gelu_quant_colwise, "sr_launches"),
    "gelu_quant_colwise_sm90": (gelu_quant_colwise, "sm90_launches"),
    "gelu_quant_colwise_sr_sm90": (gelu_quant_colwise, "sr_sm90_launches"),
    "matmul": (matmul, "launches"),
    "matmul_s8": (matmul, "s8_launches"),
    "matmul_sm90": (matmul, "sm90_launches"),
    "matmul_s8_sm90": (matmul, "s8_sm90_launches"),
    "int8_flash_fwd": (int8_flash_fwd, "launches"),
    "int8_flash_fwd_sm90": (int8_flash_fwd, "sm90_launches"),
}


def launch_counts() -> dict[str, int]:
    """Kernel launches per counter since the last :func:`reset_launch_counts`."""
    return {name: getattr(fn, attr) for name, (fn, attr) in KERNELS.items()}


def sdpa_forwards() -> int:
    """PyTorch's SDPA forwards on a card (:func:`sdpa.sdpa`) since the last
    :func:`reset_launch_counts`: how often the attention forward ran."""
    return sdpa.sdpa.launches


def launch_totals() -> dict[str, int]:
    """:func:`launch_counts` and, under ``"sdpa"``, :func:`sdpa_forwards`:
    every counter a captured region can move."""
    return {**launch_counts(), "sdpa": sdpa_forwards()}


def add_launch_counts(delta: dict[str, int]) -> None:
    """Add ``delta`` (keys of :func:`launch_totals`) to the counters: what
    a replay of a captured region launched."""
    for name, n in delta.items():
        if name == "sdpa":
            sdpa.sdpa.launches += n
        else:
            fn, attr = KERNELS[name]
            setattr(fn, attr, getattr(fn, attr) + n)


def reset_launch_counts() -> None:
    """Every kernel's counter and :func:`sdpa_forwards`' to 0."""
    for fn, attr in KERNELS.values():
        setattr(fn, attr, 0)
    sdpa.sdpa.launches = 0


__all__ = [
    "KERNELS",
    "add_launch_counts",
    "launch_counts",
    "launch_totals",
    "reset_launch_counts",
    "sdpa_forwards",
    "conv",
    "fp8",
    "mx",
    "random",
    "conv2d",
    "int8_conv2d",
    "scaled_int8_conv2d",
    "int8_mm",
    "fp8_mm",
    "scaled_fp8_mm",
    "quantize_fp8",
    "quantize_fp8_tile",
    "quantize_fp8_block",
    "quantize_mx",
    "quantize_nvfp4",
    "dequantize_mxfp4",
    "dequantize_nvfp4",
    "mxfp4_mm",
    "nvfp4_mm",
    "pack_block_scales_nv",
    "attention_ref",
    "fused_adamw_plain",
    "fused_adamw_update",
    "gelu_quant",
    "gelu_quant_colwise",
    "gelu_quant_plain",
    "gelu_quant_rowwise",
    "int4_mm",
    "int8_flash_fwd",
    "int8_flash_fwd_plain",
    "layernorm_quant",
    "layernorm_quant_colwise",
    "layernorm_quant_plain",
    "layernorm_quant_rowwise",
    "matmul",
    "matmul_plain",
    "quantize_int8_both",
    "quantize_int8_both_plain",
    "quantize_int8_colwise",
    "quantize_int8_plain",
    "quantize_int8_rowwise",
    "quantize_qkv",
    "rmsnorm_bwd",
    "rmsnorm_bwd_plain",
    "rmsnorm_quant_colwise",
    "rmsnorm_quant_colwise_plain",
    "rmsnorm_quant_rowwise",
    "rmsnorm_quant_rowwise_plain",
    "rope_group_kernel",
    "rope_group_ref",
    "rope_ungroup_kernel",
    "rope_ungroup_ref",
    "silu_mul_bwd_quant_colwise",
    "silu_mul_bwd_quant_colwise_plain",
    "silu_mul_bwd_quant_rowwise",
    "silu_mul_bwd_quant_rowwise_plain",
    "silu_mul_quant_colwise",
    "silu_mul_quant_colwise_plain",
    "silu_mul_quant_rowwise",
    "silu_mul_quant_rowwise_plain",
    "scaled_int4_mm",
    "scaled_int4_mm_plain",
    "scaled_mm",
    "scaled_mm_general",
    "scaled_mm_lhs_t",
    "scaled_mm_lhs_t_plain",
    "scaled_mm_plain",
    "scaled_mm_ref",
    "scaled_mm_rhs_t",
    "scaled_mm_rhs_t_plain",
    "tile_scaled_mm",
    "tile_scaled_mm_plain",
    "ungroup_amax",
    "ungroup_amax_plain",
    "ungroup_quant",
    "ungroup_quant_plain",
    "unpack_int4",
]
