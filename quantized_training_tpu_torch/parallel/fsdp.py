"""FSDP: the per-layer parameter gather, and BitNet's 2-bit all-gather.

Counterpart of ``quantized_training_tpu/parallel/fsdp.py`` and of what XLA
does around the JAX package's scanned layer body under an fsdp mesh.

:func:`gather` all-gathers the fsdp-split leaves of a parameter tree
through :class:`_Gather`, whose backward reduce-scatters the cotangent
(the sum over the fsdp ranks' batch rows, each rank keeping its block).
``models/llama.py::backbone`` gathers the embedding, the final norm and the
stacked leaves split on their layer dim once a step, and each layer's
other leaves inside that layer's ``torch.utils.checkpoint``, so the
backward's replay gathers again and no gathered layer outlives its use
(FSDP2's reshard-after-forward). The loss gathers the lm_head.

BitNet (``bitnet_fsdp_linear``, JAX :64-125, from the reference's
``fsdp_pre_all_gather``): the abs-mean scale is the mean of the fsdp ranks'
shard means (all equal in size, so the global abs-mean up to fp32 rounding),
the local shard is ternarized with it and packed four values to a byte
(``pack_i2_in_i8``), the int8 payload is all-gathered (8x fewer bytes than
bf16), and the linear runs K1 on x and K2 on the unpacked weight with the
scalar scale. Its backward takes grad_input from the local rows and
reduce-scatters grad_weight over fsdp, then sums it over data: such a leaf
is reduced inside the linear, and :func:`gather` leaves it split.
"""

from __future__ import annotations

import dataclasses

import torch

from ..ops import remat
from ..ops.scaled_mm import scaled_mm_general
from ..quant.core import pack_i2_in_i8, quantize_bitnet_weight, quantize_int8, unpack_i2_in_i8
from ..quant.int8 import _scales
from ..quant.node import WeightNode
from . import collectives as C
from ..utils.tree import map_tensors
from .mesh import Shard, leaf_shard

ACT_EPS = 1e-5  # the activations' quantize eps (JAX fsdp.py:79)


class _Gather(torch.autograd.Function):
    """all_gather along ``dim`` over fsdp; backward reduce_scatter."""

    @staticmethod
    def forward(ctx, x, dim, mesh):
        ctx.dim, ctx.mesh = dim, mesh
        return C.all_gather(x, dim, mesh, "fsdp")

    @staticmethod
    def backward(ctx, g):
        return C.reduce_scatter(g, ctx.dim, ctx.mesh, "fsdp"), None, None


def is_fsdp_bitnet(node) -> bool:
    """A BitNet weight routed through the 2-bit all-gather: it stays split
    into its linear, which reduces its gradient."""
    mesh = getattr(node, "mesh", None)
    return mesh is not None and mesh.shape["fsdp"] > 1


def zip_params(fn, tree, specs):
    """``fn(tensor, shard, wrapper)`` on every tensor of a parameter tree
    beside its :class:`Shard` tree (``wrapper``: the weight wrapper that
    holds the tensor, or None). A leaf that the specs hold as a wrapper (a
    storage weight's master, in the masters' tree), or a wrapper field they
    lack (a master attached after sharding), takes the wrapper's first
    field's shard."""
    def one(t, s):
        if isinstance(t, WeightNode):
            def field_shard(f):
                x = getattr(s, f, None) if isinstance(s, WeightNode) else None
                return x if x is not None else leaf_shard(s)

            return dataclasses.replace(t, **{f: fn(x, field_shard(f), t) for f, x in t.tensors().items()})
        return fn(t, leaf_shard(s), None)

    return map_tensors(one, tree, specs, is_leaf=lambda t: isinstance(t, (torch.Tensor, WeightNode)))


def gather(tree, specs, mesh, pick=lambda dim: dim):
    """Every fsdp-split tensor of ``tree`` gathered along ``pick(dim)``
    (its split dim in the tree's own layout; None leaves it as it is),
    BitNet's 2-bit route excepted."""
    def one(t, s, node):
        if s.dim is None or is_fsdp_bitnet(node):
            return t
        d = pick(s.dim)
        return t if d is None else _Gather.apply(t, d, mesh)

    return zip_params(one, tree, specs)


def prequant_specs(tree, specs):
    """The layout of ``tree`` once ``quant.prequantize_step`` has turned
    its split mixed-precision weights into PreQuantMPWeights: each view
    split as its master, but where the master's rows [.., O, I] are split
    its column scales [.., 1, I] are whole (the maxima were all-reduced),
    as are its row scales [.., O, 1] where its columns are, and the 0-sized
    placeholders of the views a mode does not make."""
    from ..quant.mixed_precision import PreQuantMPWeight

    def one(leaf, spec):
        if not isinstance(leaf, PreQuantMPWeight):
            return spec
        s = leaf_shard(spec)
        whole = Shard(None, s.index, s.count)
        last = leaf.orig.ndim - 1  # the columns' dim; the rows' is last - 1

        def field(name, t):
            scale_whole = (name == "col_s" and s.dim == last - 1) or (name == "row_s" and s.dim == last)
            return whole if t.numel() == 0 or scale_whole else s

        return dataclasses.replace(leaf, **{f: field(f, t) for f, t in leaf.tensors().items()})

    return map_tensors(one, tree, specs, is_leaf=lambda t: isinstance(t, (torch.Tensor, WeightNode)))


def bitnet_fsdp_params(params, mesh):
    """Every ``BitNetWeight`` of ``params`` with ``mesh`` set where its
    fsdp axis is larger than 1, else None (JAX :46-61): the linear then
    takes the 2-bit all-gather. Call it before ``init_train_state``, and
    again on a loaded checkpoint (a saved weight has no mesh)."""
    from ..quant.bitnet import BitNetWeight

    active = mesh if mesh is not None and mesh.shape["fsdp"] > 1 else None
    return map_tensors(lambda w: dataclasses.replace(w, mesh=active), params,
                       is_leaf=lambda t: isinstance(t, BitNetWeight))


class _BitNetFSDPLinear(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x2d, w_local, mesh):
        n = mesh.shape["fsdp"]
        scale = C.all_reduce(w_local.float().abs().mean(), mesh, "fsdp") / n
        packed = C.all_gather(pack_i2_in_i8(quantize_bitnet_weight(w_local, scale)), 0, mesh, "fsdp")
        x_i8, row_scale = quantize_int8(x2d, axis=-1, eps=ACT_EPS)
        scale_cast = scale.to(x2d.dtype)
        if remat.skips():  # the replay of an unread output (remat): what the node saves, no product
            out = remat.unread_like(x2d, (x2d.shape[0], packed.shape[0]))
        else:
            sa, sb = _scales(row_scale, scale_cast)
            out = scaled_mm_general(x_i8, unpack_i2_in_i8(packed), sa, sb, dims=(1, 1), out_dtype=x2d.dtype)
        ctx.mesh = mesh
        ctx.save_for_backward(x_i8, row_scale, packed, scale_cast)
        return out

    @staticmethod
    def backward(ctx, g):
        x_i8, row_scale, packed, scale = ctx.saved_tensors
        w_i8 = unpack_i2_in_i8(packed)
        g = g.to(scale.dtype)
        grad_input = (g @ w_i8.to(g.dtype)) * scale
        grad_w = g.T @ (x_i8.to(g.dtype) * row_scale)
        grad_w = C.all_reduce(C.reduce_scatter(grad_w, 0, ctx.mesh, "fsdp"), ctx.mesh, "data")
        return grad_input, grad_w, None


def bitnet_fsdp_linear(x: torch.Tensor, w_local: torch.Tensor, mesh) -> torch.Tensor:
    """x [..., in] (this rank's rows) @ ternarized w.T, w [out, in] split
    over fsdp on its rows (this rank's ``w_local``), through the 2-bit
    all-gather: -> [..., out]."""
    x2d = x.reshape(-1, x.shape[-1])
    out = _BitNetFSDPLinear.apply(x2d, w_local, mesh)
    return out.reshape(*x.shape[:-1], w_local.shape[0] * mesh.shape["fsdp"])
