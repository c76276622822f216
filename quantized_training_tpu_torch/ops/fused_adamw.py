"""B6: the fused AdamW update on bf16 state, and its plain version.

Counterpart of ``quantized_training_tpu/ops/pallas_optim.py::
fused_adamw_update`` (:79), the update of ``optim/adamw.py::adamw_bf16_sr``:
one pass over a parameter tensor reads p, g and the bf16 moments and writes
the new p and moments, with the moments' lerp update, bias correction,
decoupled weight decay and, optionally, the stochastic-rounding bf16
writeback of p (the 16 low bits of the key's Philox stream added to p's
fp32 pattern, ``ops/random.py``). The CUDA source is
``csrc/fused_adamw.cu``; its header says what bounds the kernel and how its
design answers that. The kernel is bit-exact with the plain version on the
card, SR or not.
"""

from __future__ import annotations

import torch

from . import _build, random

_P_DTYPES = (torch.bfloat16, torch.float32)


def fused_adamw_plain(p, g, ea, eas, scalars, key, *, bf16_sr: bool):
    """The Pallas body (``pallas_optim.py:52-75``) as torch ops, in its
    order: ``scalars`` = (lr, b1, b2, wd, eps, bc1, bc2) fp32 on p's device,
    and ``1 - b1``, ``1 - b2`` formed from them in fp32 as the kernel forms
    them. Returns (new_p in p's dtype, new_ea bf16, new_eas bf16)."""
    lr, b1, b2, wd, eps, bc1, bc2 = scalars.unbind(0)
    g32, ea32, eas32 = g.float(), ea.float(), eas.float()
    ea32 = ea32 + (1.0 - b1) * (g32 - ea32)
    eas32 = eas32 + (1.0 - b2) * (g32 * g32 - eas32)
    # every divisor is a tensor: PyTorch's CUDA division by a Python scalar
    # is a reciprocal multiply, not an IEEE division
    denom = torch.sqrt(eas32) / torch.sqrt(bc2) + eps
    p32 = p.float()
    new_p = p32 - lr * wd * p32 - lr * (ea32 / bc1) / denom
    new_p = random.bf16_stochastic_round(new_p, key) if bf16_sr else new_p.to(p.dtype)
    return new_p, ea32.to(torch.bfloat16), eas32.to(torch.bfloat16)


def _check(p, g, ea, eas, scalars, bf16_sr: bool, key) -> None:
    what = "fused_adamw_update"
    if not p.is_cuda:
        raise ValueError(f"{what}: needs CPU or CUDA tensors, got {p.device}")
    if any(t.device != p.device for t in (g, ea, eas, scalars)):
        raise ValueError(f"{what}: p, g, ea, eas and scalars must be on one device")
    if p.dtype not in _P_DTYPES or g.dtype != p.dtype:
        raise TypeError(f"{what}: p bf16 or fp32 and g of p's dtype, got {p.dtype}, {g.dtype}")
    if ea.dtype != torch.bfloat16 or eas.dtype != torch.bfloat16:
        raise TypeError(f"{what}: the moments must be bf16, got {ea.dtype}, {eas.dtype}")
    if scalars.dtype != torch.float32 or scalars.shape != (7,):
        raise ValueError(f"{what}: scalars must be fp32 [7] (lr, b1, b2, wd, eps, bc1, bc2)")
    if any(t.shape != p.shape for t in (g, ea, eas)):
        raise ValueError(f"{what}: p, g, ea and eas must share one shape")
    if not all(t.is_contiguous() for t in (p, g, ea, eas, scalars)):
        raise ValueError(f"{what}: every input must be contiguous")
    if bf16_sr and (p.dtype != torch.bfloat16 or key is None):
        raise ValueError(f"{what}: the SR writeback needs bf16 p and a key")


def fused_adamw_update(p, g, ea, eas, scalars, key, *, bf16_sr: bool, in_place: bool = False):
    """(new_p in p's dtype, new_ea bf16, new_eas bf16) of one AdamW step on
    one parameter tensor (any shape, flattened). p bf16 or fp32; g in p's
    dtype; ea and eas bf16; ``scalars`` fp32 [7] = (lr, b1, b2, wd, eps,
    bc1, bc2) on p's device, as ``pallas_optim.py:84``; ``key`` seeds the SR
    writeback (``bf16_sr``, bf16 p only). A CPU tensor takes
    :func:`fused_adamw_plain`; a CUDA tensor launches B6, or its SR form, on
    the current stream into new buffers (the inputs are left as they are),
    or with ``in_place`` into p, ea and eas themselves (a donated state),
    by B6's in-place instantiation: each thread of ``csrc/fused_adamw.cu``
    reads its elements of p, g, ea and eas before it writes the same
    elements, and no other."""
    if p.device.type == "cpu":
        outs = fused_adamw_plain(p, g, ea, eas, scalars, key, bf16_sr=bf16_sr)
        if in_place:
            for t, new in zip((p, ea, eas), outs):
                t.copy_(new)
            return p, ea, eas
        return outs
    _check(p, g, ea, eas, scalars, bf16_sr, key)
    if bf16_sr:
        _build.refuse_capture("fused_adamw_update")
    if in_place:
        new_p, new_ea, new_eas = p, ea, eas
    else:
        new_p, new_ea, new_eas = torch.empty_like(p), torch.empty_like(ea), torch.empty_like(eas)
    err = _build.library().qt_fused_adamw(
        p.data_ptr(), g.data_ptr(), ea.data_ptr(), eas.data_ptr(), scalars.data_ptr(), new_p.data_ptr(),
        new_ea.data_ptr(), new_eas.data_ptr(), p.numel(), int(p.dtype == torch.bfloat16), int(bf16_sr),
        key if bf16_sr else 0, _build.stream(),
    )
    _build.check(err, "fused_adamw_update")
    if bf16_sr:
        fused_adamw_update.sr_launches += 1
    else:
        fused_adamw_update.launches += 1
    return new_p, new_ea, new_eas


fused_adamw_update.launches = fused_adamw_update.sr_launches = 0
