"""Drive the PyTorch port on one CUDA card, end to end.

Phases (each prints its own lines; any failed check raises, exit code != 0):

1. the card: CUDA must be available; its name and power limit;
2. the build: every kernel of ``quantized_training_tpu_torch/ops/csrc``
   compiled with nvcc, one process per source (seconds printed);
3. each kernel against its plain PyTorch version on the card, at the shapes
   of the serving path (K1, K2: K1 on the persistent row walk and K2's
   decode sizes, M 8 and 16, on the split-K weight stream, each call checked
   to take its route and timed on its first design in the same call, the
   outputs bit-identical) and of the training step (K1 and B4 on
   every activation and weight, B5 on every output gradient of the bench.py
   and ViT-Giant steps, B1, B2, and K2 at 8192 tokens, each
   GEMM beside ``torch._int_mm``, the nearest library call: the int32
   product without the scale epilogue), the stochastic-rounding forms of
   K1, B4 and B5 with the same key, B6 (the fused AdamW update, SR
   writeback off and on) at every parameter shape of Llama2-1B, all
   bit-exact; and the producer-fused kernels at the fused layer's shapes
   (norm [8192, 2048], silu [8192, 5632], and [256, 2048] / [256, 5632]):
   B7 with and without the column absmax, B8 given the forward's scales
   and in two passes, B9's row and column forms (bit-exact), B10, and the
   SR forms of B7-B9; B11 and B12 at the MLP backward's [8192, 5632] and
   [256, 5632] (B7 and B8 given scales at [8192, 2048], B9-row at [8192,
   5632] and [256, 5632], B9-col given scales, B11 and B12 given scales at
   [8192, 5632], and their SR forms, and
   B10 at [8192, 2048], checked to launch on the persistent row walk, and
   B4 and B4-SR at every weight and x2d shape, checked to launch on its
   cluster form, each timed on its first design too, the parent's kernel,
   in the same call: route, both times and shares of the bound,
   bit-identical outputs, B10's dgamma, whose sums meet in the walk's
   order, within 2e-5 of its largest magnitude and the same bits run to
   run; B10 beside ``aten._fused_rms_norm_backward``, which reads the rstd
   B10 recomputes: a reference, not the same function), B13 on q, k and v of
   bench.py's micro-batch [4, 2048] and
   B14 on its attention output, with their SR forms (all bit-exact; B14's
   absmax, rows and columns, RN and SR, timed in [B, S, H, hd] and [B, H,
   S, hd] memory, and at the step's layout checked to launch on the row
   walk and timed on its first design in the same call); B16
   (int4) and B15 (tile-scaled, e4m3 within its stated bound and int8
   bit-exact) at the forward, grad_input and grad_weight shapes of gate/up
   and down, beside ``torch._int_mm`` / ``torch._scaled_mm``; B18's
   LayerNorm and GELU forms and their SR forms at ViT-Giant's padded 6,400
   tokens (LayerNorm [6400, 1536] by B7's bars, GELU [6400, 6144]
   bit-exact), each row form and given-scales column form, RN and SR,
   checked to launch on the persistent row walk and timed on its first
   design in the same call, all outputs bit-identical; B17 at 4096^3 (bf16
   -> bf16 within its fp32-sum bound beside ``torch.matmul``, int8 -> int32
   bit-exact beside ``torch._int_mm``) and B19 at Llama2-1B's attention ([4, 4] instances, G 8, S 2048, hd 64,
   block_kv 512: checked to launch once on its sm90 design, the same bits
   on a second run, and within ``ops/int8_attention.py::agreement`` of its
   plain version and of its first design, the route forced to 0, timed in
   the same call; beside SDPA in bf16); the mesh forms of K1, B4 and B5
   (their maxima forms, K1's given form and the given column cast, at a
   rank's step shapes, the fsdp weight halves and TP's row-parallel
   inputs, bit-exact, the maxima beside ``torch.linalg.vector_norm``) and
   K1, B7, B8 and B10 at phase 17's width [2048, 256]; timed with CUDA events, with GB/s or TOP/s and the share
   of the roofline; K2, B1, B2, B15 (both forms), B16 at every shape and
   B17 (both forms) also on the route they took (K2 above 16 rows, B1, B2,
   B15 at QK = 128, B16 and B17 on the TMA + wgmma mainloop of
   ``sm90_gemm.cuh``; each call checked to take it) beside their wmma
   kernels' time (``WMMA_US``), B15's e4m3 form
   with its worst error in fp32 roundings of the folded magnitudes;
   then the strides SDPA takes and returns in the grouped pipeline, which
   must run no layout copy; then the storage schemes' operand forms (K2
   with an ``Int8Weight``'s bf16 [O] column scale and a BitNet weight's
   bf16 scalar one at M 8 and 8192 for every linear, K1 at BitNet's eps
   1e-5, K1-SR on every stacked [22, O, I] weight as the commit
   re-quantizes it), each bit-exact and on its route; and K2's host cost: a
   call timed whole, its parts timed alone (route predicates, checks,
   ``torch.empty``, ``_build.stream()``, the ctypes call), and a launch of
   it in a CUDA graph of 200 (``utils/graphs.py``), host and wall;
4. the serving slice through ``benchmark_serving --load mixed``
   (``mixed_load``): Llama2-1B at full width and depth (random weights from
   a seed), ``mixed_precision``, 3 x 8 requests of JAX's mixed load
   (prompts 32/96/224/480, its budgets cut to ``SERVE_BUDGETS``) through
   the windowed ``Server(n_slots=8, max_len=2048, decode_chunk=16)`` and
   the full-window one, a warm and a timed drain each, then static batched
   ``generate``; in every drain launch counts prove the kernels ran, every
   K2 call of M <= 16 on the split-K weight stream and every other on the
   sm90 route (an eager call's M through its route predicate, a decode
   graph's replays at M = the slots), K1 on the row walk but at the KV rows
   of 64; every decode call of both servers a CUDA graph a window and chunk
   (``make_decode_step``'s default), its replays counted; two streams are
   held against ``generate()``; the same requests through an eager
   windowed server (``jit_compile=False``) give the graphed server's token
   streams exactly and its K2 launches by route; then decode alone, graphed
   and eager in turns (8 slots at positions 150-246, chunk 16): ms a decode
   step, tok/s, peak memory and the busy share (a profiled call's kernel
   intervals, their union, over that call's wall); and the static
   baseline's streams at the requests it did not pad against the server's;
5. kernel path against plain path: prefill logits of a 2-layer cut on the
   card against the same model on the CPU (plain versions);
6. the training slice: three int8 ``mixed_precision`` train steps of
   Llama2-1B at full width and depth (batch 4 x seq 2048, per-layer remat,
   SDPA attention on the grouped pipeline, AdamW, the producer-fused layer:
   the one-op MLP and the ungroup-fused o-projection) on one token batch from
   ``--seed``; the losses fall, every step launches each kernel the number
   of times the code implies (every K1 weight launch on the row walk, the
   SR form's at q, o, gate, up and down, and every K2, B1 and B2 launch on
   the sm90 route,
   here and in phases 8, 9 and 11, every B7, B8, B9 (rows and columns),
   B10, B11, B12 and B14
   launch on the row walk and every B4 launch on its cluster form, here and
   in phases 8 and 9, and B4's in phase 11), and the same steps in bf16
   start from the
   same loss; every step here and in phases 8, 10, 14-17, 19 and 20 a CUDA
   graph (``make_train_step``'s default), its launches counted as the
   eager step's;
7. kernel path against plain path: the loss and every gradient of a
   2-layer cut at full width, fp32 and bf16, and fp32 with stochastic
   rounding from one key, on the card against the CPU, both on the grouped
   pipeline: the unfused layer on both, then the fused layer
   (``set_impl('auto')`` on the card, the plain versions under
   ``set_impl('interpret')`` on the CPU); then int4 and fp8 tile, fp32; then
   a 2-block narrow ViT on its fused blocks (B18 on the card, its plain
   versions on the CPU), fp32, bf16 and fp32 with SR;
8. ``bench.py``'s step through the port's ``bench.measure``: Llama2-1B,
   tokens [4, 4, 2048] (4 x 4 gradient accumulation), remat,
   ``adamw_bf16_sr`` without the SR writeback, lr 1e-4; int8
   ``mixed_precision`` on the fused layer, on the unfused layer
   (``set_impl('off')``), then bf16, each 2 warm steps and ``BENCH_STEPS``
   synced and chained: tokens/s, the ratios, bench's JSON line with JAX's
   keys, peak memory, exact launch counts under the remat policy (B6 once
   per parameter leaf) and SDPA's forwards (``ops.sdpa_forwards()``, once a
   layer and micro-step), each step a replay of its CUDA graph; then the
   fused int8 step graphed (the default) and eager (``jit_compile=False``)
   from the same weights and batch, in turns: 3 steps under
   ``torch.use_deterministic_algorithms(True)`` give the same losses, grad
   norms and first-step parameters bit for bit and the same launches a
   step; then 3 steps of each under default algorithms and one more under
   ``torch.profiler``: ms a step, tok/s, peak memory, the kernels' device
   time by ``profile_torch_step.py``'s groups and the busy share (the union
   of the profiled step's kernel intervals over its wall);
9. the SR configuration (``llm_pretrain.py`` with ``stochastic_rounding``
   and ``--optim adamw_bf16_sr``): three steps at batch 4 x 2048 in which
   only the SR forms of K1, B4, B5, B6, B7-B9, B11, B12 and B14's quantize
   launch, and B10, B13 and B14's absmax, which have none; eager
   (``jit_compile=False``): SR in the model refuses a graph;
10. int4 and fp8: B15's int8 form on ``benchmark_mm.py``'s tile case
   through ``ops.scaled_mm``; then three steps each of int4, fp8-tile and
   fp8-row ``mixed_precision`` at phase 6's shapes and optimizer, from its
   weights and batch: the losses fall, the first within a stated bound of
   phase 6's bf16 first loss, B16 / B15 (every launch on the sm90 route)
   launched exactly as the code implies and no int8 kernel; tokens/s
   against phase 6's bf16, peak memory;
11. ViT-Giant's train step through the port's ``_bench_vit_giant.measure``
   (``vit_train``'s step): batch 24 at 224 px (6,168 tokens), 1000
   classes, remat, SDPA, ``adamw_bf16_sr`` without the SR writeback, lr
   1e-5 (``VIT_LR``), normal images; bf16, int8 ``mixed_precision`` on the
   fused blocks (LayerNorm and GELU inside the quantizes, B18) and int8 at
   ``min_k`` 1536, each a warm step and ``VIT_STEPS`` synced and chained,
   then two int8 steps with stochastic rounding: the driver's images/s
   lines, the int8/bf16 ratio, peak memory, exact launch
   counts (B18 160 / 80 / 80 / 40 a step: LayerNorm-row / GELU-row /
   LayerNorm-column / GELU-column, every one on the row walk), losses that
   fall;
12. ``benchmark_mm`` (``python -m quantized_training_tpu_torch.benchmark_mm``)
   at 1024/2048/4096: its gates (B1 and B17 int8 exact, B15-s8 and B17 bf16
   within their bounds), its rows and table, then its training shapes; B17's
   launches come from here, every one (bf16 and int8), and every B1 and
   B15-s8 one, on the sm90 route;
13. B19 as the JAX package's op: at phase 3's shape, the oracle checks of
   its test (mean relative error below 0.05 against the bf16 oracle, lse
   within 1e-4 of the explicit logsumexp) and causality (k and v changed
   from row 1536 on leave earlier rows bit-identical); two launches, both on
   the sm90 design;
14. the storage schemes: (a) three train steps each of int8 weight
   storage (``int8_quantized_training`` with int8 activations), int4
   weight-only and BitNet (``bitnet=True``), and one of int8 storage with
   ``int8_sr`` activations, Llama2-1B at full width and depth, batch 4 x
   2048, remat, SDPA on the grouped pipeline, ``adamw_bf16_sr`` without the
   SR writeback, lr 1e-4, phase 6's weights and batch: finite losses that
   fall, the launches of every step exactly as the code implies
   (``storage_per_step``: K1 and K2 14 a layer, K1-SR 7 in the int8
   commit, B13, B6 once a master leaf, no int8 backward kernel), the
   committed q leaf stored with every value one that SR can give its master
   (``on_grid_neighbours``), tokens/s and peak memory; (b) a 2-layer cut at full width, fp32, int8
   storage and BitNet, the loss and every master gradient on the card
   against the CPU; (c) the server over int8 storage and over packed BitNet,
   8 requests each, every K2 decode launch on the split-K stream and every
   prefill launch on sm90, two streams held against ``generate()``, tok/s.
   K1's, K1-SR's, K2's, B13's and B6's entries carry the phase's launches
   (``storage_launches``).
15. the LLM drivers, ``llm_pretrain`` and ``llm_evaluate``, called in
   process (``main(argv)``) at Llama-2-470m (``mini_llamas``, through
   ``from_hf_json``: hidden 1024, FFN 4096, 16 heads of 16 kv heads, 24
   layers), int8 ``mixed_precision`` on the fused layer, remat, batch 4 x
   2048: (e) first, every kernel of that path (K1, B4, B5, K2, B1, B2,
   B7-B14) in the form its step calls, on bf16 tensors at the 470m step's
   shapes, each on its bf16 route and bit-exact with its plain version
   (B7, B8 and B10 to their sum-order bars), timed; (b) a 2-layer cut at
   full width, fp32, fused and unfused, the loss and every gradient on the
   card against the CPU within phase 7's bounds; (a) 4 steps on Markov
   tokens with ``adamw``, and 2 steps with a checkpoint then ``--resume``
   to 4: the resumed run enters with the interrupted run's final state bit
   for bit and takes the uninterrupted run's third and fourth batches and
   keys, its losses at steps 3 and 4 within 5e-3 of the uninterrupted
   ones, every step's launches exactly as the routes at the 470m's shapes
   give them
   (``pretrain_per_step_launches``); (c) ``--native_loader`` over Markov
   ``.bin`` shards with ``schedule_free_adamw_8bit``, 3 steps: the loss
   finite and falling; (d) ``llm_evaluate`` on (a)'s last checkpoint,
   perplexity over 4 batches and 16 generated tokens: the loaded
   parameters bit-identical to (a)'s final ones; the eval loss falls from
   the step-2 checkpoint to it, below ln(vocab). Each run prints its
   losses, tokens/s, peak memory, the wait for its first batch and its
   seconds; every entry of the kernel table gains the phase's launches
   (``pretrain_launches``), and those of (e)'s kernels its results
   (``shapes_470m``, their errors also in ``max_abs_err``).
16. per-step weight pre-quantization (``QT_PREQUANT``), the int8 conv and
   MX: B5 at Llama2-1B's weights ([2048, 2048], [256, 2048], [5632, 2048],
   [2048, 5632]; RN and SR, bit-exact, timed with the byte bound, new
   records in B5's and B5-SR's ``shapes``); ``bench.py``'s step (phase 8's
   setup) three steps under each of ``QT_PREQUANT`` '0', 'both', 'row' and
   'col' from one state, batch and key: the launches of every step exactly
   ``prequant_per_step_launches`` ('both': K1 0, B4 0, B5 1,056), the first
   loss of each mode bit-identical to '0''s, tokens/s against '0' and peak
   memory, then the same steps under ``torch.use_deterministic_algorithms``
   (cuDNN's attention backward in a fixed order), every loss of every mode
   bit-identical to '0''s; one step of the
   SR configuration at that batch under '0' and 'both' (B5-SR on the
   weights, the loss within ``PREQUANT_SR_BOUND``); ``int8_conv2d`` (B17's
   int8 form) and ``scaled_int8_conv2d`` (K2) at ``CONV_CASES`` (the conv
   benchmark's six shapes, a C = 3 stem, a stride-2 conv at padding 0)
   equal to the CPU's bit for bit, each GEMM timed on its im2col operands
   with its bound beside cuDNN's bf16 conv (a reference), in the
   ``conv_shapes`` of B17-s8's and K2's entries; ``benchmark_conv2d
   --quick``'s table; MX (``quantize_mx`` in fp4, e4m3 and e5m2 with OCP
   and NV scales, ``quantize_nvfp4``, the dequantizes and the scale layout)
   on the card equal to the CPU's bytes, ``mxfp4_mm`` / ``nvfp4_mm`` (B17
   bf16) within the fp32-sum bound. Every entry gains the phase's launches:
   ``prequant_launches`` (the steps), ``conv_launches``, ``mx_launches``.
17. the rest of the LLM workflow at Llama-2-470m (full width and depth,
   int8 ``mixed_precision`` on the fused layer), through the drivers'
   ``main(argv)``: (a) ``tokenize_data --tokenizer byte`` on a text file
   the phase writes, into shards of 32,768 tokens (at least 2, their
   tokens the text's bytes with bos and eos, a second run leaving them as
   they are), then 2 ``llm_pretrain`` steps on them (batch 4 x 2048,
   remat): each step's launches ``pretrain_per_step_launches``; (b)
   ``llm_finetune --init_ckpt`` (a)'s checkpoint on byte-tokenized rows the
   phase writes, batch 4, ``adamw_bf16_sr``, 6 steps at padded lengths of
   at least 3 values in 256-2048: the first step enters with the
   checkpoint's parameters bit for bit, every step launches
   ``finetune_per_step_launches`` at its length, finite losses, the
   model-only checkpoint holds the final parameters; tokens/s and the wall
   of each step; (c) ``llm_evaluate --ckpt`` (b)'s checkpoint, ``--tasks
   hellaswag arc piqa`` (byte) and ``--tasks mc`` on the Markov set
   (``ints``), on files the phase writes: every predict batch launches
   ``eval_forward_launches`` at its shape, the parameters load bit for
   bit; a 2-layer cut's per-choice summed losses on the card against the
   CPU's plain path (``CUT_MAX_RMS``, ``CUT_MIN_AGREE``); (d)
   ``accuracy_parity`` at ``PARITY_STEPS`` steps and 400 rows: bf16 at
   least 0.90 accurate, each quantized configuration within 0.02 of it and
   its final loss within 0.02 nats. Every entry gains the phase's launches
   (``task_launches``).
18. ``parallel/`` on the one card, Llama2-1B at full width, every step
   eager (``jit_compile=False``: a mesh refuses a graph): (a)
   ``llm_pretrain --mesh '{"fsdp": 1}'`` under NCCL at world 1 (a child
   process with ``RANK=0 WORLD_SIZE=1``, deterministic algorithms), 8
   layers, batch 2 x 2048, 3 steps with a checkpoint at step 2 and a
   ``--resume`` from it: the losses and every step's launches equal the
   same command's without ``--mesh`` bit for bit, the resumed step too;
   then two gloo ranks sharing the card (NCCL refuses a second rank on one
   device; ``torch.multiprocessing.spawn``, each collective staged through
   the host): (b) ``{"data": 2}`` and ``{"fsdp": 2}`` (4 layers), 3 steps
   at local batch 1 x 2048 against one process at 2 x 2048 (``MESH_BOUND``
   in loss, ``MESH_NORM_RTOL`` in grad norm: every quantization maximum
   spans the mesh), replicated state bit-identical across the ranks, every
   step's launches the one-process step's with B5 as its mesh forms, the
   maxima all-reduces a step printed, fsdp half of every stacked leaf's
   bytes; (c) ``bitnet_fsdp_linear`` at q's and gate's shapes within
   1e-3 of the one-device linear, with the ternary values that differ and
   the payload's bytes, and 2 BitNet train steps (4 layers): K1 and K2
   once per BitNet linear forward; (d) TP ``generate`` at ``{"model": 2}``
   on bf16, int8 storage (int8 activations), int8 ``mixed_precision``
   (both with K1's mesh forms on o's and down's inputs), packed BitNet with
   its o and down norms, int4 weight-only and unpacked BitNet, 4 prompts
   of 128, 32 new, 4 layers: the prefill logits' mean gap to one rank's
   within the gap one bf16 ulp of the embedding makes (the model's
   rounding floor), greedy agreement, tok/s; at tests/test_parallel.py's
   TP model (bf16, int8 storage with and without int8 activations,
   ``mixed_precision``, unpacked BitNet; o's and down's partial products
   summed before they round) the logits within rtol = atol = 0.05 of one
   rank's (JAX's bound); (e)
   the sharded resume at ``{"fsdp": 2}`` (2 layers): 3 steps, a
   ``last_{rank}.pkl`` each, ``restore_sharded``, 2 steps equal 5 steps bit
   for bit; (h) schedule-free with the 8-bit state at ``{"fsdp": 2}`` (4
   layers), 3 steps against one process; each rank's codes after the first
   step, under deterministic algorithms and again without, equal bit for
   bit the one-process 8-bit state's from the ranks' gathered gradient
   (their agreement with the independent one-process run printed); (i)
   ``QT_PREQUANT`` '0', 'both' and 'col' at ``{"fsdp": 2}`` (2 layers, 2
   steps, deterministic algorithms): 'both' and 'col' equal '0' bit for
   bit, B5's and B4's mesh forms launched once a layer's weight; (g)
   ``python -m quantized_training_tpu_torch.benchmark_collectives`` at 64
   MB in the ranks (its JSON's three keys); and (f) a WebDataset
   tar of 256 JPEGs and a local ``datasets`` folder of 64, through
   ``train_transform`` at 224, batch 32, into phase 11's ViT-Giant int8
   step cut to 10 blocks (host images/s beside the step's). Prints its seconds and the
   script's. Every entry gains the launches under the mesh
   (``mesh_launches``, both ranks) and of the image steps
   (``image_launches``); the mesh forms' entries take their launches from
   this phase.
19. the remat policy (``ops/remat.py``): Llama2-1B at full width cut to
   ``REMAT_LAYERS`` layers, tokens [4, 2048], int8 ``mixed_precision`` on
   the fused layer, under ``torch.use_deterministic_algorithms(True)``:
   loss and grads with remat off, with each layer's checkpoint replayed
   whole, under the policy, under ``QT_SAVE_POSTATTN=1``, under
   ``save_qkv_residuals`` and under both: every one's loss and grads equal
   remat off's bit for bit, the policy's launches exactly
   ``per_step_launches`` at each knob, SDPA's forwards once a layer (twice
   with the whole-layer checkpoint), and each run's peak memory; then
   ViT-Giant at phase 11's width cut to ``REMAT_VIT_BLOCKS`` blocks, remat
   on against off, bit for bit, the launches ``vit_per_step_launches``.
   Every entry gains the phase's launches (``remat_launches``).
20. the measurement drivers (``drivers_phase``), each through its ``main``
   on its JAX script's flags, printing its own lines and its seconds, at
   Llama2-1B's width: ``benchmark_train_ladder --sr`` at full depth (every
   rung's launches a step exactly ``ladder_per_step_launches``, its first
   loss within 1e-2 of bf16's), then at ``DRIVER_LAYERS`` layers
   ``benchmark_inference --quantize mixed_precision`` (JAX's keys),
   ``benchmark_serving --load uniform`` and ``benchmark_step_components``
   (every variant ran), and ``benchmark_fused`` at M 16,384 (each chain's
   fused output within ``STEP_BOUND`` int8 steps of the unfused
   composite's, B13's equal); then the lines of ``bench`` (phase 8),
   ``--load mixed`` (4) and ``_bench_vit_giant`` (11). Every entry gains the
   phase's launches (``driver_launches``). ``[t]`` lines give each phase's
   seconds.

Each step's key is ``fold_in(key, i)`` of one key drawn from a generator
seeded with ``--seed``. The last lines are the kernel table as JSON (each
kernel's launches on its path, for K2, B1, B2, B15, B16 and B17 also those
on the sm90 route (``sm90_launches``; for K1 those on the row walk; K2's
decode stream has an entry of its own, ``scaled_mm_rhs_t_decode``, with its
launches in phase 4; for B4, B5 and the SR quantizes every
shape's times and bound, ``shapes``), its error against the plain version, its
time, the plain version's, the least time the H100 could take for the same
work, what bounds that time, and the library call's time where one
exists; for B7, B8, B9 (rows and columns), B10, B11, B12, B14 and B18 also their launches on the row walk,
for B4 those on its cluster form and for B19 those on its sm90 design
(``sm90_launches``), and their first design's time, ``first_design_ms``; for B14 every timed form and
layout, ``forms``),
the nvidia-smi line, and ``{"ok": true, "device": {...}}``.

Usage: python3 chip_smoke.py [--seed N]
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import gc
import importlib
import json
import os
import shutil
import subprocess
import sys
import time
from datetime import timedelta
from functools import partial

import numpy as np
import torch
import torch.distributed as dist

from quantized_training_tpu_torch import (_bench_vit_giant, accuracy_parity, bench, benchmark_collectives,
                                          benchmark_conv2d, benchmark_fused, benchmark_inference, benchmark_mm,
                                          benchmark_serving, benchmark_step_components, benchmark_train_ladder,
                                          hellaswag, llm_evaluate, llm_finetune, llm_pretrain, mc_eval, ops, optim,
                                          parallel, quant, tokenize_data, train, vit_train)
from quantized_training_tpu_torch.data import BatchLoader, MarkovTokenDataset, SyntheticImageDataset, get_tokenizer
from quantized_training_tpu_torch.models import llama, llama_infer, vit
from quantized_training_tpu_torch.models.serving import Server
from quantized_training_tpu_torch.ops import _build, random
from quantized_training_tpu_torch.ops.fp8 import quantize_fp8_block, quantize_fp8_tile
from quantized_training_tpu_torch.quant.core import quantize_int4_rowwise_absmax
from quantized_training_tpu_torch import data
from quantized_training_tpu_torch.utils import checkpoint, load_checkpoint
from quantized_training_tpu_torch.utils.timing import copies, time_ms
from quantized_training_tpu_torch.utils.tree import map_tensors, tree_leaves, tree_map

# the modules: the ops package exports functions of their names
TILE_MM = importlib.import_module("quantized_training_tpu_torch.ops.tile_scaled_mm")
MATMUL = importlib.import_module("quantized_training_tpu_torch.ops.matmul")
SCALED_MM = importlib.import_module("quantized_training_tpu_torch.ops.scaled_mm")
FP = importlib.import_module("quantized_training_tpu_torch.ops.fused_producers")
IQ = importlib.import_module("quantized_training_tpu_torch.ops.int8_quant")
ROPE = importlib.import_module("quantized_training_tpu_torch.ops.rope")
INT4_MM = importlib.import_module("quantized_training_tpu_torch.ops.int4_mm")
ATTN = importlib.import_module("quantized_training_tpu_torch.ops.int8_attention")
FUSED = importlib.import_module("quantized_training_tpu_torch.quant.fused")
REMAT = importlib.import_module("quantized_training_tpu_torch.ops.remat")
GRAPHS = importlib.import_module("quantized_training_tpu_torch.utils.graphs")
PROFILE = importlib.import_module("profile_torch_step")  # its kernel groups
SEED = 0
# phase 14's requests: the first of benchmark_serving's mixed load, at
# these budgets
MIX_BUDGETS = (16, 32, 48, 64)
N_REQUESTS = 16
# phase 4's: benchmark_serving's mixed load (3 x 8 requests) with its budgets
# (64, 160, 320, 448) cut for time
SERVE_BUDGETS = (4, 8, 12, 16)
# the near-tie bar of the static baseline's streams against the server's:
# a prefill of 8 left-padded prompts and a batched decode against one prefill
# a request and the server's slots sum in other shapes, and an int8
# activation that rounds one step the other way moves a logit by about 1/127
# of its scale; partings measured at top-2 margins up to 2.70e-2 of
# max|logit| on the H100 in this phase (a batch of one against the server
# keeps 1e-2)
STATIC_BAR = 5e-2
CFG = llama.LLAMA2_1B
DEVICE = "cuda"
SMI = ""  # the card's name and power limit, as nvidia-smi gives them (phase 1)
D, F, KVD = CFG.hidden_size, CFG.intermediate_size, CFG.num_key_value_heads * CFG.head_dim
SERVING_KERNELS = ("quantize_int8_rowwise", "scaled_mm_rhs_t")  # K1, K2
TRAIN_B, TRAIN_S = 4, 2048  # llm_pretrain.py's defaults
TOKENS = TRAIN_B * TRAIN_S
BENCH_ACCUM = 4  # bench.py: effective batch 16 as 4 x 4 accumulation
# phase 8's synced and chained steps in bench.measure (the driver's N_STEPS
# is 8), cut for time: 2 + 2 + 2 steps a configuration, where the phase ran 3
BENCH_STEPS = 2
# the keys of bench.py's JSON line (bench.py:190-209)
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "detail"}
BENCH_DETAIL_KEYS = {"bf16_tokens_per_sec", "int8_vs_bf16_speedup", "batch_size", "grad_accum", "effective_batch",
                     "seq_len", "device"}
# (name, out, in) of every quantized linear of a layer; q/o, gate/up share a shape
LINEARS = (("q/o", D, D), ("k/v", KVD, D), ("gate/up", F, D), ("down", D, F))
WEIGHTS = [(o, i) for _, o, i in LINEARS]
# every parameter shape of Llama2-1B (embedding and lm_head, the stacked
# layers' q/o, k/v, gate/up, down and norms, the final norm)
PARAM_SHAPES = [(CFG.vocab_size, D), (CFG.num_hidden_layers, D, D), (CFG.num_hidden_layers, KVD, D),
                (CFG.num_hidden_layers, F, D), (CFG.num_hidden_layers, D, F), (CFG.num_hidden_layers, D), (D,)]
# the fused layer's producer inputs: the RMSNorm sites [tokens, hidden] and
# the silu site [tokens, FFN], with one small shape each
NORM_SHAPES = [(TOKENS, D), (256, D)]
SILU_SHAPES = [(TOKENS, F), (256, F)]
# ViT-Giant (timm's vit_giant_patch14_dinov2) as vit_train.py trains it:
# batch 24 at 224 px, 257 tokens an image, 45 classes (the driver's
# default); the fused linears pad the 6,168 tokens to 6,400
VIT_CFG = vit_train.model_config("vit_giant", 45, 224)
VIT_B = 24
VIT_TOKENS = VIT_B * (VIT_CFG.num_patches + 1)
VIT_ROWS = -(-VIT_TOKENS // 256) * 256
# B4's [R, C]: the Llama2-1B step's weights, the unfused layer's x2d, and
# ViT-Giant's five a block and step (the qkv, proj, fc1 and fc2 weights and
# proj's input, the attention output of the batch's tokens)
VIT_B4 = [(3 * VIT_CFG.hidden_size, VIT_CFG.hidden_size), (VIT_CFG.hidden_size, VIT_CFG.hidden_size),
          (VIT_CFG.mlp_dim, VIT_CFG.hidden_size), (VIT_CFG.hidden_size, VIT_CFG.mlp_dim),
          (VIT_TOKENS, VIT_CFG.hidden_size)]
B4_SHAPES = [*WEIGHTS, (TOKENS, D), (TOKENS, F), *VIT_B4]
VIT_SEED = 2024  # the synthetic images' seed, vit_train.py's default
# phase 11's lr: the JAX repo's ViT bench takes 1e-4, at which Adam's first
# steps (about lr * sign(g) on every parameter, no warmup) raised ViT-Giant's
# loss in bf16 and int8 alike, so that the losses could not show the step
# learning; 1e-5 (below half a bf16 ulp of most weights, so mostly biases
# and small weights move) lets them fall
VIT_LR = 1e-5
# phase 11's synced and chained steps in _bench_vit_giant.measure (the
# driver's N_STEPS is 6), cut for time: a warm step and 1 + 1 a configuration
VIT_STEPS = 1
# B17 at benchmark_mm.py's largest square size
MM_N = 4096
# Each sm90 GEMM's (M, N, K) on its wmma kernel, before the sm90 mainloop
# took it, printed beside this run's times (H100 80GB HBM3, 700 W; PERF.md
# section 6): K2 and B17 bf16, us per call in phase 3 of this script's last
# run on those kernels; B1, B2, B15, B16 and B17 int8, ab_sm90_forms.py's
# parent/wmma (the kernels of the tree before they took the mainloop). K2's
# decode sizes time their wmma tile in the same call (decode_first_design).
WMMA_US = {
    "scaled_mm_rhs_t": {(512, D, D): 25.8, (512, KVD, D): 19.1, (512, F, D): 69.0, (512, D, F): 62.3,
                        (TOKENS, D, D): 330.8, (TOKENS, KVD, D): 44.3, (TOKENS, F, D): 890.2, (TOKENS, D, F): 851.5},
    "scaled_mm_lhs_t": {(D, D, TOKENS): 808.2, (KVD, D, TOKENS): 132.3, (F, D, TOKENS): 2205.2,
                        (D, F, TOKENS): 2215.7},
    "scaled_mm": {(TOKENS, D, D): 569.8, (TOKENS, D, KVD): 99.4, (TOKENS, D, F): 1524.2, (TOKENS, F, D): 1518.2},
    "scaled_int4_mm": {(TOKENS, F, D): 837.3, (TOKENS, D, F): 819.6, (F, D, TOKENS): 825.8, (D, F, TOKENS): 825.9},
    "tile_scaled_mm": {(TOKENS, F, D): 2203.5, (TOKENS, D, F): 2244.1, (F, D, TOKENS): 2282.6, (D, F, TOKENS): 2275.2},
    "tile_scaled_mm_s8": {(TOKENS, F, D): 1922.3, (TOKENS, D, F): 1951.3, (F, D, TOKENS): 1985.3,
                          (D, F, TOKENS): 1985.3},
    "matmul": {(MM_N, MM_N, MM_N): 1694.1},
    "matmul_s8": {(MM_N, MM_N, MM_N): 1121.3},
}
# B19 at Llama2-1B's attention in bench.py's micro-batch: one instance per
# (batch element, kv head), G query heads each
ATTN_LEAD = (TRAIN_B, CFG.num_key_value_heads)
ATTN_G = CFG.num_attention_heads // CFG.num_key_value_heads
# the H100 SXM's published peaks (NVIDIA's data sheet, dense, at 700 W):
# int8 and fp8 share the 8-bit tensor-core rate; fp32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1.979e15
BF16_OPS_PER_S = 989e12
FP32_OPS_PER_S = 67e12
# special-function operations (exp2, log2, reciprocal) a clock per SM on
# Hopper: 4 partitions x 4 SFUs; the rate is this times the SMs and the
# card's maximum SM clock (nvidia-smi), computed in sfu_ops_per_s
SFU_PER_SM_CLOCK = 16
# fp32 operations an element of B18's producers, counted from the plain
# versions: LayerNorm's two sums, centring, scale, affine and the quantize's
# absmax and cast about 10; GELU's 8 multiplies and adds, tanhf (an exp, a
# division and a correction, about 12) and the quantize about 25
B18_FP32_OPS = {"layernorm": 10, "gelu": 25}


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


@contextlib.contextmanager
def patched(module, **values):
    """The module's attributes set to ``values`` while entered: the
    drivers' cuts of depth (steps, budgets, batches)."""
    keep = {k: getattr(module, k) for k in values}
    for k, v in values.items():
        setattr(module, k, v)
    try:
        yield
    finally:
        for k, v in keep.items():
            setattr(module, k, v)


@contextlib.contextmanager
def preset(cfg: llama.LlamaConfig):
    """The drivers' ``llama2-1b`` (``llm_pretrain.MODELS``, which every
    benchmark driver reads) is ``cfg`` while entered: Llama2-1B cut in
    depth, or the CPU rehearsal's small model."""
    keep = llm_pretrain.MODELS["llama2-1b"]
    llm_pretrain.MODELS["llama2-1b"] = cfg
    try:
        yield
    finally:
        llm_pretrain.MODELS["llama2-1b"] = keep


def bound(nbytes: float, int8_ops: float = 0.0, fp32_ops: float = 0.0, bf16_ops: float = 0.0,
          sfu_ops: float = 0.0) -> tuple[float, str]:
    """The least time in ms the H100 could take for work that must move
    ``nbytes`` (each input read once, each output written once) and do
    ``int8_ops`` int8 or fp8 operations and ``bf16_ops`` bf16 ones on the
    tensor cores, ``fp32_ops`` fp32 ones outside them and ``sfu_ops``
    exponentials on the special-function units, and which bounds it, bytes
    or operations."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(int8_ops / INT8_OPS_PER_S, fp32_ops / FP32_OPS_PER_S, bf16_ops / BF16_OPS_PER_S,
                sfu_ops / sfu_ops_per_s() if sfu_ops else 0.0) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


@functools.cache
def sfu_ops_per_s() -> float:
    """The card's special-function rate: ``SFU_PER_SM_CLOCK`` x its SMs x its
    maximum SM clock."""
    mhz = float(subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                               capture_output=True, text=True, check=True).stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rate = SFU_PER_SM_CLOCK * sms * mhz * 1e6
    print(f"[3] special-function rate: {SFU_PER_SM_CLOCK} a clock x {sms} SMs x {mhz:.0f} MHz = {rate / 1e12:.3f} T/s")
    return rate


def card() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available; this script needs one CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"[1] device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
          f"torch {torch.__version__} cuda {torch.version.cuda}; nvidia-smi: {smi}", flush=True)
    global SMI
    SMI = smi
    return smi


def build() -> None:
    t0 = time.perf_counter()
    _build.library()
    print(f"[2] build: {time.perf_counter() - t0:.2f} s for "
          f"{', '.join(p.name for p in _build.sources())}", flush=True)
    log = _build.BUILD_DIR / "build.log"
    for line in log.read_text().splitlines() if log.exists() else []:
        if "Used" in line or "spill" in line:
            print(f"    ptxas: {line.strip()}")


def check_k1(gen: torch.Generator) -> dict:
    """K1 at the serving path's and the training step's shapes: bit-exact,
    timed beside its plain version; where its route takes the persistent
    row walk (every shape but the KV rows of 64), also checked to launch
    there and timed on its first design in the same call (``first_design``).
    The entry's numbers are those at gate/up's weight [5632, 2048], the
    largest a decode step quantizes."""
    shapes = {
        "decode act": [(8, D), (8, F)],
        "prefill act": [(16, D), (512, D), (512, F)],
        "train act": [(TOKENS, D), (TOKENS, F)],
        "weight": [(D, D), (KVD, D), (F, D), (D, F)],
        "kv rows": [(8 * 1 * 4, CFG.head_dim), (1 * 512 * 4, CFG.head_dim)],
    }
    worst, timed, first_ms = 0.0, None, None
    for kind, group in shapes.items():
        for shape in group:
            x = torch.randn(shape, generator=gen, device=DEVICE).to(torch.bfloat16)
            x[0] = 0  # an inactive slot's all-zero row
            q, s = ops.quantize_int8_rowwise(x)
            q_ref, s_ref = ops.quantize_int8_plain(x)
            torch.cuda.synchronize()
            err = max((q.int() - q_ref.int()).abs().max().item(), (s.float() - s_ref.float()).abs().max().item())
            check(torch.equal(q, q_ref) and torch.equal(s, s_ref), f"K1 bit-exact at {kind} {shape}")
            worst = max(worst, err)
            inputs = copies(x)
            ms = time_ms(ops.quantize_int8_rowwise, inputs)
            plain_ms = time_ms(ops.quantize_int8_plain, inputs)
            nbytes = 3 * x.numel() + 2 * shape[0]  # x read, q and the bf16 scales written
            print(f"[3] K1 quantize_int8_rowwise {kind} {list(shape)} bf16: bit-exact; "
                  f"kernel {ms:.4f} ms ({bound(nbytes)[0] / ms:.3f} of the bound), plain {plain_ms:.4f} ms")
            first = (first_design("quantize_int8_rowwise", ops.quantize_int8_rowwise, (x,), nbytes)
                     if IQ.rowwise_sm90_route(*shape, x.dtype) else None)
            if shape == (F, D):  # the largest per-matmul byte mover of a decode step
                timed, first_ms = (shape, ms, plain_ms), first
    M, K = timed[0]
    return _entry("quantize_int8_rowwise", "quantized_training_tpu/ops/pallas_quant.py:139", worst, timed,
                  3 * M * K + 2 * M, first_ms=first_ms)


# the route each GEMM with an sm90 form takes on its operands (a, b, scales),
# by counter name: the predicates of ops/scaled_mm.py, ops/tile_scaled_mm.py
# and ops/int4_mm.py
ROUTES = {
    "scaled_mm_rhs_t": lambda a, b, *_: SCALED_MM.sm90_route(a.shape[0]),
    "scaled_mm": lambda a, b, *_: SCALED_MM.rhs_mn_sm90_route(b.shape[1], a.shape[1]),
    "scaled_mm_lhs_t": lambda a, b, *_: SCALED_MM.lhs_t_sm90_route(a.shape[1], b.shape[1], a.shape[0]),
    "tile_scaled_mm": lambda a, b, sa, *_: TILE_MM.sm90_route(a.shape[1] // sa.shape[1]),
    "tile_scaled_mm_s8": lambda a, b, sa, *_: TILE_MM.sm90_route(a.shape[1] // sa.shape[1]),
    "scaled_int4_mm": lambda a, b, *_: INT4_MM.sm90_route(a.shape[0], 2 * a.shape[1],
                                                          a.data_ptr() % 16 == 0 and b.data_ptr() % 16 == 0),
}


def decode_splits(a, b) -> int:
    """K2's decode route on its operands (0: off it)."""
    aligned = a.data_ptr() % 16 == 0 and b.data_ptr() % 16 == 0
    return SCALED_MM.decode_route(a.shape[0], b.shape[0], a.shape[1], aligned)


def routed(name: str, kernel, args) -> torch.Tensor:
    """``kernel`` once on ``args``, checked to launch once and to count that
    launch on the route ``ROUTES[name]`` gives (K2 off sm90: on its decode
    stream where ``decode_route`` takes it, else on the wmma tile)."""
    ops.reset_launch_counts()
    out = kernel(*args)
    sm90, n = ROUTES[name](*args), ops.launch_counts()
    decode = name == "scaled_mm_rhs_t" and not sm90 and bool(decode_splits(*args[:2]))
    route = "sm90" if sm90 else "decode" if decode else "wmma"
    check(n[name] == 1 and n[f"{name}_sm90"] == int(sm90) and n.get(f"{name}_decode", 0) == int(decode),
          f"{name} at {[tuple(t.shape) for t in args[:2]]} launched once, on the {route} route")
    return out


def sm90_timing(name: str, args, M: int, N: int, K: int, ms: float, nbytes: float) -> str:
    """A GEMM's route, share of its bound and time against its wmma
    kernel's (``WMMA_US``)."""
    b_ms, by = bound(nbytes, int8_ops=2.0 * M * N * K)
    wmma = WMMA_US[name][(M, N, K)] / 1e3
    return (f"route {'sm90' if ROUTES[name](*args) else 'wmma'}, {b_ms / ms:.3f} of the {b_ms:.4f} ms bound by "
            f"{by}; the wmma kernel {wmma:.4f} ms ({wmma / ms:.2f}x this)")


def check_k2(gen: torch.Generator) -> tuple[float, dict]:
    """K2 at the serving shapes (decode M 8 and 16 on the split-K weight
    stream, prefill M 512 on the sm90 mainloop), each call checked to take
    its route, timed beside ``torch._int_mm``, its bound and its first
    design's time (decode: the wmma tile, the route forced to 0, in this
    call; sm90: ``WMMA_US``); returns the worst error (K2's entry is taken at
    the training step's shape) and the decode stream's entry (M 8, gate/up,
    bound by the weight's bytes)."""
    worst, decode_entry = 0.0, None
    for M in (8, 16, 512):
        for name, N, K in (("q/o", D, D), ("k/v", KVD, D), ("gate/up", F, D), ("down", D, F)):
            a, sa = ops.quantize_int8_plain(torch.randn(M, K, generator=gen, device=DEVICE).to(torch.bfloat16))
            b, sb = ops.quantize_int8_plain(
                (torch.randn(N, K, generator=gen, device=DEVICE) * 0.02).to(torch.bfloat16))
            sb = sb.reshape(1, N)
            out = routed("scaled_mm_rhs_t", ops.scaled_mm_rhs_t, (a, b, sa, sb))
            ref = ops.scaled_mm_rhs_t_plain(a, b, sa, sb)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            check(torch.equal(out, ref), f"K2 bit-exact at M={M} {name} N={N} K={K}")
            worst = max(worst, err)
            inputs = copies(a, b, sa, sb)
            ms = time_ms(ops.scaled_mm_rhs_t, inputs)
            plain_ms = time_ms(ops.scaled_mm_rhs_t_plain, inputs)
            lib = int_mm_ms("scaled_mm_rhs_t", inputs)
            tops = 2 * M * N * K / ms / 1e9
            nbytes = M * K + N * K + 2 * M * N + 2 * (M + N)
            if M <= SCALED_MM.DECODE_M:
                first = decode_first_design((a, b, sa, sb), out)
                b_ms = bound(nbytes)[0]
                timing = (f"route decode ({decode_splits(a, b)} CTAs a cluster), {b_ms / ms:.3f} of the {b_ms:.4f} ms "
                          f"bound by bytes; first design (the wmma tile) {first:.4f} ms ({first / ms:.2f}x this)")
                if M == 8 and name == "gate/up":
                    decode_entry = _entry("scaled_mm_rhs_t_decode", "quantized_training_tpu/ops/pallas_mm.py:192", err,
                                          ((M, N, K), ms, plain_ms), nbytes, 2 * M * N * K, lib, first_ms=first)
            else:
                timing = sm90_timing("scaled_mm_rhs_t", (a, b), M, N, K, ms, nbytes)
            print(f"[3] K2 scaled_mm_rhs_t M={M} {name} N={N} K={K} -> bf16: bit-exact; kernel {ms:.4f} ms "
                  f"({tops:.1f} TOP/s, {nbytes / ms / 1e6:.0f} GB/s), {timing}; plain "
                  f"(float64 matmul) {plain_ms:.4f} ms, torch._int_mm (int32 out) "
                  f"{'refused' if lib is None else f'{lib:.4f} ms'}")
    k2_host_cost(gen)
    decode_entry["max_abs_err"] = worst
    return worst, decode_entry


def check_storage_forms(gen: torch.Generator) -> None:
    """The operand forms the storage schemes (phase 14) give K1 and K2, each
    bit-exact with its plain version and each call checked to take its
    route: K2 at the decode (M 8, the split-K stream) and prefill (M 8192,
    sm90) sizes of every Llama2-1B linear, its column scale the bf16 row
    scale [O, 1] of an ``Int8Weight`` (the linear passes it as [1, O]) and
    the bf16 scalar of a BitNet weight; K1 at BitNet's eps 1e-5 on the
    activations of 8 and 8192 tokens (a row of zeros, where eps decides the
    scale); K1-SR on every stacked [22, O, I] weight, as the commit
    re-quantizes them (the row walk at K 2048, the first design at down's
    5632: ``rowwise_sm90_route``), timed beside its plain version."""
    L = CFG.num_hidden_layers
    for name, N, K in (("q/o", D, D), ("k/v", KVD, D), ("gate/up", F, D), ("down", D, F)):
        w = (torch.randn(N, K, generator=gen, device=DEVICE) * 0.02).to(torch.bfloat16)
        stored = quant.Int8Weight.from_float(w)
        ternary_scale = quant.get_bitnet_scale(w)
        w_i8 = quant.quantize_bitnet_weight(w, ternary_scale)
        for M in (8, TOKENS):
            x = torch.randn(M, K, generator=gen, device=DEVICE).to(torch.bfloat16)
            x[0] = 0
            for what, b, sb, eps in (("Int8Weight [O] column scale", stored.int_data, stored.scale.reshape(1, -1),
                                      IQ.EPS),
                                     ("BitNet scalar column scale", w_i8, ternary_scale.to(torch.bfloat16), 1e-5)):
                ops.reset_launch_counts()
                a, sa = ops.quantize_int8_rowwise(x, eps=eps)
                a_ref, sa_ref = ops.quantize_int8_plain(x, eps=eps)
                check(torch.equal(a, a_ref) and torch.equal(sa, sa_ref), f"K1 eps {eps:g} bit-exact at [{M}, {K}]")
                check(ops.launch_counts()["quantize_int8_rowwise_sm90"] == 1, f"K1 at [{M}, {K}] on the row walk")
                out = routed("scaled_mm_rhs_t", ops.scaled_mm_rhs_t, (a, b, sa, sb))
                check(torch.equal(out, ops.scaled_mm_rhs_t_plain(a, b, sa, sb)),
                      f"K2 with the {what} bit-exact at M={M} {name}")
        print(f"[3] storage forms at {name} [{N}, {K}]: K2 with an Int8Weight's bf16 [O] column scale and with a "
              f"BitNet bf16 scalar column scale, M 8 (decode stream) and {TOKENS} (sm90), bit-exact; K1 at eps "
              f"1e-5 (BitNet's activations) and 1e-12, bit-exact, on the row walk")
        master = (torch.randn(L, N, K, generator=gen, device=DEVICE) * 0.02).to(torch.bfloat16)
        key = random.fold_in(SEED, N * K)
        ops.reset_launch_counts()
        q, sc = ops.quantize_int8_rowwise(master, sr=True, key=key)
        walk = ops.launch_counts()["quantize_int8_rowwise_sr_sm90"]
        check(walk == int(bool(IQ.rowwise_sm90_route(L * N, K, master.dtype, True))),
              f"K1-SR at [{L}, {N}, {K}] on the route rowwise_sm90_route gives")
        q_ref, sc_ref = ops.quantize_int8_plain(master, sr=True, key=key)
        check(torch.equal(q, q_ref) and torch.equal(sc, sc_ref), f"K1-SR bit-exact on the stacked [{L}, {N}, {K}]")
        inputs = copies(master)
        ms = time_ms(partial(ops.quantize_int8_rowwise, sr=True, key=key), inputs)
        b_ms = bound(3 * master.numel() + 2 * L * N)[0]
        print(f"[3] K1-SR on the stacked [{L}, {N}, {K}] bf16 (the commit of an int8-stored weight): bit-exact, "
              f"{'row walk' if walk else 'first design'}; kernel {ms:.4f} ms ({b_ms / ms:.3f} of the {b_ms:.4f} ms "
              f"bound by bytes)")
        del master, q, q_ref, inputs


def decode_first_design(args, out) -> float:
    """K2 at a decode size on its first design, the wmma tile (the decode
    route forced to 0): the stream's output bit for bit, and its time."""
    route = SCALED_MM.decode_route
    SCALED_MM.decode_route = lambda *a: 0
    try:
        ops.reset_launch_counts()
        first = ops.scaled_mm_rhs_t(*args)
        check(ops.launch_counts()["scaled_mm_rhs_t_decode"] == 0, "K2's decode route forced off")
        first_ms = time_ms(ops.scaled_mm_rhs_t, copies(*args))
    finally:
        SCALED_MM.decode_route = route
    check(torch.equal(out, first), "K2's decode stream gives the wmma tile's bits")
    return first_ms


def k2_host_cost(gen: torch.Generator, n: int = 2000) -> None:
    """Host time of one K2 call on each route (the wrapper's checks, for
    sm90 the two ``cuTensorMapEncodeTiled`` calls and the attribute set, the
    launch), at N = K = 256, where the card finishes a call in a few us and
    the host sets the pace: M 17 (sm90) against M 16 (the wmma tile), in
    turns, wall clock over ``n`` calls ending in a synchronize."""
    b = torch.randint(-128, 128, (256, 256), generator=gen, device=DEVICE, dtype=torch.int8)
    sb = torch.rand(1, 256, generator=gen, device=DEVICE)
    us = {17: [], 16: []}
    for M in (17, 16, 16, 17):
        a = torch.randint(-128, 128, (M, 256), generator=gen, device=DEVICE, dtype=torch.int8)
        sa = torch.rand(M, 1, generator=gen, device=DEVICE)
        ops.scaled_mm_rhs_t(a, b, sa, sb)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            ops.scaled_mm_rhs_t(a, b, sa, sb)
        torch.cuda.synchronize()
        us[M].append((time.perf_counter() - t0) / n * 1e6)
    sm90, wmma = (sum(v) / len(v) for v in (us[17], us[16]))
    print(f"[3] K2 host time per call at N = K = 256 (host-bound, {n} calls, in turns): sm90 route (M 17) "
          f"{sm90:.2f} us {[round(v, 2) for v in us[17]]}, wmma route (M 16) {wmma:.2f} us "
          f"{[round(v, 2) for v in us[16]]}; the sm90 route's tensor-map encodes and attribute set: "
          f"{sm90 - wmma:.2f} us a call")
    for M in (17, 16):
        a = torch.randint(-128, 128, (M, 256), generator=gen, device=DEVICE, dtype=torch.int8)
        sa = torch.rand(M, 1, generator=gen, device=DEVICE)
        parts = k2_call_parts(a, b, sa, sb, n)
        replay = k2_replay_cost(a, b, sa, sb)
        print(f"[3] K2's call at M {M} ({'sm90' if M > SCALED_MM.DECODE_M else 'wmma'} route; {SMI}), its parts "
              f"timed alone over {n} calls each, us: " + ", ".join(f"{k} {v:.2f}" for k, v in parts.items())
              + f"; sum {sum(parts.values()):.2f} against the whole call's {(sm90, wmma)[M == 16]:.2f}", flush=True)
        print(f"[3] K2 at M {M} in a CUDA graph of {replay['launches']} launches: host {replay['host_us']:.3f} us a "
              f"captured launch (graph.replay() returning), {replay['wall_us']:.3f} us a launch to completion (the "
              f"device's pace), against the eager call's {(sm90, wmma)[M == 16]:.2f} us", flush=True)


def _per_call_us(fn, n: int) -> float:
    """Host wall of ``fn()`` per call over ``n`` calls, after one, ending
    in a synchronize."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e6


class _NoLaunch:
    """``_build`` for ``scaled_mm._launch`` with every kernel entry point
    returning success without a launch: what is left is the wrapper's
    checks and its ``torch.empty``."""

    check = staticmethod(_build.check)

    class library_stub:
        def __getattr__(self, name):
            return lambda *args: 0

    _lib = library_stub()

    @classmethod
    def library(cls):
        return cls._lib

    @staticmethod
    def stream() -> int:
        return 0


def k2_call_parts(a, b, sa, sb, n: int) -> dict:
    """The host time of each part of one K2 call (``ops.scaled_mm_rhs_t``)
    at a [M, 256], b [256, 256], each timed alone over ``n`` calls, us: the
    route predicates, the checks (``_launch`` with no launch, less its
    ``torch.empty``), ``torch.empty`` of the output, ``_build.stream()``,
    and the ctypes call that launches the kernel."""
    M, N, K = a.shape[0], b.shape[0], a.shape[1]
    sm90 = SCALED_MM.sm90_route(M)
    route = _per_call_us(lambda: SCALED_MM.sm90_route(M) or SCALED_MM.decode_route(
        M, N, K, a.data_ptr() % 16 == 0 and b.data_ptr() % 16 == 0), n)
    empty = _per_call_us(lambda: torch.empty((M, N), dtype=torch.bfloat16, device=a.device), n)
    with patched(SCALED_MM, _build=_NoLaunch):
        checked = _per_call_us(lambda: SCALED_MM._launch("scaled_mm_rhs_t", a, b, sa, sb, (1, 1), torch.bfloat16,
                                                         sm90, 0), n)
    stream = _per_call_us(_build.stream, n)
    lib, out = _build.library(), torch.empty((M, N), dtype=torch.bfloat16, device=a.device)
    args = (a.data_ptr(), b.data_ptr(), sa.data_ptr(), sb.data_ptr(), out.data_ptr(), M, N, K, 1, 1, 0, 1, int(sm90),
            _build.stream())
    launch = _per_call_us(lambda: lib.qt_scaled_mm_s8(*args), n)
    return {"route predicates": route, "checks": checked - empty, "torch.empty": empty, "_build.stream()": stream,
            "ctypes call and launch": launch}


def k2_replay_cost(a, b, sa, sb, launches: int = 200, replays: int = 20) -> dict:
    """K2 ``launches`` times on the same operands, captured as one CUDA
    graph (``utils/graphs.py``) and replayed ``replays`` times: the host's
    time in ``graph.replay()`` and the wall to completion, per captured
    launch (us)."""
    captured = GRAPHS.Captured(lambda: [ops.scaled_mm_rhs_t(a, b, sa, sb) for _ in range(launches)])
    captured.replay()
    torch.cuda.synchronize()
    host, t0 = 0.0, time.perf_counter()
    for _ in range(replays):
        t1 = time.perf_counter()
        captured.graph.replay()
        host += time.perf_counter() - t1
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return dict(launches=launches, host_us=host / replays / launches * 1e6,
                wall_us=wall / replays / launches * 1e6)


def _entry(name, replaces, worst, timed, nbytes, int8_ops=0.0, library_ms=None, fp32_ops=0.0, bf16_ops=0.0,
           sfu_ops=0.0, first_ms=None):
    """One kernel's line of the JSON table; ``launches`` is filled in from
    the run of its path. ``first_ms``: a redesigned kernel's first design,
    timed in the same call (B7, B11, B19)."""
    src = ("int8_quant.cu" if name.startswith("quantize") else
           "fused_adamw.cu" if name.startswith("fused_adamw") else
           "fused_producers.cu" if name.startswith(("rmsnorm", "silu", "layernorm", "gelu")) else
           "rope.cu" if name.startswith(("rope", "ungroup")) else
           "tile_scaled_mm.cu" if name.startswith("tile_scaled") else
           "matmul.cu" if name.startswith("matmul") else
           "int8_attention.cu" if name.startswith("int8_flash") else "scaled_mm.cu")
    bound_ms, bound_by = bound(nbytes, int8_ops, fp32_ops, bf16_ops, sfu_ops)
    entry = {"name": name, "route": "cuda", "source": f"quantized_training_tpu_torch/ops/csrc/{src}",
             "replaces": replaces, "launches": 0, "max_abs_err": worst, "shape": list(timed[0]), "ms": timed[1],
             "plain_ms": timed[2], "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms}
    if first_ms is not None:
        entry["first_design_ms"] = first_ms
    return entry


def _max_err(got, ref) -> float:
    return max((a.double() - b.double()).abs().max().item() for a, b in zip(got, ref))


def quantize_bytes(M: int, K: int, writes: int) -> int:
    """The bytes a bf16 [M, K] quantize must move: x read once, ``writes``
    int8 outputs and the bf16 scales (one per column for a column quantize,
    one per row and column for B5) written once."""
    return M * K * (2 + writes) + 2 * (K if writes == 1 else M + K)


# B5's shapes: the output gradients of the bench.py step (q/o and down
# [8192, 2048], k/v [8192, 256]), of the unfused layer's gate/up ([8192,
# 5632]) and of ViT-Giant's step (qkv, fc1, proj and fc2 at 6,400 tokens)
B5_SHAPES = [(TOKENS, D), (TOKENS, KVD), (TOKENS, F), (VIT_ROWS, 3 * VIT_CFG.hidden_size),
             (VIT_ROWS, VIT_CFG.mlp_dim), (VIT_ROWS, VIT_CFG.hidden_size)]


def check_training_quantizes(gen: torch.Generator) -> list:
    """B4 at the backward's column quantizes (every weight, and the unfused
    layer's x2d [8192, in]), B5 at its output gradients (``B5_SHAPES``):
    bit-exact, timed (device time; GB/s of the bytes the algorithm needs,
    each input read and each output written once, and the share of the
    bound those bytes give); B4 at every shape also on its first design
    (``first_design``, the route forced to 0). Each entry records every
    shape's times and bound (``shapes``); its own numbers are those of B4 at
    gate/up's weight [5632, 2048] (the largest the fused step launches it
    at) and of B5 at [8192, 2048], the shape the bench.py step launches it
    at most."""
    out = []
    for name, kernel, plain, shapes, writes, replaces, timed_shape in (
        ("quantize_int8_colwise", ops.quantize_int8_colwise, lambda x: ops.quantize_int8_plain(x, axis=0),
         B4_SHAPES, 1, "quantized_training_tpu/ops/pallas_quant.py:229", (F, D)),
        ("quantize_int8_both", ops.quantize_int8_both, ops.quantize_int8_both_plain, B5_SHAPES, 2,
         "quantized_training_tpu/ops/pallas_quant.py:306", (TOKENS, D)),
    ):
        worst, timed, first_ms, per_shape = 0.0, None, None, []
        for shape in shapes:
            x = (torch.randn(shape, generator=gen, device=DEVICE) * 1e-3).to(torch.bfloat16)
            x[0] = 0  # an all-zero row and column
            x[:, 1] = 0
            got, ref = kernel(x), plain(x)
            torch.cuda.synchronize()
            check(all(torch.equal(a, b) for a, b in zip(got, ref)), f"{name} bit-exact at {list(shape)}")
            worst = max(worst, _max_err(got, ref))
            inputs = copies(x)
            ms, plain_ms = time_ms(kernel, inputs), time_ms(plain, inputs)
            nbytes = quantize_bytes(*shape, writes)
            b_ms, _ = bound(nbytes)
            per_shape.append({"shape": list(shape), "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms})
            print(f"[3] {name} {list(shape)} bf16: bit-exact; kernel {ms:.4f} ms ({nbytes / ms / 1e6:.0f} GB/s, "
                  f"{b_ms / ms:.3f} of the {b_ms:.4f} ms bound by bytes), plain {plain_ms:.4f} ms")
            if name in REDESIGNED:
                per_shape[-1]["first_design_ms"] = first_design(name, kernel, (x,), nbytes)
            if shape == timed_shape:
                timed, first_ms = (shape, ms, plain_ms), per_shape[-1].get("first_design_ms")
        out.append(_entry(name, replaces, worst, timed, quantize_bytes(*timed[0], writes), first_ms=first_ms)
                   | {"shapes": per_shape})
    return out


# The mesh forms' shapes, bf16: a rank's x2d at local batch 1 x 2048 (the
# token axis that B5's and B4's maxima span in phase 18 (b), (h), (i)), the
# Llama2-1B weights' halves on a rank under {"fsdp": 2} (QT_PREQUANT's views,
# (i): B5 for 'both', B4 for 'col'), and K1 at phase 18 (d)'s row-parallel
# inputs over 2 ranks (o's and down's K halved, 4 prompts of 128 tokens)
MESH_LOCAL = 2048
MESH_FORM_SHAPES = {
    "rowwise": [(MESH_LOCAL, D), (MESH_LOCAL, F), (512, D // 2), (512, F // 2)],
    "colwise": [(MESH_LOCAL, D), (MESH_LOCAL, F), (D // 2, D), (KVD // 2, D), (F // 2, D), (D // 2, F)],
    "both": [(MESH_LOCAL, D), (MESH_LOCAL, F), (D // 2, D), (KVD // 2, D), (F // 2, D), (D // 2, F)],
}
# K1, B7, B8 and B10 at phase 17's accuracy_parity model (hidden 256, 16 x
# 128 tokens), where they take their first designs
K256 = (2048, 256)


def mesh_form_bytes(form: str, M: int, K: int) -> tuple[int, int]:
    """The bytes the (maxima, given-maxima) forms of a bf16 [M, K] quantize
    must move: the maxima form reads x and writes fp32 maxima (and B5's its
    row quantize: q_row, bf16 s_row); the given form reads x and the fp32
    maxima and writes q and the bf16 scales."""
    n = M if form == "rowwise" else K
    maxima = 2 * M * K + 4 * n + (M * K + 2 * M if form == "both" else 0)
    return maxima, 3 * M * K + 6 * n


def check_mesh_forms(gen: torch.Generator, key: int) -> list:
    """The mesh forms of K1, B4 and B5 (``MESH_FORM_SHAPES``) against their
    plain versions, bit for bit: each maxima form against the fp32 max |x|
    (B5's with its row quantize), K1's given form and the given column cast
    (B4's and B5's one) against the whole quantize's plain version given
    those maxima, RN and, at the first shape, SR; each timed with its plain
    version, the maxima forms also beside ``torch.linalg.vector_norm`` (ord
    inf), one PyTorch call for max |x| along an axis. Returns the five
    entries (the first shape's numbers, every shape's in ``shapes``). Then
    K1, B7, B8 and B10 at ``K256``, held and timed (printed)."""
    pq = "quantized_training_tpu/ops/pallas_quant.py"
    rowwise_given = IQ.quantize_int8_rowwise_given
    cols_given = IQ.quantize_int8_colwise_given
    forms = {"rowwise": (IQ.quantize_int8_rowwise_maxima, rowwise_given, -1, f"{pq}:139"),
             "colwise": (IQ.quantize_int8_colwise_maxima, cols_given, 0, f"{pq}:229"),
             "both": (IQ.quantize_int8_both_maxima, cols_given, 0, f"{pq}:306")}
    rows = {}  # entry name -> (replaces, [per-shape records])
    for form, (maxima, given, axis, replaces) in forms.items():
        name_m = f"quantize_int8_{form}_maxima"
        name_g = "quantize_int8_rowwise_given" if form == "rowwise" else "quantize_int8_colwise_given"
        if form == "both":
            m_plain = lambda x: (*IQ.quantize_int8_plain(x, axis=1), IQ.quantize_int8_maxima_plain(x, 0))
        else:
            m_plain = lambda x, axis=axis: IQ.quantize_int8_maxima_plain(x, axis)
        g_plain = lambda x, amax, axis=axis, **kw: IQ.quantize_int8_plain(x, axis=axis, amax=amax, **kw)
        for i, (M, K) in enumerate(MESH_FORM_SHAPES[form]):
            x = (torch.randn(M, K, generator=gen, device=DEVICE) * 1e-2).to(torch.bfloat16)
            x[0] = 0  # an all-zero row and column
            x[:, 1] = 0
            ops.reset_launch_counts()
            got_m, ref_m = maxima(x), m_plain(x)
            got_m, ref_m = (t if isinstance(t, tuple) else (t,) for t in (got_m, ref_m))
            amax = got_m[-1]
            got_g, ref_g = given(x, amax), g_plain(x, ref_m[-1])
            torch.cuda.synchronize()
            counts = ops.launch_counts()
            check(counts[name_m] == 1 and counts[name_g] == 1, f"{name_m} and {name_g} launched once each")
            check(all(torch.equal(a, b) for a, b in zip(got_m, ref_m)), f"{name_m} bit-exact at {[M, K]}")
            check(all(torch.equal(a, b) for a, b in zip(got_g, ref_g)), f"{name_g} bit-exact at {[M, K]}")
            if i == 0:
                sr_got, sr_ref = given(x, amax, sr=True, key=key), g_plain(x, ref_m[-1], sr=True, key=key)
                torch.cuda.synchronize()
                check(all(torch.equal(a, b) for a, b in zip(sr_got, sr_ref)) and not torch.equal(sr_got[0], got_g[0]),
                      f"{name_g}'s SR form bit-exact at {[M, K]}, and not round-to-nearest")
            m_bytes, g_bytes = mesh_form_bytes(form, M, K)
            timed = [(name_m, maxima, m_plain, (x,), m_bytes,
                      lambda x, dim=axis: torch.linalg.vector_norm(x, float("inf"), dim=dim))]
            if form != "both":  # B5's given form is the column cast timed at B4's shapes, which are these
                timed.append((name_g, given, g_plain, (x, amax), g_bytes, None))
            for name, kernel, plain, args, nbytes, lib in timed:
                inputs = copies(*args)
                ms, plain_ms = time_ms(kernel, inputs), time_ms(plain, inputs)
                lib_ms_ = lib_ms("torch.linalg.vector_norm", lib, inputs) if lib is not None else None
                b_ms = bound(nbytes)[0]
                rows.setdefault(name, (replaces, []))[1].append(
                    {"shape": [M, K], "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "library_ms": lib_ms_,
                     "nbytes": nbytes})
                print(f"[3] {name} {[M, K]} bf16: bit-exact; kernel {ms:.4f} ms ({nbytes / ms / 1e6:.0f} GB/s, "
                      f"{b_ms / ms:.3f} of the {b_ms:.4f} ms bound by bytes), plain {plain_ms:.4f} ms"
                      + (f", torch.linalg.vector_norm {lib_ms_:.4f} ms" if lib_ms_ else ""))
    out = []
    for name, (replaces, per) in rows.items():
        first = per[0]
        entry = _entry(name, replaces, 0.0, (tuple(first["shape"]), first["ms"], first["plain_ms"]),
                       first["nbytes"], library_ms=first["library_ms"])
        out.append(entry | {"shapes": [{k: v for k, v in r.items() if k != "nbytes"} for r in per]})
    # phase 17's K 256: the first designs of K1, B7, B8 and B10, held and timed
    M, K = K256
    x = torch.randn(M, K, generator=gen, device=DEVICE).to(torch.bfloat16)
    g = (1 + 0.1 * torch.randn(K, generator=gen, device=DEVICE)).to(torch.bfloat16)
    dy = (torch.randn(M, K, generator=gen, device=DEVICE) * 1e-3).to(torch.bfloat16)
    times = []
    _held_and_timed({}, "quantize_int8_rowwise", "", "exact", ops.quantize_int8_rowwise, ops.quantize_int8_plain,
                    (x,), 3 * M * K + 2 * M, times=times)
    row = _held_and_timed({}, "rmsnorm_quant_rowwise", ", column absmax", "int8",
                          partial(ops.rmsnorm_quant_rowwise, with_col_amax=True),
                          partial(ops.rmsnorm_quant_rowwise_plain, with_col_amax=True), (x, g),
                          3 * M * K + 2 * K + 4 * M + 4 * K, times=times)
    scale = row[2] * (1.0 / 127.0)
    _held_and_timed({}, "rmsnorm_quant_colwise", ", given scales", "int8",
                    lambda x, g, scale: ops.rmsnorm_quant_colwise(x, g, scale=scale),
                    lambda x, g, scale: ops.rmsnorm_quant_colwise_plain(x, g, scale=scale), (x, g, scale),
                    3 * M * K + 2 * K + 4 * K, times=times)
    _held_and_timed({}, "rmsnorm_bwd", "", "bwd", ops.rmsnorm_bwd, ops.rmsnorm_bwd_plain, (x, g, dy),
                    6 * M * K + 2 * K + 4 * K, times=times)
    for name, t in zip(("K1", "B7", "B8", "B10"), times):
        print(f"[3] {name} at K 256 {list(K256)} (phase 17's width, the first design): {t['ms'] * 1e3:.1f} us, "
              f"plain {t['plain_ms'] * 1e3:.1f} us, bound {t['bound_ms'] * 1e3:.2f} us")
    return out


# torch._int_mm on each form's operands as stored: the int32 product, the
# nearest library call (it has no scale epilogue)
INT_MM = {"scaled_mm_rhs_t": lambda a, b, *_: torch._int_mm(a, b.t()),
          "scaled_mm": lambda a, b, *_: torch._int_mm(a, b),
          "scaled_mm_lhs_t": lambda a, b, *_: torch._int_mm(a.t(), b)}


def int_mm_ms(name: str, inputs) -> float | None:
    """``torch._int_mm``'s time on the same operands, or None where it
    refuses them (its layout and shape conditions)."""
    return lib_ms(f"torch._int_mm on the operands of {name}", INT_MM[name], inputs)


def lib_ms(what: str, fn, inputs) -> float | None:
    """A library call's time on the same operands, or None where it refuses
    them (its layout, shape and type conditions)."""
    try:
        return time_ms(fn, inputs, iters=8)
    except (RuntimeError, ValueError) as e:
        print(f"[3] {what} refuses the operands: {str(e).splitlines()[0]}")
        return None


def check_training_gemms(gen: torch.Generator, k2_worst: float) -> list:
    """The three GEMM forms at 8192 tokens for every (out, in) of the
    model: K2 (forward x . w^T), B1 (grad_input g . w, K = out) and B2
    (grad_weight g^T . x, K = 8192), each on its operands as the backward
    quantizes them; bit-exact, timed beside ``torch._int_mm``, with TOP/s
    and GB/s; each on the route it takes (all sm90 here), with the share of
    the bound and its wmma kernel's time. Entries at gate/up;
    K2's error also covers the serving shapes (``k2_worst``)."""
    entries = []
    worst = {"scaled_mm_rhs_t": k2_worst, "scaled_mm": 0.0, "scaled_mm_lhs_t": 0.0}
    for lname, o, i in LINEARS:
        x = torch.randn(TOKENS, i, generator=gen, device=DEVICE).to(torch.bfloat16)
        w = (torch.randn(o, i, generator=gen, device=DEVICE) * 0.02).to(torch.bfloat16)
        g = (torch.randn(TOKENS, o, generator=gen, device=DEVICE) * 1e-4).to(torch.bfloat16)
        x_row, x_row_s = ops.quantize_int8_plain(x)
        w_row, w_row_s = ops.quantize_int8_plain(w)
        x_col, x_col_s = ops.quantize_int8_plain(x, axis=0)
        w_col, w_col_s = ops.quantize_int8_plain(w, axis=0)
        g_row, g_row_s, g_col, g_col_s = ops.quantize_int8_both_plain(g)
        for name, kernel, plain, args, (M, N, K), replaces in (
            ("scaled_mm_rhs_t", ops.scaled_mm_rhs_t, ops.scaled_mm_rhs_t_plain,
             (x_row, w_row, x_row_s, w_row_s.reshape(1, o)), (TOKENS, o, i),
             "quantized_training_tpu/ops/pallas_mm.py:192"),
            ("scaled_mm", ops.scaled_mm, ops.scaled_mm_plain, (g_row, w_col, g_row_s, w_col_s), (TOKENS, i, o),
             "quantized_training_tpu/ops/pallas_mm.py:85"),
            ("scaled_mm_lhs_t", ops.scaled_mm_lhs_t, ops.scaled_mm_lhs_t_plain,
             (g_col, x_col, g_col_s, x_col_s), (o, i, TOKENS), "quantized_training_tpu/ops/pallas_mm.py:192"),
        ):
            got = routed(name, kernel, args)
            ref = plain(*args)
            torch.cuda.synchronize()
            check(torch.equal(got, ref), f"{name} bit-exact at {lname} M={M} N={N} K={K}")
            worst[name] = max(worst[name], _max_err([got], [ref]))
            inputs = copies(*args)
            ms, plain_ms = time_ms(kernel, inputs, iters=8), time_ms(plain, inputs, iters=8)
            lib_ms = int_mm_ms(name, inputs)
            tops = 2 * M * N * K / ms / 1e9
            nbytes = M * K + N * K + 2 * M * N + 2 * (M + N)  # int8 operands and bf16 scales in, bf16 out
            print(f"[3] {name} {lname} M={M} N={N} K={K} -> bf16: bit-exact; kernel {ms:.4f} ms "
                  f"({tops:.1f} TOP/s, {nbytes / ms / 1e6:.0f} GB/s), {sm90_timing(name, args, M, N, K, ms, nbytes)}; "
                  f"plain (float64 matmul) {plain_ms:.4f} ms, "
                  f"torch._int_mm (int32 out) {'refused' if lib_ms is None else f'{lib_ms:.4f} ms'}")
            if lname == "gate/up":
                entries.append(_entry(name, replaces, worst[name], ((M, N, K), ms, plain_ms), nbytes,
                                      2 * M * N * K, lib_ms))
    for e in entries:  # every shape's error, not only gate/up's
        e["max_abs_err"] = worst[e["name"]]
    return entries


def gemm_forms(gen: torch.Generator):
    """(linear, form, a, b) at 8192 tokens for gate/up and down, bf16: the
    forward x . w^T, grad_input g . w and grad_weight g^T . x over the
    tokens, with a [M, K] and b [K, N] in the standard form the int4 and fp8
    tile paths quantize (the transposes materialized, as they are there)."""
    for lname, o, i in (("gate/up", F, D), ("down", D, F)):
        x = torch.randn(TOKENS, i, generator=gen, device=DEVICE).to(torch.bfloat16)
        w = (torch.randn(o, i, generator=gen, device=DEVICE) * 0.02).to(torch.bfloat16)
        g = (torch.randn(TOKENS, o, generator=gen, device=DEVICE) * 1e-4).to(torch.bfloat16)
        for form, a, b in (("forward", x, w.T), ("grad_input", g, w), ("grad_weight", g.T, x)):
            yield lname, form, a.contiguous(), b.contiguous()


def check_int4_gemms(gen: torch.Generator) -> dict:
    """B16 at the forward, grad_input and grad_weight shapes of gate/up and
    down (K = 8192 in grad_weight), on packed operands from int4 mixed
    precision's quantize of a and of b^T: bit-exact, timed beside
    ``torch._int_mm`` on the unpacked int8 operands (the nearest library
    call: int32 out, no epilogue), with TOP/s, GB/s, the share of the bound,
    the route (sm90 at every shape here) and the wmma kernel's time. The
    entry is the forward at gate/up."""
    worst, entry = 0.0, None
    for lname, form, a, b in gemm_forms(gen):
        ap, sa = quantize_int4_rowwise_absmax(a)
        bp, sb = quantize_int4_rowwise_absmax(b.T.contiguous())
        M, N, K = ap.shape[0], bp.shape[0], 2 * ap.shape[1]
        got = routed("scaled_int4_mm", ops.scaled_int4_mm, (ap, bp, sa, sb))
        ref = ops.scaled_int4_mm_plain(ap, bp, sa, sb)
        torch.cuda.synchronize()
        check(torch.equal(got, ref), f"B16 bit-exact at {lname} {form} M={M} N={N} K={K}")
        worst = max(worst, _max_err([got], [ref]))
        inputs = copies(ap, bp, sa, sb)
        ms, plain_ms = time_ms(ops.scaled_int4_mm, inputs, iters=8), time_ms(ops.scaled_int4_mm_plain, inputs, iters=8)
        library = lib_ms("torch._int_mm", lambda a, b: torch._int_mm(a, b.t()),
                         copies(ops.unpack_int4(ap), ops.unpack_int4(bp)))
        nbytes = M * K // 2 + N * K // 2 + 2 * (M + N) + 2 * M * N  # packed in, bf16 scales and out
        print(f"[3] scaled_int4_mm (B16) {lname} {form} M={M} N={N} K={K} -> bf16: bit-exact; kernel {ms:.4f} ms "
              f"({2 * M * N * K / ms / 1e9:.1f} TOP/s, {nbytes / ms / 1e6:.0f} GB/s), "
              f"{sm90_timing('scaled_int4_mm', (ap, bp), M, N, K, ms, nbytes)}; plain {plain_ms:.4f} ms, "
              f"torch._int_mm (unpacked, int32 out) {'refused' if library is None else f'{library:.4f} ms'}")
        if entry is None:
            entry = _entry("scaled_int4_mm", "quantized_training_tpu/ops/pallas_mm.py:636", 0.0,
                           ((M, N, K), ms, plain_ms), nbytes, 2 * M * N * K, library)
    entry["max_abs_err"] = worst
    return entry


def scaled_mm_lib(a, b, sa, sb):
    """``torch._scaled_mm`` on the e4m3 operands (b column-major, as it takes
    them) with DeepSeek's block scales where the installed PyTorch accepts
    them on this card, else with row scales (the nearest call: one scale
    per row of a and per column of b): (its time, the form timed)."""
    M, K = a.shape
    N = b.shape[1]
    b_cm = b.t().contiguous().t()
    row_a, row_b = torch.ones(M, 1, device=a.device), torch.ones(1, N, device=a.device)
    for form, s1, s2 in (("1x128 / 128x128 block scales", sa.float(), sb.float()), ("row scales", row_a, row_b)):
        ms = lib_ms(f"torch._scaled_mm with {form}", lambda x, y, s1=s1, s2=s2: torch._scaled_mm(
            x, y, scale_a=s1, scale_b=s2, out_dtype=torch.bfloat16), copies(a, b_cm))
        if ms is not None:
            return ms, form
    return None, None


def check_tile_gemms(gen: torch.Generator) -> list:
    """B15 at the shapes of ``gemm_forms`` (grad_weight: K = 8192, n_qk =
    64 > 32, the JAX kernel's other scale layout). The e4m3 form on the
    operands fp8 tile mixed precision makes (a in 1 x 128 groups, b in 128 x
    128 blocks), held in fp32 to (QK + n_qk) fp32 roundings of the folded
    magnitudes (``ops/tile_scaled_mm.py::fold_bound``: the tensor core sums each block's
    exact fp16 products in fp32, in its own order), and in bf16 to one bf16
    ulp more; the int8 form on int8 operands over the whole range with
    random scales of the same grids, bit-exact. Each checked to take the
    sm90 route (QK = 128) and timed at bf16 output beside ``scaled_mm_lib``
    (e4m3) or ``torch._int_mm`` (int8, int32 out, no scales), the share of
    the 8-bit bound and the wmma kernel's time. Entries at the gate/up
    forward."""
    rows, worst, worst_units = {}, {"tile_scaled_mm": 0.0, "tile_scaled_mm_s8": 0.0}, 0.0
    for lname, form, a, b in gemm_forms(gen):
        aq, sa = quantize_fp8_tile(a)
        bq, sb = quantize_fp8_block(b)
        (M, K), N = aq.shape, bq.shape[1]
        n_qk = sa.shape[1]
        fold = TILE_MM.fold_bound(aq, bq, sa, sb, K // n_qk + n_qk)
        got32 = ops.tile_scaled_mm(aq, bq, sa, sb, out_dtype=torch.float32)
        ref32 = ops.tile_scaled_mm_plain(aq, bq, sa, sb, out_dtype=torch.float32)
        got, ref = routed("tile_scaled_mm", ops.tile_scaled_mm, (aq, bq, sa, sb)), ops.tile_scaled_mm_plain(aq, bq, sa, sb)
        torch.cuda.synchronize()
        d32 = (got32.double() - ref32.double()).abs()
        units = (d32 / (fold / (K // n_qk + n_qk)).clamp(min=1e-300)).max().item()
        check(bool((d32 <= fold).all()), f"B15 e4m3 at {lname} {form} within {K // n_qk + n_qk} fp32 roundings")
        d16 = (got.double() - ref.double()).abs()
        check(bool((d16 <= fold + 2.0**-7 * (ref32.double().abs() + fold)).all()),
              f"B15 e4m3 bf16 output at {lname} {form} within one bf16 ulp more")
        worst["tile_scaled_mm"] = max(worst["tile_scaled_mm"], d16.max().item())
        worst_units = max(worst_units, units)
        a8 = torch.randint(-128, 128, (M, K), generator=gen, device=DEVICE, dtype=torch.int8)
        b8 = torch.randint(-128, 128, (K, N), generator=gen, device=DEVICE, dtype=torch.int8)
        s8a = (torch.rand(sa.shape, generator=gen, device=DEVICE) * 1e-4).to(torch.bfloat16)
        s8b = (torch.rand(sb.shape, generator=gen, device=DEVICE) * 1e-4).to(torch.bfloat16)
        got8 = routed("tile_scaled_mm_s8", ops.tile_scaled_mm, (a8, b8, s8a, s8b))
        ref8 = ops.tile_scaled_mm_plain(a8, b8, s8a, s8b)
        torch.cuda.synchronize()
        check(torch.equal(got8, ref8), f"B15 int8 bit-exact at {lname} {form}")
        worst["tile_scaled_mm_s8"] = max(worst["tile_scaled_mm_s8"], _max_err([got8], [ref8]))
        for name, args, library, lib_form in (
                ("tile_scaled_mm", (aq, bq, sa, sb), *scaled_mm_lib(aq, bq, sa, sb)),
                ("tile_scaled_mm_s8", (a8, b8, s8a, s8b),
                 lib_ms("torch._int_mm", lambda x, y: torch._int_mm(x, y), copies(a8, b8)), "int32 out")):
            inputs = copies(*args)
            ms = time_ms(ops.tile_scaled_mm, inputs, iters=8)
            plain_ms = time_ms(ops.tile_scaled_mm_plain, inputs, iters=4)
            nbytes = M * K + K * N + 2 * (sa.numel() + sb.numel()) + 2 * M * N
            print(f"[3] {name} (B15, {'e4m3' if name == 'tile_scaled_mm' else 'int8'}) {lname} {form} M={M} N={N} "
                  f"K={K} (n_qk {n_qk}) -> bf16: kernel {ms:.4f} ms ({2 * M * N * K / ms / 1e9:.1f} TOP/s, "
                  f"{nbytes / ms / 1e6:.0f} GB/s), {sm90_timing(name, args, M, N, K, ms, nbytes)}; plain "
                  f"{plain_ms:.4f} ms, library ({lib_form}) {'refused' if library is None else f'{library:.4f} ms'}")
            if name not in rows:
                rows[name] = _entry(name, "quantized_training_tpu/ops/pallas_mm.py:378", 0.0, ((M, N, K), ms, plain_ms),
                                    nbytes, 2 * M * N * K, library)
                rows[name]["library_form"] = lib_form
        print(f"[3] B15 e4m3 {lname} {form}: max |kernel - plain| {d32.max().item():.3e} in fp32 "
              f"({units:.2f} fp32 roundings of the folded magnitudes, bound {K // n_qk + n_qk}), "
              f"{d16.max().item():.3e} in bf16; int8 form bit-exact")
    for name, e in rows.items():
        e["max_abs_err"] = worst[name]
    rows["tile_scaled_mm"]["max_fold_roundings"] = worst_units
    return list(rows.values())


def check_sr_quantizes(gen: torch.Generator, key: int) -> list:
    """The SR forms of K1, B4 and B5 at the training step's shapes (K1 and
    B4 on the activations and every weight, B5 on the output gradients)
    against their plain versions with the same key: bit-exact, since both
    draw the same Philox words and compute the same floor(x / scale + u).
    Each is timed beside its round-to-nearest form, with GB/s of the bytes
    the algorithm needs (each input read and each output written once: K1
    one read of x and one int8 write; B4 one read and one write; B5 one read
    and two writes) and the share of the bound they give; each entry records
    every shape (``shapes``), its own numbers are those at gate/up's weight
    [5632, 2048] for K1-SR and B4-SR (each also on its first design, K1-SR
    wherever its route takes the row walk, B4-SR at every shape) and at
    [8192, 2048] for B5-SR, the shape the SR step launches it at most."""
    out = []
    for name, kernel, plain, shapes, writes, replaces, timed_shape in (
        ("quantize_int8_rowwise_sr", ops.quantize_int8_rowwise, ops.quantize_int8_plain,
         [(TOKENS, D), (TOKENS, F), *WEIGHTS], 1, "quantized_training_tpu/ops/pallas_quant.py:98", (F, D)),
        ("quantize_int8_colwise_sr", ops.quantize_int8_colwise, partial(ops.quantize_int8_plain, axis=0),
         B4_SHAPES, 1, "quantized_training_tpu/ops/pallas_quant.py:220", (F, D)),
        ("quantize_int8_both_sr", ops.quantize_int8_both, ops.quantize_int8_both_plain, B5_SHAPES, 2,
         "quantized_training_tpu/ops/pallas_quant.py:276", (TOKENS, D)),
    ):
        sr_kernel, sr_plain = partial(kernel, sr=True, key=key), partial(plain, sr=True, key=key)
        worst, timed, first_ms, per_shape = 0.0, None, None, []
        for shape in shapes:
            x = (torch.randn(shape, generator=gen, device=DEVICE) * 1e-3).to(torch.bfloat16)
            x[0] = 0  # an all-zero row and column
            x[:, 1] = 0
            got, ref = sr_kernel(x), sr_plain(x)
            torch.cuda.synchronize()
            check(all(torch.equal(a, b) for a, b in zip(got, ref)), f"{name} bit-exact at {list(shape)}")
            check(not torch.equal(got[0], kernel(x)[0]), f"{name} at {list(shape)} differs from round-to-nearest")
            worst = max(worst, _max_err(got, ref))
            inputs = copies(x)
            ms, rn_ms, plain_ms = time_ms(sr_kernel, inputs), time_ms(kernel, inputs), time_ms(sr_plain, inputs)
            nbytes = quantize_bytes(*shape, writes)
            b_ms, _ = bound(nbytes)
            per_shape.append({"shape": list(shape), "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms})
            print(f"[3] {name} {list(shape)} bf16: bit-exact; SR kernel {ms:.4f} ms ({nbytes / ms / 1e6:.0f} GB/s, "
                  f"{b_ms / ms:.3f} of the {b_ms:.4f} ms bound by bytes), round-to-nearest kernel {rn_ms:.4f} ms "
                  f"({nbytes / rn_ms / 1e6:.0f} GB/s), plain SR {plain_ms:.4f} ms")
            if name.removesuffix("_sr") in REDESIGNED and (
                    name != "quantize_int8_rowwise_sr" or IQ.rowwise_sm90_route(*shape, x.dtype, True)):
                per_shape[-1]["first_design_ms"] = first_design(name, sr_kernel, (x,), nbytes)
            if shape == timed_shape:
                timed, first_ms = (shape, ms, plain_ms), per_shape[-1].get("first_design_ms")
        out.append(_entry(name, replaces, worst, timed, quantize_bytes(*timed[0], writes), first_ms=first_ms)
                   | {"shapes": per_shape})
    return out


def check_fused_adamw(gen: torch.Generator, key: int) -> list:
    """B6 at every parameter shape of Llama2-1B, bf16 parameters, SR
    writeback off and on, against its plain version (eager torch ops on
    the card) with the same key: bit-exact in the new parameter and both
    moments, out of place and in place (``in_place``: a donated state,
    B6's in-place instantiation); timed, out of place and in place, with
    GB/s of the 14 bytes per parameter it must move (p, g, m, v read, p, m,
    v written, all bf16)."""
    t = 3  # the step's bias corrections, as adamw_bf16_sr forms them
    scalars = torch.tensor([1e-4, 0.9, 0.999, 1e-2, 1e-8, 1 - 0.9**t, 1 - 0.999**t], device=DEVICE)
    worst, timed, in_place_ms = {False: 0.0, True: 0.0}, {}, {}
    for shape in PARAM_SHAPES:
        p = (torch.randn(shape, generator=gen, device=DEVICE) * 0.02).to(torch.bfloat16)
        g = (torch.randn(shape, generator=gen, device=DEVICE) * 1e-3).to(torch.bfloat16)
        ea = (torch.randn(shape, generator=gen, device=DEVICE) * 1e-4).to(torch.bfloat16)
        eas = (torch.rand(shape, generator=gen, device=DEVICE) * 1e-7).to(torch.bfloat16)
        for sr in (False, True):
            kernel = partial(ops.fused_adamw_update, scalars=scalars, key=key, bf16_sr=sr)
            plain = partial(ops.fused_adamw_plain, scalars=scalars, key=key, bf16_sr=sr)
            got, ref = kernel(p, g, ea, eas), plain(p, g, ea, eas)
            torch.cuda.synchronize()
            form = "SR writeback" if sr else "round-to-nearest"
            check(all(torch.equal(a, b) for a, b in zip(got, ref)), f"B6 {form} bit-exact at {list(shape)}")
            worst[sr] = max(worst[sr], _max_err(got, ref))
            donated = (p.clone(), g, ea.clone(), eas.clone())
            kernel(*donated, in_place=True)
            check(all(torch.equal(a, b) for a, b in zip(donated[:1] + donated[2:], ref)),
                  f"B6 {form} in place bit-exact at {list(shape)}")
            inputs = copies(p, g, ea, eas)
            ms, plain_ms = time_ms(kernel, inputs, iters=8), time_ms(plain, inputs, iters=8)
            print(f"[3] fused_adamw_update {list(shape)} bf16, {form}: bit-exact, in place too; kernel {ms:.4f} ms "
                  f"({14 * p.numel() / ms / 1e6:.0f} GB/s), plain {plain_ms:.4f} ms")
            if shape == (CFG.num_hidden_layers, F, D):
                timed[sr] = (shape, ms, plain_ms)
                in_place_ms[sr] = time_ms(partial(kernel, in_place=True), inputs, iters=8)
                print(f"[3] fused_adamw_update {list(shape)} bf16, {form}, in place: {in_place_ms[sr]:.4f} ms "
                      f"({14 * p.numel() / in_place_ms[sr] / 1e6:.0f} GB/s; out of place {ms:.4f} ms in this call)")
                if not sr:
                    library = lib_ms("torch._fused_adamw_", fused_adamw_lib, inputs)
                    print(f"[3] torch._fused_adamw_ {list(shape)} bf16 (the same update, round-to-nearest, in "
                          f"place): {'refused' if library is None else f'{library:.4f} ms'}")
    replaces = "quantized_training_tpu/ops/pallas_optim.py:79"
    n = np.prod(timed[False][0])
    return [_entry("fused_adamw_update", replaces, worst[False], timed[False], 14 * n, library_ms=library)
            | {"in_place_ms": in_place_ms[False]},
            _entry("fused_adamw_update_sr", replaces, worst[True], timed[True], 14 * n)
            | {"in_place_ms": in_place_ms[True]}]


def fused_adamw_lib(p, g, ea, eas):
    """PyTorch's fused AdamW on bf16 parameters and moments at B6's
    hyper-parameters (lr 1e-4, betas (0.9, 0.999), weight decay 1e-2, eps
    1e-8, step 3): the same decoupled update in fp32 math with one
    round-to-nearest writeback, in place; it has no SR writeback, so it
    stands beside B6's round-to-nearest form only."""
    step = torch.full((), 3.0, device=p.device)
    torch._fused_adamw_([p], [g], [ea], [eas], [], [step], lr=1e-4, beta1=0.9, beta2=0.999, weight_decay=1e-2,
                        eps=1e-8, amsgrad=False, maximize=False)


def _int8_off(got, ref) -> tuple[int, float]:
    """Largest int8 difference and the share of elements that differ."""
    d = (got.int() - ref.int()).abs()
    return d.max().item(), (d > 0).float().mean().item()


def _rel_err(got, ref) -> float:
    """Largest elementwise relative difference (0 where both are 0)."""
    return ((got - ref).abs() / ref.abs().clamp(min=1e-30)).max().item()


def _bf16_ulps(a, b):
    def order(t):
        bits = t.to(torch.bfloat16).view(torch.int16).int()
        return torch.where(bits < 0, -(bits & 0x7FFF), bits)
    return (order(a) - order(b)).abs()


def _hold(kind: str, got, ref) -> str:
    """Hold a producer kernel's outputs to its plain version's, by the
    bars of its kind: 'exact' (B9), 'int8' (B7, B8: int8 within one step on
    at most 1e-3 of the elements, scales and column maxima within 1e-6
    relative) or 'bwd' (B10: dx within 2 bf16 ulps where |dx| is above
    2**-20 of max|dx|, dgamma within 1e-5 of max|dgamma|). Returns what
    was measured."""
    if kind == "exact":
        check(all(torch.equal(a, b) for a, b in zip(got, ref)), "bit-exact")
        return "bit-exact"
    if kind == "int8":
        off, share = _int8_off(got[0], ref[0])
        rel = max(_rel_err(a.reshape(-1), b.reshape(-1)) for a, b in zip(got[1:], ref[1:]))
        check(off <= 1 and share <= 1e-3 and rel <= 1e-6, f"int8 off by {off} on {share}, scales {rel}")
        return f"int8 off by one on a share {share:.2e} (max {off}), scales/maxima relative {rel:.2e}"
    (dx, dg), (dx_ref, dg_ref) = got, ref
    ulps = _bf16_ulps(dx, dx_ref)
    far = (ulps > 2) & ((dx - dx_ref).abs() > 2**-20 * dx_ref.abs().max())
    dg_rel = ((dg - dg_ref).abs().max() / dg_ref.abs().max()).item()
    check(not far.any() and dg_rel <= 1e-5, f"B10 dx {far.sum().item()} far, dgamma {dg_rel}")
    return f"dx max {ulps.max().item()} bf16 ulps ({(ulps > 2).sum().item()} beyond 2, all tiny), dgamma {dg_rel:.2e} of max"


def _held_and_timed(rows: dict, name: str, form: str, kind: str, kernel, plain, args, nbytes: float,
                    replaces: str | None = None, sr_of=None, times: list | None = None):
    """Run ``kernel`` and ``plain`` on ``args``, hold the outputs by the bars
    of ``kind`` (:func:`_hold`), and with ``sr_of`` (the round-to-nearest
    outputs) check that the SR form differs from them; with ``replaces`` also
    time both and keep the kernel's entry in ``rows`` (name -> (replaces,
    worst error, (shape, ms, plain ms), bytes)): the first shape timed, or
    the path's TOKENS-row shape; with ``times`` time both and append
    {"form", "ms", "plain_ms", "bound_ms"} to it. Prints one line; returns
    the kernel's outputs. GB/s and the share of the roofline count
    ``nbytes``."""
    got, ref = kernel(*args), plain(*args)
    torch.cuda.synchronize()
    held = _hold(kind, got, ref)
    if sr_of is not None:
        check(not torch.equal(got[0], sr_of[0]), f"{name} differs from round-to-nearest")
    shape = tuple(args[0].shape)
    line = f"[3] {name} {list(shape)} {str(args[0].dtype)[6:]}{form}: {held}"
    if replaces is not None or times is not None:
        inputs = copies(*args)
        ms, plain_ms = time_ms(kernel, inputs), time_ms(plain, inputs)
        b_ms = bound(nbytes)[0]
        line += (f"; kernel {ms:.4f} ms ({nbytes / ms / 1e6:.0f} GB/s, {b_ms / ms:.2f} of the {b_ms:.4f} ms "
                 f"bound), plain {plain_ms:.4f} ms")
        if times is not None:
            times.append({"form": form.strip(" ,"), "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms})
    if replaces is not None:
        err = max(rows.get(name, (None, 0.0))[1], _max_err(got, ref))
        if shape[0] == TOKENS or name not in rows:
            rows[name] = (replaces, err, (shape, ms, plain_ms), nbytes)
        else:
            rows[name] = (*rows[name][:1], err, *rows[name][2:])
    print(line)
    return got


# the redesigned kernels' route predicates by counter name: (module, name)
# of B7's, B8's, B9's, B10's, B11's, B12's and B18's (ops/fused_producers.py:
# threads a row on the row walk), B14's (ops/rope.py: the same, from the
# grouped input's width and head size), B4's (ops/int8_quant.py: the
# geometry of its cluster form) and K1's (ops/int8_quant.py: threads a row on
# the row walk, its SR form apart); a route of 0 takes the first design
REDESIGNED = {"rmsnorm_quant_rowwise": (FP, "norm_rows_sm90_route"),
              "rmsnorm_quant_colwise": (FP, "norm_cols_sm90_route"),
              "rmsnorm_bwd": (FP, "rmsnorm_bwd_sm90_route"),
              "silu_mul_bwd_quant_rowwise": (FP, "silu_bwd_rows_sm90_route"),
              "silu_mul_quant_rowwise": (FP, "silu_rows_sm90_route"),
              "silu_mul_quant_colwise": (FP, "silu_cols_sm90_route"),
              "silu_mul_bwd_quant_colwise": (FP, "silu_bwd_cols_sm90_route"),
              "quantize_int8_colwise": (IQ, "colwise_sm90_route"),
              "quantize_int8_rowwise": (IQ, "rowwise_sm90_route"),
              "layernorm_quant_rowwise": (FP, "layernorm_rows_sm90_route"),
              "layernorm_quant_colwise": (FP, "layernorm_cols_sm90_route"),
              "gelu_quant_rowwise": (FP, "gelu_rows_sm90_route"),
              "gelu_quant_colwise": (FP, "gelu_cols_sm90_route"),
              "ungroup_amax": (ROPE, "ungroup_sm90_route"),
              "ungroup_quant": (ROPE, "ungroup_sm90_route")}


def first_design(name: str, kernel, args, nbytes: float, exact: int | None = None) -> float:
    """A redesigned kernel (``name``; an SR form with its ``_sr``) on
    ``args``: checked to launch once, on its route, to give the same bits on
    a second run, and to give the outputs of its first design (the parent's
    kernel, the route forced to 0): bit for bit, or with ``exact`` the first
    ``exact`` outputs bit for bit and the others (B10's dgamma, whose sums
    meet in the walk's order) within 2e-5 of their largest magnitude; both
    timed here, one after the other; prints the route, both times and their
    shares of the bound. Returns the first design's ms."""
    module, predicate = REDESIGNED[name.removesuffix("_sr")]
    route_of = getattr(module, predicate)
    x = args[0]
    route = (route_of(*x.shape, x.dtype, name.endswith("_sr")) if predicate == "rowwise_sm90_route" else
             route_of(x.shape[1], x.dtype, name.endswith("_sr")) if predicate == "silu_cols_sm90_route" else
             route_of(*x.shape, x.dtype) if module is IQ else
             route_of(x.shape[1] * x.shape[2] * x.shape[4], x.shape[4], x.dtype) if module is ROPE else  # [B, KV, G, S, hd]
             route_of(x.shape[1], x.dtype))
    ops.reset_launch_counts()
    new = kernel(*args)
    n = ops.launch_counts()
    check(bool(route) and n[name] == 1 and n[f"{name}_sm90"] == 1,
          f"{name} at {list(args[0].shape)} launched once, on its route")
    check(all(torch.equal(a, b) for a, b in zip(new, kernel(*args))), f"{name}: the same bits on a second run")
    ms = time_ms(kernel, copies(*args))
    setattr(module, predicate, lambda *a: 0)
    try:
        first = kernel(*args)
        first_ms = time_ms(kernel, copies(*args))
    finally:
        setattr(module, predicate, route_of)
    k = len(new) if exact is None else exact
    rel = max([((a - b).abs().max() / b.abs().max()).item() for a, b in zip(new[k:], first[k:])], default=0.0)
    check(all(torch.equal(a, b) for a, b in zip(new[:k], first[:k])) and rel <= 2e-5,
          f"{name}: the route gives the first design's bits (and the rest within 2e-5: {rel:.2e})")
    b_ms = bound(nbytes)[0]
    what = (f"cluster form ({route[0]} vectors a strip, {route[1]} CTAs a cluster)"
            if predicate == "colwise_sm90_route" else f"row walk ({route} threads a row)")
    held = ("outputs bit-identical" if k == len(new) else
            f"the first {k} outputs bit-identical, the rest {rel:.2e} of their largest magnitude apart")
    print(f"[3] {name} {list(args[0].shape)}: route {what}, {ms:.4f} ms, {b_ms / ms:.3f} of the {b_ms:.4f} ms bound; "
          f"first design (the parent's kernel) {first_ms:.4f} ms ({first_ms / ms:.2f}x this, {b_ms / first_ms:.3f} of "
          f"the bound); {held}")
    return first_ms


def rms_norm_bwd_library_ms(x, g, dy) -> float | None:
    """``aten._fused_rms_norm_backward``'s time on B10's x, dy and g, given
    the rstd of ``aten._fused_rms_norm`` (computed untimed): a reference,
    not the same function (it reads rstd, which B10 recomputes); None where
    the card's torch lacks the op or refuses the operands."""
    aten = torch.ops.aten
    if not hasattr(aten, "_fused_rms_norm_backward"):
        print("[3] aten._fused_rms_norm_backward: not in this torch")
        return None
    K = x.shape[1]
    try:
        rstd = aten._fused_rms_norm(x, [K], g, 1e-5)[1]
    except (RuntimeError, ValueError) as e:
        print(f"[3] aten._fused_rms_norm refuses B10's operands: {str(e).splitlines()[0]}")
        return None
    ms = lib_ms("aten._fused_rms_norm_backward (rstd given)",
                lambda x, dy: aten._fused_rms_norm_backward(dy, x, [K], rstd, g, [True, True]), copies(x, dy))
    if ms is not None:
        print(f"[3] rmsnorm_bwd {list(x.shape)}: aten._fused_rms_norm_backward with rstd given {ms:.4f} ms "
              "(a reference, not the same function)")
    return ms


def check_fused_producers(gen: torch.Generator, key: int) -> list:
    """B7-B10 and the SR forms of B7-B9 at the fused layer's shapes (x
    [8192, 2048] at the norm sites, gate and up [8192, 5632] at the silu
    site, and 256 rows of each) against their plain versions on the card;
    the forms the path runs (B7 and B9-row with the column absmax, B8 and
    B9-col given the forward's scales) are timed and make the entries, the
    other forms (without the absmax, two-pass) are held too. GB/s and the
    share of the roofline count each input read once and each output
    written once (bf16 inputs, fp32 scales and maxima). B7 and its SR form
    at [8192, 2048], and B9-row and its SR form at both silu shapes, also
    on the first design (``first_design``), as are B8 given scales and its
    SR form, and B10, at [8192, 2048], and B9-col given scales and its SR
    form at [8192, 5632]; B10 beside the library's RMSNorm backward
    (``rms_norm_bwd_library_ms``)."""
    rows = {}  # entry name -> (replaces, worst error, timed, bytes)
    firsts = {}  # the first designs' ms at the path's shape by entry name
    library = {}
    run = partial(_held_and_timed, rows)
    pf_ = "quantized_training_tpu/ops/pallas_fused.py"
    for M, K in NORM_SHAPES:
        x = torch.randn(M, K, generator=gen, device=DEVICE).to(torch.bfloat16)
        x[0] = 0  # an all-zero row
        g = (1 + 0.1 * torch.randn(K, generator=gen, device=DEVICE)).to(torch.bfloat16)
        dy = (torch.randn(M, K, generator=gen, device=DEVICE) * 1e-3).to(torch.bfloat16)
        row_bytes = 3 * M * K + 2 * K + 4 * M + 4 * K  # x, g in; q, scale, column absmax out
        col_bytes = 3 * M * K + 2 * K + 4 * K  # x, g, scale in; q out
        rn = {}
        for sr in (False, True):
            tag, kw = ("_sr", dict(sr=True, key=key)) if sr else ("", {})
            k_row = partial(ops.rmsnorm_quant_rowwise, with_col_amax=True, **kw)
            p_row = partial(ops.rmsnorm_quant_rowwise_plain, with_col_amax=True, **kw)
            out = run(f"rmsnorm_quant_rowwise{tag}", ", column absmax", "int8", k_row, p_row, (x, g), row_bytes,
                      f"{pf_}:154", rn.get("row"))
            if M == TOKENS:
                firsts[f"rmsnorm_quant_rowwise{tag}"] = first_design(f"rmsnorm_quant_rowwise{tag}", k_row, (x, g),
                                                                     row_bytes)
            scale = out[2] * (1.0 / 127.0)
            k_col = lambda x, g, scale, kw=kw: ops.rmsnorm_quant_colwise(x, g, scale=scale, **kw)
            p_col = lambda x, g, scale, kw=kw: ops.rmsnorm_quant_colwise_plain(x, g, scale=scale, **kw)
            col = run(f"rmsnorm_quant_colwise{tag}", ", given scales", "int8", k_col, p_col, (x, g, scale), col_bytes,
                      f"{pf_}:246", rn.get("col"))
            if M == TOKENS:
                firsts[f"rmsnorm_quant_colwise{tag}"] = first_design(f"rmsnorm_quant_colwise{tag}", k_col,
                                                                     (x, g, scale), col_bytes)
            rn.update(row=out, col=col)
            if not sr:
                run("rmsnorm_quant_rowwise", "", "int8", ops.rmsnorm_quant_rowwise,
                    ops.rmsnorm_quant_rowwise_plain, (x, g), 0)
                two = run("rmsnorm_quant_colwise", ", two passes", "int8", ops.rmsnorm_quant_colwise,
                          ops.rmsnorm_quant_colwise_plain, (x, g), 0)
                check(torch.equal(two[0], col[0]), "B8 given the forward's scales equals B8 in two passes")
        bwd_bytes = 6 * M * K + 2 * K + 4 * K  # x, dy, g in; dx, dgamma out
        run("rmsnorm_bwd", "", "bwd", ops.rmsnorm_bwd, ops.rmsnorm_bwd_plain, (x, g, dy), bwd_bytes, f"{pf_}:491")
        if M == TOKENS:
            firsts["rmsnorm_bwd"] = first_design("rmsnorm_bwd", ops.rmsnorm_bwd, (x, g, dy), bwd_bytes, exact=1)
            library["rmsnorm_bwd"] = rms_norm_bwd_library_ms(x, g, dy)
    for M, K in SILU_SHAPES:
        a = torch.randn(M, K, generator=gen, device=DEVICE).to(torch.bfloat16)
        b = torch.randn(M, K, generator=gen, device=DEVICE).to(torch.bfloat16)
        a[:, 1] = 0  # an all-zero column
        row_bytes = 5 * M * K + 4 * M + 4 * K
        col_bytes = 5 * M * K + 4 * K
        rn = {}
        for sr in (False, True):
            tag, kw = ("_sr", dict(sr=True, key=key)) if sr else ("", {})
            k_row = partial(ops.silu_mul_quant_rowwise, with_col_amax=True, **kw)
            out = run(f"silu_mul_quant_rowwise{tag}", ", column absmax", "exact", k_row,
                      partial(ops.silu_mul_quant_rowwise_plain, with_col_amax=True, **kw), (a, b), row_bytes,
                      f"{pf_}:325", rn.get("row"))
            first_ms = first_design(f"silu_mul_quant_rowwise{tag}", k_row, (a, b), row_bytes)
            if M == TOKENS:
                firsts[f"silu_mul_quant_rowwise{tag}"] = first_ms
            scale = out[2] * (1.0 / 127.0)
            k_col = lambda a, b, scale, kw=kw: ops.silu_mul_quant_colwise(a, b, scale=scale, **kw)
            col = run(f"silu_mul_quant_colwise{tag}", ", given scales", "exact", k_col,
                      lambda a, b, scale, kw=kw: ops.silu_mul_quant_colwise_plain(a, b, scale=scale, **kw),
                      (a, b, scale), col_bytes, f"{pf_}:409", rn.get("col"))
            if M == TOKENS:
                firsts[f"silu_mul_quant_colwise{tag}"] = first_design(f"silu_mul_quant_colwise{tag}", k_col,
                                                                      (a, b, scale), col_bytes)
            rn.update(row=out, col=col)
            if not sr:
                run("silu_mul_quant_rowwise", "", "exact", ops.silu_mul_quant_rowwise,
                    ops.silu_mul_quant_rowwise_plain, (a, b), 0)
                two = run("silu_mul_quant_colwise", ", two passes", "exact", ops.silu_mul_quant_colwise,
                          ops.silu_mul_quant_colwise_plain, (a, b), 0)
                check(torch.equal(two[0], col[0]), "B9-col given the forward's scales equals B9-col in two passes")
    return [_entry(name, replaces, err, timed, nbytes, library_ms=library.get(name), first_ms=firsts.get(name))
            for name, (replaces, err, timed, nbytes) in rows.items()]


def check_silu_bwd(gen: torch.Generator, key: int) -> list:
    """B11 and B12 and their SR forms at the MLP backward's shape (gate, up
    and dact [8192, 5632]) and at [256, 5632], against their plain versions
    on the card, bit-exact: B11 with the column absmax (the path's form with
    an int8 grad_weight, timed) and with the (da, db) copies instead (the
    bf16 grad_weight's form, held), B12 given B11's column scales; B11 and
    B12 and their SR forms at [8192, 5632] also on the first design
    (``first_design``). Bytes: (a, b, dy) read once, two int8 written, and
    the fp32 scales and maxima."""
    rows, firsts = {}, {}
    run = partial(_held_and_timed, rows)
    pf_ = "quantized_training_tpu/ops/pallas_fused.py"
    for M, K in SILU_SHAPES:
        a = torch.randn(M, K, generator=gen, device=DEVICE).to(torch.bfloat16)
        b = torch.randn(M, K, generator=gen, device=DEVICE).to(torch.bfloat16)
        dy = (torch.randn(M, K, generator=gen, device=DEVICE) * 1e-3).to(torch.bfloat16)
        dy[:, 1] = 0  # an all-zero column of (da, db)
        rn = {}
        for sr in (False, True):
            tag, kw = ("_sr", dict(sr=True, key=key)) if sr else ("", {})
            k_row = partial(ops.silu_mul_bwd_quant_rowwise, **kw)
            row = run(f"silu_mul_bwd_quant_rowwise{tag}", ", column absmax", "exact", k_row,
                      partial(ops.silu_mul_bwd_quant_rowwise_plain, **kw), (a, b, dy), 8 * M * K + 8 * M + 8 * K,
                      f"{pf_}:631", rn.get("row"))
            if M == TOKENS:
                firsts[f"silu_mul_bwd_quant_rowwise{tag}"] = first_design(
                    f"silu_mul_bwd_quant_rowwise{tag}", k_row, (a, b, dy), 8 * M * K + 8 * M + 8 * K)
            scales = tuple(m * (1.0 / 127.0) for m in row[4:])
            k_col = partial(ops.silu_mul_bwd_quant_colwise, **kw)
            col = run(f"silu_mul_bwd_quant_colwise{tag}", ", given scales", "exact", k_col,
                      partial(ops.silu_mul_bwd_quant_colwise_plain, **kw), (a, b, dy, *scales), 8 * M * K + 8 * K,
                      f"{pf_}:704", rn.get("col"))
            if M == TOKENS:
                firsts[f"silu_mul_bwd_quant_colwise{tag}"] = first_design(
                    f"silu_mul_bwd_quant_colwise{tag}", k_col, (a, b, dy, *scales), 8 * M * K + 8 * K)
            rn.update(row=row, col=col)
            run(f"silu_mul_bwd_quant_rowwise{tag}", ", (da, db) copies", "exact",
                partial(ops.silu_mul_bwd_quant_rowwise, with_amax=False, with_bf16=True, **kw),
                partial(ops.silu_mul_bwd_quant_rowwise_plain, with_amax=False, with_bf16=True, **kw), (a, b, dy), 0)
    return [_entry(name, replaces, err, timed, nbytes, first_ms=firsts.get(name))
            for name, (replaces, err, timed, nbytes) in rows.items()]


def check_b18(gen: torch.Generator, key: int) -> list:
    """B18 and its SR forms at ViT-Giant's shapes (the padded 6,400 tokens,
    the last 232 rows zero as the padding leaves them: LayerNorm at [6400,
    1536], the qkv and fc1 inputs; GELU at [6400, 6144], fc2's) and at 256
    rows, against their plain versions on the card: LayerNorm by B7's bars,
    GELU bit-exact. The path's forms (rows with the column absmax, columns
    given the forward's scales) are timed and make the entries; rows
    without the absmax and the two-pass columns are held too. Bytes: bf16 x
    or a read once, fp32 g and b, int8 q and fp32 scales and maxima written
    once; operations: ``B18_FP32_OPS`` an element. No library call computes
    a LayerNorm or GELU with an int8 quantize. At ViT-Giant's shapes each
    timed form, RN and SR, also runs through ``first_design``: it launches
    once on the row walk, repeats its bits, and gives the first design's
    outputs (q, scales, maxima) bit for bit, LayerNorm's too."""
    rows, firsts = {}, {}
    run = partial(_held_and_timed, rows)
    pf_ = "quantized_training_tpu/ops/pallas_fused.py"
    for M in (VIT_ROWS, 256):
        replaces_at = lambda line, M=M: f"{pf_}:{line}" if M == VIT_ROWS else None
        for producer, K, kind in (("layernorm", VIT_CFG.hidden_size, "int8"), ("gelu", VIT_CFG.mlp_dim, "exact")):
            x = torch.randn(M, K, generator=gen, device=DEVICE).to(torch.bfloat16)
            x[VIT_TOKENS:] = 0
            if producer == "layernorm":
                g = (1 + 0.1 * torch.randn(K, generator=gen, device=DEVICE)).to(torch.bfloat16)
                b = (0.1 * torch.randn(K, generator=gen, device=DEVICE)).to(torch.bfloat16)
                args, kernel, plain, gb = (x, g, b), ops.layernorm_quant, ops.layernorm_quant_plain, 8 * K
            else:
                args, kernel, plain, gb = (x,), ops.gelu_quant, ops.gelu_quant_plain, 0
            row_bytes = 3 * M * K + gb + 4 * M + 4 * K
            col_bytes = 3 * M * K + gb + 4 * K
            rn = {}
            for sr in (False, True):
                tag, kw = ("_sr", dict(sr=True, key=key)) if sr else ("", {})
                k_row = partial(kernel, with_col_amax=True, **kw)
                out = run(f"{producer}_quant_rowwise{tag}", ", column absmax", kind, k_row,
                          partial(plain, with_col_amax=True, **kw), args, row_bytes, replaces_at(848), rn.get("row"))
                col_args = (*args, out[2] * (1.0 / 127.0))
                k_col = lambda *a, kw=kw, f=kernel: f(*a[:-1], axis=0, scale=a[-1], **kw)
                col = run(f"{producer}_quant_colwise{tag}", ", given scales", kind, k_col,
                          lambda *a, kw=kw, f=plain: f(*a[:-1], axis=0, scale=a[-1], **kw), col_args, col_bytes,
                          replaces_at(898), rn.get("col"))
                if M == VIT_ROWS:
                    for form, k, a, nbytes in (("rowwise", k_row, args, row_bytes), ("colwise", k_col, col_args,
                                                                                      col_bytes)):
                        name = f"{producer}_quant_{form}{tag}"
                        firsts[name] = first_design(name, k, a, nbytes)
                rn.update(row=out, col=col)
                if not sr:
                    run(f"{producer}_quant_rowwise", "", kind, kernel, plain, args, 0)
                    two = run(f"{producer}_quant_colwise", ", two passes", kind, partial(kernel, axis=0),
                              partial(plain, axis=0), args, 0)
                    check(torch.equal(two[0], col[0]), f"B18 {producer} given the forward's scales equals two passes")
    return [_entry(name, replaces, err, timed, nbytes, fp32_ops=B18_FP32_OPS[name.split("_")[0]] * np.prod(timed[0]),
                   first_ms=firsts.get(name)) for name, (replaces, err, timed, nbytes) in rows.items()]


def check_rope(gen: torch.Generator, key: int) -> list:
    """B13 and B14 at bench.py's micro-batch [4, 2048] of Llama2-1B, against
    their plain versions on the card, bit-exact: the grouping of q (the
    1/sqrt(hd) pre-scale folded into its tables, timed), of k and of v (no
    rotation); the ungrouping of q's grad with rot^T (timed) and of the
    attention output without rotation, from grouped tensors in [B, S, H, hd]
    memory (the layout SDPA takes and returns for them) and in [B, H, S, hd]
    memory; B14's absmax and its quantize along rows and columns, RN and SR,
    of the attention output [4, 2048, 32, 64] (an all-zero row among it) in
    both memory layouts, each timed (the entries' ``forms``; their own
    numbers are the step layout's absmax and rows), and at the step's layout
    each also through ``first_design``: it launches once on the row walk,
    repeats its bits, and gives the first design's outputs bit for bit.
    Bytes: bf16 in and out (int8 out for the quantize), fp32 tables, scales
    and maxima, each once."""
    rows = {}
    run = partial(_held_and_timed, rows)
    pr_ = "quantized_training_tpu/ops/pallas_rope.py"
    H, KV, hd = CFG.num_attention_heads, CFG.num_key_value_heads, CFG.head_dim
    cos, sin = llama.rope_tables(CFG, TRAIN_S, device=DEVICE)
    tables = 2 * cos.numel() * 4
    for what, heads, c, s in (("q", H, cos * hd**-0.5, sin * hd**-0.5), ("k", KV, cos, sin), ("v", KV, None, None)):
        x = torch.randn(TRAIN_B, TRAIN_S, heads, hd, generator=gen, device=DEVICE).to(torch.bfloat16)
        nbytes = 4 * x.numel() + (0 if c is None else tables)
        timed = f"{pr_}:140" if what == "q" else None
        kv = KV if heads == H else heads
        (y,) = run("rope_group", f" ({what})", "exact", lambda x, c=c, s=s, kv=kv: (ops.rope_group_kernel(x, c, s, kv=kv),),
                   lambda x, c=c, s=s, kv=kv: (ops.rope_group_ref(x, c, s, kv),), (x,), nbytes, timed)
        bhsd = x.permute(0, 2, 1, 3).contiguous().view(y.shape)
        for layout, grouped in (("[B, S, H, hd] memory", y), ("[B, H, S, hd] memory", bhsd)):
            run("rope_ungroup", f" ({what}'s grad, rot^T, {layout})", "exact",
                lambda g, c=c, s=s: (ops.rope_ungroup_kernel(g, c, s, inverse=True),),
                lambda g, c=c, s=s: (ops.rope_ungroup_ref(g, c, s, inverse=True),), (grouped,), nbytes,
                f"{pr_}:203" if what == "q" and grouped is y else None)
    x = torch.randn(TRAIN_B, TRAIN_S, H, hd, generator=gen, device=DEVICE).to(torch.bfloat16)
    x[0, 1] = 0  # an all-zero row of the ungrouped view
    G, M, K = H // KV, TRAIN_B * TRAIN_S, H * hd
    step = ops.rope_group_kernel(x, kv=KV)  # the attention output's layout in the step
    layouts = (("[B, S, H, hd] memory", step),
               ("[B, H, S, hd] memory", x.permute(0, 2, 1, 3).contiguous().view(TRAIN_B, KV, G, TRAIN_S, hd)))
    forms, firsts = {}, {}  # name -> every timed form and layout; the entry's form on its first design
    for layout, out in layouts:
        at_step = out is step

        def b14(name, form, kernel, plain, args, nbytes, replaces, sr_of=None):
            times = []
            got = run(name, f", {form}, {layout}", "exact", kernel, plain, args, nbytes,
                      replaces if at_step else None, sr_of, times=times)
            forms.setdefault(name, []).append({**times[0], "form": form, "layout": layout})
            if at_step:
                forms[name][-1]["first_design_ms"] = first_design(name, kernel, args, nbytes)
                if replaces is not None:
                    firsts[name] = forms[name][-1]["first_design_ms"]
            return got

        row, col = b14("ungroup_amax", "absmax", ops.ungroup_amax, ops.ungroup_amax_plain, (out,),
                       2 * M * K + 4 * M + 4 * K, f"{pr_}:334")
        rn = {}
        for sr in (False, True):
            tag, kw = ("_sr", dict(sr=True, key=key)) if sr else ("", {})
            for axis, scale, form, nbytes in ((1, row, "rows", 3 * M * K + 4 * M), (0, col, "columns", 3 * M * K + 4 * K)):
                name = f"ungroup_quant{tag}"
                q = b14(name, form, lambda y, s, axis=axis, kw=kw: (ops.ungroup_quant(y, s, axis=axis, **kw),),
                        lambda y, s, axis=axis, kw=kw: (ops.ungroup_quant_plain(y, s, axis=axis, **kw),),
                        (out, scale * (1.0 / 127.0)), nbytes, f"{pr_}:365" if axis == 1 else None,
                        rn.get(axis) if sr else None)
                check(not q[0][0, 1].any(), f"{name} ({form}): the all-zero row quantizes to 0")
                rn[axis] = q
    return [_entry(name, replaces, err, timed, nbytes, first_ms=firsts.get(name))
            | ({"forms": forms[name]} if name in forms else {}) for name, (replaces, err, timed, nbytes) in rows.items()]


def check_attention_layout(key: int) -> None:
    """The strides SDPA takes and returns in the grouped pipeline, at
    bench.py's micro-batch: q, k, v from B13, attention, the int8
    o-projection (B14) and the backward, once under ``torch.profiler``;
    fails if a layout copy (an ``aten::contiguous`` or ``aten::clone`` that
    runs a kernel) sits anywhere in it."""
    H, KV, hd = CFG.num_attention_heads, CFG.num_key_value_heads, CFG.head_dim
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    q, k, v = (torch.randn(TRAIN_B, TRAIN_S, h, hd, generator=gen, device=DEVICE).to(torch.bfloat16).requires_grad_()
               for h in (H, KV, KV))
    w = quant.MixedPrecisionWeight((torch.randn(D, H * hd, generator=gen, device=DEVICE) * 0.02).to(torch.bfloat16),
                                   quant.MixedPrecisionConfig())
    cos, sin = llama.rope_tables(CFG, TRAIN_S, device=DEVICE)
    strides = {}

    def block():
        qg = ops.rope.rope_group(q, cos * hd**-0.5, sin * hd**-0.5, KV)
        kg = ops.rope.rope_group(k, cos, sin, KV).squeeze(2)
        vg = ops.rope.group_heads(v, KV).squeeze(2)
        for name, t in (("q", qg), ("k", kg), ("v", vg)):
            strides[name] = t.stride()
            t.register_hook(lambda g, name=name: strides.__setitem__(f"d{name}", g.stride()))
        out = llama._attention_grouped(qg, kg, vg, "sdpa")
        strides["out"] = out.stride()
        out.register_hook(lambda g: strides.__setitem__("dout", g.stride()))
        o = quant.attn_out_linear(out, w, KV, key=key)
        (o.float() ** 2).sum().backward()

    block()  # warm-up
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        block()
        torch.cuda.synchronize()
    events = prof.key_averages()
    copying = {e.key: e.device_time_total for e in events if e.key in ("aten::contiguous", "aten::clone")
               and e.device_time_total > 0}
    kernels = sorted({e.key[:60] for e in events if e.device_type == torch.autograd.DeviceType.CUDA
                      and "copy" in e.key.lower()})
    print(f"[3] grouped attention at [{TRAIN_B}, {TRAIN_S}] (q, k, v from B13, SDPA, the int8 o-projection, "
          f"backward): strides of [B, KV, G, S, hd] (q, out) and [B, KV, S, hd] (k, v) {strides}; layout copies "
          f"{copying or 'none'}; copy kernels (dtype casts included) {kernels}")
    check(not copying, f"no layout copy around SDPA: {copying}")


def check_b17(gen: torch.Generator) -> list:
    """B17 at ``MM_N``^3, both forms, against its plain version (the float64
    product rounded once): bf16 -> fp32 within ``fp32_sum_bound`` (an fp32
    sum in the kernel's order), bf16 -> bf16 a bf16 rounding of a value
    within it, int8 -> int32 bit-exact. Timed beside ``torch.matmul`` (bf16
    out) and ``torch._int_mm``; bound by the bf16 or int8 tensor-core rate."""
    n = MM_N
    a = torch.randn(n, n, generator=gen, device=DEVICE).to(torch.bfloat16)
    b = torch.randn(n, n, generator=gen, device=DEVICE).to(torch.bfloat16)
    exact, fold = a.double() @ b.double(), MATMUL.fp32_sum_bound(a, b)
    ops.reset_launch_counts()
    got32, got16 = ops.matmul(a, b), ops.matmul(a, b, out_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    check(ops.launch_counts()["matmul_sm90"] == 2, f"B17 bf16 at {n}^3 on the sm90 route: {ops.launch_counts()}")
    d32 = (got32.double() - exact).abs()
    check(bool((d32 <= fold).all()), f"B17 bf16 -> fp32 within the fp32 sum bound at {n}^3")
    check(benchmark_mm.within_rounding(got16, exact, fold), f"B17 bf16 -> bf16 a rounding within the bound at {n}^3")
    err16 = (got16.double() - ops.matmul_plain(a, b, out_dtype=torch.bfloat16).double()).abs().max().item()
    a8 = torch.randint(-128, 128, (n, n), generator=gen, device=DEVICE, dtype=torch.int8)
    b8 = torch.randint(-128, 128, (n, n), generator=gen, device=DEVICE, dtype=torch.int8)
    ops.reset_launch_counts()
    got8 = ops.matmul(a8, b8)
    torch.cuda.synchronize()
    check(ops.launch_counts()["matmul_s8_sm90"] == 1, f"B17 int8 at {n}^3 on the sm90 route: {ops.launch_counts()}")
    check(torch.equal(got8, ops.matmul_plain(a8, b8)), f"B17 int8 bit-exact at {n}^3")
    entries, flops = [], 2.0 * n ** 3
    for name, args, kernel, plain, library, lib_name, out_bytes, peak in (
            ("matmul", (a, b), partial(ops.matmul, out_dtype=torch.bfloat16),
             partial(ops.matmul_plain, out_dtype=torch.bfloat16), torch.matmul, "torch.matmul", 2, "bf16"),
            ("matmul_s8", (a8, b8), ops.matmul, ops.matmul_plain, torch._int_mm, "torch._int_mm", 4, "int8")):
        inputs = copies(*args)
        ms, plain_ms = time_ms(kernel, inputs, iters=8), time_ms(plain, inputs, iters=4)
        library_ms = lib_ms(lib_name, library, inputs)
        nbytes = 2 * n * n * args[0].element_size() + out_bytes * n * n
        ops_kw = {"bf16_ops": flops} if peak == "bf16" else {"int8_ops": flops}
        b_ms, by = bound(nbytes, **ops_kw)
        wmma = WMMA_US[name][(n, n, n)] / 1e3
        held = (f"route sm90, within its bound (max |kernel - plain| {err16:.3e} in bf16; fp32 out at "
                f"{(d32 / fold).max().item():.4f} of the fp32 sum bound)" if peak == "bf16" else
                "route sm90, bit-exact") + f", the wmma kernel {wmma:.4f} ms ({wmma / ms:.2f}x this)"
        print(f"[3] matmul (B17, {peak}) {n}x{n}x{n} -> {'bf16' if peak == 'bf16' else 'int32'}: {held}; kernel "
              f"{ms:.4f} ms ({flops / ms / 1e9:.1f} {peak} TOP/s, {b_ms / ms:.3f} of the {b_ms:.4f} ms bound by {by}), "
              f"plain (float64 matmul) {plain_ms:.4f} ms, {lib_name} "
              f"{'refused' if library_ms is None else f'{library_ms:.4f} ms'}")
        entries.append(_entry(name, "quantized_training_tpu/ops/pallas_mm.py:537", err16 if peak == "bf16" else 0.0,
                              ((n, n, n), ms, plain_ms), nbytes, library_ms=library_ms, **ops_kw))
    return entries


def attention_inputs(gen: torch.Generator):
    """bf16 q [*ATTN_LEAD, ATTN_G, S, hd] and k, v [*ATTN_LEAD, S, hd] at
    Llama2-1B's attention in bench.py's micro-batch."""
    S, hd = TRAIN_S, CFG.head_dim
    q = torch.randn(*ATTN_LEAD, ATTN_G, S, hd, generator=gen, device=DEVICE).to(torch.bfloat16)
    k = torch.randn(*ATTN_LEAD, S, hd, generator=gen, device=DEVICE).to(torch.bfloat16)
    v = torch.randn(*ATTN_LEAD, S, hd, generator=gen, device=DEVICE).to(torch.bfloat16)
    return q, k, v


def sdpa_grouped(q, k, v):
    """``F.scaled_dot_product_attention`` in bf16 on B19's q, k and v (q's
    groups as heads, GQA over the kv heads): the library yardstick."""
    B, KV, G, S, hd = q.shape
    return torch.nn.functional.scaled_dot_product_attention(q.reshape(B, KV * G, S, hd), k, v, is_causal=True,
                                                            enable_gqa=True)


def check_b19(gen: torch.Generator) -> dict:
    """B19 at Llama2-1B's attention (``ATTN_LEAD`` instances, block_kv 512):
    checked to launch once, on its sm90 design, and to give the same bits on
    a second run; held within ``ops/int8_attention.py::agreement`` of its
    plain version and of its first design (the route forced to 0: the
    designs differ in the order of p's row sums), both designs timed here,
    beside SDPA in bf16 on the same q, k, v. Bound: each input read once,
    out and lse written once; the causal triangle's int8 products (QK and
    PV) and its exponentials."""
    q, k, v = attention_inputs(gen)
    qkv = ops.quantize_qkv(q, k, v)
    ops.reset_launch_counts()
    out, lse = ops.int8_flash_fwd(*qkv)
    torch.cuda.synchronize()
    n = ops.launch_counts()
    check(n["int8_flash_fwd"] == 1 and n["int8_flash_fwd_sm90"] == 1, f"B19 launched once, on its sm90 design: {n}")
    again = ops.int8_flash_fwd(*qkv)
    check(torch.equal(out, again[0]) and torch.equal(lse, again[1]), "B19: the same bits on a second run")
    ref_out, ref_lse = ops.int8_flash_fwd_plain(*qkv)
    ok, err, share = ATTN.agreement(out, lse, ref_out, ref_lse, qkv[5])
    check(ok, f"B19 within its bound of the plain version (max |out - plain| {err:.3e}, {share:.3e} differ)")
    inputs = copies(*qkv)
    ms = time_ms(ops.int8_flash_fwd, inputs, iters=8)
    route_of = ATTN.int8_flash_sm90_route
    ATTN.int8_flash_sm90_route = lambda *a: 0
    try:
        first_out, first_lse = ops.int8_flash_fwd(*qkv)
        first_ms = time_ms(ops.int8_flash_fwd, inputs, iters=8)
    finally:
        ATTN.int8_flash_sm90_route = route_of
    ok_f, err_f, share_f = ATTN.agreement(out, lse, first_out, first_lse, qkv[5])
    ok_fp, err_fp, share_fp = ATTN.agreement(first_out, first_lse, ref_out, ref_lse, qkv[5])
    check(ok_f and ok_fp, f"B19's designs within agreement of each other ({err_f:.3e}, {share_f:.3e} differ) and "
                          f"the first of the plain version ({err_fp:.3e}, {share_fp:.3e})")
    plain_ms = time_ms(ops.int8_flash_fwd_plain, inputs[:1], iters=2)
    library_ms = lib_ms("SDPA", sdpa_grouped, copies(q, k, v))
    n_inst, (G, S, hd) = int(np.prod(ATTN_LEAD)), q.shape[-3:]
    pairs = n_inst * G * S * (S + 1) // 2  # the causal triangle's (row, column) pairs
    nbytes = n_inst * (G * S * hd * 3 + G * S * 8 + 2 * S * hd + 2 * S * 4)  # q, k, v, scales in; out, lse out
    b_ms, by = bound(nbytes, int8_ops=4 * pairs * hd, sfu_ops=pairs)
    print(f"[3] int8_flash_fwd (B19) {list(q.shape)} causal, block_kv 512, launched on its sm90 design: within its "
          f"bound of the plain version "
          f"(max |out - plain| {err:.3e}, {share:.3e} of the elements differ, lse max "
          f"{(lse - ref_lse).abs().max().item():.3e}) and of the first design ({err_f:.3e}, {share_f:.3e} differ; "
          f"the first design against the plain version {share_fp:.3e}); the same bits on a second run; kernel "
          f"{ms:.4f} ms ({4 * pairs * hd / ms / 1e9:.1f} TOP/s, {pairs / ms / 1e9:.3f} T exp/s, {b_ms / ms:.3f} of "
          f"the {b_ms:.4f} ms bound by {by}); first design (the parent's kernel) {first_ms:.4f} ms "
          f"({first_ms / ms:.2f}x this, {b_ms / first_ms:.3f} of the bound); plain {plain_ms:.3f} ms, SDPA bf16 "
          f"{'refused' if library_ms is None else f'{library_ms:.4f} ms'}")
    return _entry("int8_flash_fwd", "quantized_training_tpu/ops/int8_attention.py:117", err,
                  (tuple(q.shape), ms, plain_ms), nbytes, int8_ops=4 * pairs * hd, library_ms=library_ms,
                  sfu_ops=pairs, first_ms=first_ms)


def mixed_requests(vocab: int):
    with patched(benchmark_serving, MIX_BUDGETS=MIX_BUDGETS):
        return benchmark_serving._mixed_requests(N_REQUESTS, vocab)


def same_stream(params, cfg, prompt, got, ref, bar: float = 1e-2) -> str:
    """Equal greedy streams, or a first difference at a near-tie: the
    reference's teacher-forced top-2 logit margin below ``bar`` of max|logit|
    (bf16 sums in another batch shape may decide such a tie either way)."""
    j = next((i for i, (x, y) in enumerate(zip(got, ref)) if x != y), None)
    check(len(got) == len(ref), "stream lengths")
    if j is None:
        return "equal"
    seq = torch.tensor([prompt + ref[:j]], device=DEVICE)
    cache = llama_infer.KVCache.zeros(cfg, 1, seq.shape[1], device=DEVICE)
    last = llama_infer.forward_with_cache(params, seq, cache, 0, cfg)[0, -1].float()
    top2 = last.topk(2).values
    margin = (top2[0] - top2[1]).item() / last.abs().max().item()
    check(margin < bar, f"stream parts at step {j} with top-2 margin {margin:.2e} (bar {bar:g})")
    return f"equal up to step {j}, then a near-tie (top-2 margin {margin:.2e} of max|logit|)"


def serve(gen: torch.Generator) -> tuple[dict, dict]:
    """Phase 4: benchmark_serving's mixed load through its ``mixed_load``
    (3 x 8 requests of its prompt lengths, budgets ``SERVE_BUDGETS``,
    ``max_len`` 2048, decode chunk 16) over Llama2-1B ``mixed_precision``
    weights at full depth: the windowed server and the full-window server,
    each a warm and a timed drain, then static batched generate. Every
    drain streams every token once and launches K1 and K2, every K2 decode
    launch on the split-K stream and every prefill launch on sm90, K1 on the
    row walk (:func:`served`); two streams of the windowed server's timed
    drain are held against generate(), and the static baseline's tokens at
    every request against the windowed server's on the same left-padded
    prompt (``STATIC_BAR``). Returns the timed windowed drain's launches and
    the driver's numbers."""
    params = quant.quantize_params(llama.init_params(gen, CFG), "mixed_precision")
    args = argparse.Namespace(n_slots=8, max_len=2048, decode_chunk=16)
    drains, drain = [], benchmark_serving.drain_mixed

    def recorded(srv, reqs):
        first = srv._next_rid
        ops.reset_launch_counts()
        with k2_calls(srv) as rows:
            n = drain(srv, reqs)
        drains.append((srv, range(first, first + len(reqs)), n, rows, ops.launch_counts()))
        return n

    torch.cuda.synchronize()
    weights_gib = sum(t.numel() * t.element_size() for t in tree_leaves(params)) / 2**30
    torch.cuda.reset_peak_memory_stats()  # the peak below is serving's, not init's
    t0 = time.perf_counter()
    with patched(benchmark_serving, drain_mixed=recorded, MIX_BUDGETS=SERVE_BUDGETS):
        reqs = benchmark_serving._mixed_requests(3 * args.n_slots, CFG.vocab_size)
        out = benchmark_serving.mixed_load(params, CFG, args)
    seconds = time.perf_counter() - t0
    check(len(drains) == 4, f"two servers, a warm and a timed drain each: {len(drains)} drains")
    for i, (srv, rids, n, rows, launches) in enumerate(drains):
        decode, k1_walk = served(launches, rows, reqs, [srv.result(r) for r in rids], n, CFG)
        print(f"[4] {('windowed', 'full-window')[i // 2]} server, {('warm', 'timed')[i % 2]} drain: {len(reqs)} "
              f"requests, {n} tokens; K2 {decode} decode launches (M <= {SCALED_MM.DECODE_M}) on the decode stream, "
              f"{launches['scaled_mm_rhs_t_sm90']} prefill launches on sm90; K1 {k1_walk} of "
              f"{launches['quantize_int8_rowwise']} launches on the row walk (the rest the KV rows of 64)")
    for i in (0, 2):  # the windowed and the full-window server
        replays = sum(fn.captured.replays for fn in drains[i][0]._decode_fns.values() if fn.captured is not None)
        check(replays > 0, f"the {('windowed', 'full-window')[i // 2]} server's decode steps are CUDA graphs, "
                           f"replayed: {replays}")
    srv, rids, _, _, launches = drains[1]
    results = [srv.result(r) for r in rids]
    print(f"[4] Llama2-1B mixed_precision, benchmark_serving --load mixed (3 x 8 requests, prompts "
          f"{benchmark_serving.MIX_PROMPTS}, budgets {SERVE_BUDGETS}, the driver's {benchmark_serving.MIX_BUDGETS} "
          f"cut for time; max_len 2048, decode chunk 16): windowed {out['windowed']:.1f} tok/s (windows compiled "
          f"{out['windows']}), full-window {out['full']:.1f} tok/s, static batched generate {out['static']:.1f} "
          f"useful tok/s; {seconds:.1f} s; weights {weights_gib:.2f} GiB, peak device memory while serving "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; the timed windowed drain's launches {launches}")
    vs_generate(4, params, CFG, reqs, results)
    graphed_vs_eager_decode(params, reqs, results, launches, args)
    # the static baseline's rows against the windowed server given the same
    # left-padded prompts (the pads are tokens it attends to, as in JAX)
    pmax = max(len(p) for p, _ in reqs)
    rows = [row.tolist() for batch in benchmark_serving.static_batches(reqs, args.n_slots, DEVICE) for row in batch]
    padded = [(row, budget) for row, (_, budget) in zip(rows, reqs)]
    srv = Server(params, CFG, n_slots=args.n_slots, max_len=args.max_len, decode_chunk=args.decode_chunk)
    rids = [srv.add_request(p, b) for p, b in padded]
    while srv.pending():
        srv.step()
    parted = []
    for i, ((prompt, budget), rid) in enumerate(zip(padded, rids)):
        static = out["static_tokens"][i // args.n_slots][i % args.n_slots, pmax:pmax + budget].tolist()
        verdict = same_stream(params, CFG, prompt, static, srv.result(rid), STATIC_BAR)
        if verdict != "equal":
            parted.append(f"request {i}: {verdict}")
    print(f"[4] static generate's {len(padded)} rows (prompts left-padded to {pmax}) against the windowed server given "
          f"the same padded prompts: {len(padded) - len(parted)} equal" + "".join(f"; {p}" for p in parted))
    return launches, out


DECODE_TIMED_CALLS = 4  # phase 4: decode calls timed, each form
DECODE_PROMPT = 150  # and its prompts' length: every call in the window of 256


def graphed_vs_eager_decode(params, reqs, graphed: list, graphed_launches: dict, args) -> dict:
    """Phase 4: the graphed decode (``Server``'s default, a CUDA graph a
    window and chunk) against the eager one (``jit_compile=False``). The
    ``--load mixed`` requests through an eager windowed server: every token
    stream identical to the graphed server's timed drain (``graphed``), every
    K2 call routed by its own M (:func:`served`: each consults the route
    predicate), and K2's decode and sm90 launches equal to the graphed timed
    drain's (``graphed_launches``). Then decode alone, the two in turns:
    ``n_slots`` slots prefilled with prompts of ``DECODE_PROMPT`` tokens and a
    first call (the graph's capture), ``DECODE_TIMED_CALLS`` timed calls of
    ``decode_chunk`` tokens a slot (each ends in the tokens' copy to the host,
    as ``Server.step`` does; the peak device memory of each form's calls,
    both servers resident), then one more under ``torch.profiler``: ms a
    decode step (one token of every slot), tok/s, and the busy share
    (:func:`kernel_ms`). Returns the numbers by form."""
    srv = Server(params, CFG, n_slots=args.n_slots, max_len=args.max_len, decode_chunk=args.decode_chunk,
                 jit_compile=False)
    ops.reset_launch_counts()
    n = 0
    with k2_calls(srv) as rows:
        rids = [srv.add_request(p, b) for p, b in reqs]  # the first n_slots prefills run here
        while srv.pending():
            n += len(srv.step())
    launches = ops.launch_counts()
    eager = [srv.result(r) for r in rids]
    check(all(fn.captured is None for fn in srv._decode_fns.values()), "the eager server captured no graph")
    check(len(rows) == launches["scaled_mm_rhs_t"], f"every eager K2 call consulted the route predicate: "
                                                     f"{len(rows)} of {launches['scaled_mm_rhs_t']}")
    decode, _ = served(launches, rows, reqs, eager, n, CFG)
    same = sum(a == b for a, b in zip(eager, graphed))
    split = {k: (launches[k], graphed_launches[k]) for k in ("scaled_mm_rhs_t_decode", "scaled_mm_rhs_t_sm90")}
    print(f"[4] --load mixed through the eager windowed server (jit_compile=False): {same} of {len(reqs)} token "
          f"streams identical to the graphed server's; K2 {decode} decode and {launches['scaled_mm_rhs_t_sm90']} "
          f"sm90 launches, each call routed by its M; (eager, graphed timed drain) by route {split}", flush=True)
    check(same == len(reqs), "the graphed decode emits the eager decode's token streams exactly")
    check(all(a == b for a, b in split.values()), "the graphed drain's K2 routes equal the eager drain's")
    del srv

    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(1, CFG.vocab_size, size=DECODE_PROMPT).tolist() for _ in range(args.n_slots)]
    k = args.decode_chunk
    servers = {name: Server(params, CFG, n_slots=args.n_slots, max_len=args.max_len, decode_chunk=k,
                            jit_compile=name == "graphed") for name in ("graphed", "eager")}
    for srv in servers.values():
        for p in prompts:
            srv.add_request(p, 1 + k * (DECODE_TIMED_CALLS + 2))
        srv.step()  # the prefills' tokens and a first decode call: the graph's capture
    GRAPHS.reset_replay_count()
    walls, peaks = {name: [] for name in servers}, dict.fromkeys(servers, 0.0)
    for _ in range(DECODE_TIMED_CALLS):
        for name, srv in servers.items():
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            n = len(srv.step())
            walls[name].append(time.perf_counter() - t0)
            peaks[name] = max(peaks[name], torch.cuda.max_memory_allocated() / 2**30)
            check(n == k * args.n_slots, f"{name}: a decode call gave {n} tokens")
    check(GRAPHS.replay_count() == DECODE_TIMED_CALLS, f"the graphed decode replayed at every timed call: "
                                                       f"{GRAPHS.replay_count()}")
    out = {}
    for name, srv in servers.items():
        total, busy, groups = kernel_ms(srv.step)
        call_ms = 1e3 * sum(walls[name]) / len(walls[name])
        out[name] = dict(ms=call_ms / k, tok_s=args.n_slots * k / call_ms * 1e3, kernels_ms=total, busy=busy,
                         peak_gib=peaks[name])
        print(f"[4] {name} decode (Llama2-1B mixed_precision, {args.n_slots} slots at positions {DECODE_PROMPT}-"
              f"{DECODE_PROMPT + k * (DECODE_TIMED_CALLS + 2)}, window 256, chunk {k}; {SMI}): "
              f"{out[name]['ms']:.3f} ms a decode step ({call_ms:.2f} ms a call of {k}, calls "
              f"{[round(w * 1e3, 2) for w in walls[name]]} ms), {out[name]['tok_s']:.1f} tok/s; peak device memory "
              f"{peaks[name]:.2f} GiB (both servers resident); one profiled call's kernels {total:.2f} ms, busy "
              f"{100 * busy:.1f}% of its wall; kernels by group: "
              + "; ".join(f"{n} {t:.2f}" for n, t in sorted(groups.items(), key=lambda kv: -kv[1])), flush=True)
    print(f"[4] graphed/eager decode: {out['eager']['ms'] / out['graphed']['ms']:.3f}x the eager decode's rate",
          flush=True)
    return out


@contextlib.contextmanager
def k2_calls(srv):
    """K2's M at each call of a drain through ``srv``, for :func:`served`:
    an eager call's as it consults the route predicate on the caller's
    stream (a graph's warm-up, on a side stream, and its capture are left
    out: their launches are taken back), and each K2 launch of a decode
    graph's replays at M = the server's slots, the rows of every decode
    step."""
    rows, route, main = [], SCALED_MM.sm90_route, torch.cuda.current_stream()
    before = {id(c): (c, c.replays) for fn in srv._decode_fns.values() if (c := fn.captured)}

    def recorded(M):
        if torch.cuda.current_stream() == main and not torch.cuda.is_current_stream_capturing():
            rows.append(M)
        return route(M)

    SCALED_MM.sm90_route = recorded
    try:
        yield rows
    finally:
        SCALED_MM.sm90_route = route
    graphs = {id(c): (c, 0) for fn in srv._decode_fns.values() if (c := fn.captured)} | before
    for c, replays in graphs.values():
        rows.extend([srv.n_slots] * ((c.replays - replays) * c.launches.get("scaled_mm_rhs_t", 0)))


def served(launches: dict, rows: list, reqs, results, n: int, cfg) -> tuple[int, int]:
    """The checks of one drain of ``reqs`` through the server: each request
    got its budget of tokens in the vocabulary and every token was streamed
    once; K1 and K2 launched, K2's calls of M <= 16 (``rows``, from
    :func:`k2_calls`: its M per call) on the decode stream and the rest on
    sm90, K1 on the row walk. Returns (K2's decode launches, K1's on the
    walk)."""
    for (prompt, budget), out in zip(reqs, results):
        check(len(out) == budget and all(0 <= t < cfg.vocab_size for t in out),
              f"{len(out)} tokens for a budget of {budget}")
    check(n == sum(b for _, b in reqs), "every token streamed once")
    check(all(launches[k] > 0 for k in SERVING_KERNELS), f"every kernel of the serving path launched: {launches}")
    decode = sum(m <= SCALED_MM.DECODE_M for m in rows)
    check(len(rows) == launches["scaled_mm_rhs_t"] and decode > 0
          and launches["scaled_mm_rhs_t_decode"] == decode and launches["scaled_mm_rhs_t_sm90"] == len(rows) - decode,
          f"K2's {decode} decode launches on the decode stream, its {len(rows) - decode} prefill launches on sm90: "
          f"{launches['scaled_mm_rhs_t_decode']} decode and {launches['scaled_mm_rhs_t_sm90']} sm90 of "
          f"{launches['scaled_mm_rhs_t']}")
    check(launches["quantize_int8_rowwise_sm90"] > 0, "K1 launched on the row walk while serving")
    return decode, launches["quantize_int8_rowwise_sm90"]


def serve_params(phase: int, what: str, params, cfg, reqs, warm: bool = True) -> dict:
    """``Server(n_slots=8, max_len=2048, decode_chunk=16)`` over ``params``
    answers ``reqs`` (after a warm-up pass of the same requests with
    ``warm``), held by :func:`served`; two streams held against
    ``generate()``. Returns the timed pass's launches."""
    torch.cuda.synchronize()
    weights_gib = sum(t.numel() * t.element_size() for t in tree_leaves(params)) / 2**30
    torch.cuda.reset_peak_memory_stats()  # the peak below is serving's, not init's
    srv = Server(params, cfg, n_slots=8, max_len=2048, decode_chunk=16)

    def drain():
        rids = [srv.add_request(p, b) for p, b in reqs]
        n = 0
        while srv.pending():
            n += len(srv.step())
        torch.cuda.synchronize()
        return rids, n

    if warm:
        drain()  # warm-up: library load, cuBLAS handles, allocator pools
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with k2_calls(srv) as rows:
        rids, n = drain()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    decode, k1_walk = served(launches, rows, reqs, [srv.result(r) for r in rids], n, cfg)
    print(f"[{phase}] Llama2-1B {what} Server(n_slots=8, max_len=2048, decode_chunk=16): "
          f"{len(reqs)} requests, {n} tokens in {wall:.3f} s = {n / wall:.1f} tok/s; K2 {decode} decode launches "
          f"(M <= {SCALED_MM.DECODE_M}) on the decode stream, {launches['scaled_mm_rhs_t_sm90']} prefill launches on "
          f"sm90; K1 "
          f"{k1_walk} of {launches['quantize_int8_rowwise']} launches on the row walk (the rest the KV rows of 64); "
          f"weights {weights_gib:.2f} GiB, peak device memory while serving "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches {launches}")
    vs_generate(phase, params, cfg, reqs, [srv.result(r) for r in rids])
    return launches


def vs_generate(phase: int, params, cfg, reqs, results) -> None:
    """The server's streams of the first two requests against
    ``generate()`` of each alone (:func:`same_stream`)."""
    for i in (0, 1):
        prompt, budget = reqs[i]
        ref = llama_infer.generate(params, torch.tensor([prompt], device=DEVICE), cfg, budget)
        ref = ref[0, len(prompt):].tolist()
        print(f"[{phase}] request {i} (prompt {len(prompt)}, budget {budget}) vs generate(): "
              f"{same_stream(params, cfg, prompt, results[i], ref)}; tokens {results[i]}")


def kernel_vs_plain_path(seed: int, dtype: torch.dtype, max_rms: float, min_agree: float) -> None:
    """Prefill logits of a 2-layer cut of Llama2-1B (full width, weights
    from ``seed``) for one 96-token prompt: kernels on the card against the
    plain versions on the CPU. Bounds: relative RMS of the difference
    <= ``max_rms`` and argmax equal at >= ``min_agree`` of positions.

    K1 and K2 are bit-exact, so the paths differ only where the torch ops
    around them (attention, norms, the lm_head GEMM) round differently on
    the card and on the CPU. The int8 path turns any such difference into
    int8 rounding flips, so the logits differ by up to the int8 noise
    itself. Measured on the CPU, the plain path against itself with the
    embedding perturbed by one ulp of noise: relative RMS 1.1e-2, argmax
    agreement 0.98 in fp32 (TF32 off); 5.9e-2 and 0.92 in bf16. The bounds
    sit above that floor (3e-2 / 0.95 fp32, 1e-1 / 0.85 bf16); a wiring
    fault (a transposed or mis-scaled operand) gives an RMS near 1."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(CFG, num_hidden_layers=2)
    raw = llama.init_params(torch.Generator(device=DEVICE).manual_seed(seed), cfg, dtype=dtype)
    to_cpu = lambda t: {k: to_cpu(v) for k, v in t.items()} if isinstance(t, dict) else t.cpu()
    p_dev = quant.quantize_params(raw, "mixed_precision")
    p_cpu = quant.quantize_params(to_cpu(raw), "mixed_precision")
    prompt = torch.from_numpy(np.random.default_rng(seed).integers(1, cfg.vocab_size, (1, 96)))
    logits = {}
    for dev, params in ((DEVICE, p_dev), ("cpu", p_cpu)):
        cache = llama_infer.KVCache.zeros(cfg, 1, 96, device=dev)
        logits[dev] = llama_infer.forward_with_cache(params, prompt.to(dev), cache, 0, cfg)[0].float().cpu()
    delta = logits[DEVICE] - logits["cpu"]
    rms = (delta.norm() / logits["cpu"].norm()).item()
    worst = (delta.abs().max() / logits["cpu"].abs().max()).item()
    agree = (logits[DEVICE].argmax(-1) == logits["cpu"].argmax(-1)).float().mean().item()
    print(f"[5] 2-layer Llama2-1B {str(dtype)[6:]} prefill (96 tokens), kernels on the card vs plain on the CPU: "
          f"relative RMS {rms:.3e} (bound {max_rms:g}), max|dlogit| {worst:.3e} of max|logit|; "
          f"argmax agree {agree:.3f} (bound {min_agree:g})")
    check(rms <= max_rms and agree >= min_agree, f"{dtype} kernel path within tolerance of the plain path")


def sdpa_per_layer() -> int:
    """SDPA forwards a Llama layer and micro-step counts under the remat
    policy or without remat (``ops.sdpa_forwards()``): one where attention
    resolves to SDPA (the card), none elsewhere (the CPU's einsum
    attention)."""
    return int(DEVICE == "cuda" and torch.cuda.is_available())


def per_step_launches(L: int, micro: int = 1, sr: bool = False, b6: int = 0, b6_sr: int = 0,
                      layer: str = "fused", mesh: bool = False, post_attn: bool = False,
                      save_qkv: bool = False) -> dict:
    """Kernel launches of one train step of L layers, from the code (pinned
    on the CPU by tests/test_torch_train.py, tests/test_torch_fused.py::
    test_kernel_calls_per_step_fused and tests/test_torch_remat.py): a layer
    has 7 quantized weights (q, k, v, o, gate, up, down) behind 4 inputs
    (q/k/v and gate/up share one). Every layer runs the grouped pipeline
    (attention is SDPA, not a kernel of the port: the remat replay is given
    its out and log-sum-exp): forward rope_group on q, k and v; backward
    rope_ungroup for their grads.

    The remat replay (``ops/remat.py``, JAX's ``save_only_these_names``)
    runs what a backward reads: the forward but down's product, its
    weight's K1 and its input's producer (B9-row, or K1 unfused);
    ``post_attn`` (``QT_SAVE_POSTATTN=1``) drops o's product, its weight's
    K1 and its input's B14 absmax and row quantize (unfused: o's K1s; the
    ungrouping stays, its linear's saved input), ``save_qkv``
    (``save_qkv_residuals``) the first B7 (unfused: its K1), q/k/v's
    products and K1s and their rope.

    ``layer`` 'fused' (int8): forward K1 per weight (7; on the row walk, the
    SR form at q, o, gate, up and down: k and v have 256 rows), K2 per weight (7),
    B7 at the two norm sites and B9-row at down's input (every one on the
    row walk), ungroup_amax and
    ungroup_quant (rows) at o's input (both on the row walk). Backward B5 at the output grads of
    q, k, v, o and down, B4 per weight (every one on the cluster form), B1
    and B2 per weight, B8 at the two norm sites and B10 at the two norms
    (every one on the row walk), B9-col at down's input, B11 and B12 for
    (dgate, dup) (all three on the row walk), ungroup_quant (columns, on the row
    walk) at o's input and rope_group
    for its grad. 'unfused' (int8, ``set_impl('off')``): forward K1 for the
    7 weights and the 4 inputs (on the row walk; the SR form at five weights
    and the three inputs of 2048), K2 per weight, rope_ungroup at o's input;
    backward per weight B5, B4, B1, B2, B4 once per input, rope_group for
    o's input grad (every B4 on the cluster form).
    'bf16': the rope kernels of 'unfused' only. All of that
    once per micro-batch, each quantize in its SR form with ``sr`` (B10 and
    B13 have none); then B6 once per parameter leaf (``b6``, or ``b6_sr``
    with the SR writeback). ``mesh``: a step on a data or fsdp mesh of two
    or more ranks, whose token-axis quantizes run as their mesh forms: every
    B5 (on the output grads) as one B5 maxima form and one B5 given form,
    and in the unfused layer the four B4 of the inputs as B4's, each with
    the given column cast (the weights' B4 and every K1 stay whole)."""
    t = "_sr" if sr else ""
    n = L * micro
    # the replay's linears: q, k, v (3), o (1), gate and up (2); never down
    qkv, o = (0 if save_qkv else 3), (0 if post_attn else 1)
    replayed = qkv + o + 2
    walk_w = (5, 4) if sr else (7, 6)  # weights on K1's walk: forward, replay (k and v off it under SR)
    walk_replay = walk_w[1] - (0 if qkv else (1 if sr else 3)) - (0 if o else 1)
    counts = dict.fromkeys(ops.KERNELS, 0)
    counts.update({"rope_group": (3 + 1 + qkv) * n, "rope_ungroup": (3 if layer == "fused" else 5) * n,
                   "fused_adamw_update": b6, "fused_adamw_update_sr": b6_sr})
    if layer == "fused":
        norm_rows = 2 + (0 if save_qkv else 1) + 1
        counts.update({f"quantize_int8_rowwise{t}": (7 + replayed) * n,
                       f"quantize_int8_rowwise{t}_sm90": (walk_w[0] + walk_replay) * n,
                       f"quantize_int8_colwise{t}": 7 * n,
                       f"quantize_int8_colwise{t}_sm90": 7 * n,
                       f"quantize_int8_both{t}": 5 * n, f"rmsnorm_quant_rowwise{t}": norm_rows * n,
                       f"rmsnorm_quant_rowwise{t}_sm90": norm_rows * n, f"silu_mul_bwd_quant_rowwise{t}_sm90": n,
                       f"silu_mul_quant_rowwise{t}": n, f"silu_mul_quant_rowwise{t}_sm90": n,
                       f"rmsnorm_quant_colwise{t}": 2 * n, f"rmsnorm_quant_colwise{t}_sm90": 2 * n,
                       f"silu_mul_quant_colwise{t}": n, f"silu_mul_quant_colwise{t}_sm90": n,
                       "rmsnorm_bwd": 2 * n, "rmsnorm_bwd_sm90": 2 * n, f"silu_mul_bwd_quant_rowwise{t}": n,
                       f"silu_mul_bwd_quant_colwise{t}": n, f"silu_mul_bwd_quant_colwise{t}_sm90": n,
                       "ungroup_amax": (1 + o) * n, "ungroup_amax_sm90": (1 + o) * n,
                       f"ungroup_quant{t}": (2 + o) * n, f"ungroup_quant{t}_sm90": (2 + o) * n})
    elif layer == "unfused":
        # the replay's inputs: q/k/v's, o's, gate/up's (down's never)
        inputs = (1 if qkv else 0) + o + 1
        walk_in = inputs  # the inputs of 2048 take the walk in both forms
        counts.update({f"quantize_int8_rowwise{t}": (11 + replayed + inputs) * n,
                       f"quantize_int8_rowwise{t}_sm90": ((8 if sr else 11) + walk_replay + walk_in) * n,
                       f"quantize_int8_colwise{t}": 11 * n,
                       f"quantize_int8_colwise{t}_sm90": 11 * n,
                       f"quantize_int8_both{t}": 7 * n})
    if layer != "bf16":
        k2 = (7 + replayed) * n
        counts.update({"scaled_mm_rhs_t": k2, "scaled_mm_rhs_t_sm90": k2, "scaled_mm": 7 * n,
                       "scaled_mm_sm90": 7 * n, "scaled_mm_lhs_t": 7 * n, "scaled_mm_lhs_t_sm90": 7 * n})
    if mesh and layer != "bf16":
        both = counts[f"quantize_int8_both{t}"]
        counts.update({f"quantize_int8_both{t}": 0, f"quantize_int8_both_maxima{t}": both,
                       f"quantize_int8_colwise_given{t}": both})
        if layer == "unfused":
            counts[f"quantize_int8_colwise{t}"] -= 4 * n
            counts[f"quantize_int8_colwise{t}_sm90"] -= 4 * n
            counts.update({"quantize_int8_colwise_maxima": 4 * n})
            counts[f"quantize_int8_colwise_given{t}"] += 4 * n
    return counts


@contextlib.contextmanager
def whole_layer_checkpoint():
    """The remat policy off: every checkpointed layer (block) replays whole
    in the backward, as before the policy (``ops/remat.py::checkpointed``
    made the identity, so no op saves, loads or skips)."""
    keep = REMAT.checkpointed
    REMAT.checkpointed = lambda fn: fn
    try:
        yield
    finally:
        REMAT.checkpointed = keep


def run_steps(params, cfg, tokens, labels, opt, lr: float, key: int, n_steps: int, expect: dict | None,
              norms: list | None = None, sdpa: int | None = None, jit_compile: bool = True):
    """n_steps of make_train_step(cfg, opt, jit_compile=jit_compile) at
    ``lr`` on one batch, step i with the key ``fold_in(key, i)``: per step
    the loss, wall seconds (ends in a synchronize) and, when ``expect`` is
    given, the launch counts checked against it, when ``sdpa`` is, SDPA's
    forwards; each step's grad norm appended to ``norms``."""
    step = train.make_train_step(cfg, opt, jit_compile=jit_compile)
    state = train.init_train_state(params, opt)
    losses, walls, launches = [], [], dict.fromkeys(ops.KERNELS, 0)
    for i in range(n_steps):
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        state, m = step(state, tokens, labels, lr, random.fold_in(key, i))
        loss = m["loss"].item()  # synchronizes
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        losses.append(loss)
        counts = ops.launch_counts()
        if expect is not None:
            check(counts == expect, f"step {i + 1} launches {counts} == {expect}")
        if sdpa is not None:
            check(ops.sdpa_forwards() == sdpa, f"step {i + 1}: SDPA forwards {ops.sdpa_forwards()} == {sdpa}")
        launches = {k: launches[k] + v for k, v in counts.items()}
        check(np.isfinite(loss) and np.isfinite(m["grad_norm"].item()), f"step {i + 1}: finite loss and norm")
        if norms is not None:
            norms.append(m["grad_norm"].item())
    del state
    return losses, walls, launches


def int8_vs_bf16(phase: int, what: str, raw, cfg, tokens, labels, opt, lr: float, key: int,
                 expect_int8: dict, expect_bf16: dict | None, expect_unfused: dict | None = None,
                 sdpa: int | None = None):
    """Three steps int8 mixed_precision on the fused layer, with
    ``expect_unfused`` three more on the unfused layer (``set_impl('off')``),
    then three bf16, from the same weights, batch and keys: the losses fall,
    the first-step losses agree within 1e-2 (int8 against bf16) and 1e-3
    (fused against unfused); each step's SDPA forwards ``sdpa`` where
    given; prints tokens/s of steps 2-3 (step 1 warms up), the ratios and
    each run's peak memory. Returns (int8 losses, int8
    launches, (bf16 first loss, bf16 tokens/s))."""
    def measured(params, expect, impl="auto"):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        quant.set_impl(impl)
        try:
            losses, walls, launches = run_steps(params, cfg, tokens, labels, opt, lr, key, 3, expect, sdpa=sdpa)
        finally:
            quant.set_impl("auto")
        return losses, walls, launches, torch.cuda.max_memory_allocated() / 2**30

    qparams = quant.quantize_params(raw, "mixed_precision")
    runs = {"int8": measured(qparams, expect_int8)}
    if expect_unfused is not None:
        runs["int8 unfused"] = measured(qparams, expect_unfused, "off")
    runs["bf16"] = measured(raw, expect_bf16)
    n_tok = tokens.numel()
    tps = {k: n_tok * (len(r[1]) - 1) / sum(r[1][1:]) for k, r in runs.items()}
    print(f"[{phase}] {what}: " + "; ".join(
        f"{k} losses {r[0]}, step walls {[round(w, 4) for w in r[1]]} s" for k, r in runs.items()))
    ratios = ", ".join(f"{k}/bf16 {tps[k] / tps['bf16']:.3f}" for k in runs if k != "bf16")
    if expect_unfused is not None:
        ratios += f", int8 fused/unfused {tps['int8'] / tps['int8 unfused']:.3f}"
    print(f"[{phase}] tokens/s ({n_tok} tokens per step, steps 2-3, wall with torch.cuda.synchronize()): "
          + ", ".join(f"{k} {v:.1f}" for k, v in tps.items()) + f" ({ratios}); peak device memory "
          + ", ".join(f"{k} {r[3]:.2f} GiB" for k, r in runs.items())
          + f"; launches per int8 step { {k: v for k, v in expect_int8.items() if v} }")
    q_losses, b_losses = runs["int8"][0], runs["bf16"][0]
    check(all(r[0][2] < r[0][0] for r in runs.values()), f"losses fall: { {k: r[0] for k, r in runs.items()} }")
    rel = abs(b_losses[0] - q_losses[0]) / abs(b_losses[0])
    check(rel <= 1e-2, f"int8 first loss within 1e-2 of bf16's: {rel:.3e}")
    print(f"[{phase}] first-step loss int8 vs bf16: relative {rel:.3e} (bound 1e-2)")
    if expect_unfused is not None:
        u = runs["int8 unfused"][0][0]
        rel_u = abs(q_losses[0] - u) / abs(u)
        print(f"[{phase}] first-step loss int8 fused vs unfused: relative {rel_u:.3e} (bound 1e-3)")
        check(rel_u <= 1e-3, f"fused first loss within 1e-3 of the unfused one: {rel_u:.3e}")
    return q_losses, runs["int8"][2], (b_losses[0], tps["bf16"])


def train_cfg_and_batch(seed: int, shape):
    """Llama2-1B as the training phases run it (remat, SDPA) and a token
    batch of ``shape`` from ``seed``, labels the tokens shifted by one."""
    cfg = dataclasses.replace(CFG, remat=True, attention_impl="auto")
    tokens = torch.from_numpy(np.random.default_rng(seed).integers(0, cfg.vocab_size, shape)).to(DEVICE)
    return cfg, tokens, torch.roll(tokens, -1, dims=-1)


def train_slice(raw, seed: int, key: int):
    """Phase 6: llm_pretrain.py's defaults (batch 4 x 2048, remat, adamw
    with weight decay 1e-2, lr 3e-4), Llama2-1B at full width and depth,
    int8 mixed_precision on the fused layer, then the same steps in bf16
    from the same weights and batch. Returns the int8 losses and launches,
    and the bf16 run's first loss and tokens/s."""
    cfg, tokens, labels = train_cfg_and_batch(seed, (TRAIN_B, TRAIN_S))
    what = (f"Llama2-1B train step (B={TRAIN_B} x S={TRAIN_S}, remat, SDPA, adamw lr 3e-4), seed {seed}")
    L = cfg.num_hidden_layers
    return int8_vs_bf16(6, what, raw, cfg, tokens, labels, optim.adamw(weight_decay=1e-2), 3e-4, key,
                        per_step_launches(L), per_step_launches(L, layer="bf16"), sdpa=sdpa_per_layer() * L)


def bench_step(raw, seed: int, key: int) -> tuple[dict, dict]:
    """Phase 8: bench.py's step through the port's ``bench`` driver
    (``bench.measure("llama2-1b", 4, 2048, scheme, accum=4)``: tokens [4,
    4, 2048], remat, adamw_bf16_sr without the SR writeback, lr 1e-4; 2 warm
    steps, then ``BENCH_STEPS`` synced and as many chained), int8
    mixed_precision without SR on the fused layer, on the unfused layer,
    then bf16, from the same weights and batch. Each int8 step launches 4 x
    the per-micro-batch counts of its layer under the remat policy, and
    each step of all three B6 (round-to-nearest) once per parameter leaf and
    SDPA's forward once a layer and micro-step; the losses fall, the int8
    first loss is within 1e-2 of bf16's and the fused within 1e-3 of the
    unfused; bench's JSON line has JAX's keys and its value the rate of the
    synced and chained loops. Then one fused int8 step under the profiler.
    Returns the fused int8 launches and bench's line."""
    L, micro, n_leaves = CFG.num_hidden_layers, BENCH_ACCUM, len(tree_leaves(raw))
    runs = {}
    with preset(CFG):
        for name, scheme, impl, layer in (("int8", "mixed_precision", "auto", "fused"),
                                          ("int8 unfused", "mixed_precision", "off", "unfused"),
                                          ("bf16", None, "auto", "bf16")):
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            quant.set_impl(impl)
            GRAPHS.reset_replay_count()
            try:
                with StepLaunches(per_step_launches(L, micro=micro, b6=n_leaves, layer=layer),
                                  sdpa=sdpa_per_layer() * L * micro) as rec:
                    got = bench.measure("llama2-1b", TRAIN_B, TRAIN_S, scheme, micro, DEVICE, n_steps=BENCH_STEPS)
            finally:
                quant.set_impl("auto")
            check(rec.steps == 2 + 2 * BENCH_STEPS, f"bench.measure ran {rec.steps} steps")
            replays = GRAPHS.replay_count()
            check(replays == rec.steps, f"{name}: bench's step is a CUDA graph, replayed at each of its {rec.steps} "
                                        f"steps: {replays}")
            runs[name] = (got, rec.losses(), rec.total, torch.cuda.max_memory_allocated() / 2**30)
    chosen = ("llama2-1b", TRAIN_B, TRAIN_S, micro)
    line = bench.result_line(runs["int8"][0].tokens_per_sec, runs["bf16"][0].tokens_per_sec, chosen,
                             torch.cuda.get_device_name(0) if DEVICE == "cuda" else "cpu")
    print(f"[8] bench.py's step through bench.measure (Llama2-1B, tokens [{micro}, {TRAIN_B}, {TRAIN_S}], remat, "
          f"SDPA, adamw_bf16_sr without SR, lr 1e-4, {n_leaves} parameter leaves; 2 warm steps, {BENCH_STEPS} synced "
          f"and {BENCH_STEPS} chained, the driver's {bench.N_STEPS} cut for time): " + "; ".join(
              f"{k} losses {r[1]}, step walls synced {r[0].synced_s:.4f} s chained {r[0].chained_s:.4f} s, "
              f"{r[0].tokens_per_sec:.1f} tok/s, peak device memory {r[3]:.2f} GiB" for k, r in runs.items()))
    print(f"[8] int8/bf16 {runs['int8'][0].tokens_per_sec / runs['bf16'][0].tokens_per_sec:.3f}, int8 fused/unfused "
          f"{runs['int8'][0].tokens_per_sec / runs['int8 unfused'][0].tokens_per_sec:.3f}; launches per int8 step "
          f"{ {k: v for k, v in per_step_launches(L, micro=micro, b6=n_leaves).items() if v} }")
    print(json.dumps(line), flush=True)
    check(set(line) == BENCH_KEYS and set(line["detail"]) == BENCH_DETAIL_KEYS, f"bench's line has JAX's keys: {line}")
    for k in ("int8", "bf16"):
        got = runs[k][0]
        check(bench.result_line(got.tokens_per_sec, 1.0, chosen, "")["value"]
              == round(TRAIN_B * TRAIN_S * micro / min(got.synced_s, got.chained_s), 1),
              f"{k}: the rate is tokens over the faster of the synced and chained loops")
    check(line["value"] == round(runs["int8"][0].tokens_per_sec, 1), "bench's value is the int8 rate")
    for k, r in runs.items():
        check(r[1][-1] < r[1][0] and all(np.isfinite(r[1])), f"{k} losses fall: {r[1]}")
    q, u, b = (runs[k][1][0] for k in ("int8", "int8 unfused", "bf16"))
    rel, rel_u = abs(b - q) / abs(b), abs(q - u) / abs(u)
    print(f"[8] first-step loss int8 vs bf16: relative {rel:.3e} (bound 1e-2); int8 fused vs unfused: relative "
          f"{rel_u:.3e} (bound 1e-3)")
    check(rel <= 1e-2 and rel_u <= 1e-3, f"first losses: int8 vs bf16 {rel:.3e}, fused vs unfused {rel_u:.3e}")
    graphed_vs_eager_step(raw, seed, key)
    return runs["int8"][2], line


GRAPH_STEPS = 3  # phase 8: the graphed and the eager step, in turns


def kernel_ms(run) -> tuple[float, float, dict]:
    """``run()`` under ``torch.profiler``: the device time of its kernels
    (ms, summed), the busy share (the union of their intervals over the
    profiled call's wall, profiler included; at most 1, where a sum of
    kernels on two streams may pass the wall), and the summed time by
    ``profile_torch_step.py``'s groups."""
    from torch.profiler import ProfilerActivity, profile

    groups = {}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    for e in prof.key_averages():
        if e.self_device_time_total > 0 and e.device_type == torch.autograd.DeviceType.CUDA:
            group = PROFILE.group_of(e.key)
            groups[group] = groups.get(group, 0.0) + e.self_device_time_total / 1e3
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA and e.time_range.end > e.time_range.start)
    check(bool(spans and groups), "the profiler traced the card's kernels")
    busy_us, end = 0.0, spans[0][0]
    for a, b in spans:
        busy_us += max(0.0, b - max(a, end))
        end = max(end, b)
    return sum(groups.values()), busy_us / 1e6 / wall, groups


def graphed_vs_eager_step(raw, seed: int, key: int) -> dict:
    """Phase 8: bench's fused int8 step (tokens [4, 4, 2048], remat,
    adamw_bf16_sr without SR, lr 1e-4) graphed (``jit_compile`` and
    ``donate``, bench's default) and eager (``jit_compile=False``) from the
    same weights and batch, in turns. First ``GRAPH_STEPS`` steps of each
    under ``torch.use_deterministic_algorithms(True)``: the losses, grad
    norms and the parameters after the first step bit for bit, the
    launches (SDPA's forwards too) of every step equal, the graph captured
    once and replayed at every step. Then, from fresh states under default
    algorithms, ``GRAPH_STEPS`` steps of each in turns: ms a step and
    tokens/s (the steps after the first; a step's wall ends in a
    synchronize), the peak device memory of its steps (both forms' states
    resident), and one more step of each under ``torch.profiler``: its
    kernels' device time, by group, and the busy share (:func:`kernel_ms`).
    Returns the numbers by form."""
    cfg, tokens, labels = train_cfg_and_batch(seed, (BENCH_ACCUM, TRAIN_B, TRAIN_S))
    params = quant.quantize_params(raw, "mixed_precision")
    opt = optim.adamw_bf16_sr(bf16_stochastic_rounding=False)
    n_tok = tokens.numel()

    def forms():
        steps = {"graphed": train.make_train_step(cfg, opt),
                 "eager": train.make_train_step(cfg, opt, jit_compile=False)}
        return steps, {k: train.init_train_state(params, opt) for k in steps}

    # (1) bit for bit under deterministic algorithms
    steps, states = forms()
    got = {k: [] for k in steps}
    deterministic = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        for i in range(GRAPH_STEPS):
            for k, step in steps.items():
                ops.reset_launch_counts()
                states[k], m = step(states[k], tokens, labels, 1e-4, random.fold_in(key, 80 + i))
                first = [t.clone() for t in tree_leaves(states[k].params)] if i == 0 else None
                got[k].append((m["loss"].item(), m["grad_norm"].item(), ops.launch_totals(), first))
    finally:
        torch.use_deterministic_algorithms(deterministic)
    (captured,) = steps["graphed"].graphs.values()
    g, e = got["graphed"], got["eager"]
    same_params = all(torch.equal(a, b) for a, b in zip(g[0][3], e[0][3]))
    print(f"[8] graphed against eager fused int8 step, deterministic algorithms, {GRAPH_STEPS} steps in turns: "
          f"losses {[x[0] for x in g]} / {[x[0] for x in e]}; grad norms {[x[1] for x in g]} / {[x[1] for x in e]}; "
          f"parameters after the first step bit for bit {same_params}; launches a step equal "
          f"{[x[2] == y[2] for x, y in zip(g, e)]}; the graph replayed {captured.graph.replays} times", flush=True)
    check([x[:2] for x in g] == [x[:2] for x in e] and same_params,
          "the graphed step gives the eager step's losses, grad norms and first-step parameters bit for bit")
    check(all(x[2] == y[2] for x, y in zip(g, e)), "the graphed step's launches a step equal the eager step's")
    check(captured.graph.replays == GRAPH_STEPS, f"the graph replayed at every step: {captured.graph.replays}")
    del steps, states, got, g, e, captured
    torch.cuda.empty_cache()

    # (2) timed, default algorithms
    steps, states = forms()
    walls, peaks = {k: [] for k in steps}, {k: 0 for k in steps}
    for i in range(GRAPH_STEPS):
        for k, step in steps.items():
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            states[k], m = step(states[k], tokens, labels, 1e-4, random.fold_in(key, 90 + i))
            loss = m["loss"].item()
            torch.cuda.synchronize()
            walls[k].append(time.perf_counter() - t0)
            peaks[k] = max(peaks[k], torch.cuda.max_memory_allocated() / 2**30)
            check(np.isfinite(loss), f"{k} step {i + 1}: finite loss")
    out = {}
    for k, step in steps.items():
        def one(k=k, step=step):
            states[k] = step(states[k], tokens, labels, 1e-4, random.fold_in(key, 99))[0]

        total, busy, groups = kernel_ms(one)
        ms = 1e3 * sum(walls[k][1:]) / (len(walls[k]) - 1)
        out[k] = dict(ms=ms, tok_s=n_tok / ms * 1e3, kernels_ms=total, busy=busy, peak_gib=peaks[k],
                      groups=groups)
    (captured,) = steps["graphed"].graphs.values()
    check(captured.graph.replays == GRAPH_STEPS + 1, f"the timed graph replayed at every step: {captured.graph.replays}")
    for k, v in out.items():
        print(f"[8] {k} fused int8 step (Llama2-1B, tokens [{BENCH_ACCUM}, {TRAIN_B}, {TRAIN_S}], remat, adamw_bf16_sr "
              f"without SR; {SMI}): {v['ms']:.1f} ms a step (steps 2-{GRAPH_STEPS}, walls "
              f"{[round(w * 1e3, 1) for w in walls[k]]} ms), {v['tok_s']:.1f} tok/s; one profiled step's kernels "
              f"{v['kernels_ms']:.1f} ms, busy {100 * v['busy']:.1f}% of its wall; peak device memory "
              f"{v['peak_gib']:.2f} GiB (both forms' states resident); kernels by group: "
              + "; ".join(f"{n} {t:.1f}" for n, t in sorted(v["groups"].items(), key=lambda kv: -kv[1])), flush=True)
    print(f"[8] graphed/eager: {out['eager']['ms'] / out['graphed']['ms']:.3f}x the eager step's rate", flush=True)
    del steps, states
    torch.cuda.empty_cache()
    return out


def sr_config(raw, seed: int, key: int, rn_first_loss: float) -> dict:
    """Phase 9: llm_pretrain.py with stochastic_rounding and ``--optim
    adamw_bf16_sr`` (SR writeback on, weight decay 1e-2, lr 3e-4) at batch
    4 x 2048, remat, the fused layer: only the SR forms of K1, B4, B5, B6,
    B7-B9, B11, B12 and B14's quantize launch (and B10, B13 and B14's
    absmax, which have none), each as often as phase 6's forms per step;
    the losses fall and the first is within 1e-2 of phase 6's
    round-to-nearest int8 first loss (same weights and batch). Returns the
    launches."""
    cfg, tokens, labels = train_cfg_and_batch(seed, (TRAIN_B, TRAIN_S))
    n_leaves = len(tree_leaves(raw))
    params = quant.quantize_params(raw, "mixed_precision", stochastic_rounding=True)
    opt = optim.get_optimizer("adamw_bf16_sr", weight_decay=1e-2)
    expect = per_step_launches(cfg.num_hidden_layers, sr=True, b6_sr=n_leaves)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    losses, walls, launches = run_steps(params, cfg, tokens, labels, opt, 3e-4, key, 3, expect,
                                        jit_compile=train.capture_refusal(params) is None)  # SR: eager
    peak = torch.cuda.max_memory_allocated() / 2**30
    rel = abs(losses[0] - rn_first_loss) / abs(rn_first_loss)
    print(f"[9] SR configuration (Llama2-1B, B={TRAIN_B} x S={TRAIN_S}, remat, SDPA, int8 mixed_precision with "
          f"stochastic_rounding, adamw_bf16_sr with the SR writeback, lr 3e-4), seed {seed}: losses {losses}, "
          f"step walls {[round(w, 4) for w in walls]} s, tokens/s (steps 2-3) "
          f"{TOKENS * (len(walls) - 1) / sum(walls[1:]):.1f}; peak device memory {peak:.2f} GiB; launches per "
          f"step { {k: v for k, v in expect.items() if v} }")
    print(f"[9] first-step loss SR vs round-to-nearest int8 (phase 6): relative {rel:.3e} (bound 1e-2)")
    check(losses[2] < losses[0], f"SR loss falls: {losses}")
    check(rel <= 1e-2, f"SR first loss within 1e-2 of the round-to-nearest one: {rel:.3e}")
    return launches


def grads_vs_plain(seed: int, dtype: torch.dtype, max_rms: float, max_dloss: float, sr_key: int | None = None,
                   fused: bool = False, qkw: dict | None = None, base: llama.LlamaConfig | None = None,
                   name: str = "Llama2-1B", phase: int = 7):
    """Phase 7: the loss and every gradient leaf of a 2-layer cut of
    Llama2-1B (full width, weights from ``seed``), int8 mixed_precision,
    one micro-step on 256 tokens, the kernels on the card against the plain
    versions on the CPU; with ``sr_key``, stochastic rounding from that key
    on both devices, which draws the same noise on both. Both run the
    grouped pipeline (``QT_FUSED_ROPE=force``: the CPU would otherwise take
    the ungrouped one; at 256 tokens the o-projection's fused op engages).
    ``fused``: the fused layer (``set_impl('auto')`` on the card,
    ``'interpret'`` on the CPU), else the unfused one on both (``'off'``).
    ``qkw``: another mixed-precision configuration (int4, fp8 tile), which
    runs the unfused layer and must launch its GEMM (B16, B15) and no int8
    kernel on the card. Bounds: relative RMS of each leaf's difference <=
    ``max_rms``; relative loss difference <= ``max_dloss``.

    Every kernel of the unfused layer is bit-exact, and B7, B8 and B10 are
    off by fp32 sum order, so the two paths differ where the torch ops
    around them round differently, and int8 rounding flips in the forward
    and both backward matmuls carry that difference. The floor, measured on
    the CPU on the grouped pipeline with weights from seeds 0 and 1: the
    plain path against itself with the embedding moved by one ulp gives a
    worst leaf of 4.5e-2 / 4.7e-2 and a loss 2.3e-5 / 1.7e-4 apart in fp32,
    7.2e-2 / 7.3e-2 and 5.2e-4 / 2.2e-4 in bf16 (the fused layer; the
    unfused one 4.4e-2 / 4.7e-2, 1.6e-4 / 1.3e-4, 7.2e-2 / 7.4e-2, 3.2e-4 /
    5.4e-4). The bounds sit above it (1.5e-1 / 2e-1 per leaf, 1e-3 on the
    loss); a wiring fault (a transposed operand, a scale on the wrong axis)
    gives a relative RMS near 1. ``base``, ``name`` and ``phase``: another
    model cut to 2 layers (phase 15's Llama-2-470m)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(base or CFG, num_hidden_layers=2, remat=True)
    raw = llama.init_params(torch.Generator(device=DEVICE).manual_seed(seed), cfg, dtype=dtype)
    to_cpu = lambda t: {k: to_cpu(v) for k, v in t.items()} if isinstance(t, dict) else t.cpu()
    rng = np.random.default_rng(seed)
    tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, 256)))
    lab = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, 256)))
    res = {}
    sr = sr_key is not None
    for dev, params, impl in ((DEVICE, raw, "auto" if fused else "off"),
                              ("cpu", to_cpu(raw), "interpret" if fused else "off")):
        qparams = quant.quantize_params(params, "mixed_precision", stochastic_rounding=sr, **(qkw or {}))
        quant.set_impl(impl)
        flag = os.environ.get("QT_FUSED_ROPE")
        os.environ["QT_FUSED_ROPE"] = "force"
        ops.reset_launch_counts()
        try:
            loss, grads = train.loss_and_grads(cfg, qparams, tok.to(dev), lab.to(dev), sr_key)
        finally:
            quant.set_impl("auto")
            if flag is None:
                del os.environ["QT_FUSED_ROPE"]
            else:
                os.environ["QT_FUSED_ROPE"] = flag
        res[dev] = (loss.item(), [g.double().cpu() for g in tree_leaves(grads)])
        n = ops.launch_counts()
        if dev == DEVICE and qkw:  # the card ran the configuration's GEMM and no int8 kernel
            gemm = "scaled_int4_mm" if qkw["dtype"] == "int4" else "tile_scaled_mm"
            int8 = sum(v for k, v in n.items() if k.startswith(("quantize", "scaled_mm")))
            check(n[gemm] > 0 and int8 == 0 and n["rope_group"] > 0, f"{gemm} launched {n[gemm]} times, int8 {int8}")
        elif dev == DEVICE:  # the card ran the layer asked for
            t = "_sr" if sr else ""
            fused_ran = [n[f"{k}{t}"] for k in ("rmsnorm_quant_rowwise", "silu_mul_bwd_quant_rowwise", "ungroup_quant")]
            check(all((c > 0) == fused for c in fused_ran) and n["rope_group"] > 0,
                  f"B7, B11, B14 launched {fused_ran} times with fused={fused}, B13 {n['rope_group']}")
    rms = [((a - b).norm() / b.norm()).item() for a, b in zip(res[DEVICE][1], res["cpu"][1])]
    dloss = abs(res[DEVICE][0] - res["cpu"][0]) / abs(res["cpu"][0])
    what = ", ".join(f"{k}={v}" for k, v in qkw.items()) if qkw else "int8"
    print(f"[{phase}] 2-layer {name} {what} {str(dtype)[6:]}{' SR' if sr else ''} {'fused' if fused else 'unfused'} "
          "layer grads (256 tokens), "
          "kernels on the card vs plain on the CPU: "
          f"loss {res[DEVICE][0]:.6f} vs {res['cpu'][0]:.6f} (relative {dloss:.2e}); worst leaf relative RMS "
          f"{max(rms):.3e}, per leaf {[f'{r:.1e}' for r in rms]} (bounds {max_rms:g}, loss {max_dloss:g})")
    check(max(rms) <= max_rms and dloss <= max_dloss, f"{dtype} gradients within tolerance of the plain path")


def tile_int8_path() -> dict:
    """The int8 form of B15 on its path: ``ops.scaled_mm`` with int8
    operands and 128 x 128 scale tiles, as ``benchmark_mm.py``'s tile case
    calls the JAX package's kernel (A, B [4096, 4096] int8, fp32 out): one
    launch, bit-exact with the plain version. Returns the launches."""
    n = 4096
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    a, b = (torch.randint(-128, 128, (n, n), generator=gen, device=DEVICE, dtype=torch.int8) for _ in range(2))
    sa, sb = (torch.rand(n // 128, n // 128, generator=gen, device=DEVICE) * 0.01 for _ in range(2))
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    out = ops.scaled_mm(a, b, sa, sb, out_dtype=torch.float32)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    check(launches["tile_scaled_mm_s8"] == launches["tile_scaled_mm_s8_sm90"] == 1 and sum(launches.values()) == 2,
          f"one B15 int8 launch, on the sm90 route: {launches}")
    check(torch.equal(out, ops.tile_scaled_mm_plain(a, b, sa, sb, out_dtype=torch.float32)),
          "the tile-scaled int8 product equals the plain version")
    print(f"[10] ops.scaled_mm int8 [{n}, {n}] x [{n}, {n}] with 128 x 128 scale tiles (benchmark_mm.py's tile case):"
          f" B15 int8 launched once, on the sm90 route, bit-exact with the plain version")
    return launches


# phase 7's bounds for int4 and fp8 tile (fp32): the floor, measured on the
# CPU as grads_vs_plain's docstring describes, with seeds 0 / 1: int4 worst
# leaf 7.0e-2 / 4.2e-1 and loss 0 / 2.4e-5 (one int4 flip moves a value by a
# seventh of its row's maximum), fp8 tile 7.2e-2 / 8.5e-2 and 3.3e-5 /
# 1.7e-4. int4's leaf bound catches an uncorrelated gradient (about 1.4) but
# not a small mis-scale, which its loss bound does.
GRAD_BOUNDS_OTHER = ((dict(dtype="int4"), 9e-1, 1e-3), (dict(dtype="fp8_e4m3", scale="tile"), 1.5e-1, 1e-3))


# the first-step loss of each configuration against phase 6's bf16 one,
# relative: on the CPU at the tests' small Llama (2 layers, hidden 256,
# random bf16 weights from seeds 0-2, a [2, 64] batch) int4 differed by at
# most 1.8e-3, fp8 tile 9.5e-5, fp8 row 7.1e-4 (int8 5.7e-5)
FIRST_LOSS_BOUNDS = {"int4": 2e-2, "fp8 tile": 1e-2, "fp8 row": 1e-2}


def other_dtypes(raw, seed: int, key: int, bf16_first: float, bf16_tps: float) -> dict:
    """Phase 10: int4 and fp8 mixed precision, as ``llm_pretrain.py
    --quantize mixed_precision --quantize_kwargs`` '{"dtype": "int4"}',
    '{"dtype": "fp8_e4m3", "scale": "tile"}' and '{"dtype": "fp8_e4m3"}'
    (row scales) give them: three steps each at phase 6's shapes, optimizer
    and lr, from its weights, batch and key, on the unfused layer (the
    fused ops take int8 only). The losses fall, each first loss is within
    FIRST_LOSS_BOUNDS of phase 6's bf16 one, and each step launches B16
    (int4) or B15's e4m3 form (fp8 tile) 27 times a layer, every launch on
    the sm90 route (7 weights: forward, its remat replay (not down's),
    grad_input,
    grad_weight) and no int8 kernel;
    fp8 row neither. Prints tokens/s of steps 2-3, the ratio to phase 6's
    bf16 tokens/s and peak memory. Returns the launches of the three runs."""
    cfg, tokens, labels = train_cfg_and_batch(seed, (TRAIN_B, TRAIN_S))
    L = cfg.num_hidden_layers
    launches = dict.fromkeys(ops.KERNELS, 0)
    for name, qkw, gemm in (("int4", dict(dtype="int4"), "scaled_int4_mm"),
                            ("fp8 tile", dict(dtype="fp8_e4m3", scale="tile"), "tile_scaled_mm"),
                            ("fp8 row", dict(dtype="fp8_e4m3", scale="row"), None)):
        expect = per_step_launches(L, layer="bf16")
        if gemm is not None:
            expect[gemm] = 27 * L
        if gemm is not None:
            expect[f"{gemm}_sm90"] = 27 * L
        params = quant.quantize_params(raw, "mixed_precision", **qkw)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        losses, walls, counts = run_steps(params, cfg, tokens, labels, optim.adamw(weight_decay=1e-2), 3e-4, key, 3,
                                          expect)
        peak = torch.cuda.max_memory_allocated() / 2**30
        tps = TOKENS * (len(walls) - 1) / sum(walls[1:])
        rel = abs(losses[0] - bf16_first) / abs(bf16_first)
        print(f"[10] {name} mixed_precision (Llama2-1B, B={TRAIN_B} x S={TRAIN_S}, remat, SDPA, adamw lr 3e-4), seed "
              f"{seed}: losses {losses}, step walls {[round(w, 4) for w in walls]} s, tokens/s (steps 2-3) {tps:.1f} "
              f"({tps / bf16_tps:.3f} of phase 6's bf16 {bf16_tps:.1f}); peak device memory {peak:.2f} GiB; first-step "
              f"loss against bf16's: relative {rel:.3e} (bound {FIRST_LOSS_BOUNDS[name]:g}); launches per step "
              f"{ {k: v for k, v in expect.items() if v} }")
        check(losses[2] < losses[0], f"{name} loss falls: {losses}")
        check(rel <= FIRST_LOSS_BOUNDS[name], f"{name} first loss within {FIRST_LOSS_BOUNDS[name]} of bf16's: {rel:.3e}")
        launches = {k: launches[k] + v for k, v in counts.items()}
    return launches


# phase 7's ViT: 2 blocks at a narrow width (hidden 256, 4 heads, mlp 1024),
# 64 x 64 images in 8 x 8 patches (65 tokens), 16 images: 1,040 tokens, which
# the fused linears pad to 1,280 (LayerNorm makes the padded rows b)
VIT_NARROW = vit.ViTConfig(image_size=64, patch_size=8, hidden_size=256, num_layers=2, num_heads=4,
                           num_classes=45, remat=True)


def vit_grads_vs_plain(seed: int, dtype: torch.dtype, max_rms: float, max_dloss: float, sr_key: int | None = None):
    """Phase 7, ViT: the loss and every gradient leaf of ``VIT_NARROW``
    (weights from ``seed``), int8 mixed_precision on the fused blocks:
    ``set_impl('auto')`` on the card (B18, SDPA) against ``'interpret'`` on
    the CPU (B18's plain versions, the einsum attention); with ``sr_key``
    stochastic rounding from that key on both devices. B18's four forms must
    launch on the card. The floor, measured on the CPU (the plain path
    against itself with the images moved by one ulp, seeds 0 and 1): worst
    leaf 1.2e-2 / 7.6e-3 and loss 4.5e-6 / 1.3e-5 apart in fp32, 3.1e-2 /
    3.2e-2 and 2.3e-4 / 2.0e-4 in bf16, 1.4e-2 / 1.5e-2 and 1.1e-5 / 5.2e-5
    in fp32 with SR. The bounds sit above it (1e-1 per leaf in fp32, 1.5e-1
    in bf16, 1e-3 on the loss); a wiring fault gives a relative RMS near 1."""
    torch.backends.cuda.matmul.allow_tf32 = False
    raw = vit.init_params(torch.Generator(device=DEVICE).manual_seed(seed), VIT_NARROW, dtype=dtype)
    to_cpu = lambda t: {k: to_cpu(v) for k, v in t.items()} if isinstance(t, dict) else t.cpu()
    rng = np.random.default_rng(seed)
    imgs = torch.from_numpy(rng.standard_normal((16, 64, 64, 3)).astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, VIT_NARROW.num_classes, 16))
    sr, res = sr_key is not None, {}
    for dev, params, impl in ((DEVICE, raw, "auto"), ("cpu", to_cpu(raw), "interpret")):
        qparams = quant.quantize_params(params, "mixed_precision", stochastic_rounding=sr)
        quant.set_impl(impl)
        ops.reset_launch_counts()
        try:
            loss, grads = train.value_and_grad(
                lambda p: vit.loss_fn(p, imgs.to(dev), labels.to(dev), VIT_NARROW, key=sr_key), qparams)
        finally:
            quant.set_impl("auto")
        res[dev] = (loss.item(), [g.double().cpu() for g in tree_leaves(grads)])
        if dev == DEVICE:
            n, t = ops.launch_counts(), "_sr" if sr else ""
            b18 = [n[f"{k}{t}"] for k in ("layernorm_quant_rowwise", "gelu_quant_rowwise", "layernorm_quant_colwise",
                                          "gelu_quant_colwise")]
            check(all(c > 0 for c in b18), f"B18 launched {b18} times on the card")
    rms = [((a - b).norm() / b.norm()).item() for a, b in zip(res[DEVICE][1], res["cpu"][1])]
    dloss = abs(res[DEVICE][0] - res["cpu"][0]) / abs(res["cpu"][0])
    n_tok = len(labels) * (VIT_NARROW.num_patches + 1)
    print(f"[7] {VIT_NARROW.num_layers}-block ViT (hidden {VIT_NARROW.hidden_size}, {n_tok} tokens padded to "
          f"{-(-n_tok // 256) * 256}) int8 {str(dtype)[6:]}{' SR' if sr else ''} "
          f"fused grads, kernels on the card vs plain on the CPU: loss {res[DEVICE][0]:.6f} vs {res['cpu'][0]:.6f} "
          f"(relative {dloss:.2e}); worst leaf relative RMS {max(rms):.3e}, per leaf {[f'{r:.1e}' for r in rms]} "
          f"(bounds {max_rms:g}, loss {max_dloss:g})")
    check(max(rms) <= max_rms and dloss <= max_dloss, f"ViT {dtype} gradients within tolerance of the plain path")


def vit_per_step_launches(L: int, n_leaves: int, sr: bool = False, layer: str = "fused") -> dict:
    """Kernel launches of one remat ViT train step of L blocks, from the
    code (pinned on the CPU by tests/test_torch_vit.py::
    test_kernel_calls_per_step): per block the forward launches
    B18 LayerNorm-row 2 (qkv, fc1; with the column absmax), GELU-row 1 (fc2),
    K1 5 (the four weights and proj's input, on the row walk), K2 4, and the
    remat replay all of it but fc2's product and its weight's K1 (no
    backward reads the block's output: tests/test_torch_remat.py); the backward
    LayerNorm-column 2 and GELU-column 1 (given the forward's scales), B5 4,
    B4 5 (every one on the cluster form), B1 4, B2 4; each quantize in its
    SR form with ``sr``; every B18 launch on the row walk. Then B6 once
    per parameter leaf. ViT-Giant's patch embedding (588 inputs) and head
    stay bf16. ``layer`` 'bf16': B6 only."""
    t = "_sr" if sr else ""
    counts = dict.fromkeys(ops.KERNELS, 0)
    counts["fused_adamw_update"] = n_leaves
    if layer == "fused":
        b18 = {f"layernorm_quant_rowwise{t}": 4 * L, f"gelu_quant_rowwise{t}": 2 * L,
               f"layernorm_quant_colwise{t}": 2 * L, f"gelu_quant_colwise{t}": L}
        counts.update({**b18, **{f"{k}_sm90": v for k, v in b18.items()},
                       f"quantize_int8_rowwise{t}": 9 * L, f"quantize_int8_rowwise{t}_sm90": 9 * L,
                       "scaled_mm_rhs_t": 7 * L, "scaled_mm_rhs_t_sm90": 7 * L,
                       f"quantize_int8_both{t}": 4 * L, f"quantize_int8_colwise{t}": 5 * L,
                       f"quantize_int8_colwise{t}_sm90": 5 * L, "scaled_mm": 4 * L,
                       "scaled_mm_sm90": 4 * L, "scaled_mm_lhs_t": 4 * L, "scaled_mm_lhs_t_sm90": 4 * L})
    return counts


def vit_giant_step(seed: int, key: int) -> tuple[dict, dict, dict]:
    """Phase 11: ViT-Giant's train step through the port's
    ``_bench_vit_giant`` (its ``measure``: remat, 1000 classes, 224 px,
    weights from seed 0, one batch of normal images, ``adamw_bf16_sr``
    without SR, ``vit_train.make_train_step``'s step) at batch ``VIT_B`` and
    lr ``VIT_LR``: bf16, int8 ``mixed_precision`` on the fused blocks (B18),
    and int8 with ``min_k`` 1536, each a warm step and ``VIT_STEPS`` synced
    and chained, each printing the driver's line; then two int8 steps with
    ``stochastic_rounding`` (B18's SR forms) from the same weights and
    batch. Every step launches exactly ``vit_per_step_launches``, the
    losses are finite and fall, the int8 first loss is within 1e-2 of
    bf16's, the ``min_k`` run's equal to int8's (at ViT-Giant every linear
    has in_features >= 1536) and the SR one within 1e-2 of int8's. Prints
    each run's peak memory. Returns the launches of the int8 and of the SR
    run, and the driver's images/s."""
    cfg = _bench_vit_giant.model_config()
    small = dataclasses.replace(cfg, image_size=28, hidden_size=128, num_layers=1, num_heads=2)  # the tree, not its sizes
    n_leaves = len(tree_leaves(vit.init_params(torch.Generator().manual_seed(0), small)))
    L, runs, rates = cfg.num_layers, {}, {}
    opt = optim.adamw_bf16_sr(bf16_stochastic_rounding=False)
    for name, scheme, min_k, layer in (("bf16", None, 0, "bf16"), ("int8-MP", "mixed_precision", 0, "fused"),
                                       ("int8-MP min_k=1536", "mixed_precision", 1536, "fused")):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        with StepLaunches(vit_per_step_launches(L, n_leaves, layer=layer), module=vit_train,
                          loss_of=lambda out: out[2]) as rec:
            rates[name] = _bench_vit_giant.measure(scheme, min_k, bs=VIT_B, n=VIT_STEPS, device=DEVICE, lr=VIT_LR)
        print(f"vit_giant bs{VIT_B} {name}: {rates[name]:.1f} img/s", flush=True)
        runs[name] = (rec.losses(), rec.total, torch.cuda.max_memory_allocated() / 2**30)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    raw = vit.init_params(torch.Generator(device=DEVICE).manual_seed(0), cfg)
    params = quant.quantize_params(raw, "mixed_precision", stochastic_rounding=True)
    del raw
    images, labels = _bench_vit_giant.batch(cfg, VIT_B, DEVICE)
    state, walls = opt.init(quant.virtual_params(params)), []
    with StepLaunches(vit_per_step_launches(L, n_leaves, sr=True), module=vit_train, loss_of=lambda out: out[2]) as rec:
        step = vit_train.make_train_step(cfg, opt)
        for i in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, state, loss = step(params, state, images, labels, VIT_LR,
                                       _bench_vit_giant.KEY if i == 0 else random.fold_in(_bench_vit_giant.KEY, 0))
            loss.item()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
    del params, state
    runs["int8 SR"] = (rec.losses(), rec.total, torch.cuda.max_memory_allocated() / 2**30)
    print(f"[11] ViT-Giant through _bench_vit_giant.measure ({L} blocks, hidden {cfg.hidden_size}, {cfg.num_classes} "
          f"classes, batch {VIT_B} x {cfg.image_size} px = {VIT_TOKENS} tokens, padded to {VIT_ROWS} in the fused "
          f"linears; remat, SDPA, adamw_bf16_sr without SR, lr {VIT_LR:g}, the driver's {_bench_vit_giant.LR:g} "
          f"lowered so that the losses fall; a warm step, {VIT_STEPS} synced and {VIT_STEPS} chained, the driver's "
          f"{_bench_vit_giant.N_STEPS} cut for time): " + "; ".join(
              f"{k} losses {r[0]}, peak device memory {r[2]:.2f} GiB" for k, r in runs.items())
          + f"; SR step walls {[round(w, 4) for w in walls]} s")
    b18 = {sr: {k: v for k, v in vit_per_step_launches(L, n_leaves, sr=sr).items()
                if k.startswith(("layernorm", "gelu")) and v} for sr in (False, True)}
    print(f"[11] images/s int8/bf16 {rates['int8-MP'] / rates['bf16']:.3f}; B18 launches per int8 step {b18[False]}, "
          f"per SR step {b18[True]} (each counted on the row walk too: every one took it), all launches per int8 "
          f"step { {k: v for k, v in vit_per_step_launches(L, n_leaves).items() if v} }")
    for k, r in runs.items():
        check(all(np.isfinite(r[0])), f"{k}: finite ViT losses {r[0]}")
        check(k == "int8 SR" or r[0][-1] < r[0][0], f"{k} ViT loss falls: {r[0]}")
    first = {k: r[0][0] for k, r in runs.items()}
    rel = abs(first["int8-MP"] - first["bf16"]) / abs(first["bf16"])
    rel_sr = abs(first["int8 SR"] - first["int8-MP"]) / abs(first["int8-MP"])
    rel_k = abs(first["int8-MP min_k=1536"] - first["int8-MP"]) / abs(first["int8-MP"])
    print(f"[11] first-step loss int8 vs bf16: relative {rel:.3e} (bound 1e-2); SR vs int8: {rel_sr:.3e} (bound "
          f"1e-2); min_k=1536 vs int8: relative {rel_k:.3e} (bound 1e-6: the same linears quantized, the same forward)")
    check(rel <= 1e-2 and rel_sr <= 1e-2, f"ViT first losses within 1e-2: {rel:.3e}, {rel_sr:.3e}")
    check(rel_k <= 1e-6, f"min_k=1536 quantizes every linear that int8 quantizes: {rel_k:.3e}")
    return runs["int8-MP"][1], runs["int8 SR"][1], rates


REMAT_LAYERS = 4  # phase 19: Llama2-1B's width, cut to 4 layers
REMAT_VIT_BLOCKS = 3  # and ViT-Giant's, cut to 3 blocks
REMAT_KNOBS = (("the policy", False, False), ("QT_SAVE_POSTATTN=1", True, False),
               ("save_qkv_residuals", False, True), ("both", True, True))


def memory_baseline() -> int:
    """Garbage collected, the cache emptied and the peak reset: the bytes
    live now, from which a run's peak is counted."""
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated()


def remat_phase(raw, seed: int, key: int) -> dict:
    """Phase 19: the remat policy against remat off, bit for bit, under
    deterministic algorithms (the module's docstring); returns the
    policy's launches."""
    t0 = time.perf_counter()
    cfg, tokens, labels = train_cfg_and_batch(seed, (TRAIN_B, TRAIN_S))
    L = REMAT_LAYERS
    params = quant.quantize_params({**raw, "layers": map_tensors(lambda t: t[:L], raw["layers"])}, "mixed_precision")
    deterministic, post = torch.are_deterministic_algorithms_enabled(), os.environ.get("QT_SAVE_POSTATTN")
    runs, ref, launches = {}, {}, dict.fromkeys(ops.KERNELS, 0)

    def run(name, loss_of, remat_on, reference: str, whole=False):
        """(loss, launches, peak GiB above what was live, bit-identical to
        ``reference``'s run); the grads kept only for a reference."""
        base = memory_baseline()
        ops.reset_launch_counts()
        with whole_layer_checkpoint() if whole else contextlib.nullcontext():
            loss, grads = loss_of(remat_on)
        torch.cuda.synchronize()
        grads, peak = tree_leaves(grads), (torch.cuda.max_memory_allocated() - base) / 2**30
        if name == reference:
            ref[name] = (loss, grads)
        same = torch.equal(loss, ref[reference][0]) and all(torch.equal(a, b) for a, b in zip(grads, ref[reference][1]))
        runs[name] = (loss, ops.launch_counts(), peak, same, ops.sdpa_forwards())
        check(same, f"[19] {name}: loss and grads bit-identical to {reference}'s")

    torch.use_deterministic_algorithms(True)
    try:
        for name, post_attn, save_qkv in (("remat off", False, False), ("whole-layer checkpoint", False, False),
                                          *REMAT_KNOBS):
            os.environ["QT_SAVE_POSTATTN"] = "1" if post_attn else "0"
            c = dataclasses.replace(cfg, num_hidden_layers=L, save_qkv_residuals=save_qkv)
            run(name, lambda r: train.loss_and_grads(dataclasses.replace(c, remat=r), params, tokens, labels, key),
                name != "remat off", "remat off", whole=name == "whole-layer checkpoint")
            sdpa = sdpa_per_layer() * L * (2 if name == "whole-layer checkpoint" else 1)
            check(runs[name][4] == sdpa, f"[19] {name}: SDPA forwards {runs[name][4]} == {sdpa}")
            if name in {k for k, *_ in REMAT_KNOBS}:
                expect = per_step_launches(L, post_attn=post_attn, save_qkv=save_qkv)
                check(runs[name][1] == expect, f"[19] {name}: launches {runs[name][1]} == {expect}")
                launches = {k: launches[k] + v for k, v in runs[name][1].items()}
        vcfg = dataclasses.replace(VIT_CFG, num_layers=REMAT_VIT_BLOCKS)
        vraw = vit.init_params(torch.Generator(device=DEVICE).manual_seed(seed), vcfg)
        ds = SyntheticImageDataset(size=vcfg.image_size, num_classes=vcfg.num_classes, seed=VIT_SEED)
        images, vlabels = (torch.from_numpy(a).to(DEVICE) for a in next(iter(BatchLoader(ds, VIT_B, prefetch=0))))
        vparams = quant.quantize_params(vraw, "mixed_precision")
        vkey = random.fold_in(key, 19)
        ref.clear()
        for name in ("ViT remat off", "ViT remat"):
            run(name, lambda r: train.value_and_grad(
                lambda p: vit.loss_fn(p, images, vlabels, dataclasses.replace(vcfg, remat=r), vkey), vparams),
                name == "ViT remat", "ViT remat off")
        expect = vit_per_step_launches(REMAT_VIT_BLOCKS, 0)
        check(runs["ViT remat"][1] == expect, f"[19] ViT-Giant remat launches {runs['ViT remat'][1]} == {expect}")
        launches = {k: launches[k] + v for k, v in runs["ViT remat"][1].items()}
    finally:
        torch.use_deterministic_algorithms(deterministic)
        if post is None:
            os.environ.pop("QT_SAVE_POSTATTN", None)
        else:
            os.environ["QT_SAVE_POSTATTN"] = post
    base = runs["remat off"][1]
    for name, r in runs.items():
        counts = {k: v for k, v in r[1].items() if v}
        print(f"[19] {name}: loss {r[0].item():.6f} (loss and grads bit-identical to the run without remat: {r[3]}),"
              f" peak device memory above what was live before it {r[2]:.3f} GiB; SDPA forwards {r[4]}; launches"
              f" {counts}")
    for name in ("whole-layer checkpoint", *(k for k, *_ in REMAT_KNOBS)):
        replay = {k: v - base[k] for k, v in runs[name][1].items() if v != base[k]}
        print(f"[19] {name}: the replay's launches over {L} layers (beside remat off) {replay}")
    print(f"[19] Llama2-1B width, {L} layers (depth cut for time), tokens [{TRAIN_B}, {TRAIN_S}], deterministic "
          f"algorithms; ViT-Giant width, {REMAT_VIT_BLOCKS} blocks, batch {VIT_B}: {time.perf_counter() - t0:.1f} s")
    return launches


def benchmark_mm_phase() -> dict:
    """Phase 12: ``benchmark_mm``'s ``main`` at 1024/2048/4096 with every
    gate (B1, B15-s8, B17 bf16 and int8), its table, then its training
    shapes; returns the launches of the run."""
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    rows = benchmark_mm.main(["--sizes", "1024", "2048", "4096"])
    benchmark_mm.main(["--train-shapes"])
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    check(launches["matmul_sm90"] == launches["matmul"] > 0 and launches["matmul_s8_sm90"] == launches["matmul_s8"] > 0,
          f"every B17 launch, bf16 and int8, on the sm90 route: {launches}")
    check(launches["scaled_mm_sm90"] == launches["scaled_mm"] and
          launches["tile_scaled_mm_s8_sm90"] == launches["tile_scaled_mm_s8"] > 0,
          f"every B1 and B15-s8 launch on the sm90 route: {launches}")
    print(f"[12] benchmark_mm at {list(rows)}: every gate passed, {time.perf_counter() - t0:.1f} s; B17 launches "
          f"bf16 {launches['matmul']} (sm90 {launches['matmul_sm90']}), int8 {launches['matmul_s8']} (sm90 "
          f"{launches['matmul_s8_sm90']}); B1 "
          f"{launches['scaled_mm']} (sm90 {launches['scaled_mm_sm90']}), B15-s8 {launches['tile_scaled_mm_s8']} "
          f"(sm90 {launches['tile_scaled_mm_s8_sm90']})")
    return launches


def int8_attention_phase(seed: int) -> dict:
    """Phase 13: B19 as the JAX package's op runs it, at Llama2-1B's
    attention (``ATTN_LEAD`` instances, G 8, S 2048, hd 64, block_kv 512):
    the oracle checks of its test (mean relative error below 0.05 against the
    bf16 oracle, lse within 1e-4 of the explicit logsumexp of the quantized
    scores) and causality (k and v changed from row 3 S / 4 on leave every
    earlier row of out and lse bit-identical); both launches on the sm90
    design. Returns the launches."""
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    q, k, v = attention_inputs(gen)
    q, k = q * 0.5, k * 0.5  # the JAX test's scales
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    qi, qs, ki, ks, vi, vs = ops.quantize_qkv(q, k, v)
    out, lse = ops.int8_flash_fwd(qi, qs, ki, ks, vi, vs)
    S = q.shape[-2]
    cut = 3 * S // 4
    k2, v2 = k.clone(), v.clone()
    k2[..., cut:, :] = torch.randn(k2[..., cut:, :].shape, generator=gen, device=DEVICE).to(torch.bfloat16)
    v2[..., cut:, :] = torch.randn(v2[..., cut:, :].shape, generator=gen, device=DEVICE).to(torch.bfloat16)
    out2, lse2 = ops.int8_flash_fwd(*ops.quantize_qkv(q, k2, v2))
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    check(launches["int8_flash_fwd"] == launches["int8_flash_fwd_sm90"] == 2 and sum(launches.values()) == 4,
          f"two B19 launches, both on the sm90 design: {launches}")
    check(bool(torch.isfinite(out.float()).all() and torch.isfinite(lse).all()), "B19's out and lse are finite")
    ref = ops.attention_ref(q, k, v).float()
    rel = ((out.float() - ref).abs().mean() / ref.abs().mean()).item()
    check(rel < 0.05, f"B19 mean relative error {rel:.3e} below 0.05")
    s = (qi.float() * qs) @ (ki.float() * ks.unsqueeze(-1)).unsqueeze(-3).transpose(-1, -2)
    s = s.masked_fill(~torch.ones(S, S, dtype=torch.bool, device=DEVICE).tril(), float("-inf"))
    lse_err = (lse[..., 0] - torch.logsumexp(s, dim=-1)).abs()
    lse_ref = torch.logsumexp(s, dim=-1).abs()
    check(bool((lse_err <= 1e-4 + 1e-4 * lse_ref).all()), f"B19 lse within 1e-4 ({lse_err.max().item():.3e})")
    causal = torch.equal(out[..., :cut, :], out2[..., :cut, :]) and torch.equal(lse[..., :cut, :], lse2[..., :cut, :])
    check(causal and not torch.equal(out[..., cut:, :], out2[..., cut:, :]),
          f"B19's rows before {cut} bit-identical when k and v change from {cut} on")
    print(f"[13] int8_flash_fwd at {list(q.shape)} (Llama2-1B attention, bench.py's micro-batch), block_kv 512: "
          f"mean relative error against the bf16 oracle {rel:.3e} (bound 0.05); lse max error "
          f"{lse_err.max().item():.3e} (bound 1e-4 + 1e-4 |lse|); rows before {cut} bit-identical under changed "
          f"future k and v; launches {launches['int8_flash_fwd']} (sm90 design {launches['int8_flash_fwd_sm90']})")
    return launches


# phase 14's training runs: (name, scheme, its kwargs, cfg.bitnet, steps);
# int8 storage takes its kernels' activations (Int8QTConfig's default is
# weight-only, a bf16 matmul)
STORAGE_RUNS = (("int8 storage", "int8_quantized_training", dict(activation="int8"), False, 3),
                ("int8 storage SR", "int8_quantized_training", dict(activation="int8_sr"), False, 1),
                ("int4 weight-only", "int4_weight_only", {}, False, 3),
                ("BitNet", "bitnet", {}, True, 3))
# the stacked [O, I] of the 7 linears of a layer, in their leaves' order
STACKED = ((D, D), (KVD, D), (KVD, D), (D, D), (F, D), (F, D), (D, F))
# phase 14's 2-layer cuts (card against CPU), fp32: the bounds of phase 7's
# int8 fp32 cut. Their floor on the CPU (the plain path against itself with
# the embedding moved one ulp, the tests' small Llama, 2 layers, hidden 256,
# 256 tokens, remat, the grouped pipeline, seeds 0 / 1): int8 storage worst
# leaf 9.0e-3 / 5.4e-3, loss 2.0e-5 / 5.3e-7; BitNet 7.4e-3 / 3.8e-3 and
# 2.4e-5 / 9.7e-6
STORAGE_GRAD_BOUNDS = (("int8_quantized_training", dict(activation="int8"), False, 1.5e-1, 1e-3),
                       ("bitnet", {}, True, 1.5e-1, 1e-3))


def storage_per_step(scheme: str, L: int, n_leaves: int, sr: bool = False) -> dict:
    """Kernel launches of one phase-14 train step of L layers (pinned on the
    CPU by tests/test_torch_train.py::test_kernel_calls_per_step_storage),
    with the routes ``ops/int8_quant.py::rowwise_sm90_route`` gives: the
    bf16 layer's B13 (rope_group 7, rope_ungroup 5 a layer) and B6 once a
    master leaf; int8 storage and BitNet quantize each of the 7 linears'
    inputs with K1 (q, k and v apart) and run K2 7 times a forward (every
    one on sm90), and in the remat replay 6 (not down's; K1 on down's input
    only for BitNet, whose node keeps it), and no int8 backward kernel;
    int8 storage's commit re-quantizes the 7 stacked weights with K1-SR."""
    counts = per_step_launches(L, b6=n_leaves, layer="bf16")
    walk = lambda M, K, sr: int(bool(IQ.rowwise_sm90_route(M, K, torch.bfloat16, sr)))
    if scheme != "int4_weight_only":
        t = "_sr" if sr else ""
        # the remat replay: no down product; BitNet's down quantizes its input
        # all the same (its node keeps the int8), int8 storage's does not
        inputs = [walk(TOKENS, i, sr) for _, i in STACKED]
        kept = 7 if scheme == "bitnet" else 6
        counts[f"quantize_int8_rowwise{t}"] += (7 + kept) * L
        counts[f"quantize_int8_rowwise{t}_sm90"] += L * (sum(inputs) + sum(inputs[:kept]))
        counts["scaled_mm_rhs_t"] = counts["scaled_mm_rhs_t_sm90"] = 13 * L
    if scheme == "int8_quantized_training":
        counts["quantize_int8_rowwise_sr"] += len(STACKED)
        counts["quantize_int8_rowwise_sr_sm90"] += sum(walk(L * o, i, True) for o, i in STACKED)
    return counts


def with_bitnet_norms(raw, cfg):
    """``raw`` with the o and down norms ``bitnet=True`` adds (ones)."""
    L, H = cfg.num_hidden_layers, cfg.num_attention_heads * cfg.head_dim
    ones = lambda *shape: torch.ones(shape, dtype=raw["final_norm"]["g"].dtype, device=raw["final_norm"]["g"].device)
    return {**raw, "layers": {**raw["layers"], "o_norm": {"g": ones(L, H)},
                              "down_norm": {"g": ones(L, cfg.intermediate_size)}}}


def on_grid_neighbours(master: torch.Tensor, stored) -> tuple[bool, int]:
    """Whether every stored value is one SR can give its master value: at
    least floor(q) and at most floor(q + (1 - 2^-24)), the largest uniform
    added in fp32, within the format's range, where q is master / (row
    absmax / 127) for int8, (master - min) / ((max - min) / 15) in each group
    for int4, in fp32 as the quantizes compute it. Also returns how many
    values are ceil(q) + 1: a q within half an fp32 ulp below an integer
    (a master still on the grid it was dequantized from) can round up
    there in the addition, in the JAX package's formula as in the port's."""
    if isinstance(stored, quant.Int8Weight):
        scale = master.abs().amax(-1, keepdim=True).float() / torch.full((), 127.0, device=master.device)
        q, v, top = master.float() / scale.clamp(min=IQ.EPS), stored.int_data.float(), 127.0
    else:
        xf = master.float().reshape(-1, stored.group_size)
        zp = xf.amin(-1, keepdim=True)
        scale = (xf.amax(-1, keepdim=True) - zp) / torch.full((), 15.0, device=master.device)
        q, top = (xf - zp) / scale.clamp(min=1e-12), 15.0
        p = stored.packed.reshape(-1, stored.group_size // 2)
        v = torch.stack([p >> 4, p & 0xF], -1).reshape(q.shape).float()
    hi = torch.floor(q + torch.full((), 1 - 2**-24, device=master.device)).clamp(max=top)
    return bool(((v >= q.floor()) & (v <= hi)).all()), int((v > q.ceil()).sum())


def storage_training(raw, seed: int, key: int) -> dict:
    """Phase 14 (a): the storage schemes' train steps, Llama2-1B at full
    width and depth, batch 4 x 2048, remat, SDPA on the grouped pipeline,
    adamw_bf16_sr without the SR writeback, lr 1e-4, phase 6's weights,
    batch and key (``STORAGE_RUNS``): finite losses that fall, each step's
    launches exactly ``storage_per_step``, and after each commit the stored
    q leaf in its format with every value one that SR can give its master
    (``on_grid_neighbours``); tokens/s of steps 2-3 and peak memory. Returns the launches."""
    cfg, tokens, labels = train_cfg_and_batch(seed, (TRAIN_B, TRAIN_S))
    L = cfg.num_hidden_layers
    launches = dict.fromkeys(ops.KERNELS, 0)
    commit = train.commit_params
    for name, scheme, kw, bitnet, n_steps in STORAGE_RUNS:
        scfg = dataclasses.replace(cfg, bitnet=bitnet)
        params = quant.quantize_params(with_bitnet_norms(raw, cfg) if bitnet else raw, scheme, **kw)
        n_leaves = len(tree_leaves(quant.virtual_params(params)))
        expect = storage_per_step(scheme, L, n_leaves, sr=kw.get("activation") == "int8_sr")
        commits, rounded_up = [], []

        def recording(new_v, q, k):
            out = commit(new_v, q, k)
            master = new_v["layers"]["q"]["w"]  # a copy: a donating step's next replay refills it
            master = master.clone() if isinstance(master, torch.Tensor) else master.map_tensors(torch.clone)
            commits.append((master, out["layers"]["q"]["w"]))
            return out

        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        train.commit_params = recording
        try:
            losses, walls, counts = run_steps(params, scfg, tokens, labels,
                                              optim.adamw_bf16_sr(bf16_stochastic_rounding=False), 1e-4, key,
                                              n_steps, expect, jit_compile=train.capture_refusal(params) is None)
        finally:
            train.commit_params = commit
        peak = torch.cuda.max_memory_allocated() / 2**30
        stored = type(params["layers"]["q"]["w"])
        for master, new in commits:
            check(type(new) is stored, f"{name}: the committed q leaf is a {stored.__name__}")
            if scheme != "bitnet":
                check((new.int_data if scheme.startswith("int8") else new.packed).dtype
                      == (torch.int8 if scheme.startswith("int8") else torch.uint8), f"{name}: storage dtype")
                on_grid, ties = on_grid_neighbours(master, new)
                check(on_grid, f"{name}: every stored q value one SR can give its master")
                rounded_up.append(ties)
        tps = (f"{TOKENS * (len(walls) - 1) / sum(walls[1:]):.1f} (steps 2-{len(walls)})" if len(walls) > 1
               else f"{TOKENS / walls[0]:.1f} (one step, with its warm-up)")
        print(f"[14] {name} ({scheme} {kw or ''}, Llama2-1B{' bitnet' if bitnet else ''}, B={TRAIN_B} x "
              f"S={TRAIN_S}, remat, SDPA, adamw_bf16_sr without SR, lr 1e-4), seed {seed}: losses {losses}, step "
              f"walls {[round(w, 4) for w in walls]} s, tokens/s {tps}; peak device memory {peak:.2f} GiB; "
              f"{len(commits)} commits checked (q values at ceil + 1 by the fp32 add: {rounded_up}); launches per "
              f"step { {k: v for k, v in expect.items() if v} }")
        if n_steps > 1:
            check(losses[-1] < losses[0], f"{name}: losses fall: {losses}")
        launches = {k: launches[k] + v for k, v in counts.items()}
        del params, commits
    return launches


def storage_grads_vs_plain(seed: int, scheme: str, kw: dict, bitnet: bool, max_rms: float, max_dloss: float):
    """Phase 14 (b): the loss and every master gradient of a 2-layer cut of
    Llama2-1B (full width, fp32 weights from ``seed``, remat), one
    micro-step on 256 tokens on the grouped pipeline, the kernels on the card
    against the plain versions on the CPU, each device quantizing the same
    weights (int8 storage is bit-exact); the card launches K1 and K2 and no
    int8 backward kernel. Bounds: ``STORAGE_GRAD_BOUNDS``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(CFG, num_hidden_layers=2, remat=True, bitnet=bitnet)
    raw = llama.init_params(torch.Generator(device=DEVICE).manual_seed(seed), cfg, dtype=torch.float32)
    to_cpu = lambda t: {k: to_cpu(v) for k, v in t.items()} if isinstance(t, dict) else t.cpu()
    rng = np.random.default_rng(seed)
    tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, 256)))
    lab = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, 256)))
    res = {}
    flag = os.environ.get("QT_FUSED_ROPE")
    os.environ["QT_FUSED_ROPE"] = "force"
    try:
        for dev, params in ((DEVICE, raw), ("cpu", to_cpu(raw))):
            ops.reset_launch_counts()
            loss, grads = train.loss_and_grads(cfg, quant.quantize_params(params, scheme, **kw), tok.to(dev),
                                               lab.to(dev), 3)
            res[dev] = (loss.item(), [g.double().cpu() for g in tree_leaves(grads)])
            if dev == DEVICE:
                n = ops.launch_counts()
                backward = sum(n[k] for k in ("scaled_mm", "scaled_mm_lhs_t", "quantize_int8_colwise",
                                              "quantize_int8_both"))
                check(n["quantize_int8_rowwise"] > 0 and n["scaled_mm_rhs_t"] > 0 and backward == 0,
                      f"{scheme}: K1 {n['quantize_int8_rowwise']}, K2 {n['scaled_mm_rhs_t']}, int8 backward {backward}")
    finally:
        if flag is None:
            del os.environ["QT_FUSED_ROPE"]
        else:
            os.environ["QT_FUSED_ROPE"] = flag
    rms = [((a - b).norm() / b.norm()).item() for a, b in zip(res[DEVICE][1], res["cpu"][1])]
    dloss = abs(res[DEVICE][0] - res["cpu"][0]) / abs(res["cpu"][0])
    print(f"[14] 2-layer Llama2-1B {scheme} {kw or ''} fp32 master grads (256 tokens), kernels on the card vs plain on "
          f"the CPU: loss {res[DEVICE][0]:.6f} vs {res['cpu'][0]:.6f} (relative {dloss:.2e}); worst leaf relative "
          f"RMS {max(rms):.3e}, per leaf {[f'{r:.1e}' for r in rms]} (bounds {max_rms:g}, loss {max_dloss:g})")
    check(max(rms) <= max_rms and dloss <= max_dloss, f"{scheme} gradients within tolerance of the plain path")


def storage_serving(raw) -> dict:
    """Phase 14 (c): the server over int8 storage (int8 activations) and
    over packed BitNet (every BitNetWeight packed, as
    tests/test_inference.py packs them), 8 requests of phase 4's mixed load
    each (``serve_params``). Returns the launches of both runs."""
    reqs = mixed_requests(CFG.vocab_size)[:8]
    params = quant.quantize_params(raw, "int8_quantized_training", activation="int8")
    launches = serve_params(14, "int8 storage (activation int8)", params, CFG, reqs, warm=False)
    del params
    cfg = dataclasses.replace(CFG, bitnet=True)
    bit = quant.quantize_params(with_bitnet_norms(raw, CFG), "bitnet")
    bit["layers"] = {k: {n: quant.BitNetPackedWeight.from_weight(w.data) if isinstance(w, quant.BitNetWeight) else w
                         for n, w in v.items()} for k, v in bit["layers"].items()}
    more = serve_params(14, "BitNet packed", bit, cfg, reqs, warm=False)
    return {k: launches[k] + more[k] for k in launches}


def storage_schemes(raw, seed: int, key: int) -> dict:
    """Phase 14: the storage schemes (a) training, (b) card against CPU, (c)
    serving; prints its seconds. Returns the launches of (a) and (c)."""
    t0 = time.perf_counter()
    launches = storage_training(raw, seed, key)
    for scheme, kw, bitnet, max_rms, max_dloss in STORAGE_GRAD_BOUNDS:
        storage_grads_vs_plain(SEED, scheme, kw, bitnet, max_rms, max_dloss)
    served = storage_serving(raw)
    print(f"[14] storage schemes: {time.perf_counter() - t0:.1f} s")
    return {k: launches[k] + served[k] for k in launches}


# phase 15: the LLM drivers at Llama-2-470m (mini_llamas, full width and
# depth: hidden 1024, FFN 4096, 16 heads of 16 kv heads, so the grouped
# pipeline runs at G = 1), llm_pretrain.py's batch; runs under runs/ and
# shards under build/, both ignored by git
PRETRAIN_MODEL = "mini_llamas/Llama-2-470m"
PRETRAIN_SAVE = os.path.join("runs", "chip_smoke")
PRETRAIN_SHARDS = os.path.join("build", "chip_smoke_shards")
# the resumed run's losses against the uninterrupted run's: the bound of
# tests/test_resume.py for the JAX driver (the card's SDPA backward need not
# be deterministic, so the runs are not held bit for bit)
RESUME_BOUND = 5e-3


def device_args() -> list[str]:
    """The drivers run on the card; a rehearsal on the CPU sets DEVICE."""
    return ["--cpu"] if DEVICE == "cpu" else []


def pretrain_per_step_launches(cfg: llama.LlamaConfig, tokens: int) -> dict:
    """Kernel launches of one int8 train step of ``cfg`` on the fused layer
    with remat (its replay under the policy) and no SR
    (``per_step_launches``), each route's counter from
    the route at ``cfg``'s shapes: K1 and B4 at the 7 weights [O, I] (the
    row walk, the cluster form), K2 at ``tokens`` rows, B1 at each
    grad_input (N = I, K = O), B2 at each grad_weight (M = O, N = I, K =
    ``tokens``), B7, B8 and B10 at the hidden width, B9, B11 and B12 at the
    FFN width, B14 at the attention width H * hd."""
    L, D, F = cfg.num_hidden_layers, cfg.hidden_size, cfg.intermediate_size
    H, KV = cfg.num_attention_heads * cfg.head_dim, cfg.num_key_value_heads * cfg.head_dim
    weights = ((H, D), (KV, D), (KV, D), (D, H), (F, D), (F, D), (D, F))
    on = lambda route: int(bool(route))
    bf = torch.bfloat16
    counts = per_step_launches(L)
    rows = [on(IQ.rowwise_sm90_route(o, i, bf)) for o, i in weights]
    counts.update({
        # the forward's 7 weights, the remat replay's 6 (not down's)
        "quantize_int8_rowwise_sm90": L * (sum(rows) + sum(rows[:6])),
        "quantize_int8_colwise_sm90": L * sum(on(IQ.colwise_sm90_route(o, i, bf)) for o, i in weights),
        "scaled_mm_rhs_t_sm90": L * 13 * on(SCALED_MM.sm90_route(tokens)),
        "scaled_mm_sm90": L * sum(on(SCALED_MM.rhs_mn_sm90_route(i, o)) for o, i in weights),
        "scaled_mm_lhs_t_sm90": L * sum(on(SCALED_MM.lhs_t_sm90_route(o, i, tokens)) for o, i in weights),
        "rmsnorm_quant_rowwise_sm90": 4 * L * on(FP.norm_rows_sm90_route(D, bf)),
        "rmsnorm_quant_colwise_sm90": 2 * L * on(FP.norm_cols_sm90_route(D, bf)),
        "rmsnorm_bwd_sm90": 2 * L * on(FP.rmsnorm_bwd_sm90_route(D, bf)),
        "silu_mul_quant_rowwise_sm90": L * on(FP.silu_rows_sm90_route(F, bf)),
        "silu_mul_quant_colwise_sm90": L * on(FP.silu_cols_sm90_route(F, bf)),
        "silu_mul_bwd_quant_rowwise_sm90": L * on(FP.silu_bwd_rows_sm90_route(F, bf)),
        "silu_mul_bwd_quant_colwise_sm90": L * on(FP.silu_bwd_cols_sm90_route(F, bf)),
        "ungroup_amax_sm90": 2 * L * on(ROPE.ungroup_sm90_route(H, cfg.head_dim, bf)),
        "ungroup_quant_sm90": 3 * L * on(ROPE.ungroup_sm90_route(H, cfg.head_dim, bf)),
    })
    return counts


class StepLaunches:
    """While it is entered, every train step a driver builds through
    ``module.make_train_step`` (``train``'s, or ``vit_train``'s) checks its
    launches against ``expect`` (a dict, or a function of the step's
    arguments that gives one; None: not checked) and, with ``sdpa``, SDPA's
    forwards against it, and adds them to ``total``; ``before``, where
    given, sees each step's arguments (state, tokens, labels, lr, key)
    before the step runs. ``runs`` keeps, for each step built, each of its
    steps' launches and loss (``loss_of`` the step's output; a tensor, read
    after the run so that no step waits for it)."""

    def __init__(self, expect: dict | None, before=None, module=train, loss_of=lambda out: out[1]["loss"],
                 sdpa: int | None = None):
        self.expect, self.before, self.module, self.loss_of, self.sdpa = expect, before, module, loss_of, sdpa
        self.steps, self.runs = 0, []
        self.total = dict.fromkeys(ops.KERNELS, 0)

    def __enter__(self):
        self.make = self.module.make_train_step

        def make(*args, **kwargs):
            step = self.make(*args, **kwargs)
            run = {"launches": [], "losses": []}
            self.runs.append(run)

            def counted(*step_args):
                if self.before is not None:
                    self.before(*step_args)
                ops.reset_launch_counts()
                out = step(*step_args)
                counts = ops.launch_counts()
                self.steps += 1
                want = self.expect(*step_args) if callable(self.expect) else self.expect
                check(want is None or counts == want, f"driver step {self.steps} launches {counts} == {want}")
                check(self.sdpa is None or ops.sdpa_forwards() == self.sdpa,
                      f"driver step {self.steps}: SDPA forwards {ops.sdpa_forwards()} == {self.sdpa}")
                self.total = {k: self.total[k] + v for k, v in counts.items()}
                run["launches"].append(counts)
                run["losses"].append(self.loss_of(out).detach())
                return out

            return counted

        self.module.make_train_step = make
        return self

    def __exit__(self, *exc):
        self.module.make_train_step = self.make

    def losses(self, i: int = -1) -> list:
        """The losses of the ``i``-th step built, as floats."""
        return [l.item() for l in self.runs[i]["losses"]]


def run_driver(main, argv: list[str]):
    """``main(argv)`` of a driver; returns (its result, wall seconds)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = main(argv)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def pretrain_report(name: str, out: dict, seconds: float, phase: int = 15) -> dict:
    """One driver run's line: losses by step, tokens/s of each step after
    the run's first (the driver's, after a sync), its peak device memory,
    the wait for the first batch and the run's seconds."""
    rows = [json.loads(l) for l in open(os.path.join(out["save_dir"], "metrics.jsonl"))]
    losses = {r["step"]: r["loss"] for r in rows}
    tps = [r["tokens_per_second"] for r in rows[1:]]
    print(f"[{phase}] {name}: losses {losses}; tokens/s after the first step {[round(t, 1) for t in tps]} "
          f"(median {float(np.median(tps)) if tps else float('nan'):.1f}); peak device memory "
          f"{rows[-1]['peak_memory_gb']:.2f} GB; first batch after {out['first_batch_s']:.2f} s; {seconds:.1f} s",
          flush=True)
    check(all(np.isfinite(v) for v in losses.values()), f"{name}: finite losses")
    return losses


def state_leaves(obj) -> list:
    """The leaves of a train state, in a fixed order: through its tuples
    (the ``NamedTuple`` states), dicts and weight wrappers (8-bit states
    too)."""
    if isinstance(obj, (list, tuple)):
        return [leaf for x in obj for leaf in state_leaves(x)]
    return [leaf for x in tree_leaves(obj) for leaf in (state_leaves(x) if isinstance(x, (list, tuple)) else [x])]


def same_leaves(a, b) -> bool:
    """Two trees' leaves equal bit for bit: tensors of one dtype and
    shape, other leaves by ``==``."""
    la, lb = state_leaves(a), state_leaves(b)
    return len(la) == len(lb) and all(
        type(x) is type(y) and (x.dtype == y.dtype and torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y)
        for x, y in zip(la, lb))


def pretrain_resume(seed: int, vocab: int, expect: dict) -> tuple[dict, dict, dict, object]:
    """Phase 15 (a): ``llm_pretrain`` at Llama-2-470m through
    ``from_hf_json`` (24 layers), int8 ``mixed_precision`` on the fused
    layer, remat, batch 4 x 2048 of Markov tokens, ``adamw``: 4 steps
    uninterrupted; 2 steps with a checkpoint, then ``--resume`` to 4. The
    resumed run's first step enters with the interrupted run's final
    state bit for bit (parameters and optimizer state, through the
    checkpoint), and the resumed run's batches and step keys are the
    uninterrupted run's third and fourth, bit for bit (the loader's
    position); its losses at steps 3 and 4 within ``RESUME_BOUND`` of the
    uninterrupted ones (the card's backward is not deterministic); every
    step's launches exactly ``expect``. Returns the launches, the runs'
    directories, the uninterrupted run's losses and the resumed run's final
    parameters."""
    common = ["--model", PRETRAIN_MODEL, "--quantize", "mixed_precision", "--activation_checkpointing",
              "--batch_size", str(TRAIN_B), "--seq_len", str(TRAIN_S), "--log_interval", "1", "--seed", str(seed),
              "--train_ds", json.dumps({"type": "markov", "vocab_size": vocab}), "--save_dir", PRETRAIN_SAVE,
              *device_args()]
    runs, inputs, saved, entered = {}, {}, {}, []

    def before(state, tokens, labels, lr, key):
        inputs[name].append((tokens.cpu(), labels.cpu(), lr, key))
        if name == "part2" and len(inputs[name]) == 1:  # the state the resume loaded
            entered.append(same_leaves(state, saved.pop("state")))

    with StepLaunches(expect, before) as counter:
        for name, extra in (("full", ["--n_steps", "4"]), ("part1", ["--n_steps", "2", "--ckpt_interval", "2"]),
                            ("part2", ["--n_steps", "4", "--ckpt_interval", "2", "--resume", None])):
            if name == "part2":
                extra[-1] = os.path.join(runs["part1"][0], "last.pkl")
            inputs[name] = []
            out, seconds = run_driver(llm_pretrain.main, [*common, *extra, "--run_name", name])
            runs[name] = (str(out["save_dir"]), pretrain_report(f"llm_pretrain {name}", out, seconds))
            if name == "part1":
                saved["state"] = out["state"]
            final = out["state"].params if name == "part2" else None
            del out
            torch.cuda.empty_cache()
    full, part1, part2 = (runs[k][1] for k in ("full", "part1", "part2"))
    check(counter.steps == 8, f"8 driver steps ran: {counter.steps}")
    same = lambda a, b: all(torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y for x, y in zip(a, b))
    batches = (len(inputs["part2"]) == 2 and all(same(a, b) for a, b in zip(inputs["part1"], inputs["full"][:2]))
               and all(same(a, b) for a, b in zip(inputs["part2"], inputs["full"][2:])))
    print(f"[15] resume: the resumed run entered with the interrupted run's final state bit for bit: {entered}; its "
          f"batches, lrs and step keys are the uninterrupted run's third and fourth: {batches}")
    check(entered == [True], "the resumed run loads the interrupted run's final state bit for bit")
    check(batches, "the resumed run's batches and keys are the uninterrupted run's third and fourth")
    check(max(abs(part1[s] - full[s]) for s in (1, 2)) <= RESUME_BOUND,
          f"the interrupted run's steps 1-2 {part1} agree with {full}")
    gap = max(abs(part2[s] - full[s]) for s in (3, 4))
    print(f"[15] resume: steps 3-4 resumed {[part2[3], part2[4]]} against uninterrupted {[full[3], full[4]]}: "
          f"largest difference {gap:.3e} (bound {RESUME_BOUND:g}); launches per step "
          f"{ {k: v for k, v in expect.items() if v} }")
    check(sorted(part2) == [3, 4] and gap <= RESUME_BOUND, f"resumed losses within {RESUME_BOUND} of uninterrupted")
    check(full[4] < full[1], f"losses fall: {full}")
    return counter.total, {k: runs[k][0] for k in runs}, full, final


def write_markov_shards(seed: int, vocab: int, n_shards: int = 2, per_shard: int = 12) -> str:
    """uint16 ``.bin`` token shards of Markov samples (each ``TRAIN_S + 1``
    tokens, so each is one window of the token dataset)."""
    shutil.rmtree(PRETRAIN_SHARDS, ignore_errors=True)
    os.makedirs(PRETRAIN_SHARDS)
    it = iter(MarkovTokenDataset(seq_len=TRAIN_S, vocab_size=vocab, seed=seed))
    for i in range(n_shards):
        toks = [np.append(x, y[-1]) for x, y in (next(it) for _ in range(per_shard))]
        np.concatenate(toks).astype(np.uint16).tofile(os.path.join(PRETRAIN_SHARDS, f"shard{i}.bin"))
    return PRETRAIN_SHARDS


def pretrain_native_8bit(seed: int, vocab: int, expect: dict) -> dict:
    """Phase 15 (c): ``llm_pretrain --native_loader`` over Markov shards
    with ``schedule_free_adamw_8bit``, three steps at (a)'s model and
    batch: the loader's library builds, the loss is finite and falls, and
    every step launches exactly ``expect`` (the optimizer has no kernel).
    Returns the launches."""
    t0 = time.perf_counter()
    shards = write_markov_shards(seed, vocab)
    print(f"[15] Markov token shards: {len(os.listdir(shards))} shards of 12 x {TRAIN_S + 1} uint16 tokens written in "
          f"{time.perf_counter() - t0:.2f} s")
    argv = ["--model", PRETRAIN_MODEL, "--quantize", "mixed_precision", "--activation_checkpointing",
            "--batch_size", str(TRAIN_B), "--seq_len", str(TRAIN_S), "--log_interval", "1", "--seed", str(seed),
            "--train_ds", json.dumps({"type": "token", "dataset_dir": shards}), "--native_loader",
            "--optim", "schedule_free_adamw_8bit", "--n_steps", "3", "--save_dir", PRETRAIN_SAVE,
            "--run_name", "native_8bit", *device_args()]
    try:
        with StepLaunches(expect) as counter:
            out, seconds = run_driver(llm_pretrain.main, argv)
            eas = out["state"].opt_state.exp_avg_sq
            n8 = sum(isinstance(x, optim.OptimState8bit) for x in tree_leaves(eas, is_leaf=lambda x: isinstance(
                x, optim.OptimState8bit)))
            losses = pretrain_report("llm_pretrain --native_loader schedule_free_adamw_8bit", out, seconds)
            del out, eas
    finally:
        shutil.rmtree(shards, ignore_errors=True)
    torch.cuda.empty_cache()
    print(f"[15] {n8} exp_avg_sq leaves in 8 bits")
    check(counter.steps == 3 and n8 > 0, f"3 steps ran ({counter.steps}) with 8-bit state ({n8} leaves)")
    check(losses[3] < losses[1], f"the 8-bit schedule-free run's loss falls: {losses}")
    return counter.total


def evaluate_checkpoint(runs: dict, seed: int, vocab: int, train_losses: dict, final) -> dict:
    """Phase 15 (d): ``llm_evaluate --ckpt`` the resumed run's last
    checkpoint (step 4), the perplexity task on 4 batches of 8 x 2048
    Markov tokens (the eval split of the training chain: the eval set's
    ``seed`` is the run's, as ``llm_evaluate`` passes none of its own) and
    16 generated tokens: the loaded
    parameters are that run's final ones bit for bit, the perplexity
    finite. Then the step-2 checkpoint: the eval loss falls from it to the
    step-4 one, and both lie below ln(vocab), the loss of a uniform guess
    (an evaluation on another chain, or of untrained parameters, lies
    above it: 10.58 and 10.64 with the eval set on another chain, on the
    H100); the step-2 eval loss is printed beside the training loss of step
    3, which the same parameters gave on the training stream's batch.
    Returns the launches of both."""
    ops.reset_launch_counts()
    results = {}
    for name, step in (("part2", 4), ("part1", 2)):
        out, seconds = run_driver(llm_evaluate.main, [
            "--model", PRETRAIN_MODEL, "--quantize", "mixed_precision", "--ckpt",
            os.path.join(runs[name], "last.pkl"), "--tasks", "perplexity", "--seq_len", str(TRAIN_S),
            "--eval_ds", json.dumps({"type": "markov", "vocab_size": vocab, "seed": seed}), "--max_batches", "4",
            "--generate", "16", *device_args()])
        results[step] = out["results"]
        print(f"[15] llm_evaluate on the step-{step} checkpoint: perplexity {out['results']['perplexity']:.4f} "
              f"(eval loss {out['results']['eval_loss']:.6f}), {len(out['results']['sample_tokens'])} tokens; "
              f"{seconds:.1f} s")
        if step == 4:
            loaded, want = tree_leaves(out["params"]), tree_leaves(final)
            same = len(loaded) == len(want) and all(a.dtype == b.dtype and torch.equal(a, b)
                                                    for a, b in zip(loaded, want))
            print(f"[15] loaded parameters bit-identical to the resumed run's final ones: {same}")
            check(same, "llm_evaluate loads the trained parameters bit for bit")
        del out
    launches = ops.launch_counts()
    check(all(np.isfinite(r["perplexity"]) and len(r["sample_tokens"]) == 4 + 16 for r in results.values()),
          "finite perplexities, 16 tokens each")
    ev2, ev4, uniform = results[2]["eval_loss"], results[4]["eval_loss"], float(np.log(vocab))
    print(f"[15] eval loss of the step-2 checkpoint {ev2:.6f} (the training loss of step 3, at the same parameters "
          f"on a training batch, {train_losses[3]:.6f}), of the step-4 checkpoint {ev4:.6f}; ln(vocab) {uniform:.6f}")
    check(ev4 < ev2 < uniform, "the eval loss falls from the step-2 to the step-4 checkpoint, below ln(vocab)")
    return launches


# the kernels of phase 15's main path (llm_pretrain --quantize
# mixed_precision at its default adamw): K1, K2, B1, B2, B4, B5, B7-B14
PRETRAIN_KERNELS = ("quantize_int8_rowwise", "scaled_mm_rhs_t", "scaled_mm", "scaled_mm_lhs_t",
                    "quantize_int8_colwise", "quantize_int8_both", "rmsnorm_quant_rowwise", "rmsnorm_quant_colwise",
                    "silu_mul_quant_rowwise", "silu_mul_quant_colwise", "rmsnorm_bwd", "silu_mul_bwd_quant_rowwise",
                    "silu_mul_bwd_quant_colwise", "rope_group", "rope_ungroup", "ungroup_amax", "ungroup_quant")


def hold_470m(name: str, kind: str, kernel, plain, args, route, nbytes: float, int8_ops: float = 0.0,
              form: str = "", results: dict | None = None) -> tuple:
    """One wrapper of phase 15's path on the card at a shape of the 470m's
    step: launched once, on its sm90 route or row walk where the kernel
    has one (``route``: the route's predicate at these operands, which
    must take it; None for B5 and B13, which have one form), held to its
    plain version by the bars of ``kind`` (:func:`_hold`), timed; appends
    {"shape", "form", "route", "max_abs_err", "ms", "bound_ms"} to
    ``results[name]``. Returns the kernel's outputs."""
    as_tuple = lambda out: out if isinstance(out, tuple) else (out,)
    ops.reset_launch_counts()
    got = as_tuple(kernel(*args))
    launched = {k: v for k, v in ops.launch_counts().items() if v}
    want = {name: 1} if route is None else {name: 1, f"{name}_sm90": 1}
    check(route is None or bool(route), f"{name} at {list(args[0].shape)}: the bf16 route takes the 470m's shape")
    check(launched == want, f"{name} at {list(args[0].shape)} launched {launched}, not {want}")
    ref = as_tuple(plain(*args))
    torch.cuda.synchronize()
    held = _hold(kind, got, ref)
    ms = time_ms(kernel, copies(*args))
    b_ms, by = bound(nbytes, int8_ops=int8_ops)
    shape = [list(t.shape) for t in args[:2]] if name.startswith("scaled_mm") else list(args[0].shape)
    results.setdefault(name, []).append({"shape": shape, "form": form, "route": route if route is None else str(route),
                                         "max_abs_err": _max_err(got, ref), "ms": ms, "bound_ms": b_ms})
    print(f"[15] {name} {shape} bf16{form and f' ({form})'} at the 470m: route {route}; {held}; kernel {ms:.4f} ms "
          f"({b_ms / ms:.3f} of the "
          f"{b_ms:.4f} ms bound by {by})")
    return got


def kernels_at_470m(cfg: llama.LlamaConfig, gen: torch.Generator) -> dict:
    """Phase 15 (e): every kernel of ``llm_pretrain --quantize
    mixed_precision`` in the form its step calls, on bf16 tensors on the
    card at the shapes the 470m's step gives it (``TOKENS`` rows; hidden
    1024, FFN 4096, attention 16 x 64 at G = 1): K1 and B4 on the weights
    [1024, 1024], [4096, 1024] and [1024, 4096]; K2, B1 and B2 on each
    weight's forward, grad_input and grad_weight; B5 on the output
    gradients [8192, 1024]; B7 (with the column absmax), B8 (given its
    scales) and B10 at [8192, 1024]; B9 rows and columns, B11 and B12 at
    [8192, 4096]; B13 grouping q (pre-scaled tables), k (tables) and the
    cotangent (none), and ungrouping them (rot^T) from both memory layouts;
    B14's absmax and row and column quantizes of the attention output in
    both layouts. Each through :func:`hold_470m`: on its route, bit-exact
    with its plain version (B7, B8 and B10 to their sum-order bars).
    Returns name -> the shapes' results, for the kernels line."""
    results = {}
    hold = partial(hold_470m, results=results)
    bf = torch.bfloat16
    M, D, F, hd = TOKENS, cfg.hidden_size, cfg.intermediate_size, cfg.head_dim
    H, KV = cfg.num_attention_heads, cfg.num_key_value_heads
    for o, i in ((D, D), (F, D), (D, F)):
        w = (torch.randn(o, i, generator=gen, device=DEVICE) * 0.02).to(bf)
        w[0] = 0  # an all-zero row
        hold("quantize_int8_rowwise", "exact", ops.quantize_int8_rowwise, ops.quantize_int8_plain, (w,),
             IQ.rowwise_sm90_route(o, i, bf), 3 * o * i + 2 * o)
        hold("quantize_int8_colwise", "exact", ops.quantize_int8_colwise,
             lambda w: ops.quantize_int8_plain(w, axis=0), (w,), IQ.colwise_sm90_route(o, i, bf),
             quantize_bytes(o, i, 1))
        x = torch.randn(M, i, generator=gen, device=DEVICE).to(bf)
        g = (torch.randn(M, o, generator=gen, device=DEVICE) * 1e-4).to(bf)
        x_row, x_row_s = ops.quantize_int8_plain(x)
        w_row, w_row_s = ops.quantize_int8_plain(w)
        x_col, x_col_s = ops.quantize_int8_plain(x, axis=0)
        w_col, w_col_s = ops.quantize_int8_plain(w, axis=0)
        g_row, g_row_s, g_col, g_col_s = ops.quantize_int8_both_plain(g)
        for name, kernel, plain, args, (m, n, k) in (
            ("scaled_mm_rhs_t", ops.scaled_mm_rhs_t, ops.scaled_mm_rhs_t_plain,
             (x_row, w_row, x_row_s, w_row_s.reshape(1, o)), (M, o, i)),
            ("scaled_mm", ops.scaled_mm, ops.scaled_mm_plain, (g_row, w_col, g_row_s, w_col_s), (M, i, o)),
            ("scaled_mm_lhs_t", ops.scaled_mm_lhs_t, ops.scaled_mm_lhs_t_plain, (g_col, x_col, g_col_s, x_col_s),
             (o, i, M)),
        ):
            hold(name, "exact", kernel, plain, args, ROUTES[name](*args),
                 m * k + n * k + 2 * m * n + 2 * (m + n), int8_ops=2.0 * m * n * k, form=f"M={m} N={n} K={k}")
        if o == D:  # the output gradients of q, k, v, o and down
            g[:, 1] = 0  # an all-zero column too
            hold("quantize_int8_both", "exact", ops.quantize_int8_both, ops.quantize_int8_both_plain, (g,), None,
                 quantize_bytes(M, o, 2))
    x = torch.randn(M, D, generator=gen, device=DEVICE).to(bf)
    x[0] = 0
    gamma = (1 + 0.1 * torch.randn(D, generator=gen, device=DEVICE)).to(bf)
    dy = (torch.randn(M, D, generator=gen, device=DEVICE) * 1e-3).to(bf)
    out = hold("rmsnorm_quant_rowwise", "int8", partial(ops.rmsnorm_quant_rowwise, with_col_amax=True),
               partial(ops.rmsnorm_quant_rowwise_plain, with_col_amax=True), (x, gamma),
               FP.norm_rows_sm90_route(D, bf), 3 * M * D + 2 * D + 4 * M + 4 * D, form="column absmax")
    hold("rmsnorm_quant_colwise", "int8", lambda x, g, s: ops.rmsnorm_quant_colwise(x, g, scale=s),
         lambda x, g, s: ops.rmsnorm_quant_colwise_plain(x, g, scale=s), (x, gamma, out[2] * (1.0 / 127.0)),
         FP.norm_cols_sm90_route(D, bf), 3 * M * D + 2 * D + 4 * D, form="given scales")
    hold("rmsnorm_bwd", "bwd", ops.rmsnorm_bwd, ops.rmsnorm_bwd_plain, (x, gamma, dy),
         FP.rmsnorm_bwd_sm90_route(D, bf), 6 * M * D + 2 * D + 4 * D)
    a = torch.randn(M, F, generator=gen, device=DEVICE).to(bf)
    b = torch.randn(M, F, generator=gen, device=DEVICE).to(bf)
    dact = (torch.randn(M, F, generator=gen, device=DEVICE) * 1e-3).to(bf)
    a[:, 1] = 0  # an all-zero column
    out = hold("silu_mul_quant_rowwise", "exact", partial(ops.silu_mul_quant_rowwise, with_col_amax=True),
               partial(ops.silu_mul_quant_rowwise_plain, with_col_amax=True), (a, b),
               FP.silu_rows_sm90_route(F, bf), 5 * M * F + 4 * M + 4 * F, form="column absmax")
    hold("silu_mul_quant_colwise", "exact", lambda a, b, s: ops.silu_mul_quant_colwise(a, b, scale=s),
         lambda a, b, s: ops.silu_mul_quant_colwise_plain(a, b, scale=s), (a, b, out[2] * (1.0 / 127.0)),
         FP.silu_cols_sm90_route(F, bf), 5 * M * F + 4 * F, form="given scales")
    row = hold("silu_mul_bwd_quant_rowwise", "exact", ops.silu_mul_bwd_quant_rowwise,
               ops.silu_mul_bwd_quant_rowwise_plain, (a, b, dact), FP.silu_bwd_rows_sm90_route(F, bf),
               8 * M * F + 8 * M + 8 * F, form="column absmax")
    hold("silu_mul_bwd_quant_colwise", "exact", ops.silu_mul_bwd_quant_colwise,
         ops.silu_mul_bwd_quant_colwise_plain, (a, b, dact, *(m * (1.0 / 127.0) for m in row[4:])),
         FP.silu_bwd_cols_sm90_route(F, bf), 8 * M * F + 8 * F, form="given scales")
    cos, sin = llama.rope_tables(cfg, TRAIN_S, device=DEVICE)
    tables = 2 * cos.numel() * 4
    for what, c, s_ in (("q", cos * hd**-0.5, sin * hd**-0.5), ("k", cos, sin), ("cotangent", None, None)):
        x = torch.randn(TRAIN_B, TRAIN_S, H, hd, generator=gen, device=DEVICE).to(bf)
        nbytes = 4 * x.numel() + (0 if c is None else tables)
        (y,) = hold("rope_group", "exact", lambda x, c=c, s=s_: ops.rope_group_kernel(x, c, s, kv=KV),
                    lambda x, c=c, s=s_: ops.rope_group_ref(x, c, s, KV), (x,), None, nbytes, form=what)
        bhsd = x.permute(0, 2, 1, 3).contiguous().view(y.shape)
        for layout, grouped in (("[B, S, H, hd] memory", y), ("[B, H, S, hd] memory", bhsd)):
            hold("rope_ungroup", "exact", lambda g, c=c, s=s_: ops.rope_ungroup_kernel(g, c, s, inverse=True),
                 lambda g, c=c, s=s_: ops.rope_ungroup_ref(g, c, s, inverse=True), (grouped,), None, nbytes,
                 form=f"{what}, rot^T, {layout}")
    x = torch.randn(TRAIN_B, TRAIN_S, H, hd, generator=gen, device=DEVICE).to(bf)
    x[0, 1] = 0  # an all-zero row of the ungrouped view
    step = ops.rope_group_kernel(x, kv=KV)
    route, K = ROPE.ungroup_sm90_route(H * hd, hd, bf), H * hd
    for layout, out in (("[B, S, H, hd] memory", step),
                        ("[B, H, S, hd] memory", x.permute(0, 2, 1, 3).contiguous().view(step.shape))):
        row, col = hold("ungroup_amax", "exact", ops.ungroup_amax, ops.ungroup_amax_plain, (out,), route,
                        2 * M * K + 4 * M + 4 * K, form=layout)
        for axis, scale, nbytes in ((1, row, 3 * M * K + 4 * M), (0, col, 3 * M * K + 4 * K)):
            hold("ungroup_quant", "exact", lambda y, s, axis=axis: ops.ungroup_quant(y, s, axis=axis),
                 lambda y, s, axis=axis: ops.ungroup_quant_plain(y, s, axis=axis), (out, scale * (1.0 / 127.0)),
                 route, nbytes, form=f"{'rows' if axis else 'columns'}, {layout}")
    missing = [k for k in PRETRAIN_KERNELS if k not in results]
    check(not missing, f"phase 15 (e) held every kernel of the path, not {missing}")
    return results


def llm_drivers(seed: int) -> tuple[dict, dict]:
    """Phase 15: (e) each kernel at the 470m's shapes and (b) the 470m's
    2-layer cut against the plain path, then (a) resume, (c) the native
    loader with the 8-bit optimizer, (d) evaluate; prints its seconds.
    Returns the launches of (a), (c) and (d), and (e)'s results."""
    t0 = time.perf_counter()
    shutil.rmtree(PRETRAIN_SAVE, ignore_errors=True)
    base = llama.LlamaConfig.from_hf_json(PRETRAIN_MODEL)
    at_470m = kernels_at_470m(base, torch.Generator(device=DEVICE).manual_seed(SEED))
    grads_vs_plain(SEED, torch.float32, 1.5e-1, 1e-3, fused=True, base=base, name="Llama-2-470m", phase=15)
    grads_vs_plain(SEED, torch.float32, 1.5e-1, 1e-3, fused=False, base=base, name="Llama-2-470m", phase=15)
    cfg = dataclasses.replace(base, remat=True, max_position_embeddings=TRAIN_S)
    expect = pretrain_per_step_launches(cfg, TOKENS)
    resumed, runs, train_losses, final = pretrain_resume(seed, cfg.vocab_size, expect)
    native = pretrain_native_8bit(seed, cfg.vocab_size, expect)
    evaluated = evaluate_checkpoint(runs, seed, cfg.vocab_size, train_losses, final)
    launches = {k: resumed[k] + native[k] + evaluated[k] for k in resumed}
    missing = [k for k in PRETRAIN_KERNELS if not launches[k]]
    check(not missing, f"phase 15 launched every kernel of its path, not {missing}")
    shutil.rmtree(PRETRAIN_SAVE, ignore_errors=True)
    print(f"[15] LLM drivers: {time.perf_counter() - t0:.1f} s", flush=True)
    return launches, at_470m


# ---- phase 16: per-step weight pre-quantization, the int8 conv, MX ---------

PREQUANT_MODES = ("0", "both", "row", "col")
# phase 16's conv cases (B, H, W, C, O, k, stride, padding): benchmark_conv2d's
# six shapes at padding k // 2, a C = 3 stem (a contraction of 27, padded to
# 32) and a stride-2 conv at padding 0
CONV_CASES = [(*c[:6], c[6], c[5] // 2) for c in benchmark_conv2d.SHAPES] + [
    (8, 224, 224, 3, 64, 3, 2, 1), (8, 56, 56, 64, 128, 3, 2, 0)]
# the SR step under QT_PREQUANT against the same step without the knob:
# JAX's bar (tests/test_env_knobs.py:92-98)
PREQUANT_SR_BOUND = 2e-2
# the MX checks' [n, n] inputs and n^3 products
MX_N = 2048


def prequant_per_step_launches(L: int, micro: int, mode: str, sr: bool = False, b6: int = 0,
                               b6_sr: int = 0) -> dict:
    """``per_step_launches`` of the fused layer under ``QT_PREQUANT=mode``
    (pinned on the CPU by tests/test_torch_prequant.py::prequant_per_step):
    'both' makes a weight's views with one B5 a micro-batch and launches no
    K1 or B4 (the weights' were the only ones on the fused layer); 'row'
    makes the row view with one K1 (the SR form on the walk at q, o, gate,
    up and down, as before) and the forward and its replay launch none;
    'col' makes the column view with one B4, on the cluster form, in place
    of the backward's."""
    counts = per_step_launches(L, micro, sr, b6, b6_sr)
    t, n = "_sr" if sr else "", L * micro
    if mode == "both":
        for k in (f"quantize_int8_rowwise{t}", f"quantize_int8_rowwise{t}_sm90", f"quantize_int8_colwise{t}",
                  f"quantize_int8_colwise{t}_sm90"):
            counts[k] = 0
        counts[f"quantize_int8_both{t}"] += 7 * n
    elif mode == "row":
        counts[f"quantize_int8_rowwise{t}"] = 7 * n
        counts[f"quantize_int8_rowwise{t}_sm90"] = (5 if sr else 7) * n
    return counts


@contextlib.contextmanager
def prequant_mode(mode: str):
    """``QT_PREQUANT`` set for a block, restored after."""
    old = os.environ.get("QT_PREQUANT")
    os.environ["QT_PREQUANT"] = mode
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("QT_PREQUANT", None)
        else:
            os.environ["QT_PREQUANT"] = old


def check_b5_weights(gen: torch.Generator, key: int) -> tuple[list, list]:
    """B5 at the Llama2-1B weights, one launch a layer's weight under
    ``QT_PREQUANT=both`` (q/o [2048, 2048], k/v [256, 2048], gate/up [5632,
    2048], down [2048, 5632]), RN and SR with one key: bit-exact with its
    plain version, timed with its byte bound. Returns the shapes' records,
    RN and SR, for B5's entries."""
    rn, sr = [], []
    for shape in WEIGHTS:
        w = (torch.randn(shape, generator=gen, device=DEVICE) * 0.02).to(torch.bfloat16)
        w[0] = 0  # an all-zero row and column
        w[:, 1] = 0
        nbytes = quantize_bytes(*shape, 2)
        b_ms, _ = bound(nbytes)
        for rows, kw in ((rn, {}), (sr, {"sr": True, "key": key})):
            kernel, plain = partial(ops.quantize_int8_both, **kw), partial(ops.quantize_int8_both_plain, **kw)
            got, ref = kernel(w), plain(w)
            torch.cuda.synchronize()
            what = f"quantize_int8_both{'_sr' if kw else ''} at the weight {list(shape)}"
            check(all(torch.equal(a, b) for a, b in zip(got, ref)), f"{what} bit-exact")
            inputs = copies(w)
            ms, plain_ms = time_ms(kernel, inputs), time_ms(plain, inputs)
            rows.append({"shape": list(shape), "form": "weight (QT_PREQUANT)", "ms": ms, "plain_ms": plain_ms,
                         "bound_ms": b_ms})
            print(f"[16] {what} bf16: bit-exact; kernel {ms:.4f} ms ({nbytes / ms / 1e6:.0f} GB/s, "
                  f"{b_ms / ms:.3f} of the {b_ms:.4f} ms bound by bytes), plain {plain_ms:.4f} ms")
    return rn, sr


def prequant_steps(raw, seed: int, key: int) -> dict:
    """bench.py's step (phase 8's: tokens [4, 4, 2048], remat, adamw_bf16_sr
    without the SR writeback, lr 1e-4, int8 on the fused layer) three steps
    under each ``QT_PREQUANT`` mode in turn ('0', 'both', 'row', 'col'), from
    one state, batch and key: the launches of every step exactly
    ``prequant_per_step_launches``, the first loss of every mode bit-identical
    to '0''s (B5's RN views are K1's and B4's bits); tokens/s (steps 2-3)
    against '0', peak memory; the later losses' gaps to '0''s printed (cuDNN's
    attention backward sums in no fixed order: on the H100 the modes' third
    losses differed by up to 4.5e-3 in one run). The same three steps
    again under ``torch.use_deterministic_algorithms(True)`` (attention's
    backward in a fixed order): every loss of every mode bit-identical to
    '0''s. Then one step of the SR configuration (phase 9's optimizer,
    stochastic rounding) at the same batch under '0' and 'both': the
    launches exact (B5-SR a layer's weight a micro-batch), the loss finite
    and within ``PREQUANT_SR_BOUND`` of '0''s. Returns the launches of all
    the runs."""
    cfg, tokens, labels = train_cfg_and_batch(seed, (BENCH_ACCUM, TRAIN_B, TRAIN_S))
    L, n_leaves = cfg.num_hidden_layers, len(tree_leaves(raw))
    launches = dict.fromkeys(ops.KERNELS, 0)

    def measured(params, opt, lr, mode, n_steps, expect):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        with prequant_mode(mode):
            losses, walls, counts = run_steps(params, cfg, tokens, labels, opt, lr, key, n_steps, expect,
                                              jit_compile=train.capture_refusal(params) is None)
        for k, v in counts.items():
            launches[k] += v
        return losses, walls, torch.cuda.max_memory_allocated() / 2**30

    qparams = quant.quantize_params(raw, "mixed_precision")
    opt = optim.adamw_bf16_sr(bf16_stochastic_rounding=False)
    runs = {m: measured(qparams, opt, 1e-4, m, 3, prequant_per_step_launches(L, BENCH_ACCUM, m, b6=n_leaves))
            for m in PREQUANT_MODES}
    n_tok = tokens.numel()
    tps = {m: n_tok * (len(r[1]) - 1) / sum(r[1][1:]) for m, r in runs.items()}
    base = runs["0"][0]
    print(f"[16] QT_PREQUANT at bench.py's step (Llama2-1B, tokens [{BENCH_ACCUM}, {TRAIN_B}, {TRAIN_S}], remat, "
          f"SDPA, int8 fused, adamw_bf16_sr without SR, lr 1e-4), seed {seed}: " + "; ".join(
              f"{m}: losses {r[0]}, step walls {[round(w, 4) for w in r[1]]} s" for m, r in runs.items()))
    print(f"[16] tokens/s (steps 2-3, wall with torch.cuda.synchronize()): " + ", ".join(
        f"{m} {tps[m]:.1f} ({tps[m] / tps['0']:.3f} of '0')" for m in runs) + "; peak device memory " + ", ".join(
        f"{m} {r[2]:.2f} GiB ({r[2] - runs['0'][2]:+.2f})" for m, r in runs.items()))
    for m in PREQUANT_MODES[1:]:
        expect = prequant_per_step_launches(L, BENCH_ACCUM, m, b6=n_leaves)
        gap = max(abs(a - b) for a, b in zip(runs[m][0][1:], base[1:]))
        print(f"[16] {m}: first loss {'bit-identical to' if runs[m][0][0] == base[0] else 'DIFFERS from'} '0''s; "
              f"later steps within {gap:.3e}; launches per step "
              f"{ {k: v for k, v in expect.items() if v and 'quantize' in k} }")
        check(runs[m][0][0] == base[0], f"QT_PREQUANT={m}: first loss {runs[m][0][0]} bit-identical to {base[0]}")
    deterministic = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        det = {m: measured(qparams, opt, 1e-4, m, 3, prequant_per_step_launches(L, BENCH_ACCUM, m, b6=n_leaves))
               for m in PREQUANT_MODES}
    finally:
        torch.use_deterministic_algorithms(deterministic)
    print(f"[16] deterministic algorithms: " + "; ".join(f"{m} losses {r[0]}" for m, r in det.items()))
    check(all(r[0] == det["0"][0] for r in det.values()),
          f"deterministic algorithms: every mode's losses bit-identical to '0''s: { {m: r[0] for m, r in det.items()} }")
    del qparams
    sr_params = quant.quantize_params(raw, "mixed_precision", stochastic_rounding=True)
    sr_opt = optim.get_optimizer("adamw_bf16_sr", weight_decay=1e-2)
    sr_runs = {m: measured(sr_params, sr_opt, 3e-4, m, 1,
                           prequant_per_step_launches(L, BENCH_ACCUM, m, sr=True, b6_sr=n_leaves))
               for m in ("0", "both")}
    rel = abs(sr_runs["both"][0][0] - sr_runs["0"][0][0]) / abs(sr_runs["0"][0][0])
    print(f"[16] SR configuration at the same batch, one step: '0' loss {sr_runs['0'][0][0]}, 'both' "
          f"{sr_runs['both'][0][0]} (relative {rel:.3e}, bound {PREQUANT_SR_BOUND:g}); walls "
          f"{sr_runs['0'][1][0]:.4f} / {sr_runs['both'][1][0]:.4f} s; peak {sr_runs['0'][2]:.2f} / "
          f"{sr_runs['both'][2]:.2f} GiB")
    check(rel <= PREQUANT_SR_BOUND, f"QT_PREQUANT=both SR loss within {PREQUANT_SR_BOUND} of '0''s: {rel:.3e}")
    return launches


def check_convs(gen: torch.Generator) -> tuple[dict, dict]:
    """``int8_conv2d`` (B17's int8 form) and ``scaled_int8_conv2d`` (K2) at
    ``CONV_CASES`` on the card against the same functions on the CPU (the
    GEMMs' plain versions), bit for bit, each launching its kernel once;
    each GEMM timed alone on its im2col operands with its bound (the int8
    operations of K = kh * kw * C and the bytes of the operands, the
    contraction's zero padding included, and of the output), the whole conv
    (im2col included) and cuDNN's bf16 conv (channels-last, a reference: not
    the same function). Returns the records by kernel and the convs'
    launches."""
    rows, launches = {"matmul_s8": [], "scaled_mm_rhs_t": []}, dict.fromkeys(ops.KERNELS, 0)
    conv = importlib.import_module("quantized_training_tpu_torch.ops.conv")
    for Bn, H, W, C, O, k, s, p in CONV_CASES:
        x = torch.randint(-128, 128, (Bn, H, W, C), generator=gen, device=DEVICE, dtype=torch.int8)
        w = torch.randint(-128, 128, (k, k, C, O), generator=gen, device=DEVICE, dtype=torch.int8)
        cs = (torch.rand(O, generator=gen, device=DEVICE) * 0.01 + 1e-3)
        ops.reset_launch_counts()
        got, got_s = ops.int8_conv2d(x, w, s, p), ops.scaled_int8_conv2d(x, w, cs, s, p)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        for kname, v in counts.items():
            launches[kname] += v
        what = f"conv [{Bn}, {H}, {W}, {C}] * [{k}, {k}, {C}, {O}] stride {s} padding {p}"
        check(counts["matmul_s8"] == 1 and counts["scaled_mm_rhs_t"] == 1, f"{what}: one B17-s8, one K2: {counts}")
        xc, wc = x.cpu(), w.cpu()
        check(torch.equal(got.cpu(), ops.int8_conv2d(xc, wc, s, p)), f"int8_conv2d {what} equals the CPU's")
        check(torch.equal(got_s.cpu(), ops.scaled_int8_conv2d(xc, wc, cs.cpu(), s, p)),
              f"scaled_int8_conv2d {what} equals the CPU's")
        cols = conv.im2col(x, k, k, s, p, conv.K_ALIGN)
        (M, Kp), K = cols.shape, k * k * C
        w_kn = conv.weight_kn(w, Kp).contiguous()
        ones = torch.ones(M, device=DEVICE)
        x_cl = x.to(torch.bfloat16).permute(0, 3, 1, 2)
        w_cl = w.to(torch.bfloat16).permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        cudnn_ms = lib_ms("cuDNN's bf16 conv", lambda a, b: torch.nn.functional.conv2d(a, b, stride=s, padding=p),
                          copies(x_cl, w_cl))
        for name, gemm, args, fn, out_bytes in (
                ("matmul_s8", ops.matmul, (cols, w_kn), lambda a, b: ops.int8_conv2d(a, b, s, p), 4 * M * O),
                ("scaled_mm_rhs_t", ops.scaled_mm_rhs_t, (cols, w_kn.T.contiguous(), ones, cs),
                 lambda a, b: ops.scaled_int8_conv2d(a, b, cs, s, p), 2 * M * O + 4 * (M + O))):
            route = (MATMUL.sm90_route(cols, w_kn) if name == "matmul_s8" else SCALED_MM.sm90_route(M))
            ms = time_ms(gemm, copies(*args), iters=8)
            conv_ms = time_ms(fn, copies(x, w), iters=8)
            nbytes = M * Kp + Kp * O + out_bytes
            b_ms, by = bound(nbytes, int8_ops=2.0 * M * O * K)
            rows[name].append({"conv": [Bn, H, W, C, O, k, s, p], "shape": [M, O, Kp], "route": "sm90" if route
                               else "wmma", "ms": ms, "conv_ms": conv_ms, "bound_ms": b_ms, "bound_by": by,
                               "library_ms": cudnn_ms, "library_form": "cuDNN bf16 conv, reference, not the same "
                               "function"})
            print(f"[16] {name} at {what} (M {M}, N {O}, K {K} padded to {Kp}): equals the CPU's; route "
                  f"{'sm90' if route else 'wmma'}; GEMM {ms:.4f} ms ({2 * M * O * K / ms / 1e9:.1f} TOP/s, "
                  f"{b_ms / ms:.3f} of the {b_ms:.4f} ms bound by {by}), whole conv {conv_ms:.4f} ms, cuDNN bf16 "
                  f"conv {'refused' if cudnn_ms is None else f'{cudnn_ms:.4f} ms'} (reference)")
    return rows, launches


def check_mx(gen: torch.Generator) -> dict:
    """The MX / NVFP4 numerics on the card against the CPU: ``quantize_mx``
    (fp4, e4m3, e5m2; OCP and NV scales) and ``quantize_nvfp4`` (its own and
    a given tensor scale) bit for bit on [2048, 2048] fp32 of three
    magnitudes with each format's maximum and beyond in it, the fp8 and E8M0
    outputs as bytes, the dequantizes too; ``mxfp4_mm`` and ``nvfp4_mm`` at
    2048^3 (B17's bf16 form, fp32 out) on the card within the fp32-sum bound
    of the float64 product of the dequantized operands, timed. Returns B17's
    launches there."""
    mx = importlib.import_module("quantized_training_tpu_torch.ops.mx")
    n = MX_N
    x = torch.randn(n, n, generator=gen, device=DEVICE) * 10.0 ** torch.randint(
        -3, 4, (n, 1), generator=gen, device=DEVICE).float()
    x[0, :8] = torch.tensor([6.0, 7.0, 448.0, 500.0, 57344.0, 1e5, -464.0, 0.25], device=DEVICE)
    xc = x.cpu()
    raw = lambda t: t.cpu().view(torch.uint8) if t.element_size() == 1 else t.cpu().view(torch.int32)
    for dt in ("fp4", torch.float8_e4m3fn, torch.float8_e5m2):
        for method in ("ocp", "nv"):
            got, ref = mx.quantize_mx(x, dt, method), mx.quantize_mx(xc, dt, method)
            check(all(torch.equal(raw(a), raw(b)) for a, b in zip(got, ref)), f"quantize_mx {dt} {method} card == CPU")
            if dt == "fp4":
                check(torch.equal(raw(mx.dequantize_mxfp4(*got)), raw(mx.dequantize_mxfp4(*ref))),
                      f"dequantize_mxfp4 ({method}) card == CPU")
    for ts in (None, 0.37):
        got, ref = mx.quantize_nvfp4(x, ts), mx.quantize_nvfp4(xc, ts)
        check(all(torch.equal(raw(a), raw(b)) for a, b in zip(got, ref)), f"quantize_nvfp4 (tensor scale {ts}) card "
              "== CPU")
        check(torch.equal(raw(mx.dequantize_nvfp4(*got)), raw(mx.dequantize_nvfp4(*ref))), "dequantize_nvfp4 card == CPU")
    scales = mx.quantize_nvfp4(x)[1]
    check(torch.equal(raw(mx.pack_block_scales_nv(scales)), raw(mx.pack_block_scales_nv(scales.cpu()))),
          "pack_block_scales_nv card == CPU")
    print(f"[16] MX: quantize_mx (fp4, e4m3, e5m2; OCP and NV scales), quantize_nvfp4 (own and given tensor scale), "
          f"the dequantizes and pack_block_scales_nv at [{n}, {n}] fp32: the card's bytes equal the CPU's")
    a, b = (torch.randn(n, n, generator=gen, device=DEVICE) for _ in range(2))
    (aq, sa), (bq, sb) = mx.quantize_mx(a, "fp4"), mx.quantize_mx(b, "fp4")
    (naq, nsa, nta), (nbq, nsb, ntb) = mx.quantize_nvfp4(a), mx.quantize_nvfp4(b)
    ops.reset_launch_counts()
    got_mx = mx.mxfp4_mm(aq, bq, sa, sb, out_dtype=torch.float32)
    got_nv = mx.nvfp4_mm(naq, nbq, nsa, nsb, nta * ntb, out_dtype=torch.float32)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    check(launches["matmul"] == 2, f"mxfp4_mm and nvfp4_mm each launch B17 bf16 once: {launches}")
    for name, got, af, bf, scale in (
            ("mxfp4_mm", got_mx, mx.dequantize_mxfp4(aq, sa), mx.dequantize_mxfp4(bq, sb), 1.0),
            ("nvfp4_mm", got_nv, mx.dequantize_nvfp4(naq, nsa, 1.0), mx.dequantize_nvfp4(nbq, nsb, 1.0),
             (nta * ntb).item())):
        exact = (af.double() @ bf.double().T) * scale
        fold = MATMUL.fp32_sum_bound(af, bf.T) * abs(scale) + 2.0**-23 * exact.abs()
        worst = ((got.double() - exact).abs() / fold).max().item()
        check(worst <= 1.0, f"{name} within the fp32-sum bound of the float64 product: {worst:.3f}")
        args = (aq, bq, sa, sb) if name == "mxfp4_mm" else (naq, nbq, nsa, nsb, nta * ntb)
        fn = getattr(mx, name)
        ms = time_ms(partial(fn, out_dtype=torch.float32), copies(*args), iters=8)
        print(f"[16] {name} {n}^3 fp32 out (dequantize, B17 bf16): at {worst:.4f} of the fp32-sum bound; "
              f"{ms:.4f} ms")
    return launches


def prequant_conv_mx(raw, seed: int, key: int, kernels: list) -> None:
    """Phase 16: B5 at the weight shapes, the QT_PREQUANT steps, the convs,
    ``benchmark_conv2d --quick``, MX; the entries of B5, B5-SR, B17-s8, K2
    and B17 take their records, every entry the phase's launches
    (``prequant_launches``: the steps; ``conv_launches``, ``mx_launches``)."""
    t0 = time.perf_counter()
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    by_name = {e["name"]: e for e in kernels}
    b5_rn, b5_sr = check_b5_weights(gen, key)
    by_name["quantize_int8_both"]["shapes"] += b5_rn
    by_name["quantize_int8_both_sr"]["shapes"] += b5_sr
    steps = prequant_steps(raw, seed, key)
    conv_rows, conv_launches = check_convs(gen)
    for name, rows in conv_rows.items():
        by_name[name]["conv_shapes"] = rows
    print("[16] benchmark_conv2d --quick:", flush=True)
    benchmark_conv2d.main(["--quick"])
    mx_launches = check_mx(gen)
    for e in kernels:
        e["prequant_launches"] = steps.get(e["name"], 0)
        for key_name, counts in (("conv_launches", conv_launches), ("mx_launches", mx_launches)):
            if counts.get(e["name"]):
                e[key_name] = counts[e["name"]]
    check(steps["quantize_int8_both"] > 0 and steps["quantize_int8_both_sr"] > 0 and
          steps["quantize_int8_rowwise"] > 0 and steps["quantize_int8_colwise"] > 0,
          f"phase 16 launched B5, B5-SR, K1 and B4 on its steps: {steps}")
    print(f"[16] QT_PREQUANT, conv and MX: {time.perf_counter() - t0:.1f} s", flush=True)


# ---- phase 17: tokenize, pretrain, finetune, evaluate on tasks, accuracy parity

# phase 17's files: the text, its shards, the finetune rows and the task sets
# under build/, the runs under runs/ (both ignored by git), removed after
TASK_DIR = os.path.join("build", "chip_smoke_tasks")
FINETUNE_B = 4
FINETUNE_STEPS = 6
# the 2-layer cut's per-choice summed losses, card against the CPU's plain
# path: the relative RMS of the difference (the kernels are bit-exact with
# their plain versions, so only attention, the norms and the bf16 lm_head
# round otherwise; phase 5's logits differ by up to 1e-1 relative RMS in
# bf16, a sum over a continuation averages that down), and the share of
# rows whose argmin may differ (random weights leave near-ties)
CUT_MAX_RMS = 1e-2
CUT_MIN_AGREE = 0.75
# accuracy_parity's steps in the phase and its bars: its default of 1200
# steps took 240.6 s on the H100 (fp8 row's plain-torch quantizes 78 ms a
# step), so the phase runs 400, where the four configurations' losses met
# within 6.4e-3 nats in that run; the default runs as a command of its own
# (PERF.md)
PARITY_STEPS = 400
PARITY_MIN_BF16, PARITY_MAX_DACC, PARITY_MAX_DLOSS = 0.90, 0.02, 0.02
WORDS = ("the", "a", "man", "woman", "dog", "ball", "runs", "throws", "into", "water", "slowly", "then", "kitchen",
         "knife", "cuts", "onion", "smiles", "garden", "rain", "falls", "child", "reads", "book", "under", "tree",
         "and", "while", "quickly", "river", "boat")


def fused_takes(M: int, K: int, n_inputs: int = 1) -> bool:
    """Whether the fused layer's ops take [M, K] bf16 inputs on the card
    (``quant/fused.py::_fused_ok``)."""
    return FP.supported(FUSED._padded_rows(M), K, torch.bfloat16, n_inputs)


def eval_forward_launches(cfg: llama.LlamaConfig, n_seq: int, S: int) -> dict:
    """Kernel launches of one ``llama.forward`` of ``cfg`` (int8
    ``mixed_precision``, no grad, the grouped pipeline) on [n_seq, S]
    tokens, M = n_seq * S rows, as the code gates each op (pinned on the CPU
    by tests/test_torch_eval_tasks.py): per layer q/k/v through B7 where the
    fused ops take [M, D], else K1 on the input; K1 on each weight and K2 per
    linear (7); rope_group 3; the o-projection through B14's absmax and
    row quantize where ``attn_out_linear`` fuses (M % 256, S % 8, the
    heads), else rope_ungroup and K1 on its input; the MLP as one op (B7,
    B9-row) where it fuses at [M, D] and [M, F], else gate/up as q/k/v and
    down through B9-row or K1 on its input. Each sm90 counter from its
    route at these shapes; the bf16 lm_head launches none."""
    L, D, F, hd = cfg.num_hidden_layers, cfg.hidden_size, cfg.intermediate_size, cfg.head_dim
    H, KV = cfg.num_attention_heads, cfg.num_key_value_heads
    M, bf = n_seq * S, torch.bfloat16
    counts = dict.fromkeys(ops.KERNELS, 0)

    def add(name, route=None):
        counts[name] += L
        if route is not None:
            counts[f"{name}_sm90"] += L * int(bool(route))

    def inputs(K: int, producer: str | None, route):
        """The input of a group of linears: its fused producer, else K1."""
        if producer:
            add(producer, route)
        else:
            add("quantize_int8_rowwise", IQ.rowwise_sm90_route(M, K, bf))

    def linear(o: int, i: int):
        add("quantize_int8_rowwise", IQ.rowwise_sm90_route(o, i, bf))
        add("scaled_mm_rhs_t", SCALED_MM.sm90_route(M))

    norm = "rmsnorm_quant_rowwise" if fused_takes(M, D) else None
    inputs(D, norm, FP.norm_rows_sm90_route(D, bf))
    for o in (H * hd, KV * hd, KV * hd):
        linear(o, D)
    counts["rope_group"] += 3 * L
    if (H * hd) % 128 == 0 and M % 256 == 0 and ROPE._supported_heads(H, H // KV, hd, S) and fused_takes(M, H * hd):
        add("ungroup_amax", ROPE.ungroup_sm90_route(H * hd, hd, bf))
        add("ungroup_quant", ROPE.ungroup_sm90_route(H * hd, hd, bf))
    else:
        add("rope_ungroup")
        inputs(H * hd, None, None)
    linear(D, H * hd)
    inputs(D, norm, FP.norm_rows_sm90_route(D, bf))
    linear(F, D)
    linear(F, D)
    silu = (norm is not None and fused_takes(M, F, 3)) or fused_takes(M, F, 2)  # the one-op MLP, or down's op
    inputs(F, "silu_mul_quant_rowwise" if silu else None, FP.silu_rows_sm90_route(F, bf))
    linear(D, F)
    return counts


def finetune_per_step_launches(cfg: llama.LlamaConfig, batch: int, S: int, n_leaves: int) -> dict:
    """Kernel launches of one ``llm_finetune`` step on a [batch, S] batch
    (S a multiple of 256: the fused layer throughout, remat): the 470m
    pretrain step's (``pretrain_per_step_launches`` at batch * S tokens) and
    B6's SR form once a parameter leaf (``adamw_bf16_sr``). Pinned on the
    CPU by tests/test_torch_llm_finetune.py."""
    counts = pretrain_per_step_launches(cfg, batch * S)
    counts["fused_adamw_update_sr"] = n_leaves
    return counts


def write_text(seed: int, n_lines: int = 500) -> str:
    """A text file of ``n_lines`` documents of 8-40 words from ``WORDS``."""
    rng = np.random.default_rng(seed)
    path = os.path.join(TASK_DIR, "corpus.txt")
    with open(path, "w") as f:
        for _ in range(n_lines):
            f.write(" ".join(rng.choice(WORDS, int(rng.integers(8, 41)))) + "\n")
    return path


def tokenize_and_pretrain(seed: int, cfg: llama.LlamaConfig) -> tuple[str, dict]:
    """Phase 17 (a): ``tokenize_data --dataset textfile --tokenizer byte``
    into shards of 32,768 tokens (at least 2; a second run leaves the
    complete directory as it is), then ``llm_pretrain`` for 2 steps on them
    at the 470m, int8 fused, remat, batch 4 x 2048, each step's launches
    ``pretrain_per_step_launches``. Returns the checkpoint and the
    launches."""
    t0 = time.perf_counter()
    text = write_text(seed)
    shards = os.path.join(TASK_DIR, "shards")
    argv = ["--dataset", "textfile", "--input", text, "--save_dir", shards, "--tokenizer", "byte",
            "--shard_size", "32768"]
    tokenize_data.main(argv)
    files = sorted(f for f in os.listdir(shards) if f.endswith(".bin"))
    sizes = [os.path.getsize(os.path.join(shards, f)) // 2 for f in files]
    with open(text) as f:
        want = sum(len(line.strip().encode()) + 2 for line in f if line.strip())
    dtype = open(os.path.join(shards, "dtype.txt")).read()
    stamps = {f: os.stat(os.path.join(shards, f)).st_mtime_ns for f in files}
    tokenize_data.main(argv)
    same = stamps == {f: os.stat(os.path.join(shards, f)).st_mtime_ns for f in files}
    print(f"[17] tokenize_data: {len(files)} shards of {sizes} tokens ({sum(sizes)}, the text's {want} bytes with "
          f"bos and eos), dtype {dtype}, COMPLETE {os.path.exists(os.path.join(shards, 'COMPLETE'))}, a second run "
          f"left them as they were: {same}; {time.perf_counter() - t0:.2f} s", flush=True)
    check(len(files) >= 2 and sum(sizes) == want and dtype == "uint16" and same, "tokenize_data's shards")
    argv = ["--model", PRETRAIN_MODEL, "--quantize", "mixed_precision", "--activation_checkpointing",
            "--batch_size", str(TRAIN_B), "--seq_len", str(TRAIN_S), "--log_interval", "1", "--seed", str(seed),
            "--train_ds", json.dumps({"type": "token", "dataset_dir": shards}), "--n_steps", "2",
            "--ckpt_interval", "2", "--save_dir", PRETRAIN_SAVE, "--run_name", "tokenized", *device_args()]
    with StepLaunches(pretrain_per_step_launches(cfg, TOKENS)) as counter:
        out, seconds = run_driver(llm_pretrain.main, argv)
    pretrain_report("llm_pretrain on the tokenized shards", out, seconds, phase=17)
    check(counter.steps == 2, f"2 pretrain steps ran: {counter.steps}")
    ckpt = os.path.join(out["save_dir"], "last.pkl")
    del out
    torch.cuda.empty_cache()
    return ckpt, counter.total


def finetune_rows(seed: int) -> list:
    """12 ``{"query", "response"}`` rows whose templates run to about 200,
    700 and 1,900 bytes: 9 short, 2 of the middle length, 1 long, so that
    the padded batches take several lengths."""
    rng = np.random.default_rng(seed)
    words = lambda n: " ".join(rng.choice(WORDS, n))
    return [{"query": words(4), "response": words(n)} for n in [2] * 9 + [80] * 2 + [280]]


def finetune(seed: int, cfg: llama.LlamaConfig, init_ckpt: str) -> tuple[str, dict, object]:
    """Phase 17 (b): ``llm_finetune --init_ckpt`` (a)'s checkpoint at the
    470m, byte-tokenized local rows, int8 ``mixed_precision``, batch 4,
    ``adamw_bf16_sr``, ``FINETUNE_STEPS`` steps: the first step enters with
    the checkpoint's parameters bit for bit, the padded lengths take at
    least 3 values in 256-2048, every step launches
    ``finetune_per_step_launches`` at its length, every loss is finite, and
    the model-only checkpoint holds the final parameters. Prints tokens/s
    and the wall of each step (the driver's, between its logs). Returns the
    checkpoint, the launches and the final parameters."""
    path = os.path.join(TASK_DIR, "finetune.jsonl")
    with open(path, "w") as f:
        f.writelines(json.dumps(r) + "\n" for r in finetune_rows(seed))
    samples = llm_finetune.load_samples(argparse.Namespace(dataset=path, max_seq_len=2048, model_kwargs={}),
                                        get_tokenizer("byte"))
    it = llm_finetune.data_iter(samples, FINETUNE_B, 256, seed)
    lengths = [next(it)[0].shape[1] for _ in range(FINETUNE_STEPS)]
    print(f"[17] finetune rows of {sorted(len(s) for s in samples)} tokens; padded lengths by step {lengths}")
    check(len(set(lengths)) >= 3, f"the finetune batches take at least 3 lengths: {lengths}")
    saved = load_checkpoint(init_ckpt, DEVICE)["state"][0]
    n_leaves = len(tree_leaves(quant.virtual_params(saved)))
    entered = []

    def before(state, tokens, labels, lr, key):
        if not entered:
            entered.append(same_leaves(state.params, saved))

    expect = lambda state, tokens, *rest: finetune_per_step_launches(cfg, tokens.shape[0], tokens.shape[1], n_leaves)
    argv = ["--model", PRETRAIN_MODEL, "--init_ckpt", init_ckpt, "--dataset", path, "--tokenizer", "byte",
            "--quantize", "mixed_precision", "--batch_size", str(FINETUNE_B), "--optim", "adamw_bf16_sr",
            "--n_steps", str(FINETUNE_STEPS), "--log_interval", "1", "--ckpt_interval", str(FINETUNE_STEPS),
            "--seed", str(seed), "--run_name", "chip_smoke", *device_args()]
    with StepLaunches(expect, before) as counter:
        out, seconds = run_driver(llm_finetune.main, argv)
    del saved
    rows = [json.loads(l) for l in open(os.path.join(out["save_dir"], "metrics.jsonl"))]
    for r in rows:
        print(f"[17] llm_finetune step {r['step']}: seq_len {r['seq_len']}, loss {r['loss']:.6f}, grad norm "
              f"{r['grad_norm']:.4f}, {1e3 / r['steps_per_second']:.1f} ms, "
              f"{FINETUNE_B * r['seq_len'] * r['steps_per_second']:.1f} tokens/s")
    print(f"[17] llm_finetune: the first step entered with the checkpoint's parameters bit for bit: {entered}; "
          f"{seconds:.1f} s", flush=True)
    check(entered == [True], "llm_finetune --init_ckpt loads the checkpoint's parameters bit for bit")
    check(counter.steps == FINETUNE_STEPS and [r["seq_len"] for r in rows] == lengths,
          f"{FINETUNE_STEPS} finetune steps at {lengths}")
    check(all(np.isfinite(r["loss"]) for r in rows), "finite finetune losses")
    ckpt = os.path.join(out["save_dir"], "last.pkl")
    model = load_checkpoint(ckpt, DEVICE)
    check(set(model) == {"state", "meta"} and set(model["state"]) == {"params"} and
          model["meta"] == {"step": FINETUNE_STEPS} and same_leaves(model["state"]["params"], out["state"].params),
          "the model-only checkpoint holds the final parameters")
    final = out["state"].params
    del out, model
    torch.cuda.empty_cache()
    return ckpt, counter.total, final


def hellaswag_rows(seed: int, n: int) -> list:
    """HellaSwag rows in the hub's schema, every ending's sequence at most
    193 bytes."""
    rng = np.random.default_rng(seed)
    words = lambda lo, hi: " ".join(rng.choice(WORDS, int(rng.integers(lo, hi))))
    return [{"activity_label": words(1, 3).capitalize(), "ctx_a": words(4, 10) + " [title]", "ctx_b": words(1, 5),
             "endings": [words(1, 9) for _ in range(4)], "label": int(rng.integers(0, 4))} for _ in range(n)]


def arc_piqa_rows(seed: int, n: int) -> list:
    """Rows that hold an ARC row (HF schema: ``question``, ``choices``
    {``text``, ``label``}, ``answerKey``) and a PIQA row (``goal``, ``sol1``,
    ``sol2``, ``label``) at once: one ``--task_data`` for both tasks."""
    rng = np.random.default_rng(seed)
    words = lambda lo, hi: " ".join(rng.choice(WORDS, int(rng.integers(lo, hi))))
    rows = []
    for _ in range(n):
        k = int(rng.integers(3, 6))
        rows.append({"question": words(3, 9) + "?", "choices": {"text": [words(1, 6) for _ in range(k)],
                                                                "label": list("ABCDE"[:k])},
                     "answerKey": "ABCDE"[int(rng.integers(0, k))], "goal": words(2, 7), "sol1": words(1, 9),
                     "sol2": words(1, 9), "label": int(rng.integers(0, 2))})
    return rows


def write_task_sets(seed: int, cfg: llama.LlamaConfig) -> dict:
    """Phase 17's task files: 16 HellaSwag rows, 16 ARC/PIQA rows, 32 rows
    of the Markov set over ``cfg``'s vocabulary (48 + 8 tokens)."""
    paths = {k: os.path.join(TASK_DIR, f"{k}.jsonl") for k in ("hellaswag", "arc_piqa", "mc")}
    for k, rows in (("hellaswag", hellaswag_rows(seed, 16)), ("arc_piqa", arc_piqa_rows(seed + 1, 16))):
        with open(paths[k], "w") as f:
            f.writelines(json.dumps(r) + "\n" for r in rows)
    mc_eval.generate_markov_mc(paths["mc"], n_rows=32, vocab_size=cfg.vocab_size, seed=seed)
    return paths


class ForwardLaunches:
    """While it is entered, every ``llama.forward`` checks its launches
    against ``eval_forward_launches`` at its tokens' shape and adds them to
    ``total``."""

    def __init__(self, cfg: llama.LlamaConfig):
        self.cfg, self.calls, self.shapes = cfg, 0, set()
        self.total = dict.fromkeys(ops.KERNELS, 0)

    def __enter__(self):
        self.forward = llama.forward

        def forward(params, tokens, cfg, key=None):
            ops.reset_launch_counts()
            out = self.forward(params, tokens, cfg, key)
            counts, want = ops.launch_counts(), eval_forward_launches(self.cfg, *tokens.shape)
            self.calls += 1
            self.shapes.add(tuple(tokens.shape))
            check(counts == want, f"predict batch {self.calls} {list(tokens.shape)} launches {counts} == {want}")
            self.total = {k: self.total[k] + v for k, v in counts.items()}
            return out

        llama.forward = forward
        return self

    def __exit__(self, *exc):
        llama.forward = self.forward


def evaluate_tasks(cfg: llama.LlamaConfig, ckpt: str, final, paths: dict) -> dict:
    """Phase 17 (c): ``llm_evaluate --ckpt`` (b)'s model-only checkpoint,
    ``--tasks hellaswag arc piqa`` with the byte tokenizer, then ``--tasks
    mc`` on the Markov set with ``--hellaswag_tokenizer ints``, batch 8: the
    loaded parameters are (b)'s final ones bit for bit, each predict batch
    launches ``eval_forward_launches`` at its shape, the accuracies lie in
    [0, 1]. Returns the launches."""
    results = {}
    with ForwardLaunches(cfg) as counter:
        for extra in (["--tasks", "hellaswag", "arc", "piqa", "--hellaswag_data", paths["hellaswag"], "--task_data",
                       paths["arc_piqa"], "--hellaswag_tokenizer", "byte"],
                      ["--tasks", "mc", "--task_data", paths["mc"], "--hellaswag_tokenizer", "ints"]):
            out, seconds = run_driver(llm_evaluate.main, ["--model", PRETRAIN_MODEL, "--quantize", "mixed_precision",
                                                          "--ckpt", ckpt, "--batch_size", "8", *extra,
                                                          *device_args()])
            same = same_leaves(out["params"], final)
            print(f"[17] llm_evaluate {' '.join(extra[1:extra.index('--hellaswag_tokenizer') + 2])}: "
                  f"{out['results']}; loaded parameters bit-identical to the finetune's final ones: {same}; "
                  f"{seconds:.1f} s", flush=True)
            check(same, "llm_evaluate loads the finetune checkpoint bit for bit")
            results.update(out["results"])
            del out
    print(f"[17] {counter.calls} predict batches at {sorted(counter.shapes)}, each launching exactly "
          "eval_forward_launches")
    check(set(results) == {"hellaswag_acc", "arc_acc", "piqa_acc", "mc_acc"} and
          all(0.0 <= v <= 1.0 for v in results.values()), f"four task accuracies: {results}")
    torch.cuda.empty_cache()
    return counter.total


def tasks_vs_plain(seed: int, base: llama.LlamaConfig, paths: dict) -> None:
    """Phase 17 (c), a 2-layer cut of the 470m (full width, weights from
    ``seed``, int8 ``mixed_precision``): the per-choice summed losses of the
    Markov set's first 8 rows ([32, 55] tokens: the fused norm and MLP, the
    o-projection unfused at S 55) and of 4 HellaSwag rows ([16, 192]: every
    op fused) on the card against the CPU's plain path. Bounds: relative
    RMS of the difference <= ``CUT_MAX_RMS``; argmins equal on at least
    ``CUT_MIN_AGREE`` of the rows."""
    cfg = dataclasses.replace(base, num_hidden_layers=2)
    raw = llama.init_params(torch.Generator(device=DEVICE).manual_seed(seed), cfg)
    to_cpu = lambda t: {k: to_cpu(v) for k, v in t.items()} if isinstance(t, dict) else t.cpu()
    p = {DEVICE: quant.quantize_params(raw, "mixed_precision"),
         "cpu": quant.quantize_params(to_cpu(raw), "mixed_precision")}
    rows = mc_eval.load_rows(paths["mc"])[:8]
    mc = [torch.from_numpy(a) for a in mc_eval.tokenize_mc(rows, mc_eval.FORMATS["mc"], mc_eval.int_tokenizer)]
    hs, _ = hellaswag.tokenize_rows(hellaswag._load_rows("validation", paths["hellaswag"])[:4], get_tokenizer("byte"))
    hs = torch.from_numpy(hs)
    for what, fn in (("Markov mc", lambda dev: mc_eval.choice_losses(p[dev], cfg, mc[0].to(dev), mc[1].to(dev),
                                                                       mc[3].to(dev))),
                     ("HellaSwag", lambda dev: hellaswag.choice_losses(p[dev], cfg, hs.to(dev)))):
        got, ref = fn(DEVICE).cpu().double(), fn("cpu").double()
        rms = ((got - ref).norm() / ref.norm()).item()
        agree = (got.argmin(-1) == ref.argmin(-1)).double().mean().item()
        gaps = ref.sort(-1).values
        print(f"[17] 2-layer Llama-2-470m {what} per-choice losses {list(ref.shape)}, kernels on the card vs plain on "
              f"the CPU: relative RMS {rms:.3e} (bound {CUT_MAX_RMS:g}), largest difference "
              f"{(got - ref).abs().max().item():.4f}, smallest gap between a row's two best "
              f"{(gaps[:, 1] - gaps[:, 0]).min().item():.4f}; argmin agree {agree:.3f} (bound {CUT_MIN_AGREE:g})")
        check(rms <= CUT_MAX_RMS and agree >= CUT_MIN_AGREE, f"{what} losses of the 2-layer cut within the bounds")


def parity_on_card() -> dict:
    """Phase 17 (d): ``accuracy_parity`` at ``PARITY_STEPS`` steps and 400
    rows: bf16's accuracy >= ``PARITY_MIN_BF16``; each quantized
    configuration's within ``PARITY_MAX_DACC`` of bf16's and its final loss
    within ``PARITY_MAX_DLOSS`` nats. Returns the launches."""
    ops.reset_launch_counts()
    out, seconds = run_driver(accuracy_parity.main, ["--steps", str(PARITY_STEPS), "--out",
                                                     os.path.join(PRETRAIN_SAVE, "parity", "parity.json"),
                                                     *device_args()])
    launches = ops.launch_counts()
    res = out["results"]
    bf16 = res[0]
    for r in res:
        print(f"[17] accuracy_parity {r['config']}: accuracy {r['accuracy']:.4f}, final loss {r['final_loss']:.6f}, "
              f"{r['train_s']} s (train and eval)")
    print(f"[17] accuracy_parity, {PARITY_STEPS} steps, {out['eval_rows']} rows: {seconds:.1f} s", flush=True)
    check(bf16["config"] == "bf16" and bf16["accuracy"] >= PARITY_MIN_BF16, f"bf16's accuracy {bf16['accuracy']}")
    for r in res[1:]:
        check(abs(r["accuracy"] - bf16["accuracy"]) <= PARITY_MAX_DACC and
              abs(r["final_loss"] - bf16["final_loss"]) <= PARITY_MAX_DLOSS,
              f"{r['config']} within {PARITY_MAX_DACC} of bf16's accuracy and {PARITY_MAX_DLOSS} of its loss")
    return launches


def tasks_phase(seed: int) -> dict:
    """Phase 17: (a) tokenize and pretrain, (b) finetune, (c) evaluate and
    the 2-layer cut, (d) accuracy parity; prints its seconds, removes its
    files. Returns the launches of (a)-(d)."""
    t0 = time.perf_counter()
    for d in (PRETRAIN_SAVE, TASK_DIR):
        shutil.rmtree(d, ignore_errors=True)
    os.makedirs(TASK_DIR)
    base = llama.LlamaConfig.from_hf_json(PRETRAIN_MODEL)
    cfg = dataclasses.replace(base, remat=True, max_position_embeddings=TRAIN_S)
    finetune_dir = None
    try:
        ckpt, pretrained = tokenize_and_pretrain(seed, cfg)
        ckpt, finetuned, final = finetune(seed, cfg, ckpt)
        finetune_dir = os.path.dirname(ckpt)
        paths = write_task_sets(seed, cfg)
        evaluated = evaluate_tasks(cfg, ckpt, final, paths)
        del final
        tasks_vs_plain(SEED, base, paths)
        t1 = time.perf_counter()
        parity = parity_on_card()
        print(f"[17] (a)-(c) {t1 - t0:.1f} s, (d) {time.perf_counter() - t1:.1f} s", flush=True)
    finally:
        for d in (PRETRAIN_SAVE, TASK_DIR, finetune_dir):
            if d:
                shutil.rmtree(d, ignore_errors=True)
    launches = {k: pretrained[k] + finetuned[k] + evaluated[k] + parity[k] for k in pretrained}
    missing = [k for k in PRETRAIN_KERNELS + ("fused_adamw_update_sr",) if not launches[k]]
    check(not missing, f"phase 17 launched every kernel of its path, not {missing}")
    print(f"[17] tokenize, pretrain, finetune, evaluate, parity: {time.perf_counter() - t0:.1f} s", flush=True)
    return launches


# ---- phase 18: parallel/ (DP, FSDP, BitNet's 2-bit gather, TP serving, the
# sharded resume), llm_pretrain --mesh and the image sets, on one card ----

MESH_MODEL = "llama2-1b"  # (a)'s --model: CFG
# (a)'s depth, cut for time (each of its three processes builds the model and
# the two that save write its whole state): the script took 1,132.4 s of its
# 1,200 on a slow host with (a) at full depth
MESH_CLI_LAYERS = 8
MESH_SAVE = os.path.join("runs", "chip_smoke_mesh")
MESH_DIR = os.path.join("build", "chip_smoke_mesh")
MESH_S = 2048  # every mesh step's sequence
MESH_RANKS = 2  # gloo ranks sharing the card: NCCL refuses a second rank on one device
MESH_LR = 1e-4  # phase 8's
# (b)'s and (h)'s gaps to one process. Every quantization maximum spans
# the mesh's token axis, so a rank's int8 operands are its rows of the
# one-process step's; only the gradients' sums over the ranks run in another
# order, as in the bf16 mesh step (tests/test_torch_parallel_ranks.py holds
# that at 2e-3 in loss, 1e-3 in grad norm). JAX's bound for a sharded step
# against one device is 0.05 (tests/test_parallel.py:70-86); before the
# maxima spanned the mesh, 4 layers measured 1.656e-3 in loss, 4.8e-4 in
# grad norm (PERF.md). The pre-clip grad norm sees a gradient counted
# twice, not divided by data x fsdp, or a replicated leaf's square summed
# once a rank (sqrt(2) or more), which AdamW's update and so the loss do not.
# From the second step on, weights that the first step moved apart (a
# gradient near 0 of either sign) move the norms too: 2.5e-3 at most in
# the CPU rehearsal at hidden 128
MESH_BOUND = 5e-3
MESH_NORM_RTOL = 5e-3
BITNET_BOUND = 1e-3  # JAX's for the 2-bit all-gather linear (tests/test_parallel.py:100-111)
TP_BOUND = 0.05  # JAX's for TP logits (tests/test_parallel.py:159-186)
TP_PROMPTS, TP_PROMPT_LEN, TP_NEW = 4, 128, 32
# depth cut for time in (b)-(e), (h), (i) and (f)'s ViT, full width ((a)
# at MESH_CLI_LAYERS): with (d) at 11 layers, (e) at 4, (i) at 4 and (f)'s ViT at
# 40 blocks phase 18 took 348.3 s inside the whole script (the script
# 1,120.3 s of its 1,200), on an H100 80GB HBM3 at 700 W (PERF.md section 6);
# with (d) at 8 layers and phases 8 and 19 grown, the script took 1,032.7 s
# on a slow host, so (d) runs at 4
MESH_LAYERS = 4
TP_LAYERS = 4
BITNET_LAYERS = 4
RESUME_LAYERS = 2
PREQUANT_MESH_LAYERS = 2
IMAGE_VIT_BLOCKS = 10
IMAGE_B, WDS_IMAGES, HF_IMAGES = 32, 256, 64
IMAGE_SIZES = ((320, 240), (500, 375))
GLOO_TIMEOUT_S = 300
COLLECTIVES_KEYS = {"psum_GiBps", "all_gather_GiBps", "psum_scatter_GiBps"}  # benchmark_collectives.py's JSON


def mesh_cfg(plan: dict, **overrides) -> llama.LlamaConfig:
    """The plan's Llama (Llama2-1B on the card) as the mesh steps run it:
    remat, SDPA, ``MESH_LAYERS`` layers unless ``overrides`` say."""
    return dataclasses.replace(plan["cfg"], remat=True, attention_impl="auto",
                               **{"num_hidden_layers": min(MESH_LAYERS, plan["cfg"].num_hidden_layers), **overrides})


def mesh_batch(plan: dict) -> tuple:
    """The global batch [MESH_RANKS, seq] of every mesh step, from the
    plan's seed (labels: the tokens shifted by one)."""
    shape = (MESH_RANKS, plan["seq"])
    tokens = torch.from_numpy(np.random.default_rng(plan["seed"]).integers(0, plan["cfg"].vocab_size, shape))
    return tokens, torch.roll(tokens, -1, dims=-1)


def mesh_plan(seed: int, key: int) -> dict:
    """What the ranks' processes need to know (they import this script
    afresh): the device, the model, the sequence, the seed and key, the
    parameter leaves (B6 runs once each) and whether launches are counted
    (a kernel launches only on the card)."""
    small = dataclasses.replace(CFG, vocab_size=8, hidden_size=64, intermediate_size=64, num_hidden_layers=1,
                                num_attention_heads=1, num_key_value_heads=1)  # the leaves, not their sizes
    n_leaves = len(tree_leaves(llama.init_params(torch.Generator().manual_seed(0), small)))
    return dict(device=DEVICE, device_type="cpu" if DEVICE == "cpu" else "cuda", cfg=CFG, seq=MESH_S, seed=seed,
                key=key, n_leaves=n_leaves, tp_prompt=TP_PROMPT_LEN, tp_new=TP_NEW, counted=DEVICE != "cpu")


def sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def fingerprint(t: torch.Tensor) -> int:
    """An exact digest of a tensor's bytes (a position-weighted sum of its
    bytes in int64, in chunks): equal tensors give equal digests, a moved
    bit a different one."""
    b = t.detach().contiguous().reshape(-1).view(torch.uint8)
    total, chunk = 0, 1 << 26
    for i in range(0, b.numel(), chunk):
        part = b[i:i + chunk].to(torch.int64)
        w = torch.arange(i, i + part.numel(), device=part.device, dtype=torch.int64) % 65521 + 1
        total = (total + int((part * w).sum()) + int(part.sum()) * 7919) % (1 << 61)
    return total


def state_tensors(state) -> list:
    out = []
    map_tensors(out.append, state)
    return out


def pretrain_child() -> None:
    """Phase 18 (a)'s child process: ``llm_pretrain``'s command line
    (``main`` on the arguments after the output path) under
    ``torch.use_deterministic_algorithms`` (the card's attention backward in
    a fixed order), writing each step's launches to that path as JSON."""
    out, argv = sys.argv[1], sys.argv[2:]
    torch.use_deterministic_algorithms(True)
    steps, make = [], train.make_train_step

    def counted_make(*args, **kwargs):
        step = make(*args, **kwargs)

        def counted(*step_args):
            ops.reset_launch_counts()
            result = step(*step_args)
            steps.append(ops.launch_counts())
            return result

        return counted

    train.make_train_step = counted_make
    llm_pretrain.main(argv)
    with open(out, "w") as f:
        json.dump(steps, f)


def pretrain_cli(name: str, argv: list, env: dict) -> tuple:
    """``python -m quantized_training_tpu_torch.llm_pretrain argv`` through
    :func:`pretrain_child`: (losses by step, each step's launches, tokens/s
    by step, its run directory, its seconds)."""
    out = os.path.join(MESH_DIR, f"{name}.json")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", "import chip_smoke; chip_smoke.pretrain_child()", out, *argv,
                           "--run_name", name], env=env, cwd=os.path.dirname(os.path.abspath(__file__)),
                          capture_output=True, text=True, timeout=600)
    check(proc.returncode == 0, f"llm_pretrain {name}: {proc.stdout[-2000:]}{proc.stderr[-4000:]}")
    run = next(p for p in sorted(os.listdir(MESH_SAVE)) if p.endswith(f"_{name}"))
    rows = [json.loads(l) for l in open(os.path.join(MESH_SAVE, run, "metrics.jsonl"))]
    with open(out) as f:
        launches = json.load(f)
    return ({r["step"]: r["loss"] for r in rows}, launches, {r["step"]: r["tokens_per_second"] for r in rows},
            os.path.join(MESH_SAVE, run), time.perf_counter() - t0)


def mesh_cli(seed: int) -> dict:
    """Phase 18 (a): ``llm_pretrain --mesh '{"fsdp": 1}'`` under NCCL at
    world 1 (``RANK=0 WORLD_SIZE=1``), Llama2-1B at full width and
    ``MESH_CLI_LAYERS`` layers,
    int8 ``mixed_precision``, remat, batch 2 x 2048 of Markov tokens,
    ``adamw_bf16_sr`` without SR: 3 steps with a checkpoint at step 2 (the
    rank's ``last_0.pkl``), then ``--resume`` from it to step 3; and the
    same command without ``--mesh``. At world 1 every collective is an
    identity: the losses and every step's launches equal the no-mesh run's
    bit for bit, and the resumed step 3 the uninterrupted one. Returns the
    mesh runs' launches."""
    common = ["--model", MESH_MODEL, "--model_kwargs", json.dumps({"num_hidden_layers": MESH_CLI_LAYERS}),
              "--quantize", "mixed_precision", "--activation_checkpointing",
              "--batch_size", "2", "--seq_len", str(MESH_S), "--optim", "adamw_bf16_sr", "--optim_kwargs",
              json.dumps({"bf16_stochastic_rounding": False}), "--lr", str(MESH_LR), "--log_interval", "1",
              "--seed", str(seed), "--save_dir", MESH_SAVE,
              "--train_ds", json.dumps({"type": "markov", "vocab_size": CFG.vocab_size}), *device_args()]
    here = os.path.dirname(os.path.abspath(__file__))
    env = {**os.environ, "CUBLAS_WORKSPACE_CONFIG": ":4096:8", "PYTHONPATH": here}
    ranked = {**env, "RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0", "MASTER_ADDR": "localhost"}
    plain = pretrain_cli("plain", [*common, "--n_steps", "3"], env)
    meshed = pretrain_cli("mesh", [*common, "--n_steps", "3", "--ckpt_interval", "2", "--mesh", '{"fsdp": 1}'],
                          {**ranked, "MASTER_PORT": str(free_port())})
    files = sorted(os.listdir(meshed[3]))
    resumed = pretrain_cli("resumed", [*common, "--n_steps", "3", "--mesh", '{"fsdp": 1}', "--resume",
                                       os.path.join(meshed[3], "last_0.pkl")],
                           {**ranked, "MASTER_PORT": str(free_port())})
    for name, run in (("no mesh", plain), ("mesh", meshed), ("mesh resumed", resumed)):
        print(f"[18] (a) llm_pretrain {name}: losses {run[0]}, tokens/s by step {run[2]} (the driver's, after a "
              f"sync; a step after a checkpoint counts its save), {run[4]:.1f} s (a process: start, init, steps)",
              flush=True)
    print(f"[18] (a) the mesh run's files {files}; launches a step "
          f"{ {k: v for k, v in meshed[1][0].items() if v} }")
    check("last_0.pkl" in files, "llm_pretrain --mesh wrote the rank's last_0.pkl")
    check(meshed[0] == plain[0], f"--mesh at world 1 gives the no-mesh losses bit for bit: {meshed[0]} {plain[0]}")
    check(meshed[1] == plain[1], "--mesh at world 1 launches what the no-mesh run launches, step for step")
    check(resumed[0] == {3: meshed[0][3]}, f"the resumed step 3 {resumed[0]} is the uninterrupted {meshed[0][3]}")
    check(resumed[1] == meshed[1][2:], "the resumed step launches what step 3 launched")
    return {k: sum(s[k] for s in meshed[1] + resumed[1]) for k in ops.KERNELS}


def step_launches(plan: dict, cfg: llama.LlamaConfig, mesh: bool = False, b6: bool = True) -> dict | None:
    """One int8 step's launches at ``cfg`` (B6 once a leaf, with ``b6``; on
    a mesh of two ranks with ``mesh``), or None where nothing is counted."""
    if not plan["counted"]:
        return None
    return per_step_launches(cfg.num_hidden_layers, b6=plan["n_leaves"] if b6 else 0, mesh=mesh)


def reference_steps(plan: dict) -> tuple:
    """(b)'s one-process run: the global batch on one process, 3 steps,
    each launching ``per_step_launches``; returns (losses, grad norms)."""
    cfg = mesh_cfg(plan)
    raw = llama.init_params(torch.Generator(device=DEVICE).manual_seed(SEED), cfg)
    tokens, labels = (t.to(DEVICE) for t in mesh_batch(plan))
    opt = optim.adamw_bf16_sr(bf16_stochastic_rounding=False)
    norms = []
    losses, walls, _ = run_steps(quant.quantize_params(raw, "mixed_precision"), cfg, tokens, labels, opt, MESH_LR,
                                 plan["key"], 3, step_launches(plan, cfg), norms, jit_compile=False)
    del raw
    torch.cuda.empty_cache()
    print(f"[18] (b) one process, {cfg.num_hidden_layers} layers, batch {MESH_RANKS} x {plan['seq']}: losses {losses}, "
          f"grad norms {norms}, step walls {[round(w, 3) for w in walls]} s", flush=True)
    return losses, norms


def rank_steps(mesh, cfg, plan: dict, scheme="mixed_precision", n_steps=3, expect=None, state=None, specs=None,
               start=0, opt=None):
    """``n_steps`` of the mesh step on this rank's rows of the global
    batch, from seed ``SEED``'s weights unless ``state`` and its layout
    ``specs`` are given (``opt``: AdamW with bf16 moments, no SR, by
    default); returns (state, specs, {"losses", "grad_norms",
    "maxima_all_reduces"} (the all-reduces of quantization maxima, all
    steps), walls, launches, staged collectives)."""
    opt = opt or optim.adamw_bf16_sr(bf16_stochastic_rounding=False)
    if state is None:
        raw = llama.init_params(torch.Generator(device=plan["device"]).manual_seed(SEED), cfg)
        qparams = quant.quantize_params(raw, scheme)
        if scheme == "bitnet":
            qparams = parallel.bitnet_fsdp_params(qparams, mesh)
        state, specs = parallel.shard_state(train.init_train_state(qparams, opt), mesh)
        del raw, qparams
        torch.cuda.empty_cache()
    step = train.make_train_step(cfg, opt, mesh=mesh, specs=specs, jit_compile=False)  # a mesh: eager
    tokens, labels = (t.to(plan["device"]) for t in parallel.shard_batch(mesh_batch(plan), mesh))
    metrics, walls, launches = dict(losses=[], grad_norms=[]), [], dict.fromkeys(ops.KERNELS, 0)
    parallel.reset_staged_collectives()
    parallel.collectives.reset_maxima_all_reduces()
    for i in range(start, start + n_steps):
        sync()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        state, m = step(state, tokens, labels, MESH_LR, random.fold_in(plan["key"], i))
        metrics["losses"].append(m["loss"].item())
        metrics["grad_norms"].append(m["grad_norm"].item())
        sync()
        walls.append(time.perf_counter() - t0)
        counts = ops.launch_counts()
        if expect is not None and plan["counted"]:
            want = expect(counts) if callable(expect) else expect
            check(counts == want, f"rank {mesh.dp_index} step {i + 1} launches {counts} == {want}")
        launches = {k: launches[k] + v for k, v in counts.items()}
    metrics["maxima_all_reduces"] = parallel.collectives.maxima_all_reduces()
    return state, specs, metrics, walls, launches, parallel.staged_collectives()


def dp_fsdp(plan: dict, rank: int) -> dict:
    """(b): ``{"data": 2}`` and ``{"fsdp": 2}``, 3 steps each at local batch
    1 x 2048: each step's launches the one-process step's at 2,048 tokens,
    the replicated tensors of the state bit-identical across the ranks,
    under fsdp every stacked leaf half its bytes a rank."""
    out, cfg = {}, mesh_cfg(plan)
    for axes in ({"data": 2}, {"fsdp": 2}):
        name = next(iter(axes))
        mesh = parallel.make_mesh(axes, plan["device_type"])
        state, specs, metrics, walls, launches, staged = rank_steps(mesh, cfg, plan,
                                                                    expect=step_launches(plan, cfg, mesh=True))
        pairs, params = [], []
        map_tensors(lambda t, s: pairs.append((t, s)), state, specs)
        map_tensors(lambda t, s: params.append((t, s)), state.params, specs.params)
        everyone = [None] * MESH_RANKS
        dist.all_gather_object(everyone, [fingerprint(t) for t, _ in pairs])
        replicated = [i for i, (_, s) in enumerate(pairs) if s.dim is None]
        same = all(everyone[0][i] == other[i] for other in everyone[1:] for i in replicated)
        check(same, f"(b) {name}: every replicated tensor of the state is bit-identical across the ranks")
        stacked = [(t.numel() * t.element_size(), s) for t, s in params if t.ndim == 3]
        if name == "fsdp":
            check(all(s.dim == 1 and s.count == 2 for _, s in stacked), "(b) fsdp splits every stacked leaf in two")
        out[name] = dict(**metrics, walls=walls, staged=staged, launches=launches,
                         local_bytes=sum(t.numel() * t.element_size() for t, _ in pairs),
                         stacked_bytes=sum(b for b, _ in stacked), replicated=len(replicated), tensors=len(pairs))
        del state, pairs, params
        torch.cuda.empty_cache()
    return out


def bitnet_fsdp(plan: dict, rank: int) -> dict:
    """(c): ``bitnet_fsdp_linear`` at q's and gate's shapes, fp32, 2,048
    tokens over the two ranks, against the one-device BitNet linear at
    ``BITNET_BOUND``, with the ternary values that differ counted and the
    payload's bytes against bf16's; then 2 BitNet train steps at ``{"fsdp":
    2}`` (Llama2-1B width, ``BITNET_LAYERS`` layers): finite losses, K1 and
    K2 once per BitNet linear forward (7 a layer, twice under remat)."""
    mesh = parallel.make_mesh({"fsdp": 2}, plan["device_type"])
    gen = torch.Generator(device=plan["device"]).manual_seed(SEED + 18)
    D, F = plan["cfg"].hidden_size, plan["cfg"].intermediate_size
    out = {}
    for name, (O, I) in {"q": (D, D), "gate": (F, D)}.items():
        x = torch.randn(2048, I, generator=gen, device=plan["device"])
        w = torch.randn(O, I, generator=gen, device=plan["device"]) * 0.02
        rows, w_rows = x.chunk(2)[mesh.dp_index], w.chunk(2)[mesh.coords["fsdp"]]
        ops.reset_launch_counts()
        got = parallel.bitnet_fsdp_linear(rows, w_rows, mesh)
        counts = ops.launch_counts()
        ref = quant.qlinear(x, quant.BitNetWeight(w)).chunk(2)[mesh.dp_index]
        excess = ((got - ref).abs() - (BITNET_BOUND + BITNET_BOUND * ref.abs())).max().item()
        scale = parallel.collectives.all_reduce(w_rows.float().abs().mean(), mesh, "fsdp") / 2
        ternary = quant.quantize_bitnet_weight(w_rows, scale)
        whole = quant.quantize_bitnet_weight(w, quant.get_bitnet_scale(w)).chunk(2)[mesh.coords["fsdp"]]
        differ = int(parallel.collectives.all_reduce((ternary != whole).sum(), mesh, "fsdp"))
        out[name] = dict(max_abs_err=(got - ref).abs().max().item(), differ=differ, payload=w_rows.numel() // 4,
                         bf16=w_rows.numel() * 2)
        check(excess <= 0, f"(c) {name}: bitnet_fsdp_linear within rtol = atol = {BITNET_BOUND} of one device")
        check(not plan["counted"] or (counts["quantize_int8_rowwise"] == 1 and counts["scaled_mm_rhs_t"] == 1),
              f"(c) {name}: one K1 and one K2: {counts}")
    L = BITNET_LAYERS
    cfg = mesh_cfg(plan, bitnet=True, num_hidden_layers=L)
    # the remat replay quantizes all 7 inputs (down's node keeps its int8), but runs 6 products
    expect = lambda c: {**c, "quantize_int8_rowwise": 2 * 7 * L, "scaled_mm_rhs_t": 13 * L}
    _, _, metrics, walls, launches, staged = rank_steps(mesh, cfg, plan, scheme="bitnet", n_steps=2, expect=expect)
    check(all(np.isfinite(metrics["losses"])), f"(c) BitNet FSDP losses finite: {metrics['losses']}")
    out["train"] = dict(losses=metrics["losses"], walls=walls, staged=staged, launches=launches)
    return out


def nudged(params, generator: torch.Generator):
    """``params`` with every embedding element moved by one bf16 ulp of
    random sign: a one-rank model that differs from it only in rounding."""
    emb = params["embed"]["embedding"]
    sign = torch.where(torch.rand(emb.shape, generator=generator, device=emb.device) < 0.5, -1.0, 1.0)
    return {**params, "embed": {"embedding": (emb.float() + sign * emb.float().abs() * 2**-8).to(emb.dtype)}}


@torch.no_grad()
def prefill(params, cfg, prompt, max_len: int, mesh=None, specs=None) -> torch.Tensor:
    """Prefill logits (fp32) of ``prompt`` from an empty cache, under TP
    where ``mesh`` is given (``params`` then this rank's, ``specs`` their
    layout)."""
    cache = llama_infer.KVCache.zeros(cfg, prompt.shape[0], max_len, device=prompt.device)
    if mesh is not None:
        cache = parallel.shard_kv_cache(cache, mesh)
    return llama_infer.forward_with_cache(params, prompt, cache, 0, cfg, mesh=mesh, specs=specs).float()


def logit_gap(got, ref) -> dict:
    """Largest and mean |got - ref|, each prompt's largest, and the largest
    excess over rtol = atol = ``TP_BOUND`` (<= 0 within it)."""
    err = (got - ref).abs()
    return dict(max=err.max().item(), mean=err.mean().item(), prompt_max=err.flatten(1).amax(1).tolist(),
                excess=(err - (TP_BOUND + TP_BOUND * ref.abs())).max().item())


# (d)'s schemes whose row-parallel inputs K1 quantizes (int8 activations)
TP_K1_FORMS = ("int8 storage", "mixed_precision")


def tp_schemes(raw, cfg, plan: dict):
    """(d)'s models at TP_LAYERS: (name, parameters, config) of bf16, int8
    storage with int8 activations, int8 ``mixed_precision``, packed BitNet
    with its o and down norms (random weights of 1 + 0.1 N(0, 1)), int4
    weight-only, unpacked BitNet; each made when its turn comes."""
    yield "bf16", raw, cfg
    yield "int8 storage", quant.quantize_params(raw, "int8_quantized_training", activation="int8"), cfg
    yield "mixed_precision", quant.quantize_params(raw, "mixed_precision"), cfg
    bcfg = dataclasses.replace(cfg, bitnet=True)
    gen = torch.Generator(device=plan["device"]).manual_seed(SEED + 26)
    norms = {k: {"g": (1 + 0.1 * torch.randn(*v["g"].shape, generator=gen, device=plan["device"])).to(v["g"].dtype)}
             for k, v in with_bitnet_norms(raw, bcfg)["layers"].items() if k in ("o_norm", "down_norm")}
    bit = quant.quantize_params({**raw, "layers": {**raw["layers"], **norms}}, "bitnet")
    bit["layers"] = {k: {n: quant.BitNetPackedWeight.from_weight(w.data) if isinstance(w, quant.BitNetWeight) else w
                         for n, w in v.items()} for k, v in bit["layers"].items()}
    yield "BitNet packed, with its norms", bit, bcfg
    del bit
    yield "int4 weight-only", quant.quantize_params(raw, "int4_weight_only"), cfg
    # C9: an unpacked BitNet weight's abs-mean over the whole matrix under TP
    yield "BitNet unpacked", quant.quantize_params(raw, "bitnet"), cfg


def tp_serving(plan: dict, rank: int) -> dict:
    """(d): tensor-parallel serving at ``{"model": 2}``. At Llama2-1B's full
    width and ``TP_LAYERS`` layers, on bf16, on int8 storage with int8
    activations (K1 and K2, K2's decode stream too; the row-parallel
    inputs' K1 as its mesh forms), int8 ``mixed_precision`` (K1's mesh forms
    on both operands of o and down), packed BitNet with its o and down
    norms (their squares summed over ``model``) and int4 weight-only (split
    by its matrix), ``TP_PROMPTS`` prompts of
    ``TP_PROMPT_LEN`` tokens and ``TP_NEW`` new ones: the prefill logits'
    mean gap to one rank's, and each prompt's largest gap, no larger than
    the gaps that one bf16 ulp of the embedding makes on one rank (the
    model's rounding floor; both printed with their excess over rtol = atol
    = ``TP_BOUND``, which this width does not meet: ROADMAP C7), greedy
    agreement and tok/s; and unpacked BitNet (its abs-mean over the whole
    matrix, C9). At tests/test_parallel.py's TP model (hidden 128, 2 layers,
    prompts [2, 16]), bf16, int8 storage (weight-only, JAX's test, and
    with int8 activations, where a row-parallel input's K1 takes its row
    maxima all-reduced over ``model``), int8 ``mixed_precision`` and
    unpacked BitNet, each row-parallel linear summing its partial products
    before it rounds (C8): the prefill logits within rtol = atol =
    ``TP_BOUND`` of one rank's, JAX's bound."""
    mesh = parallel.make_mesh({"model": 2}, plan["device_type"])
    T, new = plan["tp_prompt"], plan["tp_new"]
    cfg = dataclasses.replace(plan["cfg"], max_position_embeddings=T + new,
                              num_hidden_layers=min(TP_LAYERS, plan["cfg"].num_hidden_layers))
    raw = llama.init_params(torch.Generator(device=plan["device"]).manual_seed(SEED), cfg)
    prompt = torch.from_numpy(np.random.default_rng(plan["seed"] + 18).integers(
        0, cfg.vocab_size, (TP_PROMPTS, T))).to(plan["device"])
    out = {}
    for name, params, scheme_cfg in tp_schemes(raw, cfg, plan):
        one = prefill(params, scheme_cfg, prompt, T + new)
        floor = prefill(nudged(params, torch.Generator(device=plan["device"]).manual_seed(SEED)), scheme_cfg, prompt,
                        T + new)
        with torch.no_grad():
            sync()
            t0 = time.perf_counter()
            ref_toks = llama_infer.generate(params, prompt, scheme_cfg, new)
            sync()
            one_seconds = time.perf_counter() - t0
            local, specs = parallel.shard_params_tp(params, mesh)
            ops.reset_launch_counts()  # TP's launches: its prefill and its generate
            parallel.collectives.reset_maxima_all_reduces()
            tp = prefill(local, scheme_cfg, prompt, T + new, mesh, specs)
            sync()
            t0 = time.perf_counter()
            toks = llama_infer.generate(local, prompt, scheme_cfg, new, mesh=mesh, specs=specs)
            sync()
            seconds = time.perf_counter() - t0
        gap, floor_gap = logit_gap(tp, one), logit_gap(floor, one)
        launches = ops.launch_counts()
        out[name] = dict(gap=gap, floor=floor_gap, tok_s=TP_PROMPTS * new / seconds, launches=launches,
                         one_tok_s=TP_PROMPTS * new / one_seconds, maxima=parallel.collectives.maxima_all_reduces(),
                         agree=(toks[:, T:] == ref_toks[:, T:]).float().mean().item())
        if plan["counted"] and name in TP_K1_FORMS:
            check(launches["quantize_int8_rowwise_maxima"] > 0 and launches["quantize_int8_rowwise_given"] > 0,
                  f"(d) {name}: the row-parallel inputs' K1 ran as its mesh forms: {launches}")
        check(gap["mean"] <= floor_gap["mean"], f"(d) {name}: TP's mean logit gap {gap} within one rank's rounding "
                                                f"floor {floor_gap}")
        check(all(a <= b for a, b in zip(gap["prompt_max"], floor_gap["prompt_max"])),
              f"(d) {name}: each prompt's largest TP logit gap {gap['prompt_max']} within the floor's "
              f"{floor_gap['prompt_max']}")
        del local
    small = llama.LlamaConfig(vocab_size=256, hidden_size=128, intermediate_size=128, num_hidden_layers=2,
                              num_attention_heads=4, num_key_value_heads=4, max_position_embeddings=48)
    raw = llama.init_params(torch.Generator(device=plan["device"]).manual_seed(SEED), small)
    prompt = torch.from_numpy(np.random.default_rng(plan["seed"] + 1).integers(0, 256, (2, 16))).to(plan["device"])
    for name, params in (("bf16", raw), ("int8 storage", quant.quantize_params(raw, "int8_quantized_training")),
                         ("int8 storage, int8 activations",
                          quant.quantize_params(raw, "int8_quantized_training", activation="int8")),
                         ("mixed_precision", quant.quantize_params(raw, "mixed_precision")),
                         ("BitNet unpacked", quant.quantize_params(raw, "bitnet"))):
        local, specs = parallel.shard_params_tp(params, mesh)
        gap = logit_gap(prefill(local, small, prompt, 32, mesh, specs), prefill(params, small, prompt, 32))
        out[f"small {name}"] = gap
        check(gap["excess"] <= 0, f"(d) JAX's TP test model, {name}: logits within rtol = atol = {TP_BOUND} of one "
                                  f"rank's: {gap}")
    return out


def sharded_resume(plan: dict, rank: int) -> dict:
    """(e): at ``{"fsdp": 2}``, Llama2-1B width with ``RESUME_LAYERS``
    layers, under ``torch.use_deterministic_algorithms``: 5 steps against 3
    steps, each rank's ``last_{rank}.pkl``, a fresh state from other
    weights (the restart, in the same process) replaced by
    ``restore_sharded`` and 2 more steps; bit for bit on each rank's
    shards."""
    cfg = mesh_cfg(plan, num_hidden_layers=RESUME_LAYERS)
    mesh = parallel.make_mesh({"fsdp": 2}, plan["device_type"])
    torch.use_deterministic_algorithms(True)
    try:
        full, _, full_run, *_ = rank_steps(mesh, cfg, plan, n_steps=5)
        part, specs, *_ = rank_steps(mesh, cfg, plan, n_steps=3)
        path = checkpoint.checkpoint_name(MESH_DIR)
        checkpoint.save_checkpoint(path, {"state": part, "meta": {"step": 3}}, shard_arrays=specs)
        del part
        dist.barrier()
        fresh, specs = parallel.shard_state(train.init_train_state(
            quant.quantize_params(llama.init_params(torch.Generator(device=plan["device"]).manual_seed(SEED + 1), cfg),
                                  "mixed_precision"), optim.adamw_bf16_sr(bf16_stochastic_rounding=False)), mesh)
        del fresh
        state = checkpoint.restore_sharded(checkpoint.load_checkpoint(path)["state"], specs, plan["device"])
        resumed, _, resumed_run, *_ = rank_steps(mesh, cfg, plan, n_steps=2, state=state, specs=specs, start=3)
    finally:
        torch.use_deterministic_algorithms(False)
    full_losses, resumed_losses = full_run["losses"], resumed_run["losses"]
    same = all(torch.equal(a, b) for a, b in zip(state_tensors(full), state_tensors(resumed)))
    check(same and resumed_losses == full_losses[3:],
          f"(e) rank {rank}: 3 steps + restore + 2 equal 5 steps bit for bit ({resumed_losses} {full_losses})")
    return dict(full=full_losses, resumed=resumed_losses, file=os.path.basename(path), same=same)


SF8_REF = os.path.join(MESH_DIR, "sf8_reference.pt")
PREQUANT_MESH_STEPS = 2


def sf8_opt():
    return optim.get_optimizer("schedule_free_adamw_8bit")


def sf8_reference(plan: dict) -> tuple:
    """(h)'s one-process run: schedule-free with the 8-bit state, the global
    batch, 3 steps (no B6: the optimizer is plain torch); its 8-bit states'
    codes after the first step, in the tree's order, saved to ``SF8_REF``
    for the ranks' printed comparison. Returns (losses, grad norms)."""
    from quantized_training_tpu_torch.optim import OptimState8bit

    cfg = mesh_cfg(plan)
    raw = llama.init_params(torch.Generator(device=DEVICE).manual_seed(SEED), cfg)
    tokens, labels = (t.to(DEVICE) for t in mesh_batch(plan))
    opt = sf8_opt()
    state = train.init_train_state(quant.quantize_params(raw, "mixed_precision"), opt)
    del raw
    step = train.make_train_step(cfg, opt, jit_compile=False)  # phase 18 runs eagerly, as its mesh steps do
    losses, norms = [], []
    is8 = lambda t: isinstance(t, OptimState8bit)  # noqa: E731
    for i in range(3):
        state, m = step(state, tokens, labels, MESH_LR, random.fold_in(plan["key"], i))
        losses.append(m["loss"].item())
        norms.append(m["grad_norm"].item())
        if i == 0:
            codes = [l.codes.cpu() for l in tree_leaves(state.opt_state.exp_avg_sq, is_leaf=is8) if is8(l)]
            torch.save(codes, SF8_REF)
    del state
    torch.cuda.empty_cache()
    print(f"[18] (h) one process, schedule-free 8-bit: losses {losses}, grad norms {norms}, {len(codes)} 8-bit "
          f"states ({sum(c.numel() for c in codes):,} codes)", flush=True)
    return losses, norms


def sf8_codes_of(grads) -> list:
    """The codes of the one-process 8-bit ``exp_avg_sq`` after a first
    step on the global ``grads``: ``sf8_opt()``'s own step from its
    initial state (zero parameters stand in for the weights, which
    ``exp_avg_sq`` does not read), in the tree's order."""
    from quantized_training_tpu_torch.optim import OptimState8bit

    opt = sf8_opt()
    zeros = tree_map(torch.zeros_like, grads)
    _, state = opt.step(grads, opt.init(zeros), zeros, MESH_LR)
    is8 = lambda t: isinstance(t, OptimState8bit)  # noqa: E731
    return [l.codes for l in tree_leaves(state.exp_avg_sq, is_leaf=is8) if is8(l)]


def sf8_fsdp(plan: dict, rank: int) -> dict:
    """(h): schedule-free with the 8-bit ``exp_avg_sq`` at ``{"fsdp": 2}``
    (each rank's state its slice's codes and block scales). The first step,
    under deterministic algorithms and again without: the rank's 8-bit
    codes after it equal, bit for bit, the slice of the codes that the
    one-process 8-bit state quantizes from the same gradient, the ranks'
    gradient slices gathered (what the sharding must preserve: a rank
    requantizes its own whole blocks, and a block that crosses ranks from
    maxima all-reduced over fsdp). Their agreement with the independent
    one-process run (``SF8_REF``), whose gradient differs in the last bits
    of the card's attention backward and of its sums over ranks, is printed
    only. Then 2 more steps: losses and grad norms (held in
    ``report_ranks``), the launches of the mesh step without B6."""
    from quantized_training_tpu_torch.optim import OptimState8bit

    mesh = parallel.make_mesh({"fsdp": 2}, plan["device_type"])
    cfg = mesh_cfg(plan)
    expect = step_launches(plan, cfg, mesh=True, b6=False)
    is8 = lambda t: isinstance(t, OptimState8bit)  # noqa: E731
    ref = torch.load(SF8_REF)
    exact, agree, steps = {}, [], []
    for deterministic in (True, False):
        opt, seen = sf8_opt(), []

        def recorded(grads, *args, **kw):
            seen.append(grads)
            return opt.step(grads, *args, **kw)

        torch.use_deterministic_algorithms(deterministic)
        try:
            state, specs, metrics, walls, launches, staged = rank_steps(
                mesh, cfg, plan, n_steps=1, opt=optim.Optimizer(opt.init, recorded), expect=expect)
        finally:
            torch.use_deterministic_algorithms(False)
        pieces = [l for l in tree_leaves(state.opt_state.exp_avg_sq, is_leaf=is8) if is8(l)]
        layout = [l for l in tree_leaves(specs.opt_state.exp_avg_sq, is_leaf=is8) if is8(l)]
        check(len(pieces) == len(ref) and all(p.shard is not None for p in pieces),
              f"(h) rank {rank}: every 8-bit state split by its parameter ({len(pieces)} of {len(ref)})")
        gathered = parallel.fsdp.gather(seen[0], parallel.mesh.param_specs(specs), mesh)
        own = [c.cpu() for c in sf8_codes_of(gathered)]
        del seen, gathered
        same = [torch.equal(piece.codes.cpu(), spec.codes.take(codes))
                for piece, spec, codes in zip(pieces, layout, own)]
        exact["deterministic" if deterministic else "default"] = sum(same)
        check(all(same), f"(h) rank {rank}, deterministic algorithms {deterministic}: the codes of {sum(same)} of "
                         f"{len(same)} 8-bit states equal the one-process state's from the gathered gradient")
        if not deterministic:  # the independent run, printed
            for piece, spec, codes in zip(pieces, layout, ref):
                mine, theirs = piece.codes.int().cpu(), spec.codes.take(codes).int()
                agree.append((mine == theirs).float().mean().item())
                steps.append((mine - theirs).abs().max().item())
        codes = sum(p.codes.numel() for p in pieces)
        del pieces, layout, own
    del ref
    *_, more, more_walls, more_launches, _ = rank_steps(mesh, cfg, plan, n_steps=2, opt=sf8_opt(), expect=expect,
                                                        state=state, specs=specs, start=1)
    metrics = {k: metrics[k] + more[k] for k in metrics}
    launches = {k: launches[k] + more_launches[k] for k in launches}
    return dict(**metrics, walls=walls + more_walls, staged=staged, launches=launches, agree=min(agree),
                steps=max(steps), codes=codes, exact=exact, states=len(agree))


def prequant_fsdp(plan: dict, rank: int) -> dict:
    """(i): ``QT_PREQUANT`` '0', 'both' and 'col' at ``{"fsdp": 2}``,
    ``PREQUANT_MESH_LAYERS`` layers, ``PREQUANT_MESH_STEPS`` steps each
    under ``torch.use_deterministic_algorithms``
    (each rank makes its shards of the views, the maxima across ranks
    all-reduced, and gathers them in each layer): 'both' and 'col' give the
    '0' step's losses and grad norms bit for bit; 'both' runs B5's mesh
    forms on the weights (one a layer's weight) and the grads, 'col' B4's
    on the weights."""
    mesh = parallel.make_mesh({"fsdp": 2}, plan["device_type"])
    cfg = mesh_cfg(plan, num_hidden_layers=min(PREQUANT_MESH_LAYERS, plan["cfg"].num_hidden_layers))
    L, out = cfg.num_hidden_layers, {}
    torch.use_deterministic_algorithms(True)
    try:
        for mode in ("0", "both", "col"):
            with prequant_mode(mode):
                *_, metrics, walls, launches, staged = rank_steps(mesh, cfg, plan, n_steps=PREQUANT_MESH_STEPS)
            out[mode] = dict(**metrics, walls=walls, staged=staged, launches=launches)
            torch.cuda.empty_cache()
    finally:
        torch.use_deterministic_algorithms(False)
    for mode in ("both", "col"):
        same = (out[mode]["losses"] == out["0"]["losses"] and out[mode]["grad_norms"] == out["0"]["grad_norms"])
        check(same, f"(i) rank {rank}: QT_PREQUANT={mode} under fsdp gives the '0' step's losses and grad norms "
                    f"bit for bit: {out[mode]} {out['0']}")
    if plan["counted"]:
        n = PREQUANT_MESH_STEPS * L
        both, col = out["both"]["launches"], out["col"]["launches"]
        check(both["quantize_int8_both_maxima"] == both["quantize_int8_colwise_given"] == 12 * n
              and both["quantize_int8_both"] == 0,
              f"(i) 'both': B5's mesh forms once a layer's weight and once an output grad (12 a layer): {both}")
        check(col["quantize_int8_colwise_maxima"] == 7 * n and col["quantize_int8_colwise_given"] == 12 * n,
              f"(i) 'col': B4's maxima form once a layer's weight, the given column cast once a weight and once "
              f"an output grad (B5's): {col}")
    return out


def mesh_rank(rank: int, port: int, plan: dict) -> None:
    """One of the two gloo ranks of phase 18 (b)-(e), (g), both on the
    card: writes its results to ``MESH_DIR/rank{rank}.json``."""
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"  # (e)'s deterministic cuBLAS
    if plan["device"] != "cpu":
        torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank, world_size=MESH_RANKS,
                            timeout=timedelta(seconds=GLOO_TIMEOUT_S))
    out, seconds = {}, {}
    for part, fn in (("b", dp_fsdp), ("c", bitnet_fsdp), ("d", tp_serving), ("e", sharded_resume),
                     ("h", sf8_fsdp), ("i", prequant_fsdp)):
        t0 = time.perf_counter()
        out[part] = fn(plan, rank)
        seconds[part] = time.perf_counter() - t0
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    argv = ["--axis", "data", "--size_mb", "64", "--n_iters", "5"]
    if plan["counted"]:  # the command line on the card; its body where the rehearsal runs the ranks on the CPU
        out["g"] = benchmark_collectives.main(argv)
    else:
        out["g"] = benchmark_collectives.run(benchmark_collectives._parser().parse_args(argv), "cpu")[1]
    seconds["g"] = time.perf_counter() - t0
    out["seconds"] = seconds
    with open(os.path.join(MESH_DIR, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()


def report_ranks(ranks: list, ref: tuple, plan: dict, sf8_ref: tuple) -> None:
    """Phase 18 (b)-(e), (g)-(i)'s lines, from both ranks' results and the
    one-process runs' (losses, grad norms)."""
    r0 = ranks[0]
    ref_losses, ref_norms = ref
    for name in ("data", "fsdp"):
        runs = [r["b"][name] for r in ranks]
        gap = [abs(a - b) for a, b in zip(runs[0]["losses"], ref_losses)]
        norm_gap = [abs(a - b) / b for a, b in zip(runs[0]["grad_norms"], ref_norms)]
        print(f"[18] (b) {{'{name}': 2}}, {min(MESH_LAYERS, plan['cfg'].num_hidden_layers)} layers (depth cut for "
              f"time), local batch 1 x {plan['seq']}: losses {runs[0]['losses']} (rank 1 "
              f"{runs[1]['losses']}); one process {ref_losses}; gap a step {[f'{g:.3e}' for g in gap]} (bound "
              f"{MESH_BOUND}); grad norms "
              f"{runs[0]['grad_norms']} (one process {ref_norms}), relative gap {[f'{g:.3e}' for g in norm_gap]} "
              f"(bound {MESH_NORM_RTOL}); step walls "
              f"{[round(w, 3) for w in runs[0]['walls']]} s; staged collectives {runs[0]['staged']} in 3 steps, "
              f"{runs[0]['maxima_all_reduces'] / 3:.0f} a step of them the quantization maxima's; "
              f"state bytes a rank {runs[0]['local_bytes']:,} (stacked leaves {runs[0]['stacked_bytes']:,}); "
              f"{runs[0]['replicated']} of {runs[0]['tensors']} state tensors replicated, bit-identical; launches "
              f"a step the one-process step's at {plan['seq']} tokens", flush=True)
        check(all(r["losses"] == runs[0]["losses"] and r["grad_norms"] == runs[0]["grad_norms"] for r in runs),
              f"(b) {name}: every rank reports one global loss and grad norm")
        check(max(gap) < MESH_BOUND, f"(b) {name}: |dloss| < {MESH_BOUND} at every step: {gap}")
        check(max(norm_gap) < MESH_NORM_RTOL, f"(b) {name}: grad norm within rtol {MESH_NORM_RTOL} of one "
                                              f"process's at every step: {norm_gap}")
    dp, fs = r0["b"]["data"], r0["b"]["fsdp"]
    print(f"[18] (b) fsdp holds {fs['stacked_bytes'] / dp['stacked_bytes']:.4f} of the stacked leaves' bytes a rank "
          f"and {fs['local_bytes'] / dp['local_bytes']:.4f} of the state's")
    check(2 * fs["stacked_bytes"] == dp["stacked_bytes"], "(b) fsdp: half of every stacked leaf's bytes a rank")
    for name in ("q", "gate"):
        c = [r["c"][name] for r in ranks]
        print(f"[18] (c) bitnet_fsdp_linear at {name}'s shape, 2,048 tokens over 2 ranks, fp32: max |err| "
              f"{max(x['max_abs_err'] for x in c):.3e} (rtol = atol = {BITNET_BOUND}); ternary values that differ "
              f"from the one-device ternarization {c[0]['differ']}; payload a rank {c[0]['payload']:,} bytes against "
              f"bf16's {c[0]['bf16']:,} ({c[0]['bf16'] / c[0]['payload']:.0f}x fewer)")
    t = r0["c"]["train"]
    print(f"[18] (c) BitNet FSDP train step, Llama2-1B width, {BITNET_LAYERS} layers (depth cut for time): losses "
          f"{t['losses']} (rank 1 {ranks[1]['c']['train']['losses']}); K1 and K2 a step "
          f"{t['launches']['quantize_int8_rowwise'] // 2} and {t['launches']['scaled_mm_rhs_t'] // 2} (7 BitNet "
          f"linears a layer, twice under remat); staged collectives {t['staged']}; step walls "
          f"{[round(w, 3) for w in t['walls']]} s")
    fmt = lambda g: (f"max {g['max']:.4e}, mean {g['mean']:.4e}, each prompt's max "
                     f"{[round(x, 4) for x in g['prompt_max']]}, excess over rtol = atol = {TP_BOUND} "
                     f"{g['excess']:.4e}")
    for name, d in r0["d"].items():
        if name.startswith("small"):
            continue
        print(f"[18] (d) TP serving {{'model': 2}}, {name}, {min(TP_LAYERS, plan['cfg'].num_hidden_layers)} layers "
              f"(depth cut for time), {TP_PROMPTS} "
              f"prompts of {plan['tp_prompt']}, {plan['tp_new']} new: prefill logits against one rank: {fmt(d['gap'])};"
              f" one rank with its embedding one bf16 ulp off (the rounding floor): {fmt(d['floor'])}; greedy "
              f"tokens that agree {d['agree']:.4f}; {d['tok_s']:.1f} tok/s (one rank {d['one_tok_s']:.1f}); "
              f"maxima all-reduces {d['maxima']}; launches "
              f"(TP's prefill and generate) { {k: v for k, v in d['launches'].items() if v} }")
    for name in ("bf16", "int8 storage", "int8 storage, int8 activations", "mixed_precision", "BitNet unpacked"):
        print(f"[18] (d) JAX's TP test model (hidden 128, 2 layers), {name}: prefill logits against one rank "
              f"(o's and down's partial products summed before they round, C8): {fmt(r0['d'][f'small {name}'])}")
    e = [r["e"] for r in ranks]
    print(f"[18] (e) sharded resume at {{'fsdp': 2}}, Llama2-1B width, {RESUME_LAYERS} layers (depth cut for time): "
          f"files {[x['file'] for x in e]}; 5 steps {e[0]['full']}; 3 + restore + 2 {e[0]['resumed']}; bit for "
          f"bit on every rank's shards {[x['same'] for x in e]}")
    h = [r["h"] for r in ranks]
    sf8_losses, sf8_norms = sf8_ref
    gap = [abs(a - b) for a, b in zip(h[0]["losses"], sf8_losses)]
    norm_gap = [abs(a - b) / b for a, b in zip(h[0]["grad_norms"], sf8_norms)]
    print(f"[18] (h) schedule-free 8-bit at {{'fsdp': 2}}, {min(MESH_LAYERS, plan['cfg'].num_hidden_layers)} layers: "
          f"losses {h[0]['losses']} (one process {sf8_losses}), gap {[f'{g:.3e}' for g in gap]} (bound {MESH_BOUND}); "
          f"grad norms relative gap {[f'{g:.3e}' for g in norm_gap]} (bound {MESH_NORM_RTOL}); codes a rank "
          f"{h[0]['codes']:,}; after the first step, every rank's codes of its {h[0]['states']} 8-bit states equal "
          f"the one-process 8-bit state's from the ranks' gathered gradient, bit for bit, under deterministic and "
          f"default algorithms {[x['exact'] for x in h]}; against the independent one-process run (printed, not "
          f"held: its gradient differs in the last bits) agreeing {[round(x['agree'], 6) for x in h]}, largest step "
          f"{[x['steps'] for x in h]}; step walls {[round(w, 3) for w in h[0]['walls']]} s; maxima all-reduces a step "
          f"{h[0]['maxima_all_reduces'] / 3:.0f}", flush=True)
    check(all(x["losses"] == h[0]["losses"] for x in h), "(h) every rank reports one global loss")
    check(max(gap) < MESH_BOUND and max(norm_gap) < MESH_NORM_RTOL,
          f"(h) losses within {MESH_BOUND} and grad norms within rtol {MESH_NORM_RTOL} of one process's")
    i = r0["i"]
    print(f"[18] (i) QT_PREQUANT at {{'fsdp': 2}}, {min(PREQUANT_MESH_LAYERS, plan['cfg'].num_hidden_layers)} layers, "
          f"{PREQUANT_MESH_STEPS} steps, deterministic algorithms: "
          + "; ".join(f"{m} losses {v['losses']} walls {[round(w, 3) for w in v['walls']]} s maxima all-reduces "
                      f"{v['maxima_all_reduces']}" for m, v in i.items())
          + "; 'both' and 'col' equal '0' bit for bit on both ranks", flush=True)
    print(f"[18] (g) python -m quantized_training_tpu_torch.benchmark_collectives --axis data --size_mb 64 "
          f"--n_iters 5 on the 2 gloo ranks sharing one card, host-staged (not NCCL), GiB/s (rank 0's line): "
          + json.dumps(r0["g"]))
    check(set(r0["g"]) == COLLECTIVES_KEYS and all(v > 0 for v in r0["g"].values()),
          f"(g) the collectives line has JAX's three keys: {r0['g']}")
    print(f"[18] rank 0's seconds by part: { {k: round(v, 1) for k, v in r0['seconds'].items()} }", flush=True)


def write_images(path: str, n: int, seed: int, num_classes: int) -> None:
    """A WebDataset tar of ``n`` JPEGs (PIL, seeded pixels, 320 x 240 and
    500 x 375 by turns) with their ``cls``."""
    import io
    import tarfile

    from PIL import Image

    with tarfile.open(path, "w") as tar:
        for i in range(n):
            w, h = IMAGE_SIZES[i % 2]
            pixels = np.random.default_rng([seed, i]).integers(0, 256, (h, w, 3), dtype=np.uint8)
            buf = io.BytesIO()
            Image.fromarray(pixels).save(buf, format="JPEG", quality=90)
            for ext, payload in (("jpg", buf.getvalue()), ("cls", str(i % num_classes).encode())):
                info = tarfile.TarInfo(f"{i:06d}.{ext}")
                info.size = len(payload)
                tar.addfile(info, io.BytesIO(payload))


def image_sets(seed: int, key: int, cfg=None) -> dict:
    """Phase 18 (f): one WebDataset tar of ``WDS_IMAGES`` JPEGs and a local
    ``datasets`` folder of ``HF_IMAGES`` (a WebDataset-format tar, ``jpg``
    and ``cls`` columns), each streamed through ``train_transform`` on one
    host thread and batched by ``IMAGE_B`` into phase 11's ViT-Giant int8
    step (3 steps of the tar, 2 of the folder): finite losses, B18
    launched; the host pipeline's images/s beside the step's. Returns the
    steps' launches."""
    os.environ.setdefault("HF_DATASETS_OFFLINE", "1")
    os.environ.setdefault("HF_HUB_OFFLINE", "1")
    cfg = cfg or VIT_CFG
    folder = os.path.join(MESH_DIR, "images")
    os.makedirs(os.path.join(folder, "hf"), exist_ok=True)
    tar = os.path.join(folder, "train-000.tar")
    write_images(tar, WDS_IMAGES, seed, cfg.num_classes)
    write_images(os.path.join(folder, "hf", "train-000.tar"), HF_IMAGES, seed + 1, cfg.num_classes)
    rng = np.random.default_rng(seed)
    wds = data.get_dataset("wds", eval=True, urls=[tar], columns=["jpg", "cls"], transform={
        "jpg": lambda b: data.train_transform(data.decode_image(b), cfg.image_size, rng), "cls": int})
    hf = data.get_dataset("hf_image", eval=True, dataset=os.path.join(folder, "hf"), split="train",
                          transform=lambda im: data.train_transform(im, cfg.image_size, rng))
    streams = {"wds": (((s["jpg"], s["cls"]) for s in wds), 3, WDS_IMAGES),
               "hf_image": (iter(hf), 2, HF_IMAGES)}
    params = quant.quantize_params(vit.init_params(torch.Generator(device=DEVICE).manual_seed(SEED), cfg),
                                   "mixed_precision")
    opt = optim.adamw_bf16_sr(bf16_stochastic_rounding=False)
    step, state = vit_train.make_train_step(cfg, opt), opt.init(quant.virtual_params(params))
    launches, i = dict.fromkeys(ops.KERNELS, 0), 0
    for name, (it, n_batches, n_images) in streams.items():
        host, walls, losses = 0.0, [], []
        for _ in range(n_batches):
            t0 = time.perf_counter()
            samples = [next(it) for _ in range(IMAGE_B)]
            images = torch.from_numpy(np.stack([s[0] for s in samples])).to(DEVICE)
            labels = torch.tensor([s[1] for s in samples], device=DEVICE)
            host += time.perf_counter() - t0
            sync()
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            params, state, loss = step(params, state, images, labels, VIT_LR, random.fold_in(key, 1_000_000 + i))
            losses.append(loss.item())
            sync()
            walls.append(time.perf_counter() - t0)
            launches = {k: launches[k] + v for k, v in ops.launch_counts().items()}
            i += 1
        check(all(np.isfinite(losses)), f"(f) {name}: finite ViT losses {losses}")
        steps_ips = IMAGE_B * len(walls[1:]) / sum(walls[1:]) if len(walls) > 1 else float("nan")
        print(f"[18] (f) {name} ({n_images} JPEGs of {IMAGE_SIZES}, train_transform at {cfg.image_size}, batch "
              f"{IMAGE_B}) into ViT-Giant int8 ({cfg.num_layers} blocks): losses {losses}; host pipeline (decode, "
              f"crop, resize, flip, normalize; one thread) {n_batches * IMAGE_B / host:.1f} images/s; the step "
              f"{steps_ips:.1f} images/s after the first (walls {[round(w, 3) for w in walls]} s)", flush=True)
    if DEVICE != "cpu":
        check(launches["layernorm_quant_rowwise"] > 0 and launches["gelu_quant_rowwise"] > 0,
              f"(f) the ViT steps ran B18: {launches}")
    del params, state
    torch.cuda.empty_cache()
    return launches


def mesh_phase(seed: int, key: int, t_script: float) -> tuple[dict, dict]:
    """Phase 18: (a) llm_pretrain --mesh under NCCL at world 1, (b)-(e) and
    (g) on two gloo ranks sharing the card, (f) the image sets; prints the
    phase's seconds and the script's; removes its files. Returns the
    launches under the mesh ((a)-(e), both ranks) and (f)'s."""
    import torch.multiprocessing as mp

    t0 = time.perf_counter()
    for d in (MESH_SAVE, MESH_DIR):
        shutil.rmtree(d, ignore_errors=True)
    os.makedirs(MESH_DIR)
    try:
        launches = mesh_cli(seed)
        t_a = time.perf_counter()
        plan = mesh_plan(seed, key)
        ref = reference_steps(plan)
        sf8_ref = sf8_reference(plan)
        mp.spawn(mesh_rank, args=(free_port(), plan), nprocs=MESH_RANKS, join=True)
        ranks = []
        for r in range(MESH_RANKS):
            with open(os.path.join(MESH_DIR, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
        t_ranks = time.perf_counter()
        report_ranks(ranks, ref, plan, sf8_ref)
        for r in ranks:
            parts = [r["b"]["data"]["launches"], r["b"]["fsdp"]["launches"], r["c"]["train"]["launches"],
                     *(v["launches"] for k, v in r["d"].items() if not k.startswith("small")),
                     r["h"]["launches"], *(v["launches"] for v in r["i"].values())]
            launches = {k: launches[k] + sum(p[k] for p in parts) for k in launches}
        images = image_sets(seed, key, dataclasses.replace(VIT_CFG, num_layers=IMAGE_VIT_BLOCKS))
    finally:
        for d in (MESH_SAVE, MESH_DIR):
            shutil.rmtree(d, ignore_errors=True)
    print(f"[18] (a) {t_a - t0:.1f} s, (b)-(e) and (g) on two ranks {t_ranks - t_a:.1f} s, (f) "
          f"{time.perf_counter() - t_ranks:.1f} s; phase 18 {time.perf_counter() - t0:.1f} s; the script "
          f"{time.perf_counter() - t_script:.1f} s", flush=True)
    return launches, images


# ---- phase 20: the measurement drivers --------------------------------------

# the drivers' depth at Llama2-1B's width: the ladder runs at full depth;
# inference, the uniform serving load and the step components at
# DRIVER_LAYERS of 22 layers, cut for time (each decode step is host-bound;
# at 4 layers the five drivers took 13.0 s, the script 798.2 s of its
# 1,200, on an H100 80GB HBM3 at 700 W, PERF.md section 6); the ladder's
# synced and chained steps (its N_STEPS 6) at DRIVER_STEPS, inference's new
# tokens (128) at INFER_NEW, the uniform load's (448) at SERVE_NEW.
# bench.py's step runs in phase 8, --load mixed in phase 4, _bench_vit_giant
# in phase 11 and benchmark_collectives in phase 18 (g)
DRIVER_LAYERS = 8
DRIVER_STEPS = 2
INFER_NEW = 16
SERVE_NEW = 32
DRIVER_SEQ = 2048  # the drivers' sequence (their default)
FUSED_MKF = (16384, D, F)  # benchmark_fused's M, K, F (its default, Llama2-1B at batch 8)
COMPONENTS_BS = 8  # benchmark_step_components' batch (its default)
LADDER_BAR = 1e-2  # each rung's first loss against bf16's (PERF.md section 2)
INFERENCE_KEYS = {"metric", "prompt_len", "new_tokens", "quantize", "results"}  # benchmark_inference.py's JSON


def ladder_per_step_launches(L: int, kw: dict | None, b6: int) -> dict:
    """Kernel launches of one step of a ladder rung of L layers (one
    micro-batch, remat), the base counters only (not their routes' shares;
    pinned on the CPU by tests/test_torch_benchmark_train_ladder.py): bf16
    (``kw`` None) and all int8 as :func:`per_step_launches` gives them;
    "INT8 forward" (grad_input and grad_weight bf16) the unfused layer
    whose every linear quantizes its own input, forward and replay (K1 26 a
    layer: 14 and 12, K2 13) and no backward kernel, each quantize in its SR
    form with ``stochastic_rounding``; "+ INT8 grad_input" the fused layer's
    forward and replay, and a backward that row-quantizes the 5 output
    gradients with K1 in place of B5 and runs no B2, B8, B9-col or B12 (the
    grad_weight products are bf16), ungroups o's input once more for its bf16
    grad_weight and quantizes it along rows only. B6 once per leaf
    (``b6``)."""
    sr = bool(kw and kw.get("stochastic_rounding"))
    if kw is None:
        counts = per_step_launches(L, b6=b6, layer="bf16")
    elif kw["grad_weight"]:
        counts = per_step_launches(L, sr=sr, b6=b6)
    elif kw["grad_input"]:
        counts = per_step_launches(L, b6=b6)
        counts["quantize_int8_rowwise"] += 5 * L
        counts["rope_ungroup"] += L
        counts["ungroup_quant"] -= L
        for k in ("quantize_int8_both", "scaled_mm_lhs_t", "rmsnorm_quant_colwise", "silu_mul_quant_colwise",
                  "silu_mul_bwd_quant_colwise"):
            counts[k] = 0
    else:
        counts = per_step_launches(L, b6=b6, layer="bf16")
        counts.update({f"quantize_int8_rowwise{'_sr' if sr else ''}": 26 * L, "scaled_mm_rhs_t": 13 * L})
    return base_counts(counts)


def base_counts(counts: dict) -> dict:
    """The counters of launches, without those of a route's share
    (``*_sm90``, ``*_decode``)."""
    return {k: v for k, v in counts.items() if not k.endswith(("_sm90", "_decode"))}


def drivers_phase(t_script: float) -> dict:
    """Phase 20: the measurement drivers, each through its ``main`` on its
    JAX script's flags and printing its own lines, at Llama2-1B's width:
    (b) ``benchmark_train_ladder --sr`` at full depth (bs 8 x 2048; every
    rung's steps launch exactly
    :func:`ladder_per_step_launches`, each rung's first loss within 1e-2 of
    bf16's), (c) ``benchmark_inference --quantize mixed_precision`` (bs 1,
    8, 32, prompt 512, ``INFER_NEW`` new tokens: JAX's keys, every batch a
    result, K1 and K2 launched), (d) ``benchmark_serving --load uniform
    --quantize mixed_precision`` (``SERVE_NEW`` new tokens), (e)
    ``benchmark_fused`` at M 16,384, K 2,048, F 5,632 (full width and
    size: every chain's fused output within ``STEP_BOUND`` int8 steps of
    the unfused composite's, B13's equal), (f)
    ``benchmark_step_components`` (bs 8 x 2048: every variant ran), (c),
    (d) and (f) cut to ``DRIVER_LAYERS``. Prints each driver's seconds;
    returns the phase's launches."""
    t_phase, seconds = time.perf_counter(), {}
    launches = dict.fromkeys(ops.KERNELS, 0)
    cut = dataclasses.replace(CFG, num_hidden_layers=min(DRIVER_LAYERS, CFG.num_hidden_layers))
    L, dev = cut.num_hidden_layers, device_args()
    small = dataclasses.replace(CFG, vocab_size=8, hidden_size=64, intermediate_size=64, num_hidden_layers=1,
                                num_attention_heads=1, num_key_value_heads=1)  # the leaves, not their sizes
    n_leaves = len(tree_leaves(llama.init_params(torch.Generator().manual_seed(0), small)))

    def ran(name: str, t0: float, counts: dict) -> None:
        sync()
        seconds[name] = time.perf_counter() - t0
        for k, v in counts.items():
            launches[k] += v
        print(f"[20] {name}: {seconds[name]:.1f} s", flush=True)

    t0 = time.perf_counter()
    ladder = benchmark_train_ladder
    with preset(CFG), patched(ladder, N_STEPS=DRIVER_STEPS), StepLaunches(None) as rec:
        rows = ladder.main(["--model", "llama2-1b", "--seq", str(DRIVER_SEQ), "--sr", *dev])
    ran("benchmark_train_ladder", t0, rec.total)
    rungs = ladder.RUNGS + ladder.SR_RUNGS
    check(len(rows) == len(rungs) == len(rec.runs), f"every rung ran: {rows}")
    bf16_first = rec.losses(0)[0]
    for (name, kw), run in zip(rungs, rec.runs):
        want = ladder_per_step_launches(CFG.num_hidden_layers, kw, n_leaves)
        check(all(base_counts(c) == want for c in run["launches"]), f"{name}: every step launches {want}")
        losses = [l.item() for l in run["losses"]]
        rel = abs(losses[0] - bf16_first) / abs(bf16_first)
        print(f"[20] ladder rung {name!r}: {len(losses)} steps, losses {losses}, first against bf16's relative "
              f"{rel:.3e} (bound {LADDER_BAR:g}); launches a step { {k: v for k, v in want.items() if v} }")
        check(all(np.isfinite(losses)) and rel <= LADDER_BAR, f"{name}: first loss within {LADDER_BAR} of bf16's")

    t0 = time.perf_counter()
    ops.reset_launch_counts()
    with preset(cut):
        line = benchmark_inference.main(["--model", "llama2-1b", "--prompt_len", "512", "--new_tokens",
                                         str(INFER_NEW), "--quantize", "mixed_precision", *dev])
    counts = ops.launch_counts()
    ran("benchmark_inference", t0, counts)
    check(set(line) == INFERENCE_KEYS and [r["batch"] for r in line["results"]] == [1, 8, 32]
          and all(r["gen_tokens_per_sec"] > 0 for r in line["results"]), f"inference's line: {line}")
    check(DEVICE == "cpu" or all(counts[k] > 0 for k in SERVING_KERNELS), f"generate launched K1 and K2: {counts}")

    t0 = time.perf_counter()
    ops.reset_launch_counts()
    with preset(cut):
        uniform = benchmark_serving.main(["--model", "llama2-1b", "--quantize", "mixed_precision", "--new_tokens",
                                          str(SERVE_NEW), *dev])
    ran("benchmark_serving --load uniform", t0, ops.launch_counts())
    check(uniform["windowed"] > 0 and uniform["full"] > 0, f"the uniform load's rates: {uniform}")

    t0 = time.perf_counter()
    ops.reset_launch_counts()
    M, K, Fw = FUSED_MKF
    fused = benchmark_fused.main(["--M", str(M), "--K", str(K), "--F", str(Fw), *dev])
    ran("benchmark_fused", t0, ops.launch_counts())
    for c in benchmark_fused.chains(M, K, Fw, DEVICE) + benchmark_fused.round4_chains(M, K, Fw, DEVICE):
        gaps = benchmark_fused.gaps(c)
        exact = c.name.startswith(("rope", "ungroup"))
        print(f"[20] {c.name}: fused against unfused {gaps} (bound {0 if exact else benchmark_fused.STEP_BOUND}"
              f"{'' if exact else ' int8 steps'}); {fused[c.name][0]:.4f} / {fused[c.name][1]:.4f} ms")
        check(all(g <= (0 if exact else benchmark_fused.STEP_BOUND) for _, g in gaps), f"{c.name}: {gaps}")

    t0 = time.perf_counter()
    ops.reset_launch_counts()
    with preset(cut):
        parts = benchmark_step_components.main(["--model", "llama2-1b", "--bs", str(COMPONENTS_BS), "--seq",
                                                str(DRIVER_SEQ), *dev])
    ran("benchmark_step_components", t0, ops.launch_counts())
    check(all(parts["variants"][tag] for tag, _, _ in benchmark_step_components.VARIANTS) and parts["quantize_int8"],
          f"every part of the step components ran: {parts}")
    print(f"[20] the drivers at Llama2-1B's width, the ladder at {CFG.num_hidden_layers} layers, the others at {L} "
          f"(depth cut for time): " + ", ".join(
        f"{k} {v:.1f} s" for k, v in seconds.items()) + f"; bench.py's step in phase 8, benchmark_serving --load "
        f"mixed in phase 4, _bench_vit_giant in phase 11, benchmark_collectives in phase 18 (g); phase 20 "
        f"{time.perf_counter() - t_phase:.1f} s, the script {time.perf_counter() - t_script:.1f} s", flush=True)
    return launches


class PhaseClock:
    """Prints each phase's seconds, and the script's, as the phase ends."""

    def __init__(self, t_script: float):
        self.t_script = self.t = t_script

    def __call__(self, phase: str) -> None:
        now = time.perf_counter()
        print(f"[t] phase {phase}: {now - self.t:.1f} s; the script {now - self.t_script:.1f} s", flush=True)
        self.t = now


def fill_launches(entries, launches: dict) -> None:
    """Each entry's launches on its path, and where the kernel has an sm90
    route, that route's share of them (``sm90_launches``)."""
    for e in entries:
        e["launches"] = launches[e["name"]]
        if f"{e['name']}_sm90" in launches:
            e["sm90_launches"] = launches[f"{e['name']}_sm90"]


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=SEED,
                        help="seed of the training batches and of the steps' key (phases 6-11)")
    args = parser.parse_args()
    t_script = time.perf_counter()
    smi = card()
    clock = PhaseClock(t_script)
    build()
    clock("2, the build")
    key = random.key_from_generator(torch.Generator().manual_seed(args.seed))
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    k2_worst, k2_decode = check_k2(gen)
    check_storage_forms(gen)
    serving = [check_k1(gen), k2_decode]
    training = [*check_training_quantizes(gen), *check_training_gemms(gen, k2_worst)]
    mesh_forms = check_mesh_forms(gen, key)
    other_gemms = [check_int4_gemms(gen), *check_tile_gemms(gen)]
    sr_forms = check_sr_quantizes(gen, key)
    adamw = check_fused_adamw(gen, key)
    producers = check_fused_producers(gen, key)
    producers += check_silu_bwd(gen, key) + check_rope(gen, key)
    b18 = check_b18(gen, key)
    b17, b19 = check_b17(gen), check_b19(gen)
    check_attention_layout(key)
    clock("3")
    serve_launches, served_load = serve(torch.Generator(device=DEVICE).manual_seed(SEED))
    fill_launches(serving, serve_launches)
    clock("4")
    kernel_vs_plain_path(SEED, torch.float32, 3e-2, 0.95)
    kernel_vs_plain_path(SEED, torch.bfloat16, 1e-1, 0.85)
    clock("5")
    raw = llama.init_params(torch.Generator(device=DEVICE).manual_seed(SEED), CFG)
    q_losses, launches, (bf16_first, bf16_tps) = train_slice(raw, args.seed, key)
    fill_launches(training, launches)
    clock("6")
    for fused in (False, True):
        grads_vs_plain(SEED, torch.float32, 1.5e-1, 1e-3, fused=fused)
        grads_vs_plain(SEED, torch.bfloat16, 2e-1, 1e-3, fused=fused)
        grads_vs_plain(SEED, torch.float32, 1.5e-1, 1e-3, sr_key=random.fold_in(key, 7), fused=fused)
    for qkw, max_rms, max_dloss in GRAD_BOUNDS_OTHER:
        grads_vs_plain(SEED, torch.float32, max_rms, max_dloss, qkw=qkw)
    vit_grads_vs_plain(SEED, torch.float32, 1e-1, 1e-3)
    vit_grads_vs_plain(SEED, torch.bfloat16, 1.5e-1, 1e-3)
    vit_grads_vs_plain(SEED, torch.float32, 1e-1, 1e-3, sr_key=random.fold_in(key, 7))
    clock("7")
    bench_launches, bench_line = bench_step(raw, args.seed, key)
    fill_launches([adamw[0], *(e for e in producers if not e["name"].endswith("_sr"))], bench_launches)
    clock("8")
    fill_launches([*sr_forms, adamw[1], *(e for e in producers if e["name"].endswith("_sr"))],
                  sr_config(raw, args.seed, key, q_losses[0]))
    clock("9")
    path, steps = tile_int8_path(), other_dtypes(raw, args.seed, key, bf16_first, bf16_tps)
    fill_launches(other_gemms, {k: path[k] + steps[k] for k in path})
    clock("10")
    rn_launches, sr_launches, vit_rates = vit_giant_step(SEED, key)
    clock("11")
    fill_launches([e for e in b18 if not e["name"].endswith("_sr")], rn_launches)
    fill_launches([e for e in b18 if e["name"].endswith("_sr")], sr_launches)
    fill_launches(b17, benchmark_mm_phase())
    fill_launches([b19], int8_attention_phase(SEED))
    clock("12, 13")
    kernels = serving + training + sr_forms + adamw + producers + other_gemms + b18 + b17 + [b19]
    storage = storage_schemes(raw, args.seed, key)
    for e in kernels:  # phase 14's launches, under a key of their own
        if storage.get(e["name"]):
            e["storage_launches"] = storage[e["name"]]
    check(all(storage[k] > 0 for k in ("quantize_int8_rowwise", "quantize_int8_rowwise_sr", "scaled_mm_rhs_t",
                                       "scaled_mm_rhs_t_decode", "rope_group", "fused_adamw_update")),
          f"phase 14 launched K1, K1-SR, K2 (decode too), B13 and B6: {storage}")
    clock("14")
    pretrain, at_470m = llm_drivers(args.seed)
    for e in kernels:  # phase 15's launches, under a key of their own, and (e)'s shapes
        e["pretrain_launches"] = pretrain.get(e["name"], 0)
        if e["name"] in at_470m:
            e["shapes_470m"] = at_470m[e["name"]]
            e["max_abs_err"] = max(e["max_abs_err"], *(r["max_abs_err"] for r in at_470m[e["name"]]))
    check(all(e["launches"] > 0 for e in kernels), f"every kernel launched on its path: {kernels}")
    clock("15")
    prequant_conv_mx(raw, args.seed, key, kernels)
    clock("16")
    remat = remat_phase(raw, args.seed, key)
    clock("19")
    for e in kernels:  # phase 19's launches, under a key of their own
        e["remat_launches"] = remat.get(e["name"], 0)
    del raw
    torch.cuda.empty_cache()
    tasks = tasks_phase(args.seed)
    clock("17")
    for e in kernels:  # phase 17's launches, under a key of their own
        e["task_launches"] = tasks.get(e["name"], 0)
    meshed, images = mesh_phase(args.seed, key, t_script)
    for e in kernels:  # phase 18's launches under the mesh, and its image steps', under keys of their own
        e["mesh_launches"] = meshed.get(e["name"], 0)
        e["image_launches"] = images.get(e["name"], 0)
    missing = [k for k in PRETRAIN_KERNELS + ("fused_adamw_update",) if not meshed[k]]
    check(not missing, f"phase 18 launched every kernel of the int8 step under the mesh, not {missing}")
    fill_launches(mesh_forms, meshed)  # the mesh forms' path is phase 18's
    check(all(e["launches"] > 0 for e in mesh_forms), f"phase 18 launched every mesh form: {mesh_forms}")
    kernels += mesh_forms
    clock("18")
    drivers = drivers_phase(t_script)
    for e in kernels:  # phase 20's launches
        e["driver_launches"] = drivers.get(e["name"], 0)
    print(f"[20] bench.py's line (phase 8): {json.dumps(bench_line)}; benchmark_serving --load mixed (phase 4): "
          f"windowed {served_load['windowed']:.1f}, full-window {served_load['full']:.1f}, static "
          f"{served_load['static']:.1f} tok/s; _bench_vit_giant (phase 11): "
          + ", ".join(f"{k} {v:.1f} img/s" for k, v in vit_rates.items()), flush=True)
    clock("20")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
