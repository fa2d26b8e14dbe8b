#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one or more lines each; a failure in any phase raises and the run
exits non-zero:

1. device  — the card's name and power limit (nvidia-smi), torch and CUDA.
2. build   — every kernel of mhla_tpu_torch/csrc (nvcc, one process per
             source) and K1 (Triton; the other Triton kernels compile at
             their first launch).
3. kernels — each forward kernel against its plain PyTorch version on the
             card at the 340M serving shapes (timed: CUDA events, median
             after warm-up; K2, K3 and K4 beside their earlier kernels'
             times) and at the training shape B=8 T=2048, bf16 (K4 timed
             there too); K2 and K3 at (a)'s 4 x 1984, where the host's cost
             of a call is held beside the card's time for it; K2 timed at
             B=8 T=2048 and 1 x 16,384 and
             beside its PyTorch calls in turns (the einsum; torch.bmm over
             permuted copies, the copies counted and not). Every timed
             kernel also prints its host cost per call (host clock over 100
             enqueues) and the card's time for one call (CUDA events).
4. serve   — the 340M MHLA LM (MHLALMConfig() defaults, bf16, weights from
             a seeded init) serves two requests through ``generate``:
             4 x 1984 prompt + 64 greedy tokens (fills the 2048 context)
             and 1 x 781 + 32. Checks finite logits, that every forward
             kernel launched, and chunk == recurrent: the decode-step logits
             match one full forward over prompt + generated tokens.
5. grads   — each backward kernel (K1b-K4b) against its plain version at
             the training shape B=8 T=2048 (timed; K4b and K2b beside their
             earlier kernels' times, K2b beside two einsums that add the
             intra terms in place, both bit for bit over two runs) and at
             B=1 T=781 (the ragged last chunk), bf16; then the gradients of
             fmap+RoPE and the chunk op through the kernels against autograd of the
             plain definitions on the same CUDA tensors, at both shapes.
6. train   — ``mhla_tpu_torch.train.lm_train.main`` trains the 340M model
             6 steps at B=8 T=2048 (float32 parameters, bf16 compute,
             AdamW at 3e-4 after a 1-step warm-up). Checks finite, falling
             loss, that every backward kernel launched, that the mixing
             matrices stay tril in [1e-5, 1] and got a non-zero gradient;
             prints step time, tok/s and the checkpoint's save time.
7. kernels (LM packed) — the per-row forms of K1/K1b (a rotary row per
             token), K3/K3b and K4/K4b (a mixing matrix per batch row) and
             the causal and causal + segment-id forms of K9/K9b against their
             plain versions at B=8 T=2048 of ``PackedVarlenIterator`` rows
             (timed, beside the bound and one library call), K9/K9b also at
             an unaligned length with arbitrary ids; K9's lse; two K9b runs
             bit for bit; the tiles each masked kernel walked against the
             rule's count and the full count.
8. serve (hybrid LM) — ``generate`` with the 340M model whose layers 0, 3,
             ..., 21 are causal softmax attention (8 heads of 128): the same
             two requests, prefills on the plain causal product (T < 2048,
             as in JAX), decode through the KV caches. Checks finite logits,
             the exact launches, and the decode-step logits against one
             forward over the whole sequence (2,048 tokens: K9 causal).
9. train (hybrid LM) — ``lm_train.main --model_json=<the hybrid>
             --train.varlen=true`` trains it 6 steps on packed documents at
             B=8 T=2048, then 2 steps on token rows: finite, falling loss,
             exact launches, mixing matrices tril in [1e-5, 1] with
             gradients; step time, tok/s, peak memory; then the gradients
             of an MHLA + softmax block pair on packed rows through the
             kernels against the plain definitions.
10. kernels (long context) — K9 / K9b at head dim 256 (the default 4 heads
             of the 340M hybrid's softmax layers) in the non-causal, causal
             and causal + segment-id forms at [8, 2048, 4, 256] of
             ``PackedVarlenIterator`` rows and at an unaligned length with
             arbitrary ids (lse, two K9b runs bit for bit, tiles walked against
             the rule's count); the wide K3 / K3b at N = 64, 256, 448 and 512
             chunks (two K3b runs bit for bit) and K2b at (u)'s row of 16,384
             tokens (two runs bit for bit), K3 / K3b at N = 32; each timed
             beside its plain version, its bound and one library call, and
             K2b and the wide K3 / K3b beside their earlier kernels' times.
11. ppl (long context) — ``eval.ppl_cli.main`` on the long-context hybrid
             (its json: heads of 256, 32,768 positions, 512 mixing slots;
             seeded init, bf16 compute) over 2 x 28,672 seeded tokens in
             blocks of 28,672 with buckets of 2,048: a finite report with its
             14 buckets, the exact launches (K9 causal 8 and the wide K3 16 a
             block, at N = 448), tok/s, peak memory; then the mean NLL of a
             4,096-token block through the kernels against the plain versions.
12. serve (long context) — ``generate`` 1 x 4,096 + 32 greedy tokens with
             the same model in bf16: the exact launches, the decode-step
             logits against one forward over the whole sequence.
13. train (long context) — ``lm_train.main --model_json=<the long-context
             hybrid>`` 3 steps at B=1 T=16,384 (N = 256: the wide K3 / K3b; K9
             / K9b causal at head dim 256): finite, falling loss, exact
             launches, mixing matrices; step time, tok/s, peak memory.
14. train (d256 packed) — 3 steps of ``--train.varlen=true`` at B=8 T=2048
             with the default-heads hybrid at a 2,048 context: K9 / K9b's
             causal + segment-id forms at head dim 256.
15. kernels (delta) — K11 (the chunked gated delta rule, csrc/delta_chunk.cu)
             and K11b (its backward, csrc/delta_chunk_bwd.cu) against their
             plain versions at [8, 2048, 4, 128|256] (timed, beside the
             bound and the earlier kernels' times) and at 1 x 781 (a ragged
             last chunk), bf16 with a nonzero initial state; two K11 and two
             K11b runs bit for bit; the op's gradients through the kernels
             against autograd of the plain op.
16. serve (gdn) — ``generate`` with the 340M Gated DeltaNet LM
             (``attn_extends='gated_deltanet'``, bf16, seeded init): the same
             two requests; K11 in every layer of the prefill, decode on the
             token recurrence. Checks the exact launches and the decode-step
             logits against one chunked forward over the whole sequence.
17. train (gdn) — ``lm_train.main --model.attn_extends=gated_deltanet`` 6
             steps at B=8 T=2048: finite, falling loss, K11 and K11b once per
             layer and step; step time, tok/s, peak memory.
18. kernels (gla) — K12 (chunked gated linear attention, csrc/gla_chunk.cu)
             and K12b (its backward, csrc/gla_chunk_bwd.cu) against their
             plain versions at [8, 2048, 4, 128|256] in float32 (the layer's
             form) and bf16, at 1 x 781 (a ragged last chunk) in both, and at
             the bench shape [1, 32768, 8, 128|128] in bf16, with a nonzero
             initial state (timed beside the bound at [8, 2048] and the bench
             shape, the TF32 tensor cores' bound, the earlier kernels' times
             and their bound); at 2 x 300 tokens with chunks of 16, 32, 48
             and 64 and Dv of 64, 128 and 256 in both dtypes; two K12b runs
             bit for bit at every shape; the op's gradients through the
             kernels against autograd of the plain op.
19. serve (gla) — ``generate`` with the 340M GLA LM (``attn_extends='gla'``,
             bf16, seeded init): the same two requests; K12 in every layer of
             the prefill, decode on the token recurrence. Checks the exact
             launches and the decode-step logits against one chunked forward.
20. train (gla) — ``lm_train.main --model.attn_extends=gla`` 6 steps at B=8
             T=2048: finite, falling loss, K12 and K12b once per layer and
             step; step time, tok/s, peak memory.
21. train (simple_gla) — the same, 2 steps, with one decay per head
             (``attn_extends='simple_gla'``): finite losses, exact launches.
22. kernels (video) — K5-K9 against their plain versions at the shapes of
             the Wan2.1-1.3B sampler: CFG batch 2, 31,500 tokens in 150
             blocks of 210, cross-attention against 512 text tokens; K6 and
             K7 (TF32 tensor cores split to float32 accuracy) in float32
             within 1e-5, timed beside their earlier SIMT kernels' times,
             their bounds and ``torch.matmul`` / an einsum, also at the
             training shape (batch 1; K6 on M^T, as the backward takes it);
             two runs of K7 bit for bit.
23. video   — ``mhla_tpu_torch.eval.video_infer_cli.main`` samples 4
             DPM-Solver++ steps with CFG 5.0 of the 30-layer full-MHLA
             model at latents (21, 60, 100, 16). Checks finite latents, the
             exact launch counts of K5-K9 and one forward through the
             kernels against the same forward through their plain versions.
24. kernels (hybrid) — K10 (radial flash attention, the radial form of
             K9's Hopper forward) against its plain version at [2, 31,500,
             12, 128] in 21 frames and at a small geometry of frames
             narrower than its key tiles, and K9 at Tq = Tk = 31,500; each
             beside its bound and one ``scaled_dot_product_attention`` call,
             K10 also beside its earlier mma.sync kernel's time; two runs of
             K10 bit for bit; the tiles it walked (``visits``) against its
             lists' length.
25. video (hybrid) — the CLI samples the hybrid model (layers 0, 3, ..., 27
             dense softmax on K9, the other 20 MHLA), 4 steps: finite
             latents, exact launch counts.
26. video (hybrid_sparse) — ``sample_video_latents`` on the same weights
             with those ten layers radial-sparse, 4 steps at t x 1000 =
             1000, 900, 750, 501: K10 launches in the two steps below the
             dense guard (850) and K9 takes its place in the two above.
             Checks the exact launch counts, the forward at t = 501 through
             the kernels against the plain versions, and that the guarded
             forward at t = 900 equals the hybrid model's.

27. kernels (video training) — K5b, K8b and K7b against their plain versions
             at B=1, 150 blocks of 210 tokens (float32 and bf16, with and
             without RoPE; K7b's float32 form, TF32 split, within 1e-5 and
             beside its earlier SIMT kernel's time, two runs bit for bit)
             and K9b at 31,500 x 512 and 31,500 x 31,500, each beside its
             bound and, where one exists, a library call (two
             einsums; the backward of ``scaled_dot_product_attention``);
             then the gradients of one ``MHLA3D`` layer and one
             ``WanSelfAttention`` layer at 31,500 tokens through the kernels
             against the same layer through the plain versions.
28. train (video) — ``mhla_tpu_torch.train.wan_train.main`` trains the
             model cut to 15 of its 30 layers (the widths kept) 3 steps at
             31,500 tokens, batch 1 (float32 parameters, bf16 compute,
             per-block remat, AdamW 1e-4 with clip 0.1 after a 1-step
             warm-up, EMA): (g) full MHLA, (h) hybrid (softmax in layers 0,
             3, ..., 12). Checks finite losses, finite non-zero
             gradient norms and the exact launch counts of K5-K9 and
             K5b-K9b; prints seconds per step, peak memory and the final
             checkpoint's seconds and size.
29. kernels (sparse training) — K10 in its training form (which also
             writes the masked log-sum-exp) and K10b (the radial flash
             backward) against their plain versions at [1, 31,500, 12, 128]
             in 21 frames, each beside its bound (allowed pairs counted
             exactly) and one library call (``scaled_dot_product_attention``
             with the boolean mask, and its backward), K10 and K10b also
             beside their earlier mma.sync kernels' times; two runs of each
             form of K10 and of K10b bit for bit; the tiles K10 and K10b's
             two kernels walked (``visits``) against their lists' lengths;
             K10 in both forms and K10b at a small ragged geometry (437
             tokens in 4 frames); the gradients of one radial-sparse
             ``WanSelfAttention`` layer at 31,500 tokens through the kernels
             against the same layer through the plain versions.
30. train (video, hybrid_sparse) — (i) ``wan_train.main`` as in 28, cut to
             15 of the 30 layers (the widths kept), with the softmax layers
             0, 3, ..., 12 under the radial mask (``model.sparse_attn_idx``):
             K10 and K10b take the place of K9 and K9b in those layers; the
             exact launch counts.
31. train (video, hybrid_sparse + LoRA) — (j) the hybrid_sparse model of
             30, cut to 15 layers as (i), with ``lora.enable``: the exact
             launch counts, the base
             parameters bit for bit those
             of the seeded init after the steps, every adapter's B moved off
             zero, peak memory and the checkpoint's size (adapters only).
32. train (video, full + LePE) — (z) after 28, the gradients of one
             ``MHLA3D(is_lepe=True)`` layer at 31,500 tokens through the
             kernels against the plain versions, then ``wan_train.main
             --model.is_lepe=true`` on the full-MHLA model cut to 10 of its
             30 layers (the widths kept), 3 steps: the launch counts are
             (g)'s scaled to that depth (the LePE convolution
             is one PyTorch call outside the island), step time beside it.
33. train (dit) — ``mhla_tpu_torch.train.dit_train.main configs/dit_s2.yaml``
             6 steps: DiT-S/2 at the config's batch of 256 (float32
             parameters, bf16 compute, seeded init, synthetic latents), loss
             finite, images/s, peak memory, every trainable mixing matrix in
             [0, 1] after the steps, no kernel launched (MHLA2D runs the
             plain blockwise op, as JAX runs its einsums).
34. fid — ``mhla_tpu_torch.eval.fid_cli.main`` on 33's checkpoint: 32
             CFG samples (scale 1.5) of 10 respaced ancestral steps into the
             latent-space npz; seconds per sampling step, its shape and dtype.
35. train (vit) — ``mhla_tpu_torch.train.vit_train.main
             configs/deit_small_mhla.yaml`` 6 steps: DeiT-small MHLA at the
             config's batch of 512 with mixup / cutmix, loss finite,
             images/s, peak memory, validation top-1 of the live and the EMA
             weights.

36. kernels (mamba2) — (aa) K12 and K12b's scalar-decay form (one
             log-decay per head, difference form) against their plain
             versions at Mamba2's [8, 2048, 8, 128|256] in float32 with the
             layer's decay at init (timed beside the bound), at 1 x 781 and
             at a decay whose chunks all sum below -88.7; finite outputs,
             K12b twice bit for bit; the op's gradients through them against
             autograd of the plain op (difference form).
37. serve / train (mamba2) — (aa, ab) ``generate`` with the 340M Mamba2 LM
             (24 layers, 8 heads, d_state 128, head dim 256): the two
             requests, K12's scalar form in every prefill layer; then
             ``lm_train.main --model.attn_extends=mamba2`` 6 steps at B=8
             T=2048 (K12 / K12b's scalar form once per layer and step).
38. serve / train (mamba) — (ac) the 340M Mamba LM serves 1 x 781 + 32 and,
             cut to 12 of its 24 layers (the widths kept), trains 3 steps at
             B=8 T=2048 (no kernel: the selective scan is plain PyTorch, each
             chunk recomputed in the backward).
39. serve / train (linear_attn) — (ad) the 340M causal linear-attention LM
             serves the two requests (decode on the carried sums) and trains
             3 steps at B=8 T=2048 (no kernel).
40. options — (ae) the MHLA LM with ``attn_mode='fused_recurrent'`` serves
             1 x 781 + 32 against chunk mode; a 781-token cache continued by
             200 tokens against ``fused_recurrent``; one
             ``MHLACausal(rope_scale_base=512)`` layer's gradients at B=8
             T=2048 (K1 / K1b with XPos tables) against plain fmap+RoPE;
             ``lm_train.main --model.use_l2warp=true`` 2 steps.
41. text to video — (af), after 26: umT5-XXL (24 layers, dim 4096, 64
             heads, ffn 10,240, vocab 256,384; float32, seeded) encodes two
             seeded prompts of 37 and 512 tokens in 512 slots and the null
             prompt (finite, zero past each length, time, peak memory; a
             2-layer model of its widths on the card against the CPU first);
             ``video_infer_cli.main`` loads the full-MHLA Wan2.1-1.3B from a
             reference-named seeded safetensors file written here (every
             parameter bit for bit its source, q / k rows and norms by
             ``rope_feature_permutation``, the MHLA gates the seeded init's),
             samples 4 UniPC steps of one prompt and decodes them through the
             Wan2.1 VAE (``VAEConfig()``, a reference-named seeded .pth
             through ``convert_vae_checkpoint``) to 81 x 480 x 800 frames in
             [-1, 1] (time, peak memory; mp4 writing is replaced by a
             recorder: no imageio there), then 4 SA-Solver steps of both
             prompts in one batch; exact K5-K9 launches for 4 model calls
             each; the VAE on a small latent on the card (whole and one frame
             a slice) against the CPU.
42. image to video — (ag), after 41: K9 at the image keys' shape (Tq
             31,500, Tk 257 at 40 heads of 128: the last key tile holds one
             key) against its plain version, timed beside its bound and one
             ``scaled_dot_product_attention`` call; CLIP ViT-H/14 at full size
             (float32, seeded; 2 layers of its widths on the card against the
             CPU first) encodes one 480 x 800 frame; Wan2.1-I2V-14B's widths
             (dim 5,120, 40 heads of 128, ffn 13,824), full MHLA, cut to 10
             of its 40 layers, loads from a reference-named seeded BF16
             safetensors file written here through ``convert_wan`` (every
             parameter bit for bit its source, q / k rows and norms by
             ``rope_feature_permutation``); ``sample_video_latents`` samples 4
             DPM-Solver++ steps with CFG 5.0 and the CLIP features at
             (21, 60, 100, 16): exact launches (two K9 a layer, text and
             image), finite latents, one forward through the kernels against
             the plain versions.
43. distillation — (ah), after 32: ``wan_train.main`` writes a teacher
             checkpoint of the full-MHLA Wan2.1-1.3B cut to 10 of its 30
             layers (another seed, no step), then trains the same
             configuration 3 steps with ``distill.enable`` from that teacher
             on latents from two tar shards written with
             ``write_tar_shard``: finite losses and distillation terms,
             exact launches (the student's as (z)'s, plus the teacher's
             forward), step time, peak memory.

The last two lines are a JSON object with every kernel's numbers and
``{"ok": true, "device": {...}}``. Needs a CUDA device; there is no CPU mode.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import math
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from unittest import mock

import numpy as np
import torch

# Relative-RMS tolerance of a kernel against its plain version, both in
# bf16 on the card: both accumulate in float32 and round once to bf16 at
# the same points, so only the order of the float32 sums differs. That can
# flip a rounding by one bf16 ulp on a few elements; a half ulp is
# 2^-9 = 1.95e-3 relative, so an RMS above it is no longer rounding.
KERNEL_TOL = 2e-3
# Relative-RMS tolerance of the flash-attention kernel against its plain
# version, bf16: both round the probabilities to bf16 before the product
# with v (the kernel its unnormalized ones relative to the running row
# maximum of its key tiles, the plain version the normalized ones) and both
# round the output to bf16, so their rounding errors are independent. A
# bf16 rounding error has a relative std of about 2^-9 / sqrt(3) = 1.1e-3
# for the probabilities, which passes undiminished into the output (a
# signed sum of the same terms), and up to 1.7e-3 for the output itself:
# about 2e-3 for each version against exact arithmetic and sqrt(2) times
# that between the two (3.1e-3 measured at Tq 31,500 x Tk 512 and at 1000 x
# 1000). The tolerance is twice that; zero-filled keys past Tk that receive
# probability mass take 24 / 1024 of the weight at Tk = 1000 (1.4e-2) and
# half of it at Tk = 33, the shapes the card tests add.
FLASH_TOL = 6e-3
# Relative-RMS tolerance of the flash backward kernel against its plain
# version on the same (q, k, v, o, lse, dO), bf16: unlike the forward, the
# two round the same quantities (the normalized P, then dS, then the three
# outputs) to bf16 at the same points, from float32 values that differ only
# by the order of their sums, so few roundings flip (4.8e-4 measured at both
# of the video model's shapes). As KERNEL_TOL.
FLASH_BWD_TOL = 2e-3
# Relative-RMS tolerance of decode-step logits against one full chunked
# forward, bf16: the chunked path rounds the chunk states, the mixed states
# and the masked scores to bf16 (as the JAX op does) while the recurrent
# path keeps its state in float32, and the differences pass through 24
# layers of a bf16 residual stream. The same comparison of this model on
# the CPU's plain paths gives 3.1e-2 in bf16 and 3.7e-6 in float32, so
# 3e-2 is the bf16 floor; a wrong slot, position or mixing row gives O(1).
SERVE_TOL = 5e-2
# Relative-RMS tolerance of K6's float32 form against its plain version (the
# float32 einsum, TF32 off): its three TF32 products carry float32 accuracy
# (2.2e-7 against float64 at N = 150 on the CPU), where one TF32 product
# would be about 3e-4 off, above this bound.
K6_F32_TOL = 1e-5
# Relative-RMS tolerance of the op's gradients (dx_q, dx_k, dv, dM) through
# the kernels against autograd of the plain definitions (fmap_rope_plain,
# ops.mhla_chunk), bf16: the two round at different points (the plain op
# rounds the scaled q and its own autograd rounds nothing in the backward,
# the kernel path folds the scale into M and rounds dA, dmixed, dS and the
# intra terms to bf16 as the JAX backward does). The same comparison on the
# CPU's plain paths, at both shapes of phase 5 (B=8 T=2048, B=1 T=781) and
# two seeds, gives at most 5.2e-3 (dx_k; dx_q 4.8e-3, dv 4.2e-3, dM 3.3e-3):
# that is the bf16 floor, and the tolerance leaves 2x for the card's other
# summation orders. A dropped term, a wrong transpose or a missing mask gives O(1).
OP_GRAD_FLOOR_CPU = 5.2e-3
OP_GRAD_TOL = 1e-2
# Relative-RMS tolerance of the video model's velocity through K5-K9 against
# the same forward through their plain versions, bf16 model. Each kernel
# agrees with its plain version up to single roundings (KERNEL_TOL,
# FLASH_TOL), but two bf16 runs of 30 layers do not stay that close: a
# difference in the last float32 bit flips some bf16 roundings in the next
# layer, each flip is an error of one ulp, and within a few layers the
# distance settles at what bf16 rounding does to this model, whatever its
# first cause (K5-K8 alone, which match their plain versions to 1.4e-5,
# give the same 1.1e-2 as all five kernels). The measure of that level is
# the model's bf16 forward against its float32 forward on the CPU's plain
# paths: 1.5e-2 at 30 layers (dim 256, 2 heads, 2,400 tokens; 6.0e-3 at 2
# layers). The tolerance is twice that; a wrong block permutation, table
# row or mixing row gives O(1).
VIDEO_FLOOR_CPU = 1.5e-2
VIDEO_TOL = 3e-2

# Relative-RMS tolerance of a layer's gradients (its input's and every
# parameter's) through the kernels against the same layer through the plain
# versions under plain autograd, bf16 activations at 31,500 tokens. The
# MHLA3D island is float32 and its custom backward repeats plain autograd's
# terms, so only bf16 roundings of the incoming and outgoing gradients can
# flip; the softmax layer inherits K9's distance to its plain version
# (FLASH_TOL: independent bf16 roundings of P and of the output) in the
# saved output and in every P of the backward, and sums a few such terms.
# Measured on the card: MHLA3D at most 3.7e-3 (q.bias; dx 2.7e-3), the softmax
# layer at most 8.4e-3 (k.bias; dx 2.6e-3); the tolerance is 2e-2. A wrong
# transpose, a missing rotation sign or a dropped term gives O(1).
LAYER_GRAD_TOL = 2e-2

# K9 / K9b's times with their earlier mma.sync kernels, before the Hopper
# redesign (wgmma, TMA, a producer warpgroup), by (kernel, shape tag) as this
# script times them: the bracketed times of PERF.md section 6's table
# (NVIDIA H100 80GB HBM3, 700.00 W). Each is printed beside this run's time,
# its bound and the library call's.
FLASH_MMA_SYNC_MS = {
    ("flash_attention", "Tq=31500 Tk=512"): 0.9334,
    ("flash_attention[self]", "Tq=Tk=31500"): 47.7022,
    ("flash_attention_bwd", "Tq=31500 Tk=512"): 2.0151,
    ("flash_attention_bwd[self]", "Tq=31500 Tk=31500"): 79.4776,
    ("flash_attention[causal]", "B=8 T=2048 packed"): 0.3475,
    ("flash_attention[causal+segment]", "B=8 T=2048 packed"): 0.2409,
    ("flash_attention_bwd[causal]", "B=8 T=2048 packed"): 1.2050,
    ("flash_attention_bwd[causal+segment]", "B=8 T=2048 packed"): 0.6310,
    ("flash_attention[causal,d256]", "B=8 T=2048 H=4 D=256"): 0.7655,
    ("flash_attention[causal,d256]", "B=1 T=16384 H=4 D=256"): 5.6137,
    ("flash_attention[causal,d256]", "B=1 T=28672 H=4 D=256"): 15.9672,
    ("flash_attention_bwd[causal,d256]", "B=8 T=2048 H=4 D=256"): 2.3050,
    ("flash_attention_bwd[causal,d256]", "B=1 T=16384 H=4 D=256"): 15.3931,
    ("flash_attention[causal+segment,d256]", "B=8 T=2048 H=4 D=256"): 0.2845,
    ("flash_attention_bwd[causal+segment,d256]", "B=8 T=2048 H=4 D=256"): 1.2272,
}
# K2 / K2b's, K3 / K3b's and K4 / K4b's times with their earlier kernels (K2,
# K2b, K4 and K4b on WMMA fragments read from device memory, K3 at N = 32 on
# float32 FMAs in one thread per pair of state columns, the wide forms on
# mma.sync over cp.async), before the Hopper redesigns (wgmma, TMA), by
# (kernel, shape tag) as this script times them: the bracketed times of
# PERF.md section 6's table (NVIDIA H100 80GB HBM3, 700.00 W), K2b's from two
# runs.
CHUNK_MMA_SYNC_MS = {
    ("chunk_output", "B=4 T=2048"): (0.1528,),
    # not timed here before: the earlier kernel in two turns of
    # eval/time_kernels.py's chunk group (PERF.md section 6)
    ("chunk_output", "B=8 T=2048"): (0.3036, 0.3082),
    ("chunk_output[per-row]", "B=8 T=2048 packed"): (0.3074,),
    ("chunk_output_bwd", "B=8 T=2048"): (0.6316,),
    ("chunk_output_bwd[per-row]", "B=8 T=2048 packed"): (0.6390,),
    ("chunk_states", "B=4 T=2048"): (0.1063,),
    ("mix_states", "B=4 T=2048"): (0.0463,),
    ("mix_states[per-row]", "B=8 T=2048 packed"): (0.0901,),
    ("chunk_states_bwd", "B=8 T=2048"): (0.4231, 0.4147),
    # N = 32: the 32-slot K3b the Hopper one replaced there (float32 atomics on dM)
    ("mix_states_bwd", "B=8 T=2048"): (0.1782,),
    ("mix_states_bwd[per-row]", "B=8 T=2048 packed"): (0.1898,),
    ("mix_states[wide]", "N=64"): (0.0374,),
    ("mix_states[wide]", "N=256"): (0.1497,),
    ("mix_states[wide]", "N=448"): (0.3432,),
    ("mix_states[wide]", "N=512"): (0.4473,),
    ("mix_states_bwd[wide]", "N=64"): (0.0857,),
    ("mix_states_bwd[wide]", "N=256"): (0.2594,),
    ("mix_states_bwd[wide]", "N=448"): (0.5824,),
    ("mix_states_bwd[wide]", "N=512"): (0.7422,),
}
# K6's, K7's, K7b's, K10b's, K10's, K5b's and K8b's times with their earlier
# kernels (K6, K7 and K7b on float32 FMAs outside the tensor cores, K10b and
# K10 on mma.sync over cp.async tiles, K5b and K8b one Triton kernel reading
# 4 rows of one head a program), before the Hopper redesigns (TF32 wgmma
# split to float32 accuracy; the radial forms of K9b's and K9's wgmma / TMA
# kernels; whole token rows by bulk copies, csrc/mhla_permute.cu), by
# (kernel, shape tag) as this script times them: PERF.md section 6's table
# (NVIDIA H100 80GB HBM3, 700.00 W). The K5b form with the pre-RoPE copy's
# gradient and K8b's RoPE form were first timed by eval/time_kernels.py's
# video group on the Triton kernel (PERF.md section 6's table).
VIDEO_EARLIER_MS = {
    ("mix_states_dense", "float32 N=150"): (0.6905,),
    ("mix_states_dense[bf16]", "bfloat16 N=150"): (0.6507,),
    ("block_readout", "float32 C=210"): (0.9583,),
    ("block_readout[bf16]", "bfloat16 C=210"): (0.9756,),
    ("block_readout_bwd", "float32 C=210"): (0.8344,),
    ("block_readout_bwd[bf16]", "bfloat16 C=210"): (0.7989,),
    ("radial_flash_attention_bwd", "T=31500 21 frames B=1"): (47.4294,),
    ("radial_flash_attention", "T=31500 21 frames"): (29.1132,),
    ("radial_flash_attention[lse]", "T=31500 21 frames B=1"): (14.9403,),
    ("unblockify", "f32 rope^T"): (0.2715,),
    ("unblockify[v]", "f32 no rope"): (0.1452,),
    ("unblockify[bf16+nope]", "bf16->f32 +add"): (0.2723,),
    ("blockify", "bf16->f32"): (0.1291,),
    ("blockify[rope]", "bf16->f32 rope"): (0.2445,),
}
# K12's and K12b's times with their earlier kernels (float32 FMAs on the
# CUDA cores, the per-chunk products and the chain in separate launches),
# before the Hopper redesign (TF32 wgmma split to float32 accuracy, TMA, the
# chain fused with the per-chunk products), by (kernel, shape tag) as this
# script times them: PERF.md section 6's table (NVIDIA H100 80GB HBM3,
# 700.00 W).
GLA_EARLIER_MS = {
    ("gla_chunk_fwd", "8x2048x4|256 f32"): (1.2342,),
    ("gla_chunk_bwd", "8x2048x4|256 f32"): (3.2470,),
    ("gla_chunk_fwd[1x32768x8|128 bf16]", "1x32768x8|128 bf16"): (2.8278,),
    ("gla_chunk_bwd[1x32768x8|128 bf16]", "1x32768x8|128 bf16"): (7.7407,),
}
# K11's and K11b's times with their earlier kernels (WMMA 16 x 16 x 16 over
# cp.async tiles, S in shared memory, K11b's gradients in two passes through
# float32 partials in device memory), before the Hopper redesign (bf16 wgmma
# over TMA tiles, the chains' state in wgmma accumulators, one gradients
# pass), by (kernel, shape tag) as this script times them: PERF.md section
# 6's table (NVIDIA H100 80GB HBM3, 700.00 W).
DELTA_EARLIER_MS = {
    ("delta_chunk_fwd", "B=8 T=2048"): (0.5796,),
    ("delta_chunk_bwd", "B=8 T=2048"): (1.2457,),
}
# this run's timed K9 / K9b, K2 / K2b, K3 / K3b, K6, K7, K7b, K10, K10b, K11, K11b, K12
# and K12b forms beside their bounds and library calls
REDESIGN_TIMES = {}
# the tiles each timed or small K10 call walked beside its lists' length
K10_WALKS = {}
# every timed kernel form's host cost per call (host_us) and the card's time
# for one call (device_ms)
HOST_DEVICE = {}

SEED = 0
PROMPT_A, NEW_A, BATCH_A = 1984, 64, 4
PROMPT_B, NEW_B, BATCH_B = 781, 32, 1

KERNEL_META = {
    "fmap_rope": ("triton", "mhla_tpu_torch/kernels/fmap_rope.py",
                  "mhla_tpu/kernels/fmap_rope_pallas.py:66"),
    "chunk_states": ("cuda", "mhla_tpu_torch/csrc/mhla_chunk.cu",
                     "mhla_tpu/kernels/mhla_chunk_pallas.py:101"),
    "mix_states": ("cuda", "mhla_tpu_torch/csrc/mhla_mix_wide.cu",
                   "mhla_tpu/kernels/mhla_chunk_pallas.py:293"),
    "chunk_output": ("cuda", "mhla_tpu_torch/csrc/mhla_chunk.cu",
                     "mhla_tpu/kernels/mhla_chunk_pallas.py:589"),
    "fmap_rope_bwd": ("triton", "mhla_tpu_torch/kernels/fmap_rope.py",
                      "mhla_tpu/kernels/fmap_rope_pallas.py:72"),
    "chunk_output_bwd": ("cuda", "mhla_tpu_torch/csrc/mhla_chunk_bwd.cu",
                         "mhla_tpu/kernels/mhla_chunk_pallas.py:623"),
    "mix_states_bwd": ("cuda", "mhla_tpu_torch/csrc/mhla_mix_wide.cu",
                       "mhla_tpu/kernels/mhla_chunk_pallas.py:459"),
    "chunk_states_bwd": ("cuda", "mhla_tpu_torch/csrc/mhla_chunk_bwd.cu",
                         "mhla_tpu/kernels/mhla_chunk_pallas.py:184"),
    "blockify_island": ("triton", "mhla_tpu_torch/kernels/mhla_block.py",
                        "mhla_tpu/kernels/mhla_block_pallas.py:472"),
    "mix_states_dense": ("cuda", "mhla_tpu_torch/csrc/mhla_block.cu",
                         "mhla_tpu/kernels/mhla_block_pallas.py:51"),
    "block_readout": ("cuda", "mhla_tpu_torch/csrc/mhla_block.cu",
                      "mhla_tpu/kernels/mhla_block_pallas.py:100"),
    "unblockify_island": ("triton", "mhla_tpu_torch/kernels/mhla_block.py",
                          "mhla_tpu/kernels/mhla_block_pallas.py:672"),
    "flash_attention": ("cuda", "mhla_tpu_torch/csrc/flash_fwd.cu",
                        "mhla_tpu/kernels/flash_attention.py:115"),
    "radial_flash_attention": ("cuda", "mhla_tpu_torch/csrc/flash_fwd.cu",
                               "mhla_tpu/kernels/sparse_attention.py:312"),
    "unblockify": ("cuda", "mhla_tpu_torch/csrc/mhla_permute.cu",
                   "mhla_tpu/kernels/mhla_block_pallas.py:273"),
    "blockify": ("cuda", "mhla_tpu_torch/csrc/mhla_permute.cu",
                 "mhla_tpu/kernels/mhla_block_pallas.py:261"),
    "block_readout_bwd": ("cuda", "mhla_tpu_torch/csrc/mhla_block_bwd.cu",
                          "mhla_tpu/kernels/mhla_block_pallas.py:116"),
    "flash_attention_bwd": ("cuda", "mhla_tpu_torch/csrc/flash_bwd.cu",
                            "mhla_tpu/kernels/flash_attention.py:115"),
    "radial_flash_attention_bwd": ("cuda", "mhla_tpu_torch/csrc/flash_bwd.cu",
                                   "mhla_tpu/kernels/sparse_attention.py:507"),
    # image to video: K9 over the 257 CLIP image keys of every cross-attention
    "flash_attention[tk257]": ("cuda", "mhla_tpu_torch/csrc/flash_fwd.cu",
                               "mhla_tpu/kernels/flash_attention.py:115"),
    # the packed-documents and hybrid LM path: per-row forms of K1-K4b and
    # the causal and segment-id forms of K9 / K9b
    "fmap_rope[positions]": ("triton", "mhla_tpu_torch/kernels/fmap_rope.py",
                             "mhla_tpu/kernels/fmap_rope_pallas.py:66"),
    "fmap_rope_bwd[positions]": ("triton", "mhla_tpu_torch/kernels/fmap_rope.py",
                                 "mhla_tpu/kernels/fmap_rope_pallas.py:72"),
    "mix_states[per-row]": ("cuda", "mhla_tpu_torch/csrc/mhla_mix_wide.cu",
                            "mhla_tpu/kernels/mhla_chunk_pallas.py:293"),
    "chunk_output[per-row]": ("cuda", "mhla_tpu_torch/csrc/mhla_chunk.cu",
                              "mhla_tpu/kernels/mhla_chunk_pallas.py:589"),
    "chunk_output_bwd[per-row]": ("cuda", "mhla_tpu_torch/csrc/mhla_chunk_bwd.cu",
                                  "mhla_tpu/kernels/mhla_chunk_pallas.py:623"),
    "mix_states_bwd[per-row]": ("cuda", "mhla_tpu_torch/csrc/mhla_mix_wide.cu",
                                "mhla_tpu/kernels/mhla_chunk_pallas.py:459"),
    "flash_attention[causal]": ("cuda", "mhla_tpu_torch/csrc/flash_fwd.cu",
                                "mhla_tpu/kernels/flash_attention.py:73"),
    "flash_attention[causal+segment]": ("cuda", "mhla_tpu_torch/csrc/flash_fwd.cu",
                                        "mhla_tpu/kernels/flash_attention.py:73"),
    "flash_attention_bwd[causal]": ("cuda", "mhla_tpu_torch/csrc/flash_bwd.cu",
                                    "mhla_tpu/kernels/flash_attention.py:73"),
    "flash_attention_bwd[causal+segment]": ("cuda", "mhla_tpu_torch/csrc/flash_bwd.cu",
                                            "mhla_tpu/kernels/flash_attention.py:73"),
    # the Gated DeltaNet LM: the chunked gated delta rule, forward and backward
    "delta_chunk_fwd": ("cuda", "mhla_tpu_torch/csrc/delta_chunk.cu",
                        "mhla_tpu/kernels/delta_chunk_pallas.py:126"),
    "delta_chunk_bwd": ("cuda", "mhla_tpu_torch/csrc/delta_chunk_bwd.cu",
                        "mhla_tpu/kernels/delta_chunk_pallas.py:207"),
    # the GLA LM: chunked gated linear attention, forward and backward
    "gla_chunk_fwd": ("cuda", "mhla_tpu_torch/csrc/gla_chunk.cu",
                      "mhla_tpu/kernels/gla_chunk_pallas.py:85"),
    "gla_chunk_bwd": ("cuda", "mhla_tpu_torch/csrc/gla_chunk_bwd.cu",
                      "mhla_tpu/kernels/gla_chunk_pallas.py:160"),
    # their scalar-decay form (one log-decay per head): Mamba2 and simple GLA
    "gla_chunk_fwd_scalar": ("cuda", "mhla_tpu_torch/csrc/gla_chunk.cu",
                             "mhla_tpu/kernels/gla_chunk_pallas.py:85"),
    "gla_chunk_bwd_scalar": ("cuda", "mhla_tpu_torch/csrc/gla_chunk_bwd.cu",
                             "mhla_tpu/kernels/gla_chunk_pallas.py:160"),
    # the long-context path: K9 / K9b at head dim 256, K3 / K3b beyond 32 chunks
    "flash_attention[causal,d256]": ("cuda", "mhla_tpu_torch/csrc/flash_fwd.cu",
                                     "mhla_tpu/kernels/flash_attention.py:73"),
    "flash_attention[causal+segment,d256]": ("cuda", "mhla_tpu_torch/csrc/flash_fwd.cu",
                                             "mhla_tpu/kernels/flash_attention.py:73"),
    "flash_attention_bwd[causal,d256]": ("cuda", "mhla_tpu_torch/csrc/flash_bwd.cu",
                                         "mhla_tpu/kernels/flash_attention.py:73"),
    "flash_attention_bwd[causal+segment,d256]": ("cuda", "mhla_tpu_torch/csrc/flash_bwd.cu",
                                                 "mhla_tpu/kernels/flash_attention.py:73"),
    "mix_states[wide]": ("cuda", "mhla_tpu_torch/csrc/mhla_mix_wide.cu",
                         "mhla_tpu/kernels/mhla_chunk_pallas.py:293"),
    "mix_states_bwd[wide]": ("cuda", "mhla_tpu_torch/csrc/mhla_mix_wide.cu",
                             "mhla_tpu/kernels/mhla_chunk_pallas.py:459"),
}
FWD_KERNELS = ("fmap_rope", "chunk_states", "mix_states", "chunk_output")
BWD_KERNELS = ("fmap_rope_bwd", "chunk_output_bwd", "mix_states_bwd", "chunk_states_bwd")
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ = 6, 8, 2048
# Wan2.1-1.3B with all 30 layers MHLA (configs/wan_1300m_mhla.yaml): latents
# 21 x 60 x 100 x 16, patch (1, 2, 2) -> 31,500 tokens in 150 blocks of 210
VIDEO_LATENT = (21, 60, 100, 16)
VIDEO_GRID, VIDEO_LAYOUT = (21, 30, 50), (3, 5, 10)
VIDEO_HEADS, VIDEO_HEAD_DIM, VIDEO_TEXT_LEN, VIDEO_CFG_BATCH = 12, 128, 512, 2
VIDEO_LAYERS, VIDEO_STEPS = 30, 4
VIDEO_KERNELS = {"blockify_island": 3, "mix_states_dense": 1, "block_readout": 1,
                 "unblockify_island": 1, "flash_attention": 1}  # launches per layer
# the hybrid form (configs/wan_1300m_hybrid_mhla.yaml): every third layer
# keeps softmax self-attention, dense or (hybrid_sparse) radial-sparse below
# the guard timestep; with shift 3.0 the 4 steps run at t x 1000 = 1000, 900,
# 750, 501, two on each side of the guard
SOFTMAX_LAYERS = tuple(range(0, VIDEO_LAYERS, 3))
HYBRID_LINEAR_IDX = tuple(i for i in range(VIDEO_LAYERS) if i not in SOFTMAX_LAYERS)
# the video trainer's runs (g), (h), (i) and (j) cut the 30-layer model to 15
# layers, the widths and the layer pattern kept (softmax in layers 0, 3, ...,
# 12 for (h), radial-sparse for (i) and (j)): (i) since PR 23 (2.26 s a step
# and a 23.5 GB checkpoint in 26 s at 30 layers on an H100 80GB HBM3 at 700
# W), to make room for (af); (g) (1.87-1.99 s a step, a 23.8 GB checkpoint in
# 18-24 s at 30 layers), (h) (3.23 s) and (j) (2.02 s) since (ag) and (ah)
VIDEO_TRAIN_LAYERS = 15
VIDEO_TRAIN_SOFTMAX = tuple(i for i in SOFTMAX_LAYERS if i < VIDEO_TRAIN_LAYERS)
VIDEO_TRAIN_LINEAR = tuple(i for i in range(VIDEO_TRAIN_LAYERS) if i not in VIDEO_TRAIN_SOFTMAX)
DENSE_FROM_T, STEPS_BELOW_GUARD = 850.0, 2
T_SPARSE, T_GUARDED = 501.0, 900.0  # two of the sampler's timesteps, one on each side
VIDEO_TRAIN_STEPS = 3
# (z) trains the full-MHLA model with LePE at 10 of its 30 layers (the widths
# kept; 48 s at 30 layers on an H100 80GB HBM3 at 700 W), to make room for (af)
LEPE_LAYERS = 10
# (ag) image to video at Wan2.1-I2V-14B's widths (build_wan_config("Wan_I2V_14B"):
# dim 5,120, 40 heads of 128, ffn 13,824), full MHLA, cut to 10 of its 40
# layers: 40 layers of float32 parameters are 65 GB
I2V_LAYERS, I2V_HEADS, I2V_FRAME, I2V_IMG_TOKENS = 10, 40, (1, 480, 800, 3), 257
# (ah) distillation: the full-MHLA Wan2.1-1.3B at 10 of its 30 layers, as (z)
DISTILL_LAYERS = 10
VIDEO_BWD_KERNELS = ("unblockify", "blockify", "block_readout_bwd", "flash_attention_bwd")


def video_train_launches(mhla_layers: int, softmax_layers: int,
                          steps: int = VIDEO_TRAIN_STEPS, sparse_layers: int = 0) -> dict:
    """Launches of K5-K10 and K5b-K10b in ``steps`` training steps with
    per-block remat: every block's forward runs twice (once with the
    step's forward, once recomputed in the backward), its backward once.
    K6 launches a third time per MHLA layer, on M^T, for the gradient of the
    states; K5b once for each of q, k and v; K9 and K9b in every
    cross-attention and every dense softmax self-attention (the
    ``softmax_layers``); K10 and K10b in the self-attention of the
    ``sparse_layers``, which training never runs dense."""
    # one cross-attention per layer, one more dense attention per dense softmax layer
    attn = mhla_layers + sparse_layers + 2 * softmax_layers
    per_step = {
        "blockify_island": 2 * 3 * mhla_layers, "mix_states_dense": 3 * mhla_layers,
        "block_readout": 2 * mhla_layers, "unblockify_island": 2 * mhla_layers,
        "flash_attention": 2 * attn, "radial_flash_attention": 2 * sparse_layers,
        "unblockify": 3 * mhla_layers, "blockify": mhla_layers,
        "block_readout_bwd": mhla_layers, "flash_attention_bwd": attn,
        "radial_flash_attention_bwd": sparse_layers,
    }
    return {name: steps * n for name, n in per_step.items()}


def video_launches(mhla_layers: int, k9_per_step, k10_per_step) -> dict:
    """Launches of K5-K10 in VIDEO_STEPS steps: ``k9_per_step`` and
    ``k10_per_step`` are the per-step counts, one entry per step."""
    want = {name: VIDEO_STEPS * mhla_layers * per for name, per in VIDEO_KERNELS.items()}
    want["flash_attention"] = sum(k9_per_step)
    want["radial_flash_attention"] = sum(k10_per_step)
    return want


def log(msg: str) -> None:
    print(msg, flush=True)


_T0 = time.perf_counter()


def log_time(phase: str) -> None:
    """Print the seconds since the script started, after ``phase``: the run
    must stay within its time limit as phases are added."""
    log(f"[time] {phase} done at {time.perf_counter() - _T0:.1f} s")


def median_ms(fn, reps: int = 10, inner: int = 10, warmup: int = 3) -> float:
    """Time per call of ``fn()``: the median over ``reps`` CUDA-event
    timings of ``inner`` back-to-back calls, after warm-up. Where the host
    enqueues slower than the card runs, this is the host's cost per call."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def host_us(fn, calls: int = 100, reps: int = 5) -> float:
    """The host's cost of one call of ``fn()``, in microseconds: host clock
    over ``calls`` enqueues without a sync (after warm-up and a sync), the
    median of ``reps`` such timings (the host is shared and noisy). Above
    the card's time per call, the host sets the pace of back-to-back
    calls."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        times.append((time.perf_counter() - t0) / calls * 1e6)
    torch.cuda.synchronize()
    return statistics.median(times)


def device_ms(fn, reps: int = 5) -> float:
    """The card's time for one call of ``fn()``: CUDA events around one call
    after a sync, the median of ``reps``. A sleep kernel enqueued first keeps
    the card busy while the host enqueues the events and the call, so the
    host's cost of enqueueing is not counted."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: no CUDA device; the port's smoke run needs one")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log(f"[device] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    return smi


def phase_build(dev: torch.device) -> None:
    from mhla_tpu_torch.kernels import _build, fmap_rope, mhla_chunk
    from mhla_tpu_torch.ops import rotary_cos_sin

    t0 = time.perf_counter()
    so = _build.build()
    mhla_chunk._lib()
    t_nvcc = time.perf_counter() - t0
    x = torch.zeros(1, 16, 256, dtype=torch.bfloat16, device=dev)
    cos, sin = rotary_cos_sin(64, 128, device=dev)
    fmap_rope.fused_fmap_rope_flat(x, cos, sin, 2, "relu")  # compiles the Triton kernel
    torch.cuda.synchronize()
    log(f"[build] nvcc {t_nvcc:.1f} s, K1 Triton {time.perf_counter() - t0 - t_nvcc:.1f} s, "
        f"library {so.name}")
    for line in so.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line:
            log(f"[build] ptxas: {line.strip()}")


def _as_tuple(x):
    return x if isinstance(x, tuple) else (x,)


# Published peaks of one H100 SXM (dense): device memory 3.35 TB/s, bf16 on
# the tensor cores 989 TFLOP/s, TF32 on them 495 TFLOP/s (K6's products),
# float32 outside them 67 TFLOP/s.
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, "tf32": 495e12, torch.float32: 67e12}


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def check_kernel(results: dict, name: str, shape_tag: str, kern, plain, timed: bool,
                 work=None, library=None, tol: float = 0.0, timing=None) -> None:
    """Run ``kern`` and ``plain`` once, hold every output of the kernel
    against the plain version's (relative RMS below ``tol``, KERNEL_TOL
    unless given), and time both when ``timed``. ``work`` = (bytes moved
    with each input read and each output written once, operations, dtype of
    the operations' inputs) gives the bound: the larger of bytes over the
    card's memory rate and operations over its peak for that dtype.
    ``library`` is one PyTorch call that computes the same function, timed
    beside the kernel and used nowhere else. ``timing`` = keyword arguments
    of :func:`median_ms` for calls that take tens of milliseconds."""
    from mhla_tpu_torch.utils import get_abs_err, get_err_ratio

    tol = tol or KERNEL_TOL
    timing = timing or {}
    outs_k, outs_p = _as_tuple(kern()), _as_tuple(plain())
    torch.cuda.synchronize()
    rel = max(get_err_ratio(p, k) for p, k in zip(outs_p, outs_k))
    err = max(get_abs_err(p, k) for p, k in zip(outs_p, outs_k))
    finite = all(torch.isfinite(k.float()).all() for k in outs_k)
    if not (finite and rel < tol):
        raise AssertionError(
            f"{name} {shape_tag}: rel-RMS {rel:.3e} (tol {tol}) max|d| {err:.3e}")
    del outs_k, outs_p
    r = results.setdefault(name, {"max_abs_err": 0.0})
    r["max_abs_err"] = max(r["max_abs_err"], err)
    msg = (f"[kernels] {name:17s} {shape_tag:18s} rel-RMS {rel:.2e} (tol {tol}) "
           f"max|d| {err:.2e}")
    if timed:
        moved, ops, dtype = work
        t_bytes, t_ops = moved / PEAK_BYTES * 1e3, ops / PEAK_FLOPS[dtype] * 1e3
        ms, plain_ms = median_ms(kern, **timing), median_ms(plain, **timing)
        r.update(ms=ms, plain_ms=plain_ms, bound_ms=max(t_bytes, t_ops),
                 bound_by="bytes" if t_bytes >= t_ops else "operations",
                 library_ms=median_ms(library, **timing) if library is not None else None)
        # 100 enqueues 5 times where a call is short; 10 once for calls of a
        # millisecond or more, whose host cost is a small share of them
        r.update(host_us=host_us(kern, *((100, 5) if ms < 1 else (10, 1))),
                 device_ms=device_ms(kern))
        HOST_DEVICE[f"{name} {shape_tag}"] = {"host_us": r["host_us"], "device_ms": r["device_ms"]}
        msg += (f"  kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  bound {r['bound_ms']:.4f} ms "
                f"({r['bound_by']})")
        if library is not None:
            msg += f"  library {r['library_ms']:.4f} ms"
        msg += f"  host {r['host_us']:.1f} us/call  device {r['device_ms']:.4f} ms/call"
    log(msg)
    if timed and (name.startswith("flash_attention") or (name, shape_tag) in CHUNK_MMA_SYNC_MS
                  or (name, shape_tag) in VIDEO_EARLIER_MS or (name, shape_tag) in GLA_EARLIER_MS
                  or (name, shape_tag) in DELTA_EARLIER_MS):
        log_redesign_time(name, shape_tag, r)


def log_redesign_time(name: str, shape_tag: str, r: dict) -> None:
    """Keep a timed K9 / K9b, K2 / K2b, K3 / K3b, K6, K7, K7b, K10, K10b, K11, K11b,
    K12 or K12b form's time in this run beside its bound and the library call's time,
    and print them with its time with the earlier kernels, with the ratios.
    The earlier times are printed only: they were not measured in this run."""
    key = (name, shape_tag)
    before = ((FLASH_MMA_SYNC_MS.get(key),) if name.startswith("flash_attention")
              else CHUNK_MMA_SYNC_MS.get(key) or VIDEO_EARLIER_MS.get(key)
              or GLA_EARLIER_MS.get(key) or DELTA_EARLIER_MS.get(key, ()))
    before = tuple(x for x in before if x)
    lib = r["library_ms"]
    REDESIGN_TIMES[f"{name} {shape_tag}"] = {
        "ms": r["ms"], "bound_ms": r["bound_ms"], "library_ms": lib,
        "bound_over_ms": r["bound_ms"] / r["ms"], "ms_over_library": r["ms"] / lib if lib else None}
    msg = f"[vs earlier kernels] {name} {shape_tag}: {r['ms']:.4f} ms"
    msg += ("; earlier kernels " + " / ".join(f"{x:.4f}" for x in before) + " ms (" +
            " / ".join(f"{x / r['ms']:.2f}x" for x in before) + ")" if before
            else "; earlier kernels not timed")
    msg += f"; bound {r['bound_ms']:.4f} ms ({r['bound_ms'] / r['ms']:.1%} of it)"
    if lib:
        msg += f"; library {lib:.4f} ms (kernel / library {r['ms'] / lib:.2f})"
    log(msg)


def phase_kernels(dev: torch.device) -> dict:
    """Each forward kernel against its plain version at the serving and the
    training shapes."""
    from mhla_tpu_torch.kernels import fmap_rope, mhla_chunk
    from mhla_tpu_torch.ops import rotary_cos_sin
    from mhla_tpu_torch.ops.mhla_chunk import init_causal_mixing_matrix

    h, dk, dv, c = 4, 128, 256, 64
    bf16 = torch.bfloat16
    gen = torch.Generator(dev).manual_seed(SEED)
    randn = lambda *s: torch.randn(*s, generator=gen, device=dev)  # noqa: E731
    cos, sin = rotary_cos_sin(2048, dk, device=dev)
    results = {}
    check = lambda *a: check_kernel(results, *a)  # noqa: E731

    for b, t, timed in ((4, 2048, True), (1, 781, False), (TRAIN_BATCH, TRAIN_SEQ, False)):
        tag = f"B={b} T={t}"
        x = randn(b, t, h * dk).to(bf16)
        check("fmap_rope", tag,
              lambda: fmap_rope.fused_fmap_rope_flat(x, cos, sin, h, "relu"),
              lambda: fmap_rope.fmap_rope_plain(x, cos, sin, h, "relu"), timed,
              (2 * nbytes(x) + nbytes(cos[:t], sin[:t]), 6 * x.numel(), torch.float32))
        n = -(-t // c)
        tp = n * c
        tri, pairs = c * (c + 1) // 2, n * (n - 1) // 2  # kept score entries, (i, j < i) pairs

        def tokens(d, relu):
            y = randn(b, tp, h * d)
            y[:, t:] = 0  # the zero padding of the ragged last chunk
            y = torch.relu(y) if relu else y
            return y.to(bf16).reshape(b, n, c, h * d).contiguous()

        q4, k4, v4 = tokens(dk, True), tokens(dk, True), tokens(dv, False)
        m = torch.tril(init_causal_mixing_matrix(32, device=dev)[:n, :n] * dk**-0.5)
        m_strict = torch.tril(m, -1).to(bf16).float().contiguous()
        m_diag = torch.diagonal(m).contiguous()
        states4 = mhla_chunk.chunk_states_plain(k4, v4, h)
        mixed4 = mhla_chunk.mix_states_plain(m_strict, states4)
        m_bf = m_strict.to(bf16)
        check("chunk_states", tag, lambda: mhla_chunk.chunk_states(k4, v4, h),
              lambda: mhla_chunk.chunk_states_plain(k4, v4, h), timed,
              (nbytes(k4, v4, states4), 2 * b * n * c * h * dk * dv, bf16),
              lambda: torch.einsum("bnchk,bnchv->bnhkv", k4.unflatten(-1, (h, dk)),
                                   v4.unflatten(-1, (h, dv))))
        check("mix_states", tag, lambda: mhla_chunk.mix_states(m_strict, states4),
              lambda: mhla_chunk.mix_states_plain(m_strict, states4), timed,
              (nbytes(m_strict) + 2 * nbytes(states4), 2 * pairs * b * h * dk * dv, bf16),
              lambda: torch.einsum("ij,bjrd->bird", m_bf, states4))
        check("chunk_output", tag,
              lambda: mhla_chunk.chunk_output(q4, k4, v4, mixed4, m_diag, h),
              lambda: mhla_chunk.chunk_output_plain(q4, k4, v4, mixed4, m_diag, h), timed,
              (nbytes(q4, k4, v4, mixed4, m_diag) + nbytes(v4),
               2 * b * n * h * (c * dk * dv + tri * (dk + dv)), bf16))

    x1 = randn(4, 1, h * dk).to(bf16)
    check("fmap_rope", "B=4 T=1 offset=1984",
          lambda: fmap_rope.fused_fmap_rope_flat(x1, cos, sin, h, "relu", offset=1984),
          lambda: fmap_rope.fmap_rope_plain(x1, cos, sin, h, "relu", offset=1984), False)

    # K2 and K3 at (a)'s prefill (4 x 1984: 31 chunks), where the host's
    # cost of a call must stay below the card's time for it; K2 also at
    # (c)'s rows and (u)'s 16,384-token row; K2's yardsticks
    extra = {}
    for b, t in ((BATCH_A, PROMPT_A), (TRAIN_BATCH, TRAIN_SEQ), (1, LONG_TRAIN_SEQ)):
        tag, n = f"B={b} T={t}", -(-t // c)
        k4 = torch.relu(randn(b, n, c, h * dk)).to(bf16)
        v4 = randn(b, n, c, h * dv).to(bf16)
        states4 = mhla_chunk.chunk_states_plain(k4, v4, h)
        check_kernel(extra, "chunk_states", tag, lambda: mhla_chunk.chunk_states(k4, v4, h),
                     lambda: mhla_chunk.chunk_states_plain(k4, v4, h), True,
                     (nbytes(k4, v4, states4), 2 * b * n * c * h * dk * dv, bf16),
                     lambda: torch.einsum("bnchk,bnchv->bnhkv", k4.unflatten(-1, (h, dk)),
                                          v4.unflatten(-1, (h, dv))))
        results.setdefault("k2_times", {})[tag] = dict(extra["chunk_states"])
        if t == PROMPT_A:
            m = torch.tril(init_causal_mixing_matrix(32, device=dev)[:n, :n] * dk**-0.5)
            m_strict = torch.tril(m, -1).to(bf16).float().contiguous()
            pairs = n * (n - 1) // 2
            check_kernel(extra, "mix_states", tag,
                         lambda: mhla_chunk.mix_states(m_strict, states4),
                         lambda: mhla_chunk.mix_states_plain(m_strict, states4), True,
                         (nbytes(m_strict) + 2 * nbytes(states4), 2 * pairs * b * h * dk * dv,
                          bf16),
                         lambda: torch.einsum("ij,bjrd->bird", m_strict.to(bf16), states4))
            for name in ("chunk_states", "mix_states"):
                r = extra[name]
                log(f"[host] {name} at (a)'s {tag}: host {r['host_us']:.1f} us a call, card "
                    f"{r['device_ms'] * 1e3:.1f} us a call: the host "
                    f"{'below' if r['host_us'] < r['device_ms'] * 1e3 else 'NOT below'} the card")
            results["host_at_a"] = {name: {key: extra[name][key] for key in
                                           ("host_us", "device_ms", "ms", "bound_ms")}
                                    for name in ("chunk_states", "mix_states")}
        if t == TRAIN_SEQ:
            results["k2_yardsticks"] = k2_yardsticks(k4, v4, h, tag)
        del k4, v4, states4

    # K4 at (c)'s training rows, where the main path launches it 144 times
    b, t = TRAIN_BATCH, TRAIN_SEQ
    tag, n = f"B={b} T={t}", t // c
    q4, k4 = (torch.relu(randn(b, n, c, h * dk)).to(bf16) for _ in range(2))
    v4 = randn(b, n, c, h * dv).to(bf16)
    m = torch.tril(init_causal_mixing_matrix(32, device=dev)[:n, :n] * dk**-0.5)
    m_diag = torch.diagonal(m).contiguous()
    mixed4 = mhla_chunk.mix_states_plain(torch.tril(m, -1).to(bf16).float(),
                                         mhla_chunk.chunk_states_plain(k4, v4, h))
    check_kernel(extra, "chunk_output", tag,
                 lambda: mhla_chunk.chunk_output(q4, k4, v4, mixed4, m_diag, h),
                 lambda: mhla_chunk.chunk_output_plain(q4, k4, v4, mixed4, m_diag, h), True,
                 (nbytes(q4, k4, v4, mixed4, m_diag) + nbytes(v4),
                  2 * b * n * h * (c * dk * dv + c * (c + 1) // 2 * (dk + dv)), bf16))
    results["k4_train"] = dict(extra["chunk_output"])
    del q4, k4, v4, mixed4
    torch.cuda.empty_cache()
    return results


def k2_yardsticks(k4, v4, h: int, tag: str) -> dict:
    """K2's PyTorch calls timed in turns (einsum, bmm with copies, bmm,
    bmm, bmm with copies, einsum): the einsum over k4 and v4 as they are,
    ``torch.bmm`` over permuted contiguous copies made inside the call (the
    same inputs and outputs as K2), and ``torch.bmm`` over copies made
    before (the product alone). Returns each one's times in turn order."""
    b, n, c, hdk = k4.shape
    dk, dv = hdk // h, v4.shape[-1] // h
    k5, v5 = k4.unflatten(-1, (h, dk)), v4.unflatten(-1, (h, dv))
    kt = k5.permute(0, 1, 3, 4, 2).reshape(-1, dk, c)
    vt = v5.permute(0, 1, 3, 2, 4).reshape(-1, c, dv)
    calls = {
        "einsum": lambda: torch.einsum("bnchk,bnchv->bnhkv", k5, v5),
        "bmm, copies counted": lambda: torch.bmm(k5.permute(0, 1, 3, 4, 2).reshape(-1, dk, c),
                                                 v5.permute(0, 1, 3, 2, 4).reshape(-1, c, dv)),
        "bmm, copies not counted": lambda: torch.bmm(kt, vt),
    }
    from mhla_tpu_torch.utils import get_err_ratio

    ref = calls["einsum"]().reshape(-1, dk, dv)
    for name, fn in calls.items():
        rel = get_err_ratio(ref, fn().reshape(-1, dk, dv))
        if not rel < KERNEL_TOL:
            raise AssertionError(f"K2 yardstick {name} disagrees with the einsum: {rel:.3e}")
    turns = ["einsum", "bmm, copies counted", "bmm, copies not counted",
             "bmm, copies not counted", "bmm, copies counted", "einsum"]
    out = {name: [] for name in calls}
    for name in turns:
        out[name].append(median_ms(calls[name]))
    log(f"[kernels] K2 yardsticks at {tag}, ms in turns: " +
        "; ".join(f"{name} " + " / ".join(f"{x:.4f}" for x in xs) for name, xs in out.items()))
    return out


def phase_kernels_video(dev: torch.device) -> dict:
    """K5-K9 against their plain versions at the shapes one ``MHLA3D`` call
    and one cross-attention of the Wan2.1-1.3B sampler give them (CFG batch
    2, 31,500 tokens): the default float32 island (timed, in the kernels
    line) and the bf16 island (``attn_compute_dtype=bfloat16``)."""
    import torch.nn.functional as F

    from mhla_tpu_torch.kernels import flash_attention as flash
    from mhla_tpu_torch.kernels import mhla_block
    from mhla_tpu_torch.ops.block_mix import block_mixing_matrix
    from mhla_tpu_torch.ops.rotary import rope_tables_flat

    b, h, dh = VIDEO_CFG_BATCH, VIDEO_HEADS, VIDEO_HEAD_DIM
    glt = (VIDEO_GRID, VIDEO_LAYOUT, h)
    t, n = math.prod(VIDEO_GRID), math.prod(VIDEO_LAYOUT)
    c, f = t // n, h * dh
    f32, bf16 = torch.float32, torch.bfloat16
    gen = torch.Generator(dev).manual_seed(SEED + 5)
    randn = lambda *s: torch.randn(*s, generator=gen, device=dev)  # noqa: E731
    results = {}
    check = lambda *a, **kw: check_kernel(results, *a, **kw)  # noqa: E731

    tables = rope_tables_flat(VIDEO_GRID, dh, device=dev)
    gamma, g_head = 1 + 0.1 * randn(f), 1 + 0.1 * randn(dh)
    x = randn(b, t, f).to(bf16)
    eps = 1e-6
    # K5 as q and k take it (norm, relu + eps, RoPE) and as v takes it (cast + permutation)
    check("blockify_island", "q/k bf16->f32",
          lambda: mhla_block.blockify_island(x, tables, gamma, *glt, eps, eps)[0],
          lambda: mhla_block.blockify_island_plain(x, tables, gamma, *glt, eps, eps)[0], True,
          work=(nbytes(x, gamma, *tables) + 4 * x.numel(), 12 * x.numel(), f32))
    check("blockify_island[v]", "v bf16->f32",
          lambda: mhla_block.blockify_island(x, None, None, *glt)[0],
          lambda: mhla_block.blockify_island_plain(x, None, None, *glt)[0], True,
          work=(nbytes(x) + 4 * x.numel(), x.numel(), f32))
    check("blockify_island[bf16]", "q/k bf16 +nope",
          lambda: mhla_block.blockify_island(x, tables, gamma, *glt, eps, eps, bf16, bf16, True),
          lambda: mhla_block.blockify_island_plain(x, tables, gamma, *glt, eps, eps, bf16, bf16,
                                                   True), False)
    del x

    m = torch.from_numpy(block_mixing_matrix(VIDEO_LAYOUT)).to(dev)
    states = randn(b, n, f, dh)
    q4 = torch.relu(randn(b, n, c, f)) + eps
    mixed = mhla_block.mix_states_dense_plain(m, states)
    # K6's and K7's bounds: the bytes, or the TF32 products at the tensor
    # cores' TF32 peak: three for float32 accuracy; one for the bf16 forms,
    # whose output rounding lies above a single TF32 product's error
    for dt, suffix, products in ((f32, "", 3), (bf16, "[bf16]", 1)):
        st, qq, mx = states.to(dt), q4.to(dt), mixed.to(dt)
        check("mix_states_dense" + suffix, f"{str(dt)[6:]} N={n}",
              lambda: mhla_block.mix_states_dense(m, st),
              lambda: mhla_block.mix_states_dense_plain(m, st), True,
              work=(nbytes(m) + 2 * nbytes(st), products * 2 * n * n * b * f * dh, "tf32"),
              library=lambda: torch.matmul(m.to(dt), st.view(b, n, f * dh)),
              tol=K6_F32_TOL if dt == f32 else KERNEL_TOL)
        check("block_readout" + suffix, f"{str(dt)[6:]} C={c}",
              lambda: mhla_block.block_readout(qq, mx, h),
              lambda: mhla_block.block_readout_plain(qq, mx, h), True,
              work=(2 * nbytes(qq) + nbytes(mx), products * 2 * b * n * c * h * dh * dh, "tf32"),
              library=lambda: torch.einsum("bnchk,bnhkv->bnchv", qq.unflatten(-1, (h, dh)),
                                           mx.unflatten(-2, (h, dh))),
              tol=K6_F32_TOL if dt == f32 else KERNEL_TOL)
        if not torch.equal(mhla_block.block_readout(qq, mx, h),
                           mhla_block.block_readout(qq, mx, h)):
            raise AssertionError(f"block_readout{suffix}: two runs differ")
        del st, qq, mx
    # K7 at the training shape, batch 1 (the forward and its remat recompute)
    q1, mx1 = q4[:1].contiguous(), mixed[:1].contiguous()
    check("block_readout[B=1]", f"float32 C={c} B=1",
          lambda: mhla_block.block_readout(q1, mx1, h),
          lambda: mhla_block.block_readout_plain(q1, mx1, h), True,
          work=(2 * nbytes(q1) + nbytes(mx1), 3 * 2 * n * c * h * dh * dh, "tf32"),
          library=lambda: torch.einsum("bnchk,bnhkv->bnchv", q1.unflatten(-1, (h, dh)),
                                       mx1.unflatten(-2, (h, dh))),
          tol=K6_F32_TOL)
    del q1, mx1
    # the training shape: batch 1, on M^T (the backward's dstates = M^T dmixed)
    mt, st1 = m.T.contiguous(), states[:1].contiguous()
    check("mix_states_dense[M^T]", f"float32 N={n} B=1",
          lambda: mhla_block.mix_states_dense(mt, st1),
          lambda: mhla_block.mix_states_dense_plain(mt, st1), True,
          work=(nbytes(mt) + 2 * nbytes(st1), 3 * 2 * n * n * f * dh, "tf32"),
          library=lambda: torch.matmul(mt, st1.view(1, n, f * dh)), tol=K6_F32_TOL)
    del states, mixed, st1

    # K8 on the default path (float32 island, rounded to bf16 before the norm) and on the bf16 island
    check("unblockify_island", "f32->bf16",
          lambda: mhla_block.unblockify_island(q4, g_head, *glt, eps, bf16, bf16),
          lambda: mhla_block.unblockify_island_plain(q4, g_head, *glt, eps, bf16, bf16), True,
          work=(nbytes(q4, g_head) + 2 * q4.numel(), 6 * q4.numel(), f32))
    qb = q4.to(bf16)
    del q4
    check("unblockify_island[bf16]", "bf16->bf16",
          lambda: mhla_block.unblockify_island(qb, g_head, *glt, eps, None, bf16),
          lambda: mhla_block.unblockify_island_plain(qb, g_head, *glt, eps, None, bf16), False)
    del qb

    # K9: the text cross-attention, and a self-attention of a ragged length
    for tq, tk, timed in ((t, VIDEO_TEXT_LEN, True), (1000, 1000, False)):
        q, k, v = (randn(b, tt, h, dh).to(bf16) for tt in (tq, tk, tk))
        check("flash_attention", f"Tq={tq} Tk={tk}",
              lambda: flash.flash_attention(q, k, v),
              lambda: flash.flash_attention_plain(q, k, v), timed, tol=FLASH_TOL,
              work=(2 * nbytes(q) + nbytes(k, v), 4 * b * h * tq * tk * dh, bf16),
              library=lambda: F.scaled_dot_product_attention(
                  q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)).transpose(1, 2))
    return results


def phase_kernels_hybrid(dev: torch.device) -> dict:
    """K10 against its plain version at the sampler's self-attention shape
    (CFG batch 2, 31,500 tokens in 21 frames of 1,500, 12 heads) and at a
    small ragged geometry, and K9 at Tq = Tk = 31,500. The bound counts the
    allowed pairs exactly, from the mask's formula, whatever tiles a kernel
    visits; the library call is ``scaled_dot_product_attention``, for K10
    with the boolean [T, T] mask (1 GB)."""
    import torch.nn.functional as F

    from mhla_tpu_torch.kernels import flash_attention as flash
    from mhla_tpu_torch.kernels import sparse_attention as sparse

    b, h, dh, frames = VIDEO_CFG_BATCH, VIDEO_HEADS, VIDEO_HEAD_DIM, VIDEO_GRID[0]
    t = math.prod(VIDEO_GRID)
    bf16 = torch.bfloat16
    gen = torch.Generator(dev).manual_seed(SEED + 9)
    randn = lambda *s: torch.randn(*s, generator=gen, device=dev)  # noqa: E731
    results = {}
    check = lambda *a, **kw: check_kernel(results, *a, **kw)  # noqa: E731
    slow = dict(reps=5, inner=2, warmup=1)  # calls of 20 ms to 1 s

    # 5 frames of 100 tokens: frames narrower than a key tile, tiles that
    # straddle frames, a ragged last tile
    qs, ks, vs = (randn(b, 500, 3, dh).to(bf16) for _ in range(3))
    check("radial_flash_attention", "T=500 5 frames",
          lambda: sparse.radial_flash_attention(qs, ks, vs, 5),
          lambda: sparse.radial_flash_attention_plain(qs, ks, vs, 5), False, tol=FLASH_TOL)
    k10_walk(sparse, qs, ks, vs, 5, training=False)

    q, k, v = (randn(b, t, h, dh).to(bf16) for _ in range(3))
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    t0 = time.perf_counter()
    offsets, tiles, full, _ = sparse.radial_fwd_lists(t, frames)
    t_sched = time.perf_counter() - t0
    own, step = sparse.FWD_WALK_TILES
    n_all = (len(offsets) - 1) * -(-t // step)
    pairs = sparse.radial_allowed_pairs(t, frames)
    log(f"[kernels] radial mask at {frames} frames of {t // frames}: {pairs / t**2:.4f} of the "
        f"pairs allowed; K10's lists of {own} x {step} tiles: {len(tiles)} of {n_all} tiles "
        f"= {len(tiles) / n_all:.4f}, {full.mean():.4f} of them full, "
        f"{np.diff(offsets).min()} to {np.diff(offsets).max()} per query block; built on the "
        f"host in {t_sched:.3f} s, once per geometry")
    mask = torch.cat([sparse.radial_block_mask(r, min(t, r + 2048), t, frames, dev)
                      for r in range(0, t, 2048)])
    masked_sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
        qt, kt, vt, attn_mask=mask).transpose(1, 2)
    try:
        masked_sdpa()
        torch.cuda.synchronize()
    except RuntimeError as exc:  # the yardstick only: the port never calls it
        log(f"[kernels] masked scaled_dot_product_attention cannot run here: {exc}")
        masked_sdpa = None
    check("radial_flash_attention", f"T={t} {frames} frames",
          lambda: sparse.radial_flash_attention(q, k, v, frames),
          lambda: sparse.radial_flash_attention_plain(q, k, v, frames), True, tol=FLASH_TOL,
          work=(4 * nbytes(q), 4 * b * h * dh * pairs, bf16), library=masked_sdpa, timing=slow)
    del mask
    k10_walk(sparse, q, k, v, frames, training=False)
    check("flash_attention[self]", f"Tq=Tk={t}",
          lambda: flash.flash_attention(q, k, v),
          lambda: flash.flash_attention_plain(q, k, v), True, tol=FLASH_TOL,
          work=(4 * nbytes(q), 4 * b * h * t * t * dh, bf16),
          library=lambda: F.scaled_dot_product_attention(qt, kt, vt).transpose(1, 2),
          timing=slow)
    return results


def phase_serve(dev: torch.device) -> dict:
    from mhla_tpu_torch import kernels
    from mhla_tpu_torch.models import MHLAForCausalLM, MHLALMConfig, generate, init_lm_params
    from mhla_tpu_torch.utils import get_err_ratio

    cfg = MHLALMConfig(dtype=torch.bfloat16)
    t0 = time.perf_counter()
    model = MHLAForCausalLM(cfg, device=dev)
    init_lm_params(model, torch.Generator(dev).manual_seed(SEED))
    model = model.to(torch.bfloat16).eval()
    n_params = sum(p.numel() for p in model.parameters())
    torch.cuda.synchronize()
    log(f"[serve] 340M MHLA LM: {cfg.num_hidden_layers} layers, hidden {cfg.hidden_size}, "
        f"{cfg.num_heads} heads, vocab {cfg.vocab_size}, context {cfg.max_context}, "
        f"{n_params / 1e6:.1f} M params bf16, built in {time.perf_counter() - t0:.1f} s")

    gen = torch.Generator(dev).manual_seed(SEED + 1)
    requests = [
        (torch.randint(0, cfg.vocab_size, (BATCH_A, PROMPT_A), generator=gen, device=dev), NEW_A),
        (torch.randint(0, cfg.vocab_size, (BATCH_B, PROMPT_B), generator=gen, device=dev), NEW_B),
    ]
    # warm-up request: compiles the Triton specializations of prefill and decode
    generate(model, requests[1][0][:, :100], max_new_tokens=4)
    torch.cuda.synchronize()

    kernels.reset_launch_counts()
    served = []
    for ids, new in requests:
        t0 = time.perf_counter()
        out, scores = generate(model, ids, max_new_tokens=new, output_scores=True)
        torch.cuda.synchronize()
        served.append((ids, new, out, scores, time.perf_counter() - t0))
    counts = kernels.launch_counts()
    log(f"[serve] launches in the two requests: {counts}")
    if not all(counts[name] > 0 for name in FWD_KERNELS):
        raise AssertionError(f"a kernel of the serving path never launched: {counts}")

    rates = {}
    with torch.no_grad():
        for ids, new, out, scores, t_total in served:
            b, t = ids.shape
            tag = f"{b} x {t} + {new}"
            if out.shape != (b, t + new) or scores.shape != (b, new, cfg.vocab_size):
                raise AssertionError(f"{tag}: shapes {tuple(out.shape)}, {tuple(scores.shape)}")
            full, _ = model(out[:, :-1])
            ref = full[:, t - 1:]
            if not (torch.isfinite(scores).all() and torch.isfinite(full).all()):
                raise AssertionError(f"{tag}: non-finite logits")
            rel = get_err_ratio(ref, scores)
            agree = (ref.argmax(-1) == scores.argmax(-1)).float().mean().item()
            log(f"[serve] {tag}: chunk vs recurrent logits rel-RMS {rel:.3e} "
                f"(tol {SERVE_TOL}), argmax agreement {agree:.3f}")
            if not rel < SERVE_TOL:
                raise AssertionError(f"{tag}: chunk != recurrent ({rel:.3e})")

            def prefill():
                model(ids, use_cache=True)

            t_pre = median_ms(prefill, reps=3, inner=1, warmup=1) / 1e3
            t_dec = t_total - t_pre
            rates[tag] = {
                "prefill_tok_s": b * t / t_pre,
                "decode_tok_s": b * (new - 1) / t_dec,
                "prefill_ms": t_pre * 1e3,
                "decode_ms_per_step": t_dec * 1e3 / (new - 1),
            }
            log(f"[serve] {tag}: prefill {t_pre * 1e3:.2f} ms = {b * t / t_pre:,.0f} tok/s; "
                f"decode {t_dec * 1e3 / (new - 1):.3f} ms/step = "
                f"{b * (new - 1) / t_dec:,.1f} tok/s")
    return {"launches": counts, "rates": rates}


def op_grads(dev: torch.device, b: int, t: int, kernels_path: bool, seed: int = SEED):
    """Gradients (dx_q, dx_k, dv, dM) of sum(o * w) for o = the chunk op on
    relu fmap + RoPE of x_q, x_k, bf16, with the 340M layer's head geometry:
    through the kernel entry points, or through autograd of the plain
    definitions (``fmap_rope_plain``, ``ops.mhla_chunk``). Also runs on the
    CPU, where the kernel entry points take their plain versions."""
    from mhla_tpu_torch.kernels import fmap_rope, mhla_chunk
    from mhla_tpu_torch.ops import clamp_causal_mixing_matrix, rotary_cos_sin
    from mhla_tpu_torch.ops import mhla_chunk as mhla_chunk_op

    h, dk, dv = 4, 128, 256
    gen = torch.Generator(dev).manual_seed(seed)
    randn = lambda *s: torch.randn(*s, generator=gen, device=dev)  # noqa: E731
    xq, xk = randn(b, t, h * dk).to(torch.bfloat16), randn(b, t, h * dk).to(torch.bfloat16)
    v = randn(b, t, h * dv).to(torch.bfloat16)
    m = torch.tril(torch.rand(32, 32, generator=gen, device=dev))
    w = randn(b, t, h * dv)
    xq, xk, v, m = (x.requires_grad_() for x in (xq, xk, v, m))
    cos, sin = rotary_cos_sin(2048, dk, device=dev)
    mm = clamp_causal_mixing_matrix(m)
    if kernels_path:
        q = fmap_rope.fused_fmap_rope_flat(xq, cos, sin, h, "relu")
        k = fmap_rope.fused_fmap_rope_flat(xk, cos, sin, h, "relu")
        o, _ = mhla_chunk.mhla_chunk_fused_flat(q, k, v, mm, num_heads=h)
    else:
        q = fmap_rope.fmap_rope_plain(xq, cos, sin, h, "relu").unflatten(-1, (h, dk))
        k = fmap_rope.fmap_rope_plain(xk, cos, sin, h, "relu").unflatten(-1, (h, dk))
        o, _ = mhla_chunk_op(q, k, v.unflatten(-1, (h, dv)), mm)
        o = o.flatten(-2)
    (o.float() * w).sum().backward()
    return xq.grad, xk.grad, v.grad, m.grad


def check_states_bwd(results: dict, tag: str, h: int, k4, v4, dstates4, dk_i, dv_i,
                     timed: bool) -> None:
    """K2b against its plain version, bit for bit over two runs; timed beside
    its bound and the library's two einsums, each adding its intra term in
    place (the same function: dk = v dS^T + dk_intra, dv = k dS + dv_intra)."""
    from mhla_tpu_torch.kernels import mhla_chunk

    b, n, c, hdk = k4.shape
    dk, dv = hdk // h, v4.shape[-1] // h
    k5, v5 = k4.view(b, n, c, h, dk), v4.view(b, n, c, h, dv)
    ds5 = dstates4.view(b, n, h, dk, dv)
    dki5, dvi5 = dk_i.view(b, n, c, h, dk), dv_i.view(b, n, c, h, dv)
    run = lambda: mhla_chunk.chunk_states_bwd(k4, v4, dstates4, dk_i, dv_i, h)  # noqa: E731
    check_kernel(results, "chunk_states_bwd", tag, run,
                 lambda: mhla_chunk.chunk_states_bwd_plain(k4, v4, dstates4, dk_i, dv_i, h),
                 timed,
                 (3 * nbytes(k4, v4) + nbytes(dstates4), 4 * b * n * c * h * dk * dv,
                  torch.bfloat16),
                 lambda: (torch.einsum("bnchv,bnhkv->bnchk", v5, ds5).add_(dki5),
                          torch.einsum("bnchk,bnhkv->bnchv", k5, ds5).add_(dvi5)))
    if not all(torch.equal(x, y) for x, y in zip(run(), run())):
        raise AssertionError(f"K2b {tag}: two runs differ")


def phase_grads(dev: torch.device) -> dict:
    """Each backward kernel against its plain version, then the op's
    gradients through the kernels against plain autograd."""
    from mhla_tpu_torch.kernels import fmap_rope, mhla_chunk
    from mhla_tpu_torch.ops import rotary_cos_sin
    from mhla_tpu_torch.ops.mhla_chunk import init_causal_mixing_matrix
    from mhla_tpu_torch.utils import get_err_ratio

    h, dk, dv, c = 4, 128, 256, 64
    bf16 = torch.bfloat16
    gen = torch.Generator(dev).manual_seed(SEED + 3)
    randn = lambda *s: torch.randn(*s, generator=gen, device=dev)  # noqa: E731
    cos, sin = rotary_cos_sin(2048, dk, device=dev)
    results = {}
    check = lambda *a: check_kernel(results, *a)  # noqa: E731

    for b, t, timed in ((TRAIN_BATCH, TRAIN_SEQ, True), (1, 781, False)):
        tag = f"B={b} T={t}"
        x, dy = randn(b, t, h * dk).to(bf16), randn(b, t, h * dk).to(bf16)
        check("fmap_rope_bwd", tag,
              lambda: fmap_rope.fmap_rope_bwd(dy, x, cos, sin, h, "relu"),
              lambda: fmap_rope.fmap_rope_bwd_plain(dy, x, cos, sin, h, "relu"), timed,
              (3 * nbytes(x) + nbytes(cos[:t], sin[:t]), 8 * x.numel(), torch.float32))
        n = -(-t // c)
        tri, pairs = c * (c + 1) // 2, n * (n - 1) // 2  # kept score entries, (i, j < i) pairs

        def tokens(d, relu):
            y = randn(b, n * c, h * d)
            y[:, t:] = 0  # the zero padding (and zero gradient) of the ragged last chunk
            y = torch.relu(y) if relu else y
            return y.to(bf16).reshape(b, n, c, h * d).contiguous()

        q4, k4, v4, do4 = tokens(dk, True), tokens(dk, True), tokens(dv, False), tokens(dv, False)
        m = torch.tril(init_causal_mixing_matrix(32, device=dev)[:n, :n] * dk**-0.5)
        m_strict = torch.tril(m, -1).to(bf16).float().contiguous()
        m_diag = torch.diagonal(m).contiguous()
        states4 = mhla_chunk.chunk_states_plain(k4, v4, h)
        mixed4 = mhla_chunk.mix_states_plain(m_strict, states4)
        _, dk_i, dv_i, dmixed4, _ = mhla_chunk.chunk_output_bwd_plain(
            q4, k4, v4, mixed4, m_diag, do4, h)
        dstates4, _ = mhla_chunk.mix_states_bwd_plain(m_strict, dmixed4, states4)
        check("chunk_output_bwd", tag,
              lambda: mhla_chunk.chunk_output_bwd(q4, k4, v4, mixed4, m_diag, do4, h),
              lambda: mhla_chunk.chunk_output_bwd_plain(q4, k4, v4, mixed4, m_diag, do4, h),
              timed,
              (2 * nbytes(q4, k4, v4, mixed4, m_diag) + nbytes(do4),
               2 * b * n * h * (2 * c * dk * dv + tri * (2 * dv + 3 * dk)), bf16))
        first, again = (mhla_chunk.chunk_output_bwd(q4, k4, v4, mixed4, m_diag, do4, h)
                        for _ in range(2))
        if not all(torch.equal(x, y) for x, y in zip(first, again)):
            raise AssertionError(f"chunk_output_bwd {tag}: two runs differ")
        del first, again
        m_bf, flat = m_strict.to(bf16), (b, n, h * dk * dv)
        check("mix_states_bwd", tag,
              lambda: mhla_chunk.mix_states_bwd(m_strict, dmixed4, states4),
              lambda: mhla_chunk.mix_states_bwd_plain(m_strict, dmixed4, states4), timed,
              (2 * nbytes(m_strict) + 3 * nbytes(states4), 4 * pairs * b * h * dk * dv, bf16),
              lambda: (torch.matmul(m_bf.T, dmixed4.view(flat)),
                       torch.einsum("bir,bjr->ij", dmixed4.view(flat), states4.view(flat))))
        check_states_bwd(results, tag, h, k4, v4, dstates4, dk_i, dv_i, timed)

    for b, t in ((TRAIN_BATCH, TRAIN_SEQ), (1, 781)):
        got = op_grads(dev, b, t, kernels_path=True)
        ref = op_grads(dev, b, t, kernels_path=False)
        torch.cuda.synchronize()
        rels = [get_err_ratio(r, g) for r, g in zip(ref, got)]
        log(f"[grads] op B={b} T={t}: rel-RMS dx_q {rels[0]:.3e} dx_k {rels[1]:.3e} "
            f"dv {rels[2]:.3e} dM {rels[3]:.3e} (tol {OP_GRAD_TOL}; CPU floor "
            f"{OP_GRAD_FLOOR_CPU})")
        if not (all(torch.isfinite(g).all() for g in got) and max(rels) < OP_GRAD_TOL):
            raise AssertionError(f"op gradients B={b} T={t} disagree: {rels}")
    return results


def check_mixing_matrices(model) -> int:
    """Every mixing matrix tril in [1e-5, 1] with a non-zero gradient; their count."""
    n_mix = 0
    for name, p in model.named_parameters():
        if name.endswith("mixing_matrix"):
            n_mix += 1
            low = p[torch.tril(torch.ones_like(p, dtype=torch.bool))]
            if torch.count_nonzero(torch.triu(p, 1)) or low.min() < 1e-5 or low.max() > 1:
                raise AssertionError(f"{name} left tril [1e-5, 1] after the steps")
            if p.grad is None or not torch.count_nonzero(p.grad):
                raise AssertionError(f"{name} got no gradient")
    return n_mix


def phase_train(dev: torch.device) -> dict:
    from mhla_tpu_torch import kernels
    from mhla_tpu_torch.train import lm_train

    with tempfile.TemporaryDirectory(prefix="mhla_train_") as work:
        argv = [
            f"--device={dev.type}", f"--work_dir={work}",
            f"--train.batch_size={TRAIN_BATCH}", f"--train.seq_len={TRAIN_SEQ}",
            f"--train.max_steps={TRAIN_STEPS}", "--train.log_interval=1",
            # configs/mhla_340m.yaml's optimizer, warm-up cut to one step
            "--optimizer.learning_rate=3e-4", "--optimizer.warmup_steps=1",
            "--optimizer.total_steps=20000",
        ]
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        out = lm_train.main(argv)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"[train] launches in {TRAIN_STEPS} steps: {counts}")
    losses = out["losses"]
    if len(losses) != TRAIN_STEPS or not all(map(math.isfinite, losses)):
        raise AssertionError(f"training losses {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"loss did not fall: {losses}")
    if not all(counts[name] > 0 for name in FWD_KERNELS + BWD_KERNELS):
        raise AssertionError(f"a kernel of the training path never launched: {counts}")
    n_mix = check_mixing_matrices(out["model"])
    step_s = statistics.median(out["step_seconds"][1:])
    tok_s = TRAIN_BATCH * TRAIN_SEQ / step_s
    log(f"[train] 340M, B={TRAIN_BATCH} T={TRAIN_SEQ}, float32 params, bf16 compute: "
        f"losses {[round(x, 4) for x in losses]}; grad norms "
        f"{[round(x, 3) for x in out['grad_norms']]}; {n_mix} mixing matrices tril in "
        f"[1e-5, 1] with non-zero gradients")
    log(f"[train] step {step_s * 1e3:.1f} ms (median of steps 2-{TRAIN_STEPS}; step 1 "
        f"{out['step_seconds'][0] * 1e3:.1f} ms) = {tok_s:,.0f} tok/s; checkpoint save "
        f"{out['save_seconds']:.2f} s; peak device memory {peak_gb:.1f} GB")
    return {"launches": counts, "step_ms": step_s * 1e3, "tok_s": tok_s,
            "save_s": out["save_seconds"], "losses": losses, "peak_gb": peak_gb}


# the hybrid 340M model of the packed-documents path (profile_step.HYBRID_ATTN):
# causal softmax attention, 8 heads of 128, in layers 0, 3, ..., 21
LM_MHLA_LAYERS, LM_SOFTMAX_LAYERS = 16, 8
# per training step of the hybrid on packed rows: K1 on q and k of every MHLA
# layer, K2-K4 once each, K9 (masked) once per softmax layer; the backward alike
HYBRID_TRAIN_LAUNCHES = {
    "fmap_rope": 2 * LM_MHLA_LAYERS, "chunk_states": LM_MHLA_LAYERS,
    "mix_states": LM_MHLA_LAYERS, "chunk_output": LM_MHLA_LAYERS,
    "flash_attention_masked": LM_SOFTMAX_LAYERS, "fmap_rope_bwd": 2 * LM_MHLA_LAYERS,
    "chunk_output_bwd": LM_MHLA_LAYERS, "mix_states_bwd": LM_MHLA_LAYERS,
    "chunk_states_bwd": LM_MHLA_LAYERS, "flash_attention_masked_bwd": LM_SOFTMAX_LAYERS,
    "flash_attention": 0, "flash_attention_bwd": 0,
}
# the kernel forms of the packed and hybrid path, each under the counter its
# wrapper adds to, and the phase whose run gives its launches
PACKED_FORMS = {
    "fmap_rope[positions]": "fmap_rope", "fmap_rope_bwd[positions]": "fmap_rope_bwd",
    "mix_states[per-row]": "mix_states", "chunk_output[per-row]": "chunk_output",
    "chunk_output_bwd[per-row]": "chunk_output_bwd", "mix_states_bwd[per-row]": "mix_states_bwd",
    "flash_attention[causal+segment]": "flash_attention_masked",
    "flash_attention_bwd[causal+segment]": "flash_attention_masked_bwd",
}


def hybrid_model_json(directory: str) -> str:
    """Write the hybrid 340M model as a reference-format model json (the
    keys of configs/mhla_340m.yaml's model, MHLALMConfig()'s values, plus
    ``attn``) into ``directory``; returns its path."""
    from mhla_tpu_torch.train.profile_step import HYBRID_ATTN

    from mhla_tpu_torch.models import MHLALMConfig

    cfg = MHLALMConfig()
    keys = ("hidden_size", "expand_k", "expand_v", "hidden_ratio", "num_hidden_layers",
            "num_heads", "feature_map", "attn_mode", "use_output_gate", "hidden_act",
            "max_position_embeddings", "norm_eps", "vocab_size", "tie_word_embeddings",
            "initializer_range", "chunk_size")
    raw = {"model_type": "mhla", **{k: getattr(cfg, k) for k in keys}, "attn": HYBRID_ATTN}
    path = f"{directory}/mhla_340M_hybrid.json"
    with open(path, "w") as f:
        json.dump(raw, f, indent=2)
    return path


def packed_segment_ids(dev: torch.device, b: int, t: int) -> torch.Tensor:
    """The segment ids of the first packed batch ``lm_train`` takes with
    ``--train.varlen=true`` (seed 42, the synthetic corpus), [B, T] on dev."""
    from mhla_tpu_torch.data import make_lm_dataloader

    batch = next(make_lm_dataloader(t, b, 32000, seed=42, varlen=True))
    return torch.from_numpy(batch["segment_ids"]).to(dev)


def kept_pairs(seg: torch.Tensor, causal: bool) -> int:
    """Query-key pairs the mask keeps, summed over the batch: per id, n^2
    pairs (n (n + 1) / 2 when causal) for its n tokens, wherever they lie."""
    total = 0
    for row in seg.cpu():
        n = torch.unique(row, return_counts=True)[1].long()
        total += int((n * (n + 1) // 2).sum() if causal else (n * n).sum())
    return total


def phase_kernels_packed(dev: torch.device) -> dict:
    """The per-row forms of K1/K1b, K3/K3b and K4/K4b and the causal and
    causal + segment-id forms of K9/K9b against their plain versions at the
    shapes the packed hybrid's training step gives them (B=8 T=2048 of
    ``PackedVarlenIterator`` rows, MHLA 4 heads of 128/256, softmax 8 heads
    of 128), each beside its bound and one library call; K9 and K9b also at
    an unaligned geometry with arbitrary ids; the tiles K9 and K9b walk
    against the rule's count and the full count."""
    from mhla_tpu_torch.train.profile_step import HYBRID_ATTN

    import torch.nn.functional as F

    from mhla_tpu_torch.kernels import flash_attention as flash
    from mhla_tpu_torch.kernels import fmap_rope, mhla_chunk
    from mhla_tpu_torch.ops import build_segment_mixing, rotary_cos_sin, segment_positions
    from mhla_tpu_torch.ops.mhla_chunk import init_causal_mixing_matrix
    from mhla_tpu_torch.utils import get_err_ratio

    b, t, h, dk, dv, c = TRAIN_BATCH, TRAIN_SEQ, 4, 128, 256, 64
    n = t // c
    bf16 = torch.bfloat16
    gen = torch.Generator(dev).manual_seed(SEED + 17)
    randn = lambda *s: torch.randn(*s, generator=gen, device=dev)  # noqa: E731
    results = {}
    check = lambda *a, **kw: check_kernel(results, *a, **kw)  # noqa: E731
    seg = packed_segment_ids(dev, b, t)
    docs = [len(torch.unique(r)) for r in seg.cpu()]
    log(f"[kernels packed] B={b} T={t}: {sum(docs)} segments (documents and pad runs), "
        f"{min(docs)} to {max(docs)} per row")
    tag = f"B={b} T={t} packed"

    pos = segment_positions(seg)
    cos, sin = rotary_cos_sin(2048, dk, device=dev)
    x, dy = randn(b, t, h * dk).to(bf16), randn(b, t, h * dk).to(bf16)
    check("fmap_rope[positions]", tag,
          lambda: fmap_rope.fused_fmap_rope_flat(x, cos, sin, h, "relu", positions=pos),
          lambda: fmap_rope.fmap_rope_plain(x, cos, sin, h, "relu", positions=pos), True,
          (2 * nbytes(x) + 4 * b * t + nbytes(cos, sin), 6 * x.numel(), torch.float32))
    check("fmap_rope_bwd[positions]", tag,
          lambda: fmap_rope.fmap_rope_bwd(dy, x, cos, sin, h, "relu", positions=pos),
          lambda: fmap_rope.fmap_rope_bwd_plain(dy, x, cos, sin, h, "relu", positions=pos), True,
          (3 * nbytes(x) + 4 * b * t + nbytes(cos, sin), 8 * x.numel(), torch.float32))
    del x, dy

    m = torch.tril(build_segment_mixing(init_causal_mixing_matrix(32, device=dev), seg, n, c)
                   * dk**-0.5)
    m_strict = torch.tril(m, -1).to(bf16).float().contiguous()
    m_diag = torch.diagonal(m, dim1=-2, dim2=-1).contiguous()
    pairs = int(torch.count_nonzero(m_strict))  # (b, i, j < i) pairs that mix
    q4, k4 = (torch.relu(randn(b, n, c, h * dk)).to(bf16) for _ in range(2))
    v4, do4 = (randn(b, n, c, h * dv).to(bf16) for _ in range(2))
    tri = c * (c + 1) // 2
    states4 = mhla_chunk.chunk_states_plain(k4, v4, h)
    mixed4 = mhla_chunk.mix_states_plain(m_strict, states4)
    m_bf = m_strict.to(bf16)
    check("mix_states[per-row]", tag, lambda: mhla_chunk.mix_states(m_strict, states4),
          lambda: mhla_chunk.mix_states_plain(m_strict, states4), True,
          (nbytes(m_strict) + 2 * nbytes(states4), 2 * pairs * h * dk * dv, bf16),
          lambda: torch.einsum("bij,bjrd->bird", m_bf, states4))
    check("chunk_output[per-row]", tag,
          lambda: mhla_chunk.chunk_output(q4, k4, v4, mixed4, m_diag, h),
          lambda: mhla_chunk.chunk_output_plain(q4, k4, v4, mixed4, m_diag, h), True,
          (nbytes(q4, k4, v4, mixed4, m_diag) + nbytes(v4),
           2 * b * n * h * (c * dk * dv + tri * (dk + dv)), bf16))
    _, _, _, dmixed4, _ = mhla_chunk.chunk_output_bwd_plain(q4, k4, v4, mixed4, m_diag, do4, h)
    check("chunk_output_bwd[per-row]", tag,
          lambda: mhla_chunk.chunk_output_bwd(q4, k4, v4, mixed4, m_diag, do4, h),
          lambda: mhla_chunk.chunk_output_bwd_plain(q4, k4, v4, mixed4, m_diag, do4, h), True,
          (2 * nbytes(q4, k4, v4, mixed4, m_diag) + nbytes(do4),
           2 * b * n * h * (2 * c * dk * dv + tri * (2 * dv + 3 * dk)), bf16))
    flat = (b, n, h * dk * dv)
    check("mix_states_bwd[per-row]", tag,
          lambda: mhla_chunk.mix_states_bwd(m_strict, dmixed4, states4),
          lambda: mhla_chunk.mix_states_bwd_plain(m_strict, dmixed4, states4), True,
          (2 * nbytes(m_strict) + 3 * nbytes(states4), 4 * pairs * h * dk * dv, bf16),
          lambda: (torch.matmul(m_bf.transpose(1, 2), dmixed4.view(flat)),
                   torch.matmul(dmixed4.view(flat), states4.view(flat).transpose(1, 2))))
    del q4, k4, v4, do4, states4, mixed4, dmixed4, m_bf

    # K9 / K9b at the softmax layers' shape: causal, and causal within packed documents
    ha, dh = HYBRID_ATTN["num_heads"], 128
    q, k, v, do = (randn(b, t, ha, dh).to(bf16) for _ in range(4))
    qt, kt, vt = (x.detach().transpose(1, 2).requires_grad_() for x in (q, k, v))
    dot = do.transpose(1, 2)
    n_tiles = -(-t // 64)
    walks = {}
    for form, causal, s in (("causal", True, None), ("causal+segment", True, seg)):
        keep = None
        if s is not None:
            ar = torch.arange(t, device=dev)
            keep = ((s[:, :, None] == s[:, None, :]) & (ar[:, None] >= ar[None, :]))[:, None]
        kept = kept_pairs(s, True) * ha if s is not None else b * ha * t * (t + 1) // 2
        sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qt.detach(), kt.detach(), vt.detach(), attn_mask=keep, is_causal=keep is None)
        sdpa_out = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=keep,
                                                  is_causal=keep is None)
        check(f"flash_attention[{form}]", tag,
              lambda: flash.flash_attention(q, k, v, causal=causal, segment_ids=s),
              lambda: flash.flash_attention_plain(q, k, v, causal=causal, segment_ids=s), True,
              tol=FLASH_TOL, work=(4 * nbytes(q), 4 * dh * kept, bf16), library=sdpa)
        o, lse = flash._flash_fwd(q, k, v, None, True, causal, s)
        if not torch.equal(o, flash.flash_attention(q, k, v, causal=causal, segment_ids=s)):
            raise AssertionError(f"K9 {form}: the training form and the serving form disagree")
        lse_rel = get_err_ratio(
            flash.flash_attention_plain(q, k, v, return_lse=True, causal=causal,
                                        segment_ids=s)[1], lse)
        if not lse_rel < 1e-5:
            raise AssertionError(f"K9 {form}: log-sum-exp vs plain {lse_rel:.3e}")
        check(f"flash_attention_bwd[{form}]", tag,
              lambda: flash.flash_attention_bwd(q, k, v, o, lse, do, None, causal, s),
              lambda: flash.flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal,
                                                      segment_ids=s), True,
              tol=FLASH_BWD_TOL,
              work=(nbytes(q, k, v, o, do, lse) + nbytes(q, k, v), 10 * dh * kept, bf16),
              library=lambda: torch.autograd.grad(sdpa_out, (qt, kt, vt), dot, retain_graph=True))
        first = flash.flash_attention_bwd(q, k, v, o, lse, do, None, causal, s)
        visits = torch.zeros(3, dtype=torch.int32, device=dev)
        flash._flash_fwd(q, k, v, None, False, causal, s, visits[:1])
        again = flash.flash_attention_bwd(q, k, v, o, lse, do, None, causal, s, visits[1:])
        if not all(torch.equal(x, y) for x, y in zip(first, again)):
            raise AssertionError(f"K9b {form}: two runs differ")
        want = flash.kernel_visits(causal, s, t, dh, ha, b)
        walked = visits.tolist()
        walks[form] = {"walked": walked, "rule": want, "full_64": b * ha * n_tiles**2,
                       "kept_pairs": kept}
        log(f"[kernels packed] K9 {form}: lse vs plain rel-RMS {lse_rel:.2e}; K9b two runs "
            f"equal; tiles walked by K9 / K9b dK,dV / K9b dQ {walked} (the rule's count "
            f"{want}; {b * ha * n_tiles**2} tiles of 64 x 64); kept pairs "
            f"{kept / (b * ha * t * t):.4f} of all")
        if walked != want:
            raise AssertionError(f"K9 {form} walked {walked} tiles, the rule says {want}")
        del o, lse, first, again, sdpa_out
    results["walks"] = walks

    # an unaligned geometry with arbitrary ids: T no multiple of the tile,
    # boundaries inside tiles, decreasing and recurring ids
    ts = 1000
    sa = torch.stack([(ts - torch.arange(ts)) // 97, torch.arange(ts) % 7]).to(dev)
    qs, ks, vs, dos = (randn(2, ts, 3, dh).to(bf16) for _ in range(4))
    for form, causal in (("segment", False), ("causal+segment", True)):
        check(f"flash_attention[{form}]", f"T={ts} arbitrary ids",
              lambda: flash.flash_attention(qs, ks, vs, causal=causal, segment_ids=sa),
              lambda: flash.flash_attention_plain(qs, ks, vs, causal=causal, segment_ids=sa),
              False, tol=FLASH_TOL)
        os_, lses = flash._flash_fwd(qs, ks, vs, None, True, causal, sa)
        check(f"flash_attention_bwd[{form}]", f"T={ts} arbitrary ids",
              lambda: flash.flash_attention_bwd(qs, ks, vs, os_, lses, dos, None, causal, sa),
              lambda: flash.flash_attention_bwd_plain(qs, ks, vs, os_, lses, dos, causal=causal,
                                                      segment_ids=sa), False,
              tol=FLASH_BWD_TOL)
    return results


def plain_lm_kernels():
    """Context in which the LM layers' kernel entry points (K1/K1b, the
    chunk op K2-K4b, and K9/K9b) run their plain PyTorch definitions on
    whatever device their tensors lie, with plain autograd (and the plain
    flash backward) for their gradients."""
    from mhla_tpu_torch.kernels import fmap_rope
    from mhla_tpu_torch.layers import attention, mhla_causal
    from mhla_tpu_torch.ops import mhla_chunk as chunk_op

    def fmap_plain(x, cos, sin, num_heads, feature_map=None, offset=0, positions=None):
        return fmap_rope.fmap_rope_plain(x, cos, sin, num_heads, feature_map, offset, positions)

    def chunk_plain(q, k, v, m, num_heads, chunk_size=64, output_final_state=False,
                    segment_ids=None):
        heads = lambda x: x.unflatten(-1, (num_heads, -1))  # noqa: E731
        o, s = chunk_op(heads(q), heads(k), heads(v), m, chunk_size, output_final_state,
                        segment_ids)
        return o.flatten(-2), s

    stack = contextlib.ExitStack()
    for module, name, plain in ((mhla_causal, "fused_fmap_rope_flat", fmap_plain),
                                (mhla_causal, "mhla_chunk_fused_flat", chunk_plain),
                                (attention, "flash_attention", plain_flash_attention)):
        stack.enter_context(mock.patch.object(module, name, plain))
    return stack


def check_block_grads(dev: torch.device) -> dict:
    """The gradients of one hybrid block pair (the MHLA block 2 and the
    softmax block 3 of the 340M hybrid, float32 parameters from the seeded
    init, norm weights moved off 1) on packed rows, B=2 T=2048, bf16
    activations: through the kernels against the plain definitions under
    plain autograd. The whole gradient (dx and every parameter's as one
    vector) is held to OP_GRAD_TOL, each tensor to LAYER_GRAD_TOL.

    Why the pair starts with the MHLA block, and why a tensor gets the
    wider bound: the relu feature map's derivative flips wherever two
    paths round a q or k projection near 0 to different signs, and the q/k
    projection weights' gradients, sums over 4,096 tokens that largely
    cancel, carry those flips. Fed the same input, both paths make the same
    projections; behind a softmax block they do not (K9 rounds its
    probabilities apart from the plain version, FLASH_TOL), and then the
    MHLA block's q/k weight gradients differed by 3.2-3.7e-2 on an H100
    (the plain definitions alone, on the card against the CPU, by
    2.7-3.1e-2) where dx differed by 7e-3."""
    from mhla_tpu_torch.train.profile_step import HYBRID_ATTN

    from mhla_tpu_torch import kernels
    from mhla_tpu_torch.models import MHLALMConfig
    from mhla_tpu_torch.models.gla_lm import MHLABlock
    from mhla_tpu_torch.utils import get_err_ratio

    cfg = MHLALMConfig(attn=HYBRID_ATTN)
    blocks = torch.nn.ModuleList([MHLABlock(cfg, i, device=dev) for i in (2, 3)])
    if [b.is_softmax for b in blocks] != [False, True]:
        raise AssertionError("layers 2 and 3 of the hybrid are not MHLA and softmax")
    gen = torch.Generator(dev).manual_seed(SEED + 18)
    with torch.no_grad():
        for name, p in blocks.named_parameters():
            if p.ndim == 2 and "mixing_matrix" not in name:
                p.normal_(0.0, cfg.initializer_range, generator=gen)
            elif "norm" in name:
                p.add_(0.1 * torch.randn(p.shape, generator=gen, device=dev))
    b, t = 2, TRAIN_SEQ
    seg = packed_segment_ids(dev, b, t)
    x = torch.randn(b, t, cfg.hidden_size, generator=gen, device=dev).to(torch.bfloat16)
    w = torch.randn(b, t, cfg.hidden_size, generator=gen, device=dev)

    class BlockPair(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.blocks = blocks

        def forward(self, y):
            for block in self.blocks:
                y, _ = block(y, segment_ids=seg)
            return y

    pair = BlockPair()
    kernels.reset_launch_counts()
    got = layer_grads(pair, x, w)
    launched = {k_: v_ for k_, v_ in kernels.launch_counts().items() if v_}
    kernels.reset_launch_counts()
    with plain_lm_kernels():
        ref = layer_grads(pair, x, w)
    if any(kernels.launch_counts().values()):
        raise AssertionError("the plain block pair launched a kernel")
    torch.cuda.synchronize()
    rels = {name: get_err_ratio(ref[name], got[name]) for name in ref}
    whole = get_err_ratio(torch.cat([g.flatten().float() for g in ref.values()]),
                          torch.cat([g.flatten().float() for g in got.values()]))
    worst = max(rels, key=rels.get)
    log(f"[grads] hybrid block pair (MHLA + softmax) on packed rows B={b} T={t}, kernels "
        f"{launched}: gradients vs plain definitions, rel-RMS all as one vector {whole:.3e} "
        f"(tol {OP_GRAD_TOL}), dx {rels['x']:.3e}, worst tensor {worst} {rels[worst]:.3e} "
        f"(tol {LAYER_GRAD_TOL})")
    if not (all(torch.isfinite(g).all() for g in got.values()) and whole < OP_GRAD_TOL
            and rels[worst] < LAYER_GRAD_TOL):
        raise AssertionError(f"hybrid block gradients: kernels != plain: {whole:.3e}, {rels}")
    return {"all": whole, "dx": rels["x"], "worst": worst, "worst_rel": rels[worst]}


def phase_serve_hybrid(dev: torch.device) -> dict:
    """``generate`` with the hybrid 340M model (bf16, seeded init): 4 x 1984
    + 64 and 1 x 781 + 32 greedy tokens. The prefills take the plain causal
    product in the softmax layers (T < 2048, as in JAX), the decode steps
    their KV caches. Checks finite logits, the exact launches, and the
    decode-step logits against one forward over the whole sequence (for the
    first request 2,048 tokens: K9's causal form in the 8 softmax layers)."""
    from mhla_tpu_torch.train.profile_step import HYBRID_ATTN

    from mhla_tpu_torch import kernels
    from mhla_tpu_torch.models import MHLAForCausalLM, MHLALMConfig, generate, init_lm_params
    from mhla_tpu_torch.utils import get_err_ratio

    cfg = MHLALMConfig(attn=HYBRID_ATTN, dtype=torch.bfloat16)
    model = MHLAForCausalLM(cfg, device=dev)
    init_lm_params(model, torch.Generator(dev).manual_seed(SEED))
    model = model.to(torch.bfloat16).eval()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"[serve hybrid] 340M hybrid: {LM_MHLA_LAYERS} MHLA + {LM_SOFTMAX_LAYERS} softmax layers "
        f"(layers {HYBRID_ATTN['layers']}, {HYBRID_ATTN['num_heads']} heads of 128), "
        f"{n_params / 1e6:.1f} M params bf16")
    gen = torch.Generator(dev).manual_seed(SEED + 1)
    requests = [
        (torch.randint(0, cfg.vocab_size, (BATCH_A, PROMPT_A), generator=gen, device=dev), NEW_A),
        (torch.randint(0, cfg.vocab_size, (BATCH_B, PROMPT_B), generator=gen, device=dev), NEW_B),
    ]
    generate(model, requests[1][0][:, :100], max_new_tokens=4)  # warm-up
    torch.cuda.synchronize()
    out = {"launches": {}, "rates": {}}
    for ids, new in requests:
        b, t = ids.shape
        tag = f"{b} x {t} + {new}"
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        toks, scores = generate(model, ids, max_new_tokens=new, output_scores=True)
        torch.cuda.synchronize()
        t_total = time.perf_counter() - t0
        counts = kernels.launch_counts()
        # K1 on q and k of every MHLA layer in the prefill and in each decode
        # step, K2-K4 in the prefill only; the softmax layers launch nothing
        want = {"fmap_rope": 2 * LM_MHLA_LAYERS * new, "chunk_states": LM_MHLA_LAYERS,
                "mix_states": LM_MHLA_LAYERS, "chunk_output": LM_MHLA_LAYERS,
                "flash_attention_masked": 0, "flash_attention": 0}
        if {name: counts[name] for name in want} != want:
            raise AssertionError(f"{tag}: launches {counts}, expected {want}")
        kernels.reset_launch_counts()
        with torch.no_grad():
            full, _ = model(toks)
        n_flash = kernels.launch_counts()["flash_attention_masked"]
        if n_flash != (LM_SOFTMAX_LAYERS if toks.shape[1] >= 2048 else 0):
            raise AssertionError(f"{tag}: the full forward launched K9's masked form {n_flash}x")
        ref = full[:, t - 1:-1]
        if not (torch.isfinite(scores).all() and torch.isfinite(full).all()):
            raise AssertionError(f"{tag}: non-finite logits")
        rel = get_err_ratio(ref, scores)
        log(f"[serve hybrid] {tag}: decode-step logits vs one forward over {toks.shape[1]} tokens "
            f"(K9 causal in it: {n_flash} launches) rel-RMS {rel:.3e} (tol {SERVE_TOL}); "
            f"launches {want}")
        if not rel < SERVE_TOL:
            raise AssertionError(f"{tag}: decode != full forward ({rel:.3e})")
        with torch.no_grad():  # as generate runs it: no autograd graph
            t_pre = median_ms(lambda: model(ids, use_cache=True), reps=3, inner=1,
                              warmup=1) / 1e3
        t_dec = t_total - t_pre
        out["rates"][tag] = {"prefill_ms": t_pre * 1e3, "prefill_tok_s": b * t / t_pre,
                             "decode_ms_per_step": t_dec * 1e3 / (new - 1),
                             "decode_tok_s": b * (new - 1) / t_dec, "decode_vs_full": rel}
        log(f"[serve hybrid] {tag}: prefill {t_pre * 1e3:.2f} ms = {b * t / t_pre:,.0f} tok/s; "
            f"decode {t_dec * 1e3 / (new - 1):.3f} ms/step = {b * (new - 1) / t_dec:,.1f} tok/s")
        if toks.shape[1] >= 2048:
            out["launches"] = {"flash_attention[causal]": n_flash}
    return out


def phase_train_hybrid(dev: torch.device, varlen: bool = True,
                       steps: int = TRAIN_STEPS) -> dict:
    """``lm_train.main --model_json=<hybrid> --train.varlen=true`` trains the
    hybrid 340M model ``steps`` steps on packed documents at B=8 T=2048
    (float32 parameters, bf16 compute, AdamW 3e-4 after a 1-step warm-up);
    with ``varlen`` false on plain token rows (K9 / K9b in their causal form).
    Checks a finite, falling loss, the exact launches (HYBRID_TRAIN_LAUNCHES
    per step), the mixing matrices tril in [1e-5, 1] with non-zero
    gradients, then (packed) the gradients of one hybrid block pair through
    the kernels against the plain definitions; prints step time, tok/s and
    peak memory."""
    from mhla_tpu_torch import kernels
    from mhla_tpu_torch.train import lm_train

    tag = "train hybrid" + ("" if varlen else " unpacked")
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="mhla_train_hybrid_") as work:
        argv = [
            f"--device={dev.type}", f"--work_dir={work}", f"--model_json={hybrid_model_json(work)}",
            f"--train.varlen={str(varlen).lower()}", f"--train.batch_size={TRAIN_BATCH}",
            f"--train.seq_len={TRAIN_SEQ}", f"--train.max_steps={steps}",
            "--train.log_interval=1", "--optimizer.learning_rate=3e-4",
            "--optimizer.warmup_steps=1", "--optimizer.total_steps=20000",
        ]
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        out = lm_train.main(argv)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"[{tag}] launches in {steps} steps: {counts}")
    want = {name: steps * n for name, n in HYBRID_TRAIN_LAUNCHES.items()}
    if {name: counts[name] for name in want} != want:
        raise AssertionError(f"hybrid training launches {counts}, expected {want}")
    losses = out["losses"]
    if len(losses) != steps or not all(map(math.isfinite, losses)):
        raise AssertionError(f"training losses {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"loss did not fall: {losses}")
    model = out["model"]
    if sum(b.is_softmax for b in model.model.layers) != LM_SOFTMAX_LAYERS:
        raise AssertionError("not the hybrid model")
    n_mix = check_mixing_matrices(model)
    step_s = statistics.median(out["step_seconds"][1:])
    tok_s = TRAIN_BATCH * TRAIN_SEQ / step_s
    log(f"[{tag}] 340M hybrid on {'packed' if varlen else 'token'} rows, B={TRAIN_BATCH} "
        f"T={TRAIN_SEQ}, {out['params'] / 1e6:.1f} M float32 params, bf16 compute: losses "
        f"{[round(x, 4) for x in losses]}; grad norms {[round(x, 3) for x in out['grad_norms']]}; "
        f"{n_mix} mixing matrices tril in [1e-5, 1] with non-zero gradients")
    log(f"[{tag}] step {step_s * 1e3:.1f} ms (median of steps 2-{steps}; step 1 "
        f"{out['step_seconds'][0] * 1e3:.1f} ms) = {tok_s:,.0f} tok/s; checkpoint save "
        f"{out['save_seconds']:.2f} s; peak device memory {peak_gb:.1f} GB")
    del out, model
    torch.cuda.empty_cache()
    result = {"launches": counts, "step_ms": step_s * 1e3, "tok_s": tok_s, "losses": losses,
              "peak_gb": peak_gb}
    if varlen:
        result["block_grads"] = check_block_grads(dev)
    return result


# The long-context hybrid (the 340M widths, softmax in layers 0, 3, ..., 21
# with the LM's default 4 heads of 256, 16 MHLA layers, 32,768 positions:
# 512 mixing slots). ppl_cli's blocks of 28,672 tokens mix 448 chunks, a
# 4,096-token prompt 64, a 16,384-token training row 256: every MHLA layer
# there takes the wide K3 / K3b, every softmax layer K9 / K9b at head dim 256.
LONG_POSITIONS, LONG_HEAD_DIM = 32768, 256
PPL_BLOCK, PPL_BUCKET, PPL_BLOCKS = 28672, 2048, 2
# Relative-RMS tolerance of the logits of a 28,672-token block through the
# kernels against the plain versions, over the block and in each 2,048-token
# bucket. Measured on an H100: 4.3e-2 over the block, 3.2e-2 in the first
# bucket growing to 4.8e-2 in the last (the bf16 noise of 24 layers on a
# bf16 residual stream, as decode vs full's 3.2e-2); K9 with its output past
# 2,048 tokens shifted by one row gives 1.6e-1 (bucket 1.9e-1), with its keys
# cut to a 2,048-token window 1.09. The limit sits between.
PPL_TOL = 1e-1
# Relative tolerance of the block's mean NLL, kernels vs plain: a coarse
# check (over a 4,096-token block the faults above moved it 7.8e-5, 4.1e-4)
PPL_NLL_TOL = 1e-2
LONG_PROMPT, LONG_NEW = 4096, 32
LONG_TRAIN_SEQ, LONG_TRAIN_STEPS = 16384, 3
# per forward of the long-context hybrid on token rows: K1 on q and k of
# every MHLA layer, K2, the wide K3 and K4 once each, K9 (causal) once per
# softmax layer; the backward alike
LONG_FWD_LAUNCHES = {
    "fmap_rope": 2 * LM_MHLA_LAYERS, "chunk_states": LM_MHLA_LAYERS,
    "mix_states": LM_MHLA_LAYERS, "chunk_output": LM_MHLA_LAYERS,
    "flash_attention_masked": LM_SOFTMAX_LAYERS, "flash_attention": 0,
}
LONG_BWD_LAUNCHES = {
    "fmap_rope_bwd": 2 * LM_MHLA_LAYERS, "chunk_output_bwd": LM_MHLA_LAYERS,
    "mix_states_bwd": LM_MHLA_LAYERS,
    "chunk_states_bwd": LM_MHLA_LAYERS, "flash_attention_masked_bwd": LM_SOFTMAX_LAYERS,
    "flash_attention_bwd": 0,
}
# the new kernel forms of this path, each under the counter its wrapper adds to
LONG_FORMS = {
    "flash_attention[causal,d256]": ("ppl", "flash_attention_masked"),
    "flash_attention_bwd[causal,d256]": ("train_long", "flash_attention_masked_bwd"),
    "flash_attention[causal+segment,d256]": ("train_d256_packed", "flash_attention_masked"),
    "flash_attention_bwd[causal+segment,d256]": ("train_d256_packed",
                                                 "flash_attention_masked_bwd"),
    "mix_states[wide]": ("ppl", "mix_states"),
    "mix_states_bwd[wide]": ("train_long", "mix_states_bwd"),
}


def long_model_json(directory: str, positions: int = LONG_POSITIONS) -> str:
    """Write the long-context hybrid as a reference-format model json: the
    hybrid's keys with ``max_position_embeddings`` = ``positions`` and an
    ``attn`` without ``num_heads`` (the LM's 4 heads of 256)."""
    with open(hybrid_model_json(directory)) as f:
        raw = json.load(f)
    raw["max_position_embeddings"] = positions
    raw["attn"] = {"layers": list(range(0, 24, 3))}
    path = f"{directory}/mhla_340M_hybrid_{positions}.json"
    with open(path, "w") as f:
        json.dump(raw, f, indent=2)
    return path


def phase_kernels_long(dev: torch.device) -> dict:
    """K9 / K9b at head dim 256 in the non-causal, causal and causal +
    segment-id forms at [8, 2048, 4, 256] (segment ids from
    ``PackedVarlenIterator`` rows), in the causal form at the long-context
    path's own shapes ([1, 16,384, 4, 256] of (u), forward and backward;
    [1, 28,672, 4, 256] of (s), forward), and at an unaligned length with
    arbitrary ids; the lse; two K9b runs bit for bit; the tiles walked
    against the rule's count. Then the wide K3 / K3b at N = 64, 256, 448 and
    512 chunks of the 340M's states (B=1, 4 heads of 128 x 256); two K3b runs
    bit for bit; and K3 / K3b timed at the 340M's N = 32 shapes. Each timed beside its plain version, its bound
    and one library call (SDPA with its flash or memory-efficient backend;
    ``torch.matmul`` of the masked M). The kernels line keeps each form's
    time at the shape its main-path phase runs (the last timed)."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from mhla_tpu_torch.kernels import flash_attention as flash
    from mhla_tpu_torch.kernels import mhla_chunk
    from mhla_tpu_torch.utils import get_err_ratio

    h, dh = 4, LONG_HEAD_DIM
    bf16 = torch.bfloat16
    gen = torch.Generator(dev).manual_seed(SEED + 31)
    randn = lambda *s: torch.randn(*s, generator=gen, device=dev)  # noqa: E731
    results = {}
    check = lambda *a, **kw: check_kernel(results, *a, **kw)  # noqa: E731
    slow = dict(reps=5, inner=2, warmup=1)
    walks, flash_times = {}, {}
    backends = [SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION]

    def flash_form(b, t, form, causal, s, backward=True):
        tag = f"B={b} T={t} H={h} D={dh}"
        q, k, v, do = (randn(b, t, h, dh).to(bf16) for _ in range(4))
        keep = None
        if s is not None:
            ar = torch.arange(t, device=dev)
            keep = ((s[:, :, None] == s[:, None, :]) & (ar[:, None] >= ar[None, :]))[:, None]
        kept = (kept_pairs(s, True) * h if s is not None
                else b * h * (t * (t + 1) // 2 if causal else t * t))
        qt, kt, vt = (x.detach().transpose(1, 2).requires_grad_(backward) for x in (q, k, v))

        def sdpa():
            with sdpa_kernel(backends):
                return F.scaled_dot_product_attention(qt.detach(), kt.detach(), vt.detach(),
                                                      attn_mask=keep,
                                                      is_causal=causal and keep is None)

        name = f"flash_attention[{form},d256]" if form else "flash_attention[d256]"
        check(name, tag,
              lambda: flash.flash_attention(q, k, v, causal=causal, segment_ids=s),
              lambda: flash.flash_attention_plain(q, k, v, causal=causal, segment_ids=s), True,
              tol=FLASH_TOL, work=(4 * nbytes(q), 4 * dh * kept, bf16), library=sdpa,
              timing=slow)
        flash_times[f"{name} {tag}"] = {key: results[name][key] for key in
                                        ("ms", "plain_ms", "bound_ms", "library_ms")}
        o, lse = flash._flash_fwd(q, k, v, None, True, causal, s)
        if not torch.equal(o, flash.flash_attention(q, k, v, causal=causal, segment_ids=s)):
            raise AssertionError(f"K9 d256 {form} {tag}: the training and serving forms disagree")
        lse_rel = get_err_ratio(
            flash.flash_attention_plain(q, k, v, return_lse=True, causal=causal,
                                        segment_ids=s)[1], lse)
        if not lse_rel < 1e-5:
            raise AssertionError(f"K9 d256 {form} {tag}: log-sum-exp vs plain {lse_rel:.3e}")
        msg = f"[kernels long] K9 d256 {form or 'plain'} {tag}: lse vs plain rel-RMS {lse_rel:.2e}"
        if backward:
            with sdpa_kernel(backends):
                sdpa_out = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=keep,
                                                          is_causal=causal and keep is None)
            dot = do.transpose(1, 2)

            def sdpa_bwd():
                return torch.autograd.grad(sdpa_out, (qt, kt, vt), dot, retain_graph=True)

            bwd_name = name.replace("flash_attention", "flash_attention_bwd")
            check(bwd_name, tag,
                  lambda: flash.flash_attention_bwd(q, k, v, o, lse, do, None, causal, s),
                  lambda: flash.flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal,
                                                          segment_ids=s), True,
                  tol=FLASH_BWD_TOL,
                  work=(nbytes(q, k, v, o, do, lse) + nbytes(q, k, v), 10 * dh * kept, bf16),
                  library=sdpa_bwd, timing=slow)
            flash_times[f"{bwd_name} {tag}"] = {key: results[bwd_name][key] for key in
                                                ("ms", "plain_ms", "bound_ms", "library_ms")}
            first = flash.flash_attention_bwd(q, k, v, o, lse, do, None, causal, s)
            again = flash.flash_attention_bwd(q, k, v, o, lse, do, None, causal, s)
            if not all(torch.equal(x, y) for x, y in zip(first, again)):
                raise AssertionError(f"K9b d256 {form} {tag}: two runs differ")
            msg += "; K9b two runs equal"
            del sdpa_out, first, again
        if causal:
            n_tiles = -(-t // 64)
            visits = torch.zeros(3, dtype=torch.int32, device=dev)
            flash._flash_fwd(q, k, v, None, False, causal, s, visits[:1])
            if backward:
                flash.flash_attention_bwd(q, k, v, o, lse, do, None, causal, s, visits[1:])
            want = flash.kernel_visits(causal, s, t, dh, h, b)[:3 if backward else 1]
            walked = visits.tolist()[:3 if backward else 1]
            walks[f"{form} {tag}"] = {"walked": walked, "rule": want,
                                      "full_64": b * h * n_tiles**2, "kept_pairs": kept}
            msg += (f"; tiles walked by K9{' / K9b dK,dV / K9b dQ' if backward else ''} "
                    f"{walked} (the rule's count {want}; {b * h * n_tiles**2} tiles of 64 x 64)")
            if walked != want:
                raise AssertionError(f"K9 d256 {form} {tag} walked {walked} tiles, "
                                     f"the rule says {want}")
        log(msg)
        del q, k, v, do, o, lse, qt, kt, vt, keep
        torch.cuda.empty_cache()

    b, t = TRAIN_BATCH, TRAIN_SEQ
    seg = packed_segment_ids(dev, b, t)
    # the causal form last at the long path's shapes: (u)'s 16,384-token row
    # (K9b's main-path shape), then (s)'s 28,672-token block (K9's)
    for fb, ft, form, causal, s, backward in (
            (b, t, "", False, None, True), (b, t, "causal", True, None, True),
            (b, t, "causal+segment", True, seg, True),
            (1, LONG_TRAIN_SEQ, "causal", True, None, True),
            (1, PPL_BLOCK, "causal", True, None, False)):
        flash_form(fb, ft, form, causal, s, backward)

    # an unaligned length with arbitrary ids: boundaries inside tiles,
    # decreasing and recurring ids
    ts = 1000
    sa = torch.stack([(ts - torch.arange(ts)) // 97, torch.arange(ts) % 7]).to(dev)
    qs, ks, vs, dos = (randn(2, ts, 3, dh).to(bf16) for _ in range(4))
    for form, causal in (("segment", False), ("causal+segment", True)):
        check(f"flash_attention[{form},d256]", f"T={ts} arbitrary ids",
              lambda: flash.flash_attention(qs, ks, vs, causal=causal, segment_ids=sa),
              lambda: flash.flash_attention_plain(qs, ks, vs, causal=causal, segment_ids=sa),
              False, tol=FLASH_TOL)
        os_, lses = flash._flash_fwd(qs, ks, vs, None, True, causal, sa)
        check(f"flash_attention_bwd[{form},d256]", f"T={ts} arbitrary ids",
              lambda: flash.flash_attention_bwd(qs, ks, vs, os_, lses, dos, None, causal, sa),
              lambda: flash.flash_attention_bwd_plain(qs, ks, vs, os_, lses, dos, causal=causal,
                                                      segment_ids=sa), False,
              tol=FLASH_BWD_TOL)
    results["walks_d256"] = walks
    results["flash_d256_times"] = flash_times

    # the wide K3 / K3b; the main path's N last, so its timing is the one kept
    hdk, dv = 4 * 128, 256
    r = hdk * dv
    mix_times = {}
    for kind, order in (("mix_states[wide]", (64, 256, 512, 448)),
                        ("mix_states_bwd[wide]", (64, 448, 512, 256))):
        for n in order:
            m = torch.rand(n, n, generator=gen, device=dev)
            m_strict = torch.tril(m * 128**-0.5, -1).to(bf16).float().contiguous()
            m_bf = m_strict.to(bf16)
            pairs = n * (n - 1) // 2
            states4 = randn(1, n, hdk, dv).to(bf16)
            if kind == "mix_states[wide]":
                check(kind, f"N={n}", lambda: mhla_chunk.mix_states(m_strict, states4),
                      lambda: mhla_chunk.mix_states_plain(m_strict, states4), True,
                      (nbytes(m_strict) + 2 * nbytes(states4), 2 * pairs * r, bf16),
                      lambda: torch.matmul(m_bf, states4.view(n, r)))
            else:
                dmixed4 = randn(1, n, hdk, dv).to(bf16)
                check(kind, f"N={n}", lambda: mhla_chunk.mix_states_bwd(m_strict, dmixed4, states4),
                      lambda: mhla_chunk.mix_states_bwd_plain(m_strict, dmixed4, states4), True,
                      (2 * nbytes(m_strict) + 3 * nbytes(states4), 4 * pairs * r, bf16),
                      lambda: (torch.matmul(m_bf.T, dmixed4.view(n, r)),
                               torch.matmul(dmixed4.view(n, r), states4.view(n, r).T)))
                first = mhla_chunk.mix_states_bwd(m_strict, dmixed4, states4)
                again = mhla_chunk.mix_states_bwd(m_strict, dmixed4, states4)
                if not all(torch.equal(x, y) for x, y in zip(first, again)):
                    raise AssertionError(f"K3b wide N={n}: two runs differ")
                del dmixed4, first, again
            mix_times[f"{kind} N={n}"] = {key: results[kind][key] for key in
                                          ("ms", "plain_ms", "bound_ms", "library_ms")}
            del states4
    log("[kernels long] K3b wide: two runs equal bit for bit at every N")
    results["mix_wide_times"] = mix_times

    # K2b at (u)'s row: 256 chunks of one 16,384-token row, 4 heads of 128 | 256
    n, h = LONG_TRAIN_SEQ // 64, 4
    k4, dk_i = (randn(1, n, 64, h * 128).to(bf16) for _ in range(2))
    v4, dv_i = (randn(1, n, 64, h * 256).to(bf16) for _ in range(2))
    ds4 = randn(1, n, h * 128, 256).to(bf16)
    k2b = {}
    check_states_bwd(k2b, f"B=1 T={LONG_TRAIN_SEQ}", h, k4, v4, ds4, dk_i, dv_i, True)
    results["k2b_long"] = {key: k2b["chunk_states_bwd"][key] for key in
                           ("ms", "plain_ms", "bound_ms", "library_ms")}
    del k4, v4, ds4, dk_i, dv_i

    # K3 and K3b at the 340M's N = 32 (the small form): serving 4 x 2048
    # tokens, training 8 x 2048 on token and on packed rows, each K3 beside
    # the einsum of its form of M
    n, pairs = 32, 32 * 31 // 2
    forms = {}
    for b, per_row in ((4, False), (TRAIN_BATCH, False), (TRAIN_BATCH, True)):
        shape = (b, n, n) if per_row else (n, n)
        m_strict = torch.tril(torch.rand(*shape, generator=gen, device=dev) * 128**-0.5,
                              -1).to(bf16).float().contiguous()
        m_bf = m_strict.to(bf16)
        states4, dmixed4 = (randn(b, n, hdk, dv).to(bf16) for _ in range(2))
        fwd_work = (nbytes(m_strict) + 2 * nbytes(states4), 2 * pairs * b * r, bf16)
        bwd_work = (2 * nbytes(m_strict) + 3 * nbytes(states4), 4 * pairs * b * r, bf16)
        times, row = {}, {}
        check_kernel(times, "K3", f"N=32 B={b}", lambda: mhla_chunk.mix_states(m_strict, states4),
                     lambda: mhla_chunk.mix_states_plain(m_strict, states4), True, fwd_work,
                     lambda: torch.einsum("bij,bjrd->bird" if per_row else "ij,bjrd->bird",
                                          m_bf, states4))
        row["K3"], row["K3 einsum"] = times["K3"]["ms"], times["K3"]["library_ms"]
        check_kernel(times, "K3b", f"N=32 B={b}",
                     lambda: mhla_chunk.mix_states_bwd(m_strict, dmixed4, states4),
                     lambda: mhla_chunk.mix_states_bwd_plain(m_strict, dmixed4, states4),
                     True, bwd_work)
        row["K3b"] = times["K3b"]["ms"]
        key = f"B={b} {'per-row' if per_row else 'shared'} M"
        forms[key] = row
        log(f"[kernels long] N=32 {key}: K3 {row['K3']:.4f} ms (einsum {row['K3 einsum']:.4f} "
            f"ms); K3b {row['K3b']:.4f} ms")
        del states4, dmixed4
    results["mix_n32_times"] = forms
    torch.cuda.empty_cache()
    return results


def phase_ppl(dev: torch.device, work: str) -> dict:
    """(s) ``ppl_cli.main`` on the long-context json: seeded init, bf16
    compute, 2 x 28,672 tokens made from the seed, blocks of 28,672 with
    buckets of 2,048. Checks a finite report with its 14 buckets and the
    exact launches; times the evaluator alone (tok/s, peak memory); then the
    logits of a whole 28,672-token block through the kernels against the
    same model on the plain versions, over the block and in each 2,048-token
    bucket, and the block's mean NLL. Returns the report and the model."""
    from mhla_tpu_torch import kernels
    from mhla_tpu_torch.eval import PerplexityEvaluator, ppl_cli
    from mhla_tpu_torch.models import MHLALMConfig
    from mhla_tpu_torch.utils import get_err_ratio

    model_json = long_model_json(work)
    vocab = MHLALMConfig.from_json(model_json).vocab_size
    tokens = np.random.default_rng(SEED + 32).integers(0, vocab, PPL_BLOCKS * PPL_BLOCK)
    shard = f"{work}/tokens.npy"
    np.save(shard, tokens.astype(np.int32))
    argv = [f"--model_json={model_json}", f"--tokens={shard}",
            f"--block_size={PPL_BLOCK}", f"--bucket_size={PPL_BUCKET}", "--bf16=true",
            f"--device={dev.type}", f"--out={work}/ppl.json"]
    torch.cuda.empty_cache()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    report = ppl_cli.main(argv)
    torch.cuda.synchronize()
    t_cli = time.perf_counter() - t0
    counts = kernels.launch_counts()
    want = {name: PPL_BLOCKS * n for name, n in LONG_FWD_LAUNCHES.items()}
    if {name: counts[name] for name in want} != want:
        raise AssertionError(f"ppl launches {counts}, expected {want}")
    buckets = [key for key in report if key.startswith("ppl@")]
    if len(buckets) != PPL_BLOCK // PPL_BUCKET or not all(map(math.isfinite, report.values())):
        raise AssertionError(f"ppl report {report}")
    cfg = ppl_cli.PPLConfig(model_json=model_json, device=dev.type)
    model = ppl_cli.build_model(cfg)
    n_params = sum(p.numel() for p in model.parameters())
    evaluator = PerplexityEvaluator(model, PPL_BLOCK, PPL_BUCKET)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    again = evaluator.evaluate_tokens(tokens)
    torch.cuda.synchronize()
    t_eval = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if again != report:
        raise AssertionError(f"the evaluator on the CLI's model disagrees: {again} != {report}")
    tok_s = PPL_BLOCKS * PPL_BLOCK / t_eval
    log(f"[ppl] 340M long-context hybrid ({n_params / 1e6:.1f} M params, "
        f"{model.config.num_slots} mixing slots, softmax heads of {LONG_HEAD_DIM}), "
        f"{PPL_BLOCKS} blocks of {PPL_BLOCK}: ppl {report['ppl']:.2f}, ppl@{PPL_BUCKET} "
        f"{report[f'ppl@{PPL_BUCKET}']:.2f} .. ppl@{PPL_BLOCK} {report[f'ppl@{PPL_BLOCK}']:.2f} "
        f"({len(buckets)} buckets); launches {want}")
    log(f"[ppl] evaluator {t_eval:.3f} s = {tok_s:,.0f} tok/s (CLI with model build "
        f"{t_cli:.2f} s); peak device memory {peak_gb:.1f} GB")

    ids = torch.from_numpy(tokens[:PPL_BLOCK]).to(dev, torch.long)[None]
    with torch.no_grad():
        logits_k = model(ids)[0][0].float()
        with plain_lm_kernels():
            kernels.reset_launch_counts()
            logits_p = model(ids)[0][0].float()
            if any(kernels.launch_counts().values()):
                raise AssertionError("the plain forward launched a kernel")
    rel = get_err_ratio(logits_p, logits_k)
    rel_buckets = [get_err_ratio(logits_p[i:i + PPL_BUCKET], logits_k[i:i + PPL_BUCKET])
                   for i in range(0, PPL_BLOCK, PPL_BUCKET)]
    labels = ids[0, 1:, None]
    nll_k, nll_p = (float((torch.logsumexp(x[:-1], -1) - x[:-1].gather(-1, labels)[:, 0]).mean())
                    for x in (logits_k, logits_p))
    nll_rel = abs(nll_k - nll_p) / abs(nll_p)
    del logits_k, logits_p
    worst = max(range(len(rel_buckets)), key=rel_buckets.__getitem__)
    log(f"[ppl] logits of a {PPL_BLOCK}-token block through the kernels vs the plain versions: "
        f"rel-RMS {rel:.3e}, worst bucket ppl@{(worst + 1) * PPL_BUCKET} "
        f"{rel_buckets[worst]:.3e} (tol {PPL_TOL}); by bucket "
        f"{[float(f'{x:.3e}') for x in rel_buckets]}")
    log(f"[ppl] mean NLL of that block through the kernels {nll_k:.5f} vs the plain versions "
        f"{nll_p:.5f}: rel {nll_rel:.3e} (tol {PPL_NLL_TOL})")
    if not (max(rel, *rel_buckets) < PPL_TOL and nll_rel < PPL_NLL_TOL):
        raise AssertionError(f"ppl kernels != plain: logits {rel:.3e}, buckets {rel_buckets}, "
                             f"mean NLL {nll_rel:.3e}")
    out = {"launches": counts, "report": report, "eval_s": t_eval, "tok_s": tok_s,
           "peak_gb": peak_gb, "logits_rel": rel, "logits_rel_buckets": rel_buckets,
           "nll_kernels": nll_k, "nll_plain": nll_p, "nll_rel": nll_rel, "params": n_params}
    return out, model


def phase_serve_long(dev: torch.device, model) -> dict:
    """(t) ``generate`` with 1 x 4,096 + 32 greedy tokens on the long-context
    hybrid (bf16): the prefill mixes 64 chunks (wide K3) and runs K9 causal
    at head dim 256; decode on the 512-slot states and the KV caches. Checks
    finite logits, the exact launches and the decode-step logits against one
    forward over the whole sequence."""
    from mhla_tpu_torch import kernels
    from mhla_tpu_torch.models import generate
    from mhla_tpu_torch.utils import get_err_ratio

    model = model.to(torch.bfloat16).eval()
    cfg = model.config
    ids = torch.randint(0, cfg.vocab_size, (1, LONG_PROMPT),
                        generator=torch.Generator(dev).manual_seed(SEED + 33), device=dev)
    generate(model, ids[:, :100], max_new_tokens=4)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    toks, scores = generate(model, ids, max_new_tokens=LONG_NEW, output_scores=True)
    torch.cuda.synchronize()
    t_total = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    counts = kernels.launch_counts()
    want = {**LONG_FWD_LAUNCHES, "fmap_rope": 2 * LM_MHLA_LAYERS * LONG_NEW}
    if {name: counts[name] for name in want} != want:
        raise AssertionError(f"long serve launches {counts}, expected {want}")
    with torch.no_grad():
        full, _ = model(toks)
    ref = full[:, LONG_PROMPT - 1:-1]
    if not (torch.isfinite(scores).all() and torch.isfinite(full).all()):
        raise AssertionError("long serve: non-finite logits")
    rel = get_err_ratio(ref, scores)
    with torch.no_grad():
        t_pre = median_ms(lambda: model(ids, use_cache=True), reps=3, inner=1, warmup=1) / 1e3
    t_dec = t_total - t_pre
    tag = f"1 x {LONG_PROMPT} + {LONG_NEW}"
    log(f"[serve long] {tag}: decode-step logits vs one forward over {toks.shape[1]} tokens "
        f"rel-RMS {rel:.3e} (tol {SERVE_TOL}); launches {want}")
    log(f"[serve long] {tag}: prefill {t_pre * 1e3:.2f} ms = {LONG_PROMPT / t_pre:,.0f} tok/s; "
        f"decode {t_dec * 1e3 / (LONG_NEW - 1):.3f} ms/step; peak device memory {peak_gb:.1f} GB")
    if not rel < SERVE_TOL:
        raise AssertionError(f"long serve: decode != full forward ({rel:.3e})")
    return {"launches": counts, "prefill_ms": t_pre * 1e3, "prefill_tok_s": LONG_PROMPT / t_pre,
            "decode_ms_per_step": t_dec * 1e3 / (LONG_NEW - 1), "decode_vs_full": rel,
            "peak_gb": peak_gb}


def phase_train_long(dev: torch.device, tag: str, positions: int, batch: int, seq: int,
                     steps: int, varlen: bool) -> dict:
    """``lm_train.main --model_json=<the long-context hybrid at ``positions``>``
    ``steps`` steps at B=``batch`` T=``seq`` (float32 parameters, bf16
    compute, AdamW 3e-4 after a 1-step warm-up, so the loss can fall from
    step 3 on): (u) token rows of 16,384
    (wide K3 / K3b at 256 chunks, K9 / K9b causal at head dim 256); (v)
    packed documents at 2,048 (K9 / K9b's causal + segment forms at head dim
    256, the per-row K3 / K3b). Checks finite, falling losses, the exact
    launches and the mixing matrices; step time, tok/s, peak memory."""
    from mhla_tpu_torch import kernels
    from mhla_tpu_torch.train import lm_train

    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="mhla_train_long_") as work:
        argv = [
            f"--device={dev.type}", f"--work_dir={work}",
            f"--model_json={long_model_json(work, positions)}",
            f"--train.varlen={str(varlen).lower()}", f"--train.batch_size={batch}",
            f"--train.seq_len={seq}", f"--train.max_steps={steps}",
            "--train.log_interval=1", "--optimizer.learning_rate=3e-4",
            "--optimizer.warmup_steps=1", "--optimizer.total_steps=20000",
        ]
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        out = lm_train.main(argv)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"[{tag}] launches in {steps} steps: { {k_: v_ for k_, v_ in counts.items() if v_} }")
    if varlen:
        want = {name: steps * n for name, n in HYBRID_TRAIN_LAUNCHES.items()}
    else:
        want = {name: steps * n for name, n in {**LONG_FWD_LAUNCHES, **LONG_BWD_LAUNCHES}.items()}
    if {name: counts[name] for name in want} != want:
        raise AssertionError(f"{tag} launches {counts}, expected {want}")
    losses = out["losses"]
    if len(losses) != steps or not all(map(math.isfinite, losses)):
        raise AssertionError(f"{tag} losses {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"{tag}: loss did not fall: {losses}")
    model = out["model"]
    attn = model.model.layers[0].attn
    if (attn.num_heads, attn.head_dim) != (model.config.num_heads, LONG_HEAD_DIM):
        raise AssertionError(f"{tag}: softmax layer has {attn.num_heads} heads of {attn.head_dim}")
    n_mix = check_mixing_matrices(model)
    step_s = statistics.median(out["step_seconds"][1:])
    tok_s = batch * seq / step_s
    log(f"[{tag}] 340M hybrid with heads of {LONG_HEAD_DIM}, {model.config.num_slots} slots, "
        f"{'packed' if varlen else 'token'} rows B={batch} T={seq}, "
        f"{out['params'] / 1e6:.1f} M params: losses {[round(x, 4) for x in losses]}; "
        f"{n_mix} mixing matrices tril in [1e-5, 1] with non-zero gradients")
    log(f"[{tag}] step {step_s * 1e3:.1f} ms (median of steps 2-{steps}; step 1 "
        f"{out['step_seconds'][0] * 1e3:.1f} ms) = {tok_s:,.0f} tok/s; peak device memory "
        f"{peak_gb:.1f} GB")
    del out, model
    torch.cuda.empty_cache()
    return {"launches": counts, "step_ms": step_s * 1e3, "tok_s": tok_s, "losses": losses,
            "peak_gb": peak_gb}


# The baseline LMs at the 340M widths, the Gated DeltaNet LM
# (attn_extends='gated_deltanet'; gla_lm.py's branch turns expand_k 0.5 and
# expand_v 1.0 into head_dim 128 and expand_v 2; short convs of 4 taps) and
# the GLA LMs ('gla', 'simple_gla'): 24 layers, 4 heads, Dk 128, Dv 256,
# chunk 64. Their kernels, forward and backward (BASE_KERNELS), run in every
# layer of a prefill longer than 64 tokens and of a training step.
BASE_LAYERS, BASE_HEADS, BASE_DK, BASE_DV, BASE_CHUNK = 24, 4, 128, 256, 64
# (ac) trains the Mamba LM at 3 of its 24 layers (the widths kept; 10.1 s a
# step at 24 layers, 5.02 s at 12, 2.52 s at 6 on an H100 80GB HBM3 at 700 W),
# to make room for (af), then (ag) and (ah)
MAMBA_TRAIN_LAYERS = 3
# The Mamba2 LM at the same widths (gla_lm.py's branch: head dim 1024 * 1.0
# / 4 = 256, expand 2, so 8 heads; d_state 128) runs K12 / K12b in their
# scalar-decay form (one log-decay per head, as simple GLA now does); the
# Mamba LM (its selective scan) and the causal linear-attention LM run
# plain PyTorch, as JAX runs jnp: no kernel.
BASE_KERNELS = {"gated_deltanet": ("delta_chunk_fwd", "delta_chunk_bwd"),
                "gla": ("gla_chunk_fwd", "gla_chunk_bwd"),
                "simple_gla": ("gla_chunk_fwd_scalar", "gla_chunk_bwd_scalar"),
                "mamba2": ("gla_chunk_fwd_scalar", "gla_chunk_bwd_scalar"),
                "mamba": (), "linear_attn": ()}
# (heads, Dk, Dv) of each baseline's attention layer at the 340M widths
# (Mamba2: Dk = d_state, Dv = head_dim; Mamba has no heads: None)
BASE_GEOMETRY = {"gated_deltanet": (4, 128, 256), "gla": (4, 128, 256),
                 "simple_gla": (4, 128, 256), "mamba2": (8, 128, 256), "mamba": None,
                 "linear_attn": (4, 128, 256)}
MAMBA2_HEADS = 8
# Relative-RMS tolerance of the op's gradients (q, k, v, g, beta, s0)
# through K11 / K11b (bf16 q, k, v; bf16 entry states and products at the
# TPU kernel's rounding points) against autograd of the plain op
# ``ops.delta_rule.gated_delta_chunk`` (float32 throughout) on the same CUDA
# tensors. The same comparison on the CPU's plain paths gives at most
# 6.1e-3 over [1, 781], [2, 1024], [2, 2048] and [8, 2048] (dg at 2 x 1024;
# 4.6e-3 at the training shape): the bf16 floor. A dropped term, a wrong
# transpose or a lost decay gives O(1).
DELTA_GRAD_FLOOR_CPU = 6.1e-3
DELTA_GRAD_TOL = 1e-2


def delta_inputs(dev: torch.device, b: int, t: int, seed: int = SEED):
    """Raw op inputs as the Gated DeltaNet layer makes them at the 340M
    widths: q, k, v bf16 [B, T, H, D]; g = -A softplus(x + dt_bias) with A
    up to 16 and dt log-uniform in [1e-3, 0.1] (the layer's init); beta a
    sigmoid; a nonzero initial state."""
    h, dk, dv = BASE_HEADS, BASE_DK, BASE_DV
    gen = torch.Generator(dev).manual_seed(seed)
    randn = lambda *s: torch.randn(*s, generator=gen, device=dev)  # noqa: E731
    q, k, v = randn(b, t, h, dk), randn(b, t, h, dk), randn(b, t, h, dv)
    a = torch.rand(h, generator=gen, device=dev) * 16
    dt = torch.exp(torch.rand(h, generator=gen, device=dev) * (math.log(0.1) - math.log(1e-3))
                   + math.log(1e-3))
    g = -a * torch.nn.functional.softplus(randn(b, t, h) + torch.log(torch.expm1(dt)))
    beta = torch.sigmoid(randn(b, t, h))
    s0 = 0.1 * randn(b, h, dk, dv)
    bf16 = torch.bfloat16
    return q.to(bf16), k.to(bf16), v.to(bf16), g, beta, s0


def delta_kernel_inputs(dev: torch.device, b: int, t: int, seed: int = SEED):
    """The padded, chunk-major inputs ``gated_delta_chunk_fused`` hands K11
    and K11b: L2-normed q, k and v in bf16, the within-chunk cumsum G and
    beta float32 (the ragged tail zero: g = 0, beta = 0), s0, and the
    cotangents dO (zero on the tail) and dS."""
    from mhla_tpu_torch.ops.delta_rule import l2norm
    from mhla_tpu_torch.ops.mhla_chunk import _pad_to_chunks

    c = BASE_CHUNK
    q, k, v, g, beta, s0 = delta_inputs(dev, b, t, seed)
    bf16 = torch.bfloat16
    q4, k4 = (_pad_to_chunks(l2norm(x.float()), c).to(bf16) for x in (q, k))
    v4 = _pad_to_chunks(v, c)
    n = q4.shape[1] // c
    g_cum = torch.cumsum(_pad_to_chunks(g, c).reshape(b, n, c, -1), 2).reshape(b, n * c, -1)
    bp = _pad_to_chunks(beta, c)
    gen = torch.Generator(dev).manual_seed(seed + 1)
    do4 = torch.randn(v4.shape, generator=gen, device=dev)
    do4[:, t:] = 0
    ds = torch.randn(s0.shape, generator=gen, device=dev)
    return q4, k4, v4, g_cum.contiguous(), bp, s0, do4.to(bf16), ds


def delta_work(b: int, n: int, backward: bool):
    """(bytes, operations, dtype) of K11 (training form: the entry states
    are an output) or K11b over B x N chunks of the 340M heads: every input
    read once and every output written once; the products of the formulas
    (the backward recomputes the forward's per-chunk products, as only the
    entry states are kept) in bf16, and the float32 triangular solve
    (C^3/3 multiply-adds per chunk and head) counted at its bf16-equivalent
    cost (989 / 67 operations each)."""
    h, dk, dv, c = BASE_HEADS, BASE_DK, BASE_DV, BASE_CHUNK
    tok = b * n * c * h
    state = b * h * dk * dv * 4
    states = b * n * h * dk * dv * 2
    qkv = tok * (2 * dk + dv) * 2
    gates = 2 * tok * 4
    if not backward:
        moved = qkv + gates + state + tok * dv * 2 + state + states
        ops = 2 * c * c * (3 * dk + 2 * dv) + 6 * c * dk * dv
    else:
        moved = (qkv + gates + states + tok * dv * 2 + state
                 + qkv + gates + state)
        ops = 2 * c * c * (9 * dk + 5 * dv) + 14 * c * dk * dv
    solve = 2 * c ** 3 / 3 * PEAK_FLOPS[torch.bfloat16] / PEAK_FLOPS[torch.float32]
    return moved, b * n * h * (ops + solve), torch.bfloat16


def delta_op_grads(dev: torch.device, b: int, t: int, kernels_path: bool):
    """Gradients of q, k, v, g, beta and s0 of sum(o * w) + sum(S * ws)
    through ``gated_delta_chunk_fused`` (K11 / K11b) or autograd of the
    plain op ``gated_delta_chunk``, same CUDA tensors."""
    from mhla_tpu_torch.kernels.delta_chunk import gated_delta_chunk_fused
    from mhla_tpu_torch.ops.delta_rule import gated_delta_chunk

    xs = [x.requires_grad_() for x in delta_inputs(dev, b, t, SEED + 5)]
    gen = torch.Generator(dev).manual_seed(SEED + 6)
    w = torch.randn(b, t, BASE_HEADS, BASE_DV, generator=gen, device=dev)
    ws = torch.randn(xs[5].shape, generator=gen, device=dev)
    fn = gated_delta_chunk_fused if kernels_path else gated_delta_chunk
    o, s = fn(*xs[:5], initial_state=xs[5], output_final_state=True)
    ((o.float() * w).sum() + (s * ws).sum()).backward()
    return [x.grad for x in xs]


def phase_kernels_delta(dev: torch.device) -> dict:
    """K11 and K11b against their plain versions at the training shape
    [8, 2048, 4, 128|256] (timed, beside their earlier kernels' times) and
    at 1 x 781 (a ragged last chunk), bf16 with a nonzero initial state; each
    twice, bit for bit; then the op's gradients through the kernels against
    plain autograd at both shapes."""
    from mhla_tpu_torch.kernels import delta_chunk as dc
    from mhla_tpu_torch.utils import get_err_ratio

    results = {}
    c = BASE_CHUNK
    for b, t, timed in ((TRAIN_BATCH, TRAIN_SEQ, True), (1, 781, False)):
        tag = f"B={b} T={t}"
        q4, k4, v4, g_cum, beta, s0, do4, ds = delta_kernel_inputs(dev, b, t)
        n = q4.shape[1] // c
        fwd = lambda: dc.delta_chunk_fwd(q4, k4, v4, g_cum, beta, s0, c, True)  # noqa: E731
        check_kernel(results, "delta_chunk_fwd", tag, fwd,
                     lambda: dc.delta_chunk_fwd_plain(q4, k4, v4, g_cum, beta, s0, c, True),
                     timed, delta_work(b, n, False))
        first, second = fwd(), fwd()
        torch.cuda.synchronize()
        if not all(torch.equal(x, y) for x, y in zip(first, second)):
            raise AssertionError(f"delta_chunk_fwd {tag}: two runs differ")
        del first, second
        states = dc.delta_chunk_fwd_plain(q4, k4, v4, g_cum, beta, s0, c, True)[2]
        bwd = lambda: dc.delta_chunk_bwd(q4, k4, v4, g_cum, beta, states, do4, ds, c)  # noqa: E731
        check_kernel(results, "delta_chunk_bwd", tag, bwd,
                     lambda: dc.delta_chunk_bwd_plain(q4, k4, v4, g_cum, beta, states, do4, ds, c),
                     timed, delta_work(b, n, True))
        first, second = bwd(), bwd()
        torch.cuda.synchronize()
        if not all(torch.equal(x, y) for x, y in zip(first, second)):
            raise AssertionError(f"delta_chunk_bwd {tag}: two runs differ")
        log(f"[kernels delta] delta_chunk_fwd and delta_chunk_bwd {tag}: two runs bit for bit "
            "equal")
        del first, second, states
    names = ("q", "k", "v", "g", "beta", "s0")
    for b, t in ((TRAIN_BATCH, TRAIN_SEQ), (1, 781)):
        got = delta_op_grads(dev, b, t, kernels_path=True)
        ref = delta_op_grads(dev, b, t, kernels_path=False)
        torch.cuda.synchronize()
        rels = {name: get_err_ratio(r, x) for name, r, x in zip(names, ref, got)}
        log(f"[grads delta] op B={b} T={t}: rel-RMS " + " ".join(
            f"d{name} {rel:.3e}" for name, rel in rels.items())
            + f" (tol {DELTA_GRAD_TOL}; CPU floor {DELTA_GRAD_FLOOR_CPU})")
        if not (all(torch.isfinite(x).all() for x in got) and max(rels.values()) < DELTA_GRAD_TOL):
            raise AssertionError(f"delta op gradients B={b} T={t} disagree: {rels}")
    return results


# The layer hands K12 / K12b float32 q, k, v and gk, as JAX's op computes:
# kernel and plain version then differ in the order of float32 sums only,
# and JAX holds its fused kernel to its op at 1e-4 (tests/test_kernels.py
# TestGLAFused). The bf16 form keeps KERNEL_TOL.
GLA_TOL = 1e-4
# The op's gradients through K12 / K12b against autograd of the plain op are
# held to GLA_TOL in float32 and, for bf16 inputs, to OP_GRAD_TOL: the kernels
# round qd, kd, the scores, dp, the entry states and the exit cotangents to
# bf16 as the TPU kernel does, the plain op rounds nothing.
GLA_BENCH = (1, 32768, 8, 128, 128)  # benchmarks/gla_bench.py's default (B, T, H, Dk, Dv)


def gla_kernel_inputs(dev: torch.device, b: int, t: int, h: int, dv: int, dtype,
                      seed: int = SEED, chunk: int = BASE_CHUNK):
    """K12 / K12b's inputs as ``gla_chunk_fused`` makes them from layer-like
    raw inputs: relu q, k (the LM's feature map) and v in ``dtype``, the
    decay logsigmoid(x) / 16 (per key channel), a nonzero initial state; then
    qd, kd, v in the compute dtype and e^{G_last}, padded to whole chunks of
    ``chunk``; and the cotangents dO (zero on the ragged tail) and dS."""
    from mhla_tpu_torch.kernels import gla_chunk as gc

    gen = torch.Generator(dev).manual_seed(seed)
    randn = lambda *s: torch.randn(*s, generator=gen, device=dev)  # noqa: E731
    q, k = torch.relu(randn(b, t, h, BASE_DK)), torch.relu(randn(b, t, h, BASE_DK))
    v = randn(b, t, h, dv)
    gk = torch.nn.functional.logsigmoid(randn(b, t, h, BASE_DK)) / 16
    qd, kd, v4, egl, _ = gc._prep(q.to(dtype), k.to(dtype), v.to(dtype), gk, chunk)
    s0 = 0.1 * randn(b, h, BASE_DK, dv)
    do = randn(*v4.shape)
    do[:, t:] = 0
    return (qd.contiguous(), kd.contiguous(), v4, egl, s0, do.to(v4.dtype),
            randn(b, h, BASE_DK, dv))


def gla_work(b: int, n: int, h: int, dv: int, dtype, backward: bool, scalar: bool = False,
             shared_qk: bool = False):
    """(bytes, operations, "tf32") of K12 (training form: the entry states
    are an output) or K12b over B x N chunks of C tokens (``scalar``: their
    scalar-decay form, whose gate is G [B, T, H] and its gradient dG in place
    of e^{G_last} [B, N, H, Dk] and its gradient; the e^{G_i - G_j} factors
    of the score tiles are not counted; ``shared_qk``: q and k, and dq and
    dk, moved once per token and not once per head, as Mamba2's function,
    whose heads share them, needs): every input read
    once and every output written once; the products over the kept (causal)
    pairs of each chunk and the state products (forward: q k^T and its
    product with v, qd S and kc^T v; backward: q k^T, dO v^T, the three
    intra products, qd^T dO and the three products with the states), at the
    tensor cores' TF32 peak: three products each for float32 accuracy, one
    in bf16, whose operands TF32 holds exactly (K6's restated bound)."""
    c, dk = BASE_CHUNK, BASE_DK
    e = torch.tensor([], dtype=dtype).element_size()
    tok = b * n * c * h
    state = b * h * dk * dv * 4
    states = b * n * h * dk * dv * 4
    egl = tok * 4 if scalar else b * n * h * dk * 4
    qk = tok // h if shared_qk else tok  # the rows of q and k moved
    pairs = c * (c + 1) // 2
    if not backward:
        moved = (qk * 2 * dk + tok * dv) * e + egl + state + tok * dv * e + state + states
        ops = 2 * pairs * (dk + dv) + 4 * c * dk * dv
    else:
        moved = ((qk * 2 * dk + tok * 2 * dv) * e + egl + states + state
                 + (qk * 2 * dk + tok * dv) * 4 + egl + state)
        ops = 2 * pairs * (3 * dk + 2 * dv) + 8 * c * dk * dv
    return moved, (3 if dtype == torch.float32 else 1) * b * n * h * ops, "tf32"


def gla_op_grads(dev: torch.device, b: int, t: int, dtype, kernels_path: bool):
    """Gradients of q, k, v, gk and s0 of sum(o * w) + sum(S * ws) through
    ``gla_chunk_fused`` (K12 / K12b) or autograd of the plain op
    ``gla_chunk``, same CUDA tensors."""
    from mhla_tpu_torch.kernels.gla_chunk import gla_chunk_fused
    from mhla_tpu_torch.ops.gla_chunk import gla_chunk

    gen = torch.Generator(dev).manual_seed(SEED + 5)
    randn = lambda *s: torch.randn(*s, generator=gen, device=dev)  # noqa: E731
    h, dk, dv = BASE_HEADS, BASE_DK, BASE_DV
    xs = [torch.relu(randn(b, t, h, dk)).to(dtype), torch.relu(randn(b, t, h, dk)).to(dtype),
          randn(b, t, h, dv).to(dtype),
          torch.nn.functional.logsigmoid(randn(b, t, h, dk)) / 16, 0.1 * randn(b, h, dk, dv)]
    xs = [x.requires_grad_() for x in xs]
    w, ws = randn(b, t, h, dv), randn(b, h, dk, dv)
    fn = gla_chunk_fused if kernels_path else gla_chunk
    o, s = fn(*xs[:4], initial_state=xs[4], output_final_state=True)
    ((o.float() * w).sum() + (s * ws).sum()).backward()
    return [x.grad for x in xs]


def phase_kernels_gla(dev: torch.device) -> dict:
    """K12 and K12b against their plain versions: at [8, 2048, 4, 128|256]
    in float32 (the layer's form; timed, the kernels line's row) and bf16, at
    1 x 781 (a ragged last chunk) in both, and at the bench shape [1, 32768,
    8, 128|128] in bf16 (timed); a nonzero initial state; K12b twice, bit
    for bit, everywhere; then the op's gradients through the kernels against
    plain autograd at [8, 2048] and 1 x 781, in float32 and bf16. The
    float32 rows are the kernels line's; the bf16 ones are returned under
    ``gla_shapes``."""
    from mhla_tpu_torch.kernels import gla_chunk as gc
    from mhla_tpu_torch.utils import get_err_ratio

    results, shapes = {}, {}
    c = BASE_CHUNK
    f32, bf16 = torch.float32, torch.bfloat16
    b_bench, t_bench, h_bench, _, dv_bench = GLA_BENCH
    cases = ((TRAIN_BATCH, TRAIN_SEQ, BASE_HEADS, BASE_DV, f32, True),  # (b, t, h, dv, dtype, timed)
             (1, 781, BASE_HEADS, BASE_DV, f32, False),
             (TRAIN_BATCH, TRAIN_SEQ, BASE_HEADS, BASE_DV, bf16, True),
             (1, 781, BASE_HEADS, BASE_DV, bf16, False),
             (b_bench, t_bench, h_bench, dv_bench, bf16, True))
    for b, t, h, dv, dtype, timed in cases:
        tag = f"{b}x{t}x{h}|{dv} {'f32' if dtype == f32 else 'bf16'}"
        # the float32 form is the layer's: its rows are the kernels line's
        sink, suffix = (results, "") if dtype == f32 else (shapes, f"[{tag}]")
        tol = GLA_TOL if dtype == f32 else KERNEL_TOL
        timing = {"reps": 3, "inner": 3, "warmup": 1} if t == t_bench else None
        qd, kd, v4, egl, s0, do, ds = gla_kernel_inputs(dev, b, t, h, dv, dtype)
        n = egl.shape[1]
        check_kernel(sink, "gla_chunk_fwd" + suffix, tag,
                     lambda: gc.gla_chunk_fwd(qd, kd, v4, egl, s0, c, True),
                     lambda: gc.gla_chunk_fwd_plain(qd, kd, v4, egl, s0, c, True),
                     timed, gla_work(b, n, h, dv, dtype, False), tol=tol, timing=timing)
        states = gc.gla_chunk_fwd_plain(qd, kd, v4, egl, s0, c, True)[2]
        bwd = lambda: gc.gla_chunk_bwd(qd, kd, v4, egl, states, do, ds, c)  # noqa: E731
        check_kernel(sink, "gla_chunk_bwd" + suffix, tag, bwd,
                     lambda: gc.gla_chunk_bwd_plain(qd, kd, v4, egl, states, do, ds, c),
                     timed, gla_work(b, n, h, dv, dtype, True), tol=tol, timing=timing)
        first, second = bwd(), bwd()
        torch.cuda.synchronize()
        if not all(torch.equal(x, y) for x, y in zip(first, second)):
            raise AssertionError(f"gla_chunk_bwd {tag}: two runs differ")
        log(f"[kernels gla] gla_chunk_bwd {tag}: two runs bit for bit equal")
        del first, second, states, qd, kd, v4, egl, s0, do, ds
        torch.cuda.empty_cache()
    # the other forms the kernels hold, untimed: chunks of 16 to 64, Dv of one
    # to four 64-column panels, a ragged last chunk, both dtypes
    forms, n_forms = {}, 0
    for c2, dv2, dtype in itertools.product((16, 32, 48, 64), (64, 128, 256), (f32, bf16)):
        tag = f"2x300x2|{dv2} C={c2} {'f32' if dtype == f32 else 'bf16'}"
        tol = GLA_TOL if dtype == f32 else KERNEL_TOL
        qd, kd, v4, egl, s0, do, ds = gla_kernel_inputs(dev, 2, 300, 2, dv2, dtype, chunk=c2)
        check_kernel(forms, "gla_chunk_fwd", tag,
                     lambda: gc.gla_chunk_fwd(qd, kd, v4, egl, s0, c2, True),
                     lambda: gc.gla_chunk_fwd_plain(qd, kd, v4, egl, s0, c2, True), False, tol=tol)
        states = gc.gla_chunk_fwd_plain(qd, kd, v4, egl, s0, c2, True)[2]
        bwd = lambda: gc.gla_chunk_bwd(qd, kd, v4, egl, states, do, ds, c2)  # noqa: E731
        check_kernel(forms, "gla_chunk_bwd", tag, bwd,
                     lambda: gc.gla_chunk_bwd_plain(qd, kd, v4, egl, states, do, ds, c2), False,
                     tol=tol)
        if not all(torch.equal(x, y) for x, y in zip(bwd(), bwd())):
            raise AssertionError(f"gla_chunk_bwd {tag}: two runs differ")
        n_forms += 1
    log(f"[kernels gla] {n_forms} further forms (C 16-64, Dv 64-256, 2 x 300 tokens, both "
        f"dtypes) within tolerance; K12b bit-equal over two runs in each")
    names = ("q", "k", "v", "gk", "s0")
    for b, t in ((TRAIN_BATCH, TRAIN_SEQ), (1, 781)):
        for dtype, tol in ((f32, GLA_TOL), (bf16, OP_GRAD_TOL)):
            got = gla_op_grads(dev, b, t, dtype, kernels_path=True)
            ref = gla_op_grads(dev, b, t, dtype, kernels_path=False)
            torch.cuda.synchronize()
            rels = {name: get_err_ratio(r, x) for name, r, x in zip(names, ref, got)}
            log(f"[grads gla] op B={b} T={t} {dtype}: rel-RMS " + " ".join(
                f"d{name} {rel:.3e}" for name, rel in rels.items()) + f" (tol {tol})")
            if not (all(torch.isfinite(x).all() for x in got) and max(rels.values()) < tol):
                raise AssertionError(f"gla op gradients B={b} T={t} {dtype} disagree: {rels}")
            del got, ref
    results["gla_shapes"] = shapes
    return results


def attn_geometry(attn):
    """(heads, Dk, Dv) of a baseline LM's attention layer, None for Mamba."""
    if hasattr(attn, "d_state"):  # Mamba2
        return attn.num_heads, attn.d_state, attn.head_dim
    if hasattr(attn, "num_heads"):
        return attn.num_heads, attn.head_k_dim, attn.head_v_dim
    return None


def phase_serve_baseline(dev: torch.device, extends: str, tag: str,
                         both_requests: bool = True) -> dict:
    """``generate`` with a 340M baseline LM (``attn_extends=extends``, bf16):
    4 x 1984 + 64 (unless not ``both_requests``) and 1 x 781 + 32 greedy
    tokens. The prefills run its forward kernel (K11, K12 in its float32
    form or, for Mamba2 and simple GLA, in its scalar-decay form) in every
    layer, or none (Mamba, linear attention); the decode steps the exact
    token recurrence (T = 1; the carried sums of linear attention). Checks
    finite logits, the exact launches, and the decode-step logits against
    one chunked forward over the whole sequence (the forward kernel
    again)."""
    from mhla_tpu_torch import kernels
    from mhla_tpu_torch.models import MHLAForCausalLM, MHLALMConfig, generate, init_lm_params
    from mhla_tpu_torch.utils import get_err_ratio

    fwd = (BASE_KERNELS[extends] or (None,))[0]
    cfg = MHLALMConfig(attn_extends=extends, dtype=torch.bfloat16)
    model = MHLAForCausalLM(cfg, device=dev)
    init_lm_params(model, torch.Generator(dev).manual_seed(SEED))
    model = model.to(torch.bfloat16).eval()
    block = model.model.layers[0]
    geometry = attn_geometry(block.attn)
    if not (block.extends == extends and cfg.num_hidden_layers == BASE_LAYERS
            and geometry == BASE_GEOMETRY[extends]):
        raise AssertionError(f"not the 340M {extends} geometry: {geometry}")
    n_params = sum(p.numel() for p in model.parameters())
    shape = ("d_inner 2048, state 16" if geometry is None
             else "{} heads, Dk {}, Dv {}".format(*geometry))
    log(f"[serve {tag}] 340M {extends} LM: {BASE_LAYERS} layers, {shape}, "
        f"{n_params / 1e6:.1f} M params bf16")
    gen = torch.Generator(dev).manual_seed(SEED + 1)
    requests = [
        (torch.randint(0, cfg.vocab_size, (BATCH_A, PROMPT_A), generator=gen, device=dev), NEW_A),
        (torch.randint(0, cfg.vocab_size, (BATCH_B, PROMPT_B), generator=gen, device=dev), NEW_B),
    ][0 if both_requests else 1:]
    generate(model, requests[-1][0][:, :100], max_new_tokens=4)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = {"launches": {}, "rates": {}}
    for ids, new in requests:
        b, t = ids.shape
        what = f"{b} x {t} + {new}"
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        toks, scores = generate(model, ids, max_new_tokens=new, output_scores=True)
        torch.cuda.synchronize()
        t_total = time.perf_counter() - t0
        counts = kernels.launch_counts()
        want = {name: 0 for name in counts}
        if fwd is not None:
            want[fwd] = BASE_LAYERS  # the prefill; decode launches nothing
        if counts != want:
            raise AssertionError(f"{what}: launches {counts}, expected {want}")
        out["launches"] = counts
        kernels.reset_launch_counts()
        with torch.no_grad():
            full, _ = model(toks[:, :-1])
        if fwd is not None and kernels.launch_counts()[fwd] != BASE_LAYERS:
            raise AssertionError(f"{what}: the full forward did not run {fwd} in every layer")
        ref = full[:, t - 1:]
        if toks.shape != (b, t + new) or not (torch.isfinite(scores).all()
                                               and torch.isfinite(full).all()):
            raise AssertionError(f"{what}: shapes {tuple(toks.shape)} or non-finite logits")
        rel = get_err_ratio(ref, scores)
        launched = f"{fwd} {counts[fwd]}, every other kernel 0" if fwd else "none"
        log(f"[serve {tag}] {what}: decode-step logits vs one chunked forward over "
            f"{toks.shape[1] - 1} tokens rel-RMS {rel:.3e} (tol {SERVE_TOL}); launches: "
            f"{launched}")
        if not rel < SERVE_TOL:
            raise AssertionError(f"{what}: chunk != recurrent ({rel:.3e})")
        with torch.no_grad():  # as generate runs it: no autograd graph
            t_pre = median_ms(lambda: model(ids, use_cache=True), reps=3, inner=1,
                              warmup=1) / 1e3
        t_dec = t_total - t_pre
        out["rates"][what] = {"prefill_ms": t_pre * 1e3, "prefill_tok_s": b * t / t_pre,
                              "decode_ms_per_step": t_dec * 1e3 / (new - 1),
                              "decode_tok_s": b * (new - 1) / t_dec, "decode_vs_full": rel}
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        out["rates"][what]["peak_gb"] = peak_gb
        log(f"[serve {tag}] {what}: prefill {t_pre * 1e3:.2f} ms = {b * t / t_pre:,.0f} tok/s; "
            f"decode {t_dec * 1e3 / (new - 1):.3f} ms/step = {b * (new - 1) / t_dec:,.1f} tok/s; "
            f"peak device memory {peak_gb:.1f} GB")
    del model
    torch.cuda.empty_cache()
    return out


def phase_train_baseline(dev: torch.device, extends: str, tag: str,
                         steps: int = TRAIN_STEPS, layers: int = BASE_LAYERS) -> dict:
    """``lm_train.main --model.attn_extends=<extends>`` trains a 340M baseline
    LM (cut to ``layers`` of its 24 layers where asked, the widths kept)
    ``steps`` steps at B=8 T=2048 (float32 parameters, bf16 compute,
    AdamW 3e-4 after a 1-step warm-up): finite losses, falling over 3 or more
    steps (the first step's learning rate is 0, so 2 steps only show them
    finite), the exact launches (its forward and backward kernels once per
    layer and step, or none at all); step time, tok/s, peak memory."""
    from mhla_tpu_torch import kernels
    from mhla_tpu_torch.train import lm_train

    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix=f"mhla_train_{extends}_") as work:
        argv = [
            f"--device={dev.type}", f"--work_dir={work}", f"--model.attn_extends={extends}",
            f"--train.batch_size={TRAIN_BATCH}", f"--train.seq_len={TRAIN_SEQ}",
            f"--train.max_steps={steps}", "--train.log_interval=1",
            "--optimizer.learning_rate=3e-4", "--optimizer.warmup_steps=1",
            "--optimizer.total_steps=20000", f"--model.num_hidden_layers={layers}",
        ]
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        out = lm_train.main(argv)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"[train {tag}] launches in {steps} steps: {counts}")
    want = {name: 0 for name in counts}
    for name in BASE_KERNELS[extends]:
        want[name] = steps * layers
    if counts != want:
        raise AssertionError(f"{extends} training launches {counts}, expected {want}")
    losses = out["losses"]
    if len(losses) != steps or not all(map(math.isfinite, losses)):
        raise AssertionError(f"training losses {losses}")
    if steps > 2 and not losses[-1] < losses[0]:
        raise AssertionError(f"loss did not fall: {losses}")
    if (out["model"].config.attn_extends, out["model"].config.num_hidden_layers) != (
            extends, layers):
        raise AssertionError(f"not the {extends} model of {layers} layers")
    step_s = statistics.median(out["step_seconds"][1:])
    tok_s = TRAIN_BATCH * TRAIN_SEQ / step_s
    log(f"[train {tag}] 340M {extends} ({layers} layers), B={TRAIN_BATCH} T={TRAIN_SEQ}, "
        f"{out['params'] / 1e6:.1f} M float32 params, bf16 compute: losses "
        f"{[round(x, 4) for x in losses]}; grad norms {[round(x, 3) for x in out['grad_norms']]}")
    log(f"[train {tag}] step {step_s * 1e3:.1f} ms (median of steps 2-{steps}; step 1 "
        f"{out['step_seconds'][0] * 1e3:.1f} ms) = {tok_s:,.0f} tok/s; checkpoint save "
        f"{out['save_seconds']:.2f} s; peak device memory {peak_gb:.1f} GB")
    del out
    torch.cuda.empty_cache()
    return {"launches": counts, "step_ms": step_s * 1e3, "tok_s": tok_s, "losses": losses,
            "peak_gb": peak_gb}


# The Mamba2 layer hands K12 / K12b's scalar form float32 q, k, v (as JAX's
# op computes); their decay at init: A ~ U(1e-4, 16), dt log-uniform in
# [1e-3, 0.1] (about 1 in 3 of its heads' chunks sums below -88.7 at B=8
# T=2048). The strong-decay case: gk ~ -U(1.5, 3), every chunk below -96.
def gla_scalar_inputs(dev: torch.device, b: int, t: int, h: int, dv: int, strong: bool,
                      seed: int = SEED, dtype=torch.float32):
    """K12 / K12b's scalar-form inputs as ``gla_chunk_fused`` makes them from
    a Mamba2-like call: q, k, v, one log-decay per head (the layer's init,
    or ``strong``), padded to whole chunks with G the within-chunk cumsum; a
    nonzero initial state and the cotangents (dO zero on the ragged tail)."""
    from mhla_tpu_torch.kernels import gla_chunk as gc

    gen = torch.Generator(dev).manual_seed(seed)
    randn = lambda *s: torch.randn(*s, generator=gen, device=dev)  # noqa: E731
    q, k, v = randn(b, t, h, BASE_DK), randn(b, t, h, BASE_DK), randn(b, t, h, dv)
    if strong:
        gk = -1.5 - 1.5 * torch.rand(b, t, h, generator=gen, device=dev)
    else:
        a = 1e-4 + (16 - 1e-4) * torch.rand(h, generator=gen, device=dev)
        dt = torch.exp(torch.rand(h, generator=gen, device=dev) * math.log(100.0)
                       + math.log(1e-3))
        gk = -a * torch.nn.functional.softplus(randn(b, t, h) + torch.log(torch.expm1(dt)))
    q4, k4, v4, g4 = gc._prep_scalar(q.to(dtype), k.to(dtype), v.to(dtype), gk, BASE_CHUNK)
    do = randn(*v4.shape)
    do[:, t:] = 0
    return q4, k4, v4, g4, 0.1 * randn(b, h, BASE_DK, dv), do.to(v4.dtype), randn(b, h, BASE_DK, dv)


def gla_scalar_op_grads(dev: torch.device, b: int, t: int, strong: bool, kernels_path: bool):
    """Gradients of q, k, v, gk and s0 of sum(o * w) + sum(S * ws) through
    ``gla_chunk_fused`` (K12 / K12b's scalar form) or autograd of the plain
    op ``gla_chunk`` (its difference form), float32, same CUDA tensors."""
    from mhla_tpu_torch.kernels.gla_chunk import gla_chunk_fused
    from mhla_tpu_torch.ops.gla_chunk import gla_chunk

    h, dv = MAMBA2_HEADS, BASE_DV
    gen = torch.Generator(dev).manual_seed(SEED + 23)
    randn = lambda *s: torch.randn(*s, generator=gen, device=dev)  # noqa: E731
    gk = (-1.5 - 1.5 * torch.rand(b, t, h, generator=gen, device=dev) if strong
          else -16 * torch.rand(h, generator=gen, device=dev)
          * torch.nn.functional.softplus(randn(b, t, h) - 4.0))
    xs = [randn(b, t, h, BASE_DK), randn(b, t, h, BASE_DK), randn(b, t, h, dv), gk,
          0.1 * randn(b, h, BASE_DK, dv)]
    xs = [x.requires_grad_() for x in xs]
    w, ws = randn(b, t, h, dv), randn(b, h, BASE_DK, dv)
    fn = gla_chunk_fused if kernels_path else gla_chunk
    o, s = fn(*xs[:4], initial_state=xs[4], output_final_state=True)
    ((o.float() * w).sum() + (s * ws).sum()).backward()
    return [x.grad for x in xs]


def phase_kernels_mamba2(dev: torch.device) -> dict:
    """(aa) K12 and K12b's scalar-decay form against their plain versions: at
    Mamba2's training shape [8, 2048, 8, 128|256] in float32 (the layer's
    form; timed, the kernels line's rows) with the layer's decay at init,
    at 1 x 781 (a ragged last chunk), and at a strong decay (every chunk's
    summed log-decay below -88.7, where the factored form's e^{-G}
    overflows) at [2, 512]: every output finite, K12b twice bit for bit;
    then the op's gradients through them against autograd of the plain op
    at [8, 2048] and at the strong decay."""
    from mhla_tpu_torch.kernels import gla_chunk as gc
    from mhla_tpu_torch.utils import get_err_ratio

    results, c, h, dv = {}, BASE_CHUNK, MAMBA2_HEADS, BASE_DV
    shared_bounds = results["mamba2_shared_qk_bounds"] = {}
    for b, t, strong, timed in ((TRAIN_BATCH, TRAIN_SEQ, False, True), (1, 781, False, False),
                                (2, 512, True, False)):
        tag = f"{b}x{t}x{h}|{dv} f32" + (" strong" if strong else "")
        q4, k4, v4, g4, s0, do, ds = gla_scalar_inputs(dev, b, t, h, dv, strong)
        gl = g4.view(b, -1, c, h)[:, :, -1]
        n = q4.shape[1] // c
        fwd = lambda: gc.gla_chunk_fwd_scalar(q4, k4, v4, g4, s0, c, True)  # noqa: E731
        check_kernel(results, "gla_chunk_fwd_scalar", tag, fwd,
                     lambda: gc.gla_chunk_fwd_scalar_plain(q4, k4, v4, g4, s0, c, True),
                     timed, gla_work(b, n, h, dv, torch.float32, False, scalar=True),
                     tol=GLA_TOL)
        states = gc.gla_chunk_fwd_scalar_plain(q4, k4, v4, g4, s0, c, True)[2]
        bwd = lambda: gc.gla_chunk_bwd_scalar(q4, k4, v4, g4, states, do, ds, c)  # noqa: E731
        check_kernel(results, "gla_chunk_bwd_scalar", tag, bwd,
                     lambda: gc.gla_chunk_bwd_scalar_plain(q4, k4, v4, g4, states, do, ds, c),
                     timed, gla_work(b, n, h, dv, torch.float32, True, scalar=True),
                     tol=GLA_TOL)
        if timed:  # Mamba2's heads share q and k: the bound with them moved once
            for name, backward in (("gla_chunk_fwd_scalar", False), ("gla_chunk_bwd_scalar", True)):
                moved, ops, dtype = gla_work(b, n, h, dv, torch.float32, backward, scalar=True,
                                             shared_qk=True)
                bound = max(moved / PEAK_BYTES, ops / PEAK_FLOPS[dtype]) * 1e3
                shared_bounds[name] = {"bound_ms": bound, "share": bound / results[name]["ms"]}
                log(f"[kernels mamba2] {name} {tag}: bound with q and k moved once per token "
                    f"(Mamba2's heads share them) {bound:.4f} ms = {bound / results[name]['ms']:.1%}"
                    f" of the kernel's time; with them moved once per head "
                    f"{results[name]['bound_ms']:.4f} ms")
        first, second = bwd(), bwd()
        torch.cuda.synchronize()
        if not all(torch.equal(x, y) for x, y in zip(first, second)):
            raise AssertionError(f"gla_chunk_bwd_scalar {tag}: two runs differ")
        log(f"[kernels mamba2] {tag}: chunks' summed log-decay min {float(gl.min()):.1f}, "
            f"{float((gl < -88.7).float().mean()):.1%} below -88.7; gla_chunk_bwd_scalar two "
            "runs bit for bit equal")
        del first, second, states, q4, k4, v4, g4, s0, do, ds
        torch.cuda.empty_cache()
    names = ("q", "k", "v", "gk", "s0")
    for b, t, strong in ((TRAIN_BATCH, TRAIN_SEQ, False), (2, 512, True)):
        got = gla_scalar_op_grads(dev, b, t, strong, kernels_path=True)
        ref = gla_scalar_op_grads(dev, b, t, strong, kernels_path=False)
        torch.cuda.synchronize()
        rels = {name: get_err_ratio(r, x) for name, r, x in zip(names, ref, got)}
        log(f"[grads mamba2] op B={b} T={t}{' strong decay' if strong else ''}: rel-RMS "
            + " ".join(f"d{name} {rel:.3e}" for name, rel in rels.items()) + f" (tol {GLA_TOL})")
        if not (all(torch.isfinite(x).all() for x in got) and max(rels.values()) < GLA_TOL):
            raise AssertionError(f"mamba2 op gradients B={b} T={t} disagree: {rels}")
        del got, ref
    return results


LONG_CONTINUATION = 200  # tokens that continue a 781-token cache in (ae)


def phase_lm_options(dev: torch.device) -> dict:
    """(ae) The MHLA LM's options at the 340M widths (bf16, seeded init):
    ``attn_mode='fused_recurrent'`` serves 1 x 781 + 32 (every token through
    the recurrence: K1 on q and k in every layer and step, no chunk kernel;
    its prompt logits against chunk mode on the same weights, its decode-step
    logits against one chunked forward); a cache of 781 tokens (a chunked
    prefill) continued by 200 tokens in one call, against
    ``fused_recurrent`` over the 981 tokens; one 340M-width
    ``MHLACausal(rope_scale_base=512)`` layer forward and backward at B=8
    T=2048 (K1 / K1b with the XPos tables, q's and k's, against the same
    layer with the plain fmap+RoPE); and ``lm_train.main
    --model.use_l2warp=true`` 2 steps at B=8 T=2048."""
    import dataclasses

    from mhla_tpu_torch import kernels
    from mhla_tpu_torch.kernels import fmap_rope
    from mhla_tpu_torch.layers import MHLACausal, mhla_causal
    from mhla_tpu_torch.models import MHLAForCausalLM, MHLALMConfig, generate, init_lm_params
    from mhla_tpu_torch.train import lm_train
    from mhla_tpu_torch.utils import get_err_ratio

    bf16 = torch.bfloat16
    out = {}
    cfg = MHLALMConfig(dtype=bf16)
    chunk = MHLAForCausalLM(cfg, device=dev)
    init_lm_params(chunk, torch.Generator(dev).manual_seed(SEED))
    chunk = chunk.to(bf16).eval()
    rec = MHLAForCausalLM(dataclasses.replace(cfg, attn_mode="fused_recurrent"), device=dev)
    rec.load_state_dict(chunk.state_dict())
    rec = rec.to(bf16).eval()
    ids = torch.randint(0, cfg.vocab_size, (BATCH_B, PROMPT_B + LONG_CONTINUATION),
                        generator=torch.Generator(dev).manual_seed(SEED + 41), device=dev)
    prompt = ids[:, :PROMPT_B]
    generate(rec, prompt[:, :20], max_new_tokens=4)  # warm-up
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    toks, scores = generate(rec, prompt, max_new_tokens=NEW_B, output_scores=True)
    torch.cuda.synchronize()
    t_total = time.perf_counter() - t0
    counts = {k_: v_ for k_, v_ in kernels.launch_counts().items() if v_}
    want = {"fmap_rope": 2 * BASE_LAYERS * NEW_B}
    if counts != want:
        raise AssertionError(f"fused_recurrent serve launches {counts}, expected {want}")
    with torch.no_grad():
        # one fused_recurrent forward over the 981 tokens: its first 781
        # positions are the prompt's logits, the rest the continuation's
        # reference below
        t1 = time.perf_counter()
        ref, _ = rec(ids)
        torch.cuda.synchronize()
        t_ref = time.perf_counter() - t1
        logits_chunk, _ = chunk(prompt)
        full, _ = chunk(toks[:, :-1])
    rel_prompt = get_err_ratio(logits_chunk, ref[:, :PROMPT_B])
    rel_decode = get_err_ratio(full[:, PROMPT_B - 1:], scores)
    finite = all(torch.isfinite(x).all() for x in (scores, ref, full))
    log(f"[options] fused_recurrent 1 x {PROMPT_B} + {NEW_B}: prompt logits vs chunk mode "
        f"rel-RMS {rel_prompt:.3e}, decode-step logits vs one chunked forward {rel_decode:.3e} "
        f"(tol {SERVE_TOL}); launches {counts}; generate {t_total * 1e3:.1f} ms (prefill "
        f"through the token loop and {NEW_B - 1} decode steps); one forward over "
        f"{ids.shape[1]} tokens {t_ref * 1e3:.1f} ms (the token loop)")
    if not (finite and rel_prompt < SERVE_TOL and rel_decode < SERVE_TOL):
        raise AssertionError(f"fused_recurrent: {rel_prompt:.3e} / {rel_decode:.3e}")
    out["fused_recurrent"] = {"prompt_vs_chunk": rel_prompt, "decode_vs_full": rel_decode,
                              "generate_ms": t_total * 1e3,
                              f"forward_{ids.shape[1]}_ms": t_ref * 1e3}
    with torch.no_grad():
        _, states = chunk(prompt, use_cache=True)
        kernels.reset_launch_counts()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        cont, _ = chunk(ids[:, PROMPT_B:], states, use_cache=True)
        torch.cuda.synchronize()
        t_cont = time.perf_counter() - t1
        counts = {k_: v_ for k_, v_ in kernels.launch_counts().items() if v_}
    rel = get_err_ratio(ref[:, PROMPT_B:], cont)
    log(f"[options] a {PROMPT_B}-token cache continued by {LONG_CONTINUATION} tokens in one "
        f"call: logits vs fused_recurrent over {ids.shape[1]} tokens rel-RMS {rel:.3e} (tol "
        f"{SERVE_TOL}); launches {counts}; {t_cont * 1e3:.1f} ms")
    if not (torch.isfinite(cont).all() and rel < SERVE_TOL
            and counts == {"fmap_rope": 2 * BASE_LAYERS}):
        raise AssertionError(f"long continuation: {rel:.3e}, launches {counts}")
    out["long_continuation"] = {"vs_fused_recurrent": rel, "ms": t_cont * 1e3}
    del chunk, rec, full, ref, states
    torch.cuda.empty_cache()

    # XPos: one 340M-width layer, K1 / K1b with q's and k's own tables
    layer = MHLACausal(hidden_size=1024, num_heads=4, chunk_size=BASE_CHUNK, num_slots=32,
                       rope_scale_base=512.0, device=dev)
    gen = torch.Generator(dev).manual_seed(SEED + 42)
    with torch.no_grad():
        for name, p in layer.named_parameters():
            if p.ndim == 2 and name.endswith(".weight"):
                p.normal_(0.0, 0.02, generator=gen)
    x = torch.randn(TRAIN_BATCH, TRAIN_SEQ, 1024, generator=gen, device=dev).to(bf16)
    w = torch.randn(TRAIN_BATCH, TRAIN_SEQ, 1024, generator=gen, device=dev)

    def grads():
        layer.zero_grad(set_to_none=True)
        xx = x.detach().requires_grad_()
        (layer(xx)[0].float() * w).sum().backward()
        return {"x": xx.grad, **{n_: p.grad for n_, p in layer.named_parameters()}}

    kernels.reset_launch_counts()
    got = grads()
    xpos_counts = {k_: kernels.launch_counts()[k_] for k_ in ("fmap_rope", "fmap_rope_bwd")}

    def plain_fmap_rope(x_, cos, sin, num_heads, feature_map=None, offset=0, positions=None):
        return fmap_rope.fmap_rope_plain(x_, cos, sin, num_heads, feature_map, offset, positions)

    kernels.reset_launch_counts()
    with mock.patch.object(mhla_causal, "fused_fmap_rope_flat", plain_fmap_rope):
        want = grads()
    if kernels.launch_counts()["fmap_rope"]:
        raise AssertionError("the plain XPos layer launched K1")
    torch.cuda.synchronize()
    rels = {name: get_err_ratio(want[name], got[name]) for name in want}
    worst = max(rels, key=rels.get)
    log(f"[options] MHLACausal(rope_scale_base=512) at B={TRAIN_BATCH} T={TRAIN_SEQ}: launches "
        f"{xpos_counts}; gradients vs plain fmap+RoPE rel-RMS dx {rels['x']:.3e}, worst "
        f"{worst} {rels[worst]:.3e} (tol {OP_GRAD_TOL})")
    if not (xpos_counts == {"fmap_rope": 2, "fmap_rope_bwd": 2}
            and all(torch.isfinite(g).all() for g in got.values())
            and rels[worst] < OP_GRAD_TOL):
        raise AssertionError(f"XPos layer: launches {xpos_counts}, gradients {rels}")
    out["xpos_layer"] = {"launches": xpos_counts, "grads_vs_plain": rels[worst]}
    del layer, x, w, got, want
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory(prefix="mhla_train_l2warp_") as work:
        argv = [f"--device={dev.type}", f"--work_dir={work}", "--model.use_l2warp=true",
                f"--train.batch_size={TRAIN_BATCH}", f"--train.seq_len={TRAIN_SEQ}",
                "--train.max_steps=2", "--train.log_interval=1",
                "--optimizer.learning_rate=3e-4", "--optimizer.warmup_steps=1",
                "--optimizer.total_steps=20000"]
        kernels.reset_launch_counts()
        res = lm_train.main(argv)
        counts = kernels.launch_counts()
    losses = res["losses"]
    log(f"[options] lm_train --model.use_l2warp=true 2 steps: losses "
        f"{[round(v_, 4) for v_ in losses]}, step {res['step_seconds'][-1] * 1e3:.1f} ms")
    if not (len(losses) == 2 and all(map(math.isfinite, losses))
            and all(counts[n_] > 0 for n_ in FWD_KERNELS + BWD_KERNELS)):
        raise AssertionError(f"l2warp training: losses {losses}, launches {counts}")
    out["train_l2warp"] = {"losses": losses, "step_ms": res["step_seconds"][-1] * 1e3}
    del res
    torch.cuda.empty_cache()
    return out


def plain_flash_attention(q, k, v, causal=False, segment_ids=None):
    """``flash_attention_plain`` (in its causal and segment-id forms where
    asked); where a gradient is wanted, with ``flash_attention_bwd_plain`` as
    its backward (plain autograd would keep every [B, H, rows, Tk] score
    block of the forward)."""
    from mhla_tpu_torch.kernels import flash_attention as flash

    masks = {"causal": causal, "segment_ids": segment_ids}

    class PlainFlash(torch.autograd.Function):
        @staticmethod
        def forward(ctx, q, k, v):
            o, lse = flash.flash_attention_plain(q, k, v, return_lse=True, **masks)
            ctx.save_for_backward(q, k, v, o, lse)
            return o

        @staticmethod
        def backward(ctx, do):
            return flash.flash_attention_bwd_plain(*ctx.saved_tensors, do, **masks)

    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        return PlainFlash.apply(q, k, v)
    return flash.flash_attention_plain(q, k, v, **masks)


def plain_radial_flash_attention(q, k, v, num_frames, scale=None):
    """``radial_flash_attention_plain``, with ``radial_flash_attention_bwd_plain``
    as its backward where a gradient is wanted."""
    from mhla_tpu_torch.kernels import sparse_attention as sparse

    class PlainRadial(torch.autograd.Function):
        @staticmethod
        def forward(ctx, q, k, v):
            o, lse = sparse.radial_flash_attention_plain(q, k, v, num_frames, scale,
                                                         return_lse=True)
            ctx.save_for_backward(q, k, v, o, lse)
            return o

        @staticmethod
        def backward(ctx, do):
            return sparse.radial_flash_attention_bwd_plain(*ctx.saved_tensors, do, num_frames,
                                                           scale)

    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        return PlainRadial.apply(q, k, v)
    return sparse.radial_flash_attention_plain(q, k, v, num_frames, scale)


def plain_kernels(only=None):
    """Context in which the video model's wrappers K5-K10 (or those named in
    ``only``) run their plain PyTorch versions on whatever device their
    tensors lie; gradients then come from plain autograd (and the plain flash
    and radial flash backwards)."""
    from mhla_tpu_torch.kernels import mhla_block, sparse_attention
    from mhla_tpu_torch.layers import attention, mhla_vision

    stack = contextlib.ExitStack()
    for module, name, plain in (
        (mhla_vision, "blockify_island", mhla_block.blockify_island_plain),
        (mhla_vision, "unblockify_island", mhla_block.unblockify_island_plain),
        (mhla_block, "mix_states_dense", mhla_block.mix_states_dense_plain),
        (mhla_block, "block_readout", mhla_block.block_readout_plain),
        (attention, "flash_attention", plain_flash_attention),
        (sparse_attention, "radial_flash_attention", plain_radial_flash_attention),
    ):
        if only is None or name in only:
            stack.enter_context(mock.patch.object(module, name, plain))
    return stack


def video_text_embeddings():
    """Seeded normal text and null embeddings [512, 4096], float32 numpy."""
    gen = torch.Generator().manual_seed(SEED + 7)
    return tuple(torch.randn(VIDEO_TEXT_LEN, 4096, generator=gen).numpy() for _ in range(2))


def sample_with_cli(dev: torch.device, tag: str, want: dict, extra_argv=()) -> dict:
    """One prompt through ``video_infer_cli.main``: VIDEO_STEPS DPM-Solver++
    steps with CFG 5.0 and shift 3.0 at the full latent size. Checks finite
    latents of the right shape and the launch counts ``want``."""
    from mhla_tpu_torch import kernels
    from mhla_tpu_torch.eval import video_infer_cli

    emb, null = video_text_embeddings()
    with tempfile.TemporaryDirectory(prefix="mhla_video_") as work:
        np.savez(f"{work}/emb.npz", emb_0=emb, null=null)
        with open(f"{work}/prompts.txt", "w") as fh:
            fh.write("a paper boat drifting down a rain-filled gutter\n")
        argv = [
            f"--device={dev.type}", f"--txt_file={work}/prompts.txt", f"--out_dir={work}/out",
            f"--emb_file={work}/emb.npz", "--sampling.solver=dpm-solver",
            f"--sampling.num_steps={VIDEO_STEPS}", "--sampling.cfg_scale=5.0",
            "--sampling.flow_shift=3.0",
            f"--sampling.latent_shape={VIDEO_LATENT}".replace(" ", ""), *extra_argv,
        ]
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        out = video_infer_cli.main(argv)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        latents = np.load(out["outputs"][0]["path"])
    cfg = out["model"].cfg
    n_params = sum(p.numel() for p in out["model"].parameters())
    types = [cfg.layer_attn_type(i) for i in range(cfg.num_layers)]
    log(f"[{tag}] Wan2.1-1.3B: {cfg.num_layers} layers ({types.count('mhla_uni')} mhla_uni, "
        f"{types.count('flash')} flash, {types.count('sparse')} sparse), dim {cfg.dim}, "
        f"{cfg.num_heads} heads, ffn {cfg.ffn_dim}, block layout {cfg.block_layout}, "
        f"{n_params / 1e6:.1f} M float32 params, compute {cfg.dtype}")
    check_sampling(tag, latents, counts, want)
    return {"model": out["model"], "counts": counts, "peak_gb": peak_gb, "latents": latents,
            "seconds": out["sample_seconds"][0]}


def check_sampling(tag: str, latents: np.ndarray, counts: dict, want: dict) -> None:
    log(f"[{tag}] launches in {VIDEO_STEPS} dpm-solver steps with CFG: {counts}")
    if latents.shape != VIDEO_LATENT or not np.isfinite(latents).all():
        raise AssertionError(f"latents {latents.shape}, finite {np.isfinite(latents).all()}")
    got = {name: counts[name] for name in want}
    if got != want:
        raise AssertionError(f"launches of the {tag} path {got}, expected {want}")


def video_inputs(dev: torch.device, text_dim: int, t_value: float):
    """The CFG batch of one model call: latents, timesteps, text embeddings."""
    gen = torch.Generator(dev).manual_seed(SEED + 8)
    x = torch.randn(VIDEO_CFG_BATCH, *VIDEO_LATENT, generator=gen, device=dev)
    ctx = torch.randn(VIDEO_CFG_BATCH, VIDEO_TEXT_LEN, text_dim, generator=gen, device=dev)
    return x, torch.full((VIDEO_CFG_BATCH,), t_value, device=dev), ctx


def phase_video(dev: torch.device) -> dict:
    from mhla_tpu_torch import kernels
    from mhla_tpu_torch.utils import get_err_ratio

    run = sample_with_cli(dev, "video", video_launches(VIDEO_LAYERS, [VIDEO_LAYERS] * VIDEO_STEPS,
                                                      [0] * VIDEO_STEPS))
    model, counts, peak_gb, latents = run["model"], run["counts"], run["peak_gb"], run["latents"]
    cfg = model.cfg
    step_ms = run["seconds"] * 1e3 / VIDEO_STEPS

    # one model forward through the kernels against the same forward through
    # their plain versions, same weights and inputs (the CFG batch of two)
    x, t, ctx = video_inputs(dev, cfg.text_dim, 500.0)
    with torch.no_grad():
        v_kern = model(x, t, ctx)
        before = kernels.launch_counts()
        with plain_kernels():
            v_plain = model(x, t, ctx)
        if kernels.launch_counts() != before:
            raise AssertionError("the plain forward launched a kernel")
        with plain_kernels(only=("flash_attention",)):
            v_flash_plain = model(x, t, ctx)
        fwd_ms = median_ms(lambda: model(x, t, ctx), reps=3, inner=1, warmup=0)
    rel = get_err_ratio(v_plain, v_kern)
    log(f"[video] forward through K5-K9 vs plain versions: velocity rel-RMS {rel:.3e} "
        f"(tol {VIDEO_TOL}; bf16 vs float32 on the CPU {VIDEO_FLOOR_CPU}); with K9 alone "
        f"through its plain version {get_err_ratio(v_plain, v_flash_plain):.3e}")
    if not (torch.isfinite(v_kern).all() and rel < VIDEO_TOL):
        raise AssertionError(f"video forward: kernels != plain ({rel:.3e})")
    log(f"[video] latents {latents.shape} finite, std {latents.std():.3f}; "
        f"{step_ms:.1f} ms per denoising step (sampling {run['seconds']:.2f} s for "
        f"{VIDEO_STEPS} steps, host clock); {fwd_ms:.1f} ms per forward of the CFG batch "
        f"(CUDA events, median of 3); peak device memory {peak_gb:.1f} GB")
    return {"launches": counts, "step_ms": step_ms, "forward_ms": fwd_ms, "peak_gb": peak_gb,
            "kernels_vs_plain": rel}


def phase_video_hybrid(dev: torch.device):
    """The hybrid model through the CLI: 20 MHLA layers, 10 dense softmax
    layers on K9 at Tq = Tk = 31,500. Returns the numbers and the model."""
    idx = str(HYBRID_LINEAR_IDX).replace(" ", "")
    k9 = [VIDEO_LAYERS + len(SOFTMAX_LAYERS)] * VIDEO_STEPS  # cross- and self-attention
    run = sample_with_cli(dev, "hybrid", video_launches(len(HYBRID_LINEAR_IDX), k9,
                                                        [0] * VIDEO_STEPS),
                          [f"--linear_attn_idx={idx}"])
    model = run["model"]
    x, t, ctx = video_inputs(dev, model.cfg.text_dim, 500.0)
    with torch.no_grad():
        fwd_ms = median_ms(lambda: model(x, t, ctx), reps=3, inner=1, warmup=1)
    step_ms = run["seconds"] * 1e3 / VIDEO_STEPS
    log(f"[hybrid] latents {run['latents'].shape} finite, std {run['latents'].std():.3f}; "
        f"{step_ms:.1f} ms per denoising step (sampling {run['seconds']:.2f} s for {VIDEO_STEPS} "
        f"steps, host clock); {fwd_ms:.1f} ms per forward of the CFG batch (CUDA events, "
        f"median of 3); peak device memory {run['peak_gb']:.1f} GB")
    return {"launches": run["counts"], "step_ms": step_ms, "forward_ms": fwd_ms,
            "peak_gb": run["peak_gb"]}, model


def phase_video_sparse(dev: torch.device, hybrid) -> dict:
    """The hybrid model's weights with the softmax layers radial-sparse,
    through ``sample_video_latents`` (the CLI has no field for it, as in the
    JAX package)."""
    import dataclasses

    from mhla_tpu_torch import kernels
    from mhla_tpu_torch.eval import sample_video_latents
    from mhla_tpu_torch.models import WanModel
    from mhla_tpu_torch.utils import get_err_ratio

    cfg = dataclasses.replace(hybrid.cfg, sparse_attn_idx=SOFTMAX_LAYERS)
    if cfg.sparse_dense_from_t != DENSE_FROM_T:
        raise AssertionError(f"dense guard at {cfg.sparse_dense_from_t}, expected {DENSE_FROM_T}")
    model = WanModel(cfg, device=dev).eval()
    model.load_state_dict(hybrid.state_dict())
    emb, null = (torch.from_numpy(a)[None] for a in video_text_embeddings())
    n_soft, above = len(SOFTMAX_LAYERS), VIDEO_STEPS - STEPS_BELOW_GUARD
    want = video_launches(
        len(HYBRID_LINEAR_IDX),
        [VIDEO_LAYERS + n_soft] * above + [VIDEO_LAYERS] * STEPS_BELOW_GUARD,
        [0] * above + [n_soft] * STEPS_BELOW_GUARD)
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    latents = sample_video_latents(
        model, emb, null, latent_shape=VIDEO_LATENT, cfg_scale=5.0, num_steps=VIDEO_STEPS,
        solver="dpm-solver", flow_shift=3.0, generator=torch.Generator(dev).manual_seed(SEED),
    ).cpu().numpy()[0]  # the copy waits for the device
    seconds = time.perf_counter() - t0
    counts = kernels.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check_sampling("hybrid_sparse", latents, counts, want)

    low, high = T_SPARSE, T_GUARDED
    x, t_low, ctx = video_inputs(dev, cfg.text_dim, low)
    t_high = torch.full_like(t_low, high)
    with torch.no_grad():
        v_kern = model(x, t_low, ctx)
        before = kernels.launch_counts()
        with plain_kernels():
            v_plain = model(x, t_low, ctx)
        if kernels.launch_counts() != before:
            raise AssertionError("the plain forward launched a kernel")
        rel = get_err_ratio(v_plain, v_kern)
        del v_plain
        guard = get_err_ratio(hybrid(x, t_high, ctx), model(x, t_high, ctx))
        differs = get_err_ratio(hybrid(x, t_low, ctx), v_kern)
        fwd_low = median_ms(lambda: model(x, t_low, ctx), reps=3, inner=1, warmup=0)
        fwd_high = median_ms(lambda: model(x, t_high, ctx), reps=3, inner=1, warmup=0)

        # what the guard's host-side decision costs: two forwards back to
        # back at t = 501, with the guard (the host waits for max(t)) and
        # without one (no wait), in turns
        def pair_ms(dense_from_t):
            model.cfg.sparse_dense_from_t = dense_from_t
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model(x, t_low, ctx)
            model(x, t_low, ctx)
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1e3 / 2

        try:
            pairs = [(g, pair_ms(g)) for g in (DENSE_FROM_T, None, None, DENSE_FROM_T)]
        finally:
            model.cfg.sparse_dense_from_t = DENSE_FROM_T
    log(f"[hybrid_sparse] forward at t = {low:g} through K5-K10 vs plain versions: velocity "
        f"rel-RMS {rel:.3e} (tol {VIDEO_TOL}); guarded forward at t = {high:g} vs the hybrid "
        f"model's: rel-RMS {guard:.3e} (expected 0); at t = {low:g} vs the hybrid model's: "
        f"{differs:.3e} (the mask is active)")
    if not (torch.isfinite(v_kern).all() and rel < VIDEO_TOL):
        raise AssertionError(f"hybrid_sparse forward: kernels != plain ({rel:.3e})")
    if guard != 0.0 or not differs > 1e-3:
        raise AssertionError(f"dense guard: t = {high:g} differs from the hybrid model by "
                             f"{guard:.3e}; t = {low:g} by {differs:.3e}")
    step_ms = seconds * 1e3 / VIDEO_STEPS
    log(f"[hybrid_sparse] latents {latents.shape} finite, std {latents.std():.3f}; "
        f"{step_ms:.1f} ms per denoising step (sampling {seconds:.2f} s for {VIDEO_STEPS} steps, "
        f"two on each side of the guard, host clock); forward of the CFG batch {fwd_low:.1f} ms "
        f"at t = {low:g} (K10), {fwd_high:.1f} ms at t = {high:g} (dense guard; CUDA events, "
        f"median of 3); peak device memory {peak_gb:.1f} GB")
    log(f"[hybrid_sparse] host clock per forward, two back to back at t = {low:g}: "
        + ", ".join(f"{'guard' if g else 'no guard'} {ms:.1f} ms" for g, ms in pairs))
    return {"launches": counts, "step_ms": step_ms, "forward_ms_sparse": fwd_low,
            "forward_ms_guarded": fwd_high, "peak_gb": peak_gb, "kernels_vs_plain": rel,
            "guard_vs_hybrid": guard,
            "guard_wait_ms": statistics.mean(ms for g, ms in pairs if g)
            - statistics.mean(ms for g, ms in pairs if not g)}


# (af) text to video: umT5-XXL (models.t5.UMT5_XXL: 24 layers, dim 4096, 64
# heads, ffn 10,240, vocab 256,384; float32, seeded) encodes two prompts of
# 37 and 512 tokens in 512 slots and the null prompt (one token: umT5's
# tokenizer gives the empty prompt its end token); the CLI loads the
# full-MHLA Wan2.1-1.3B from a reference-named seeded safetensors file and
# samples 4 UniPC and 4 SA-Solver steps on those embeddings (CFG 5.0, shift
# 3.0); the Wan2.1 VAE (VAEConfig()), from a reference-named seeded .pth,
# decodes the UniPC sample to 81 x 480 x 800 frames
T2V_PROMPT_LENS = (37, 512, 1)
T2V_PROMPTS = ("a paper boat drifting down a rain-filled gutter\n",
               "a red kite over the dunes at dusk\n")
T2V_FRAMES = (1, 81, 480, 800, 3)
# Relative-RMS tolerance of float32 work on the card (TF32 off) against the
# same work on the CPU: umT5's GEMMs and softmax and the VAE's convolutions
# sum in other orders (cuDNN may take an FFT or Winograd algorithm, which
# round differently; 1e-6 is typical); a wrong frame, channel or position
# gives O(1)
T2V_CPU_TOL = 1e-4


def write_safetensors(path: str, tensors: dict) -> None:
    """The safetensors format: an 8-byte little-endian header length, the
    JSON header, then each float32 numpy array's bytes."""
    header, offset = {}, 0
    for name, a in tensors.items():
        header[name] = {"dtype": "F32", "shape": list(a.shape),
                        "data_offsets": [offset, offset + a.nbytes]}
        offset += a.nbytes
    head = json.dumps(header).encode()
    with open(path, "wb") as fh:
        fh.write(len(head).to_bytes(8, "little") + head)
        for a in tensors.values():
            fh.write(np.ascontiguousarray(a, "<f4").data)


def seeded_tensor(name: str, shape: tuple, gen: torch.Generator, dev: torch.device):
    """One seeded float32 tensor on the card: norm weights and gammas 1 +
    N(0, 0.1), biases N(0, 0.02), modulations N(0, 1/16), the rest N(0, 1 /
    fan_in)."""
    x = torch.randn(shape, generator=gen, device=dev)
    if name.endswith("gamma") or ("norm" in name and name.endswith("weight")):
        return 1.0 + 0.1 * x
    if name.endswith("bias"):
        return 0.02 * x
    if "modulation" in name:
        return x / 16
    return x * math.prod(shape[1:]) ** -0.5


def seeded_reference_state(shapes: dict, dev: torch.device, seed: int) -> dict:
    """float32 numpy tensors of the given names and shapes, drawn on the
    card by :func:`seeded_tensor`."""
    gen = torch.Generator(dev).manual_seed(seed)
    return {name: seeded_tensor(name, shape, gen, dev).cpu().numpy()
            for name, shape in shapes.items()}


def write_seeded_bf16_safetensors(path: str, shapes: dict, dev: torch.device, seed: int) -> int:
    """A safetensors file of BF16 tensors of the given names and shapes,
    each drawn on the card by :func:`seeded_tensor` and rounded to bf16,
    written one at a time (the host never holds the whole state). Returns
    its bytes."""
    header, offset = {}, 0
    for name, shape in shapes.items():
        size = 2 * math.prod(shape)
        header[name] = {"dtype": "BF16", "shape": list(shape), "data_offsets": [offset, offset + size]}
        offset += size
    head = json.dumps(header).encode()
    gen = torch.Generator(dev).manual_seed(seed)
    with open(path, "wb") as fh:
        fh.write(len(head).to_bytes(8, "little") + head)
        for name, shape in shapes.items():
            x = seeded_tensor(name, shape, gen, dev).to(torch.bfloat16)
            fh.write(x.view(torch.int16).cpu().numpy().data)  # little-endian, as the format
    return 8 + len(head) + offset


def t2v_text_embeddings(dev: torch.device) -> dict:
    """umT5-XXL at full size encodes the two seeded prompts and the null
    prompt; a 2-layer model of its widths, card against CPU, first."""
    from mhla_tpu_torch.models.t5 import UMT5_XXL, T5Encoder, encode_masked, init_t5_params
    from mhla_tpu_torch.utils import get_err_ratio

    lens = torch.tensor(T2V_PROMPT_LENS)
    gen = torch.Generator().manual_seed(SEED + 20)
    ids = torch.randint(3, UMT5_XXL.vocab_size, (len(lens), VIDEO_TEXT_LEN), generator=gen)
    mask = (torch.arange(VIDEO_TEXT_LEN)[None] < lens[:, None]).int()
    ids = ids * mask
    ids[torch.arange(len(lens)), lens - 1] = 1  # each prompt ends with its end token

    # the widths on a small input: card against CPU
    import dataclasses

    two = dataclasses.replace(UMT5_XXL, num_layers=2, vocab_size=4096)
    small = init_t5_params(T5Encoder(two, device=dev), torch.Generator(dev).manual_seed(SEED + 22))
    on_cpu = T5Encoder(two, device="meta")
    on_cpu.load_state_dict({k: v.cpu() for k, v in small.state_dict().items()}, assign=True)
    ids_small, mask_small = ids[:, :64] % two.vocab_size, mask[:, :64]
    rel = get_err_ratio(encode_masked(on_cpu, ids_small, mask_small),
                        encode_masked(small, ids_small.to(dev), mask_small.to(dev)))
    del small, on_cpu
    log(f"[t2v] umT5 widths, 2 layers, 3 x 64 tokens: card vs CPU rel-RMS {rel:.3e} "
        f"(tol {T2V_CPU_TOL})")
    if not rel < T2V_CPU_TOL:
        raise AssertionError(f"umT5 on the card differs from the CPU ({rel:.3e})")

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = T5Encoder(UMT5_XXL, device=dev).eval().requires_grad_(False)
    init_t5_params(model, torch.Generator(dev).manual_seed(SEED + 21))
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    ids, mask = ids.to(dev), mask.to(dev)
    times = []
    for _ in range(2):  # the first call pays cuBLAS's set-up
        t0 = time.perf_counter()
        emb = encode_masked(model, ids, mask)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    n_params = sum(p.numel() for p in model.parameters())
    del model
    torch.cuda.empty_cache()
    past = torch.arange(VIDEO_TEXT_LEN, device=dev)[None] >= lens.to(dev)[:, None]
    if emb.shape != (3, VIDEO_TEXT_LEN, UMT5_XXL.dim) or not torch.isfinite(emb).all():
        raise AssertionError(f"umT5 embeddings {tuple(emb.shape)}, finite "
                             f"{bool(torch.isfinite(emb).all())}")
    if emb[past].any() or not emb[~past].abs().amax(-1).gt(0).all():
        raise AssertionError("umT5 embeddings not zero exactly past each prompt's length")
    log(f"[t2v] umT5-XXL: {UMT5_XXL.num_layers} layers, dim {UMT5_XXL.dim}, "
        f"{UMT5_XXL.num_heads} heads, ffn {UMT5_XXL.dim_ffn}, vocab {UMT5_XXL.vocab_size}, "
        f"{n_params / 1e9:.3f} B float32 params (seeded init {build_s:.1f} s); 3 x "
        f"{VIDEO_TEXT_LEN} slots, lengths {list(T2V_PROMPT_LENS)}: finite, zero past each "
        f"length; encode {times[1] * 1e3:.1f} ms (first call {times[0] * 1e3:.1f} ms, host "
        f"clock after a sync); peak device memory {peak_gb:.1f} GB")
    emb = emb.cpu().numpy()
    return {"emb": emb, "encode_ms": times[1] * 1e3, "encode_first_ms": times[0] * 1e3,
            "init_s": build_s, "peak_gb": peak_gb, "card_vs_cpu_2_layers": rel}


def t2v_vae_state(dev: torch.device, work: str) -> tuple:
    """The reference-named seeded Wan2.1 VAE state dict as ``work``/vae.pth;
    the VAE on a small latent, card (whole and one frame a slice) against
    CPU. Returns the path and the numbers."""
    from mhla_tpu_torch.models import vae as vae_mod
    from mhla_tpu_torch.models.convert_jax import vae_params_from_jax
    from mhla_tpu_torch.utils import get_err_ratio

    shapes = vae_mod.reference_state_shapes(vae_mod.WanVAE(device="meta"))
    state = seeded_reference_state(shapes, dev, SEED + 24)
    path = f"{work}/Wan2.1_VAE.pth"
    torch.save({k: torch.from_numpy(v) for k, v in state.items()}, path)
    params = vae_params_from_jax(vae_mod.convert_vae_checkpoint(state))
    cpu, card = vae_mod.WanVAE(), vae_mod.WanVAE(device=dev)
    cpu.load_state_dict(params)
    card.load_state_dict(params)
    z = torch.randn(1, 3, 4, 4, 16, generator=torch.Generator().manual_seed(SEED + 25))
    ref = cpu.decode(z)
    rels = {}
    for slice_bytes in (vae_mod.SLICE_BYTES, 1):
        card.slice_bytes = slice_bytes
        rels[slice_bytes] = get_err_ratio(ref, card.decode(z.to(dev)))
    del card
    log(f"[t2v] Wan2.1 VAE ({len(shapes)} tensors, {sum(map(math.prod, shapes.values())) / 1e6:.1f}"
        f" M params) decoding [1, 3, 4, 4, 16] -> {list(ref.shape)}: card vs CPU rel-RMS "
        f"{rels[vae_mod.SLICE_BYTES]:.3e}, one frame a slice {rels[1]:.3e} (tol {T2V_CPU_TOL})")
    if not max(rels.values()) < T2V_CPU_TOL:
        raise AssertionError(f"the VAE on the card differs from the CPU: {rels}")
    return path, {"card_vs_cpu": rels[vae_mod.SLICE_BYTES], "card_sliced_vs_cpu": rels[1]}


def t2v_cli(dev: torch.device, work: str, solver: str, prompts: int, extra=()) -> tuple:
    """``video_infer_cli.main`` with ``solver``: the first ``prompts``
    prompts in one batch, 4 steps on the umT5 embeddings, the model from the
    safetensors file. Returns the CLI's output, the launches, the seconds it
    took and its arguments."""
    from mhla_tpu_torch import kernels
    from mhla_tpu_torch.eval import video_infer_cli

    with open(f"{work}/prompts_{solver}.txt", "w") as fh:
        fh.write("".join(T2V_PROMPTS[:prompts]))
    argv = [
        f"--device={dev.type}", f"--txt_file={work}/prompts_{solver}.txt",
        f"--out_dir={work}/{solver}", f"--batch_size={prompts}",
        f"--emb_file={work}/emb.npz", f"--wan_safetensors={work}/wan.safetensors",
        f"--sampling.solver={solver}", f"--sampling.num_steps={VIDEO_STEPS}",
        "--sampling.cfg_scale=5.0", "--sampling.flow_shift=3.0",
        f"--sampling.latent_shape={VIDEO_LATENT}".replace(" ", ""), *extra,
    ]
    torch.cuda.empty_cache()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    out = video_infer_cli.main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = kernels.launch_counts()
    want = video_launches(VIDEO_LAYERS, [VIDEO_LAYERS] * VIDEO_STEPS, [0] * VIDEO_STEPS)
    log(f"[t2v {solver}] launches in {VIDEO_STEPS} steps with CFG ({VIDEO_STEPS} model calls):"
        f" {counts}")
    got = {name: counts[name] for name in want}
    if got != want:
        raise AssertionError(f"launches of the {solver} path {got}, expected {want}")
    return out, counts, seconds, argv


def phase_t2v(dev: torch.device) -> dict:
    """(af) text to video through the entry points: umT5-XXL embeddings, the
    Wan weights from a reference safetensors file, UniPC with the VAE decode
    and SA-Solver, each 4 steps."""
    import shutil

    from mhla_tpu_torch.eval import video_infer_cli
    from mhla_tpu_torch.models import WanModel, convert_wan, vae as vae_mod

    t_phase = time.perf_counter()
    text = t2v_text_embeddings(dev)
    with tempfile.TemporaryDirectory(prefix="mhla_t2v_") as work:
        log(f"[t2v] {shutil.disk_usage(work).free / 1e9:.0f} GB free where the checkpoints go")
        np.savez(f"{work}/emb.npz", emb_0=text["emb"][0], emb_1=text["emb"][1],
                 null=text["emb"][2])
        # the reference-named seeded Wan2.1-1.3B checkpoint
        model_cfg = video_infer_cli._wan_config(video_infer_cli.VideoInferConfig())
        meta = WanModel(model_cfg, device="meta")
        names = convert_wan.reference_names(meta)
        shapes = {ref: tuple(meta.state_dict()[name].shape) for name, ref in names.items()}
        t0 = time.perf_counter()
        source = seeded_reference_state(shapes, dev, SEED + 23)
        write_safetensors(f"{work}/wan.safetensors", source)
        write_s = time.perf_counter() - t0
        wan_gb = sum(a.nbytes for a in source.values()) / 1e9
        vae_path, vae_check = t2v_vae_state(dev, work)

        # UniPC, decoded by the VAE (the card has no imageio: the mp4 writer
        # is replaced by a recorder of the frames it was handed)
        frames, decode = {}, {}
        real_to_uint8, real_decode = video_infer_cli.to_uint8_video, vae_mod.WanVAE.decode

        def to_uint8(x):
            frames.update(shape=x.shape, finite=bool(np.isfinite(x).all()), lo=float(x.min()),
                          hi=float(x.max()), clipped=float((np.abs(x) >= 1.0).mean()))
            out = real_to_uint8(x)
            frames["uint8"] = (out.shape, str(out.dtype))
            return out

        def measured_decode(self, z):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            x = real_decode(self, z)
            torch.cuda.synchronize()
            decode.update(base_gb=base / 1e9, peak_gb=torch.cuda.max_memory_allocated() / 1e9)
            return x

        with mock.patch.object(video_infer_cli, "to_uint8_video", to_uint8), \
                mock.patch.object(video_infer_cli, "write_mp4", lambda path, f, fps: path), \
                mock.patch.object(vae_mod.WanVAE, "decode", measured_decode):
            uni, uni_counts, uni_s, argv = t2v_cli(dev, work, "unipc", 1,
                                                   [f"--vae_ckpt={vae_path}"])
        if frames["shape"] != T2V_FRAMES[1:] or not frames["finite"] or not (
                -1.0 <= frames["lo"] and frames["hi"] <= 1.0):
            raise AssertionError(f"decoded frames {frames}")
        model = uni["model"]
        # every loaded parameter against its source: q, k and their norms by
        # the RoPE permutation, the MHLA gates from the seeded init
        perm = convert_wan.rope_feature_permutation(model.cfg.dim, model.cfg.num_heads)
        init = video_infer_cli._build_model(video_infer_cli.parse_cli(
            video_infer_cli.VideoInferConfig, argv), dev)
        init_params = init.state_dict()
        checked = permuted = gates = 0
        for name, p in model.state_dict().items():
            if name not in names:
                gates += 1
                if not torch.equal(p, init_params[name]):
                    raise AssertionError(f"{name} is not the seeded init's")
                continue
            src = torch.from_numpy(source[names[name]])
            if name.split(".")[2:4] in (["self_attn", n] for n in ("q", "k", "norm_q", "norm_k")):
                src, permuted = src[perm], permuted + 1
            if not torch.equal(p.cpu(), src):
                raise AssertionError(f"{name} differs from {names[name]} of the checkpoint")
            checked += 1
        del init, init_params, model, uni["model"]
        log(f"[t2v] Wan2.1-1.3B from a {wan_gb:.2f} GB reference-named safetensors file "
            f"({len(source)} tensors, written in {write_s:.1f} s): {checked} parameters bit for bit "
            f"their source ({permuted} q/k rows and norms by rope_feature_permutation), {gates} "
            "MHLA gate tensors the seeded init's")
        log(f"[t2v unipc] the {T2V_PROMPT_LENS[0]}-token prompt: sampling "
            f"{uni['sample_seconds'][0]:.2f} s for {VIDEO_STEPS} steps (host clock); VAE decode "
            f"of {[1, *VIDEO_LATENT]} -> {list(frames['shape'])} in [{frames['lo']:.3f}, "
            f"{frames['hi']:.3f}] ({frames['clipped'] * 100:.1f}% at the clip), uint8 "
            f"{frames['uint8']}: {uni['decode_seconds'][0]:.2f} s (host clock, to the frames on "
            f"the host), peak device memory {decode['peak_gb']:.1f} GB ({decode['base_gb']:.1f} "
            f"GB held before it); the CLI run {uni_s:.1f} s")
        sa, sa_counts, sa_s, _ = t2v_cli(dev, work, "sa-solver", 2)
        latents = [np.load(item["path"]) for item in sa["outputs"]]
        if any(lat.shape != VIDEO_LATENT or not np.isfinite(lat).all() for lat in latents):
            raise AssertionError("SA-Solver latents not finite or of the wrong shape")
        log(f"[t2v sa-solver] both prompts in one batch (a CFG batch of 4): latents "
            f"{latents[0].shape} finite, std {latents[0].std():.3f} and {latents[1].std():.3f}; "
            f"sampling {sa['sample_seconds'][0]:.2f} s for {VIDEO_STEPS} steps (host clock); the "
            f"CLI run {sa_s:.1f} s")
        del sa["model"]
    torch.cuda.empty_cache()
    seconds = time.perf_counter() - t_phase
    log(f"[t2v] phase {seconds:.1f} s")
    return {"launches": uni_counts, "t5": {k: v for k, v in text.items() if k != "emb"},
            "wan_checkpoint_gb": wan_gb, "write_s": write_s, "vae": vae_check,
            "unipc_sample_s": uni["sample_seconds"][0], "decode_s": uni["decode_seconds"][0],
            "decode_peak_gb": decode["peak_gb"], "decode_base_gb": decode["base_gb"],
            "frames": {k: frames[k] for k in ("lo", "hi", "clipped")},
            "unipc_cli_s": uni_s, "sa_solver_sample_s": sa["sample_seconds"][0],
            "sa_solver_cli_s": sa_s, "seconds": seconds}


def phase_kernels_i2v(dev: torch.device) -> dict:
    """K9 at the image cross-attention's shape of (ag): CFG batch 2, 31,500
    queries against the 257 CLIP tokens at 40 heads of 128 (its last key
    tile holds a single key)."""
    import torch.nn.functional as F

    from mhla_tpu_torch.kernels import flash_attention as flash

    b, t, h, dh, bf16 = VIDEO_CFG_BATCH, math.prod(VIDEO_GRID), I2V_HEADS, VIDEO_HEAD_DIM, torch.bfloat16
    gen = torch.Generator(dev).manual_seed(SEED + 31)
    q, k, v = (torch.randn(b, n, h, dh, generator=gen, device=dev).to(bf16)
               for n in (t, I2V_IMG_TOKENS, I2V_IMG_TOKENS))
    results = {}
    check_kernel(results, "flash_attention[tk257]", f"Tq={t} Tk={I2V_IMG_TOKENS} H={h}",
                 lambda: flash.flash_attention(q, k, v),
                 lambda: flash.flash_attention_plain(q, k, v), True, tol=FLASH_TOL,
                 work=(2 * nbytes(q) + nbytes(k, v), 4 * b * h * t * I2V_IMG_TOKENS * dh, bf16),
                 library=lambda: F.scaled_dot_product_attention(
                     q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)).transpose(1, 2))
    return results


def i2v_clip_features(dev: torch.device) -> tuple:
    """CLIP ViT-H/14 at full size (float32, seeded) encodes one seeded 480 x
    800 frame in [-1, 1]; 2 layers of its widths, card against CPU, first.
    Returns the features [1, 257, 1280] and the numbers."""
    import dataclasses

    from mhla_tpu_torch.models.clip import (
        CLIP_VIT_H_14,
        CLIPVisionTransformer,
        encode_i2v_features,
        init_clip_params,
    )
    from mhla_tpu_torch.utils import get_err_ratio

    frame = torch.rand(I2V_FRAME, generator=torch.Generator().manual_seed(SEED + 32)) * 2 - 1
    two = dataclasses.replace(CLIP_VIT_H_14, num_layers=2)
    small = init_clip_params(CLIPVisionTransformer(two, device=dev),
                             torch.Generator(dev).manual_seed(SEED + 33))
    on_cpu = CLIPVisionTransformer(two, device="meta")
    on_cpu.load_state_dict({k: v.cpu() for k, v in small.state_dict().items()}, assign=True)
    rel = get_err_ratio(encode_i2v_features(on_cpu, frame), encode_i2v_features(small, frame))
    del small, on_cpu
    log(f"[i2v] CLIP ViT-H/14 widths, 2 layers, one {I2V_FRAME[1]} x {I2V_FRAME[2]} frame: card vs "
        f"CPU rel-RMS {rel:.3e} (tol {T2V_CPU_TOL})")
    if not rel < T2V_CPU_TOL:
        raise AssertionError(f"CLIP on the card differs from the CPU ({rel:.3e})")

    torch.cuda.reset_peak_memory_stats()
    model = CLIPVisionTransformer(CLIP_VIT_H_14, device=dev).eval().requires_grad_(False)
    init_clip_params(model, torch.Generator(dev).manual_seed(SEED + 34))
    n_params = sum(p.numel() for p in model.parameters())
    times = []
    for _ in range(2):  # the first call pays cuBLAS's set-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fea = encode_i2v_features(model, frame)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    del model
    torch.cuda.empty_cache()
    if fea.shape != (1, I2V_IMG_TOKENS, CLIP_VIT_H_14.dim) or not torch.isfinite(fea).all():
        raise AssertionError(f"CLIP features {tuple(fea.shape)}, finite "
                             f"{bool(torch.isfinite(fea).all())}")
    log(f"[i2v] CLIP ViT-H/14: {CLIP_VIT_H_14.num_layers} layers (features after "
        f"{CLIP_VIT_H_14.num_layers - 1}), dim {CLIP_VIT_H_14.dim}, {CLIP_VIT_H_14.num_heads} heads "
        f"of {CLIP_VIT_H_14.dim // CLIP_VIT_H_14.num_heads}, {n_params / 1e6:.1f} M float32 params; "
        f"one frame -> {list(fea.shape)} finite, std {fea.std():.3f}; encode {times[1] * 1e3:.1f} "
        f"ms (first call {times[0] * 1e3:.1f} ms; preprocessing included, host clock after a "
        f"sync); peak device memory {peak_gb:.1f} GB")
    return fea, {"encode_ms": times[1] * 1e3, "encode_first_ms": times[0] * 1e3,
                 "peak_gb": peak_gb, "card_vs_cpu_2_layers": rel}


def phase_i2v(dev: torch.device) -> dict:
    """(ag) image to video through ``sample_video_latents``: CLIP features of
    one frame, Wan2.1-I2V-14B's widths at I2V_LAYERS layers from a
    reference-named seeded BF16 safetensors file, 4 DPM-Solver++ steps with
    CFG; the image keys' K9 launches counted apart."""
    from mhla_tpu_torch import kernels
    from mhla_tpu_torch.eval import sample_video_latents
    from mhla_tpu_torch.layers import attention
    from mhla_tpu_torch.models import WanModel, build_wan_config, convert_wan, init_wan_params
    from mhla_tpu_torch.models.convert_jax import wan_params_from_jax
    from mhla_tpu_torch.utils import get_err_ratio
    from mhla_tpu_torch.utils.safetensors_io import load_safetensors

    t_phase = time.perf_counter()
    fea, clip_info = i2v_clip_features(dev)
    cfg = build_wan_config("Wan_I2V_14B", num_layers=I2V_LAYERS,
                           linear_attn_idx=tuple(range(I2V_LAYERS)), dtype=torch.bfloat16)
    if (cfg.model_type, cfg.dim, cfg.num_heads, cfg.ffn_dim) != ("i2v", 5120, I2V_HEADS, 13824):
        raise AssertionError(f"not Wan2.1-I2V-14B's widths: {cfg}")
    with tempfile.TemporaryDirectory(prefix="mhla_i2v_") as work:
        meta = WanModel(cfg, device="meta")
        names = convert_wan.reference_names(meta)
        shapes = convert_wan.reference_state_shapes(meta)
        del meta
        path = f"{work}/wan_i2v.safetensors"
        t0 = time.perf_counter()
        file_bytes = write_seeded_bf16_safetensors(path, shapes, dev, SEED + 35)
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        model = init_wan_params(WanModel(cfg, device=dev), torch.Generator(dev).manual_seed(SEED))
        model.eval().requires_grad_(False)
        state = load_safetensors(path)
        model.load_state_dict(wan_params_from_jax(convert_wan.convert_wan_checkpoint(
            state, cfg, convert_wan.mhla_init_params(model))))
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        # every loaded parameter against its source in the file
        perm = torch.from_numpy(convert_wan.rope_feature_permutation(cfg.dim, cfg.num_heads)).to(dev)
        checked = permuted = 0
        for name, p in model.state_dict().items():
            if name not in names:
                continue
            src = torch.from_numpy(np.ascontiguousarray(state[names[name]])).to(dev)
            if name.split(".")[2:4] in (["self_attn", n] for n in ("q", "k", "norm_q", "norm_k")):
                src, permuted = src[perm], permuted + 1
            if not torch.equal(p, src):
                raise AssertionError(f"{name} differs from {names[name]} of the checkpoint")
            checked += 1
        del state
    n_params = sum(p.numel() for p in model.parameters())
    log(f"[i2v] Wan2.1-I2V-14B widths, {I2V_LAYERS} of 40 layers all MHLA, dim {cfg.dim}, "
        f"{cfg.num_heads} heads, ffn {cfg.ffn_dim}, {n_params / 1e9:.3f} B float32 params, compute "
        f"{cfg.dtype}: a {file_bytes / 1e9:.2f} GB reference-named BF16 safetensors file "
        f"({len(shapes)} tensors) written in {write_s:.1f} s, read, converted and loaded in "
        f"{load_s:.1f} s; {checked} parameters bit for bit their source ({permuted} q/k rows and "
        "norms by rope_feature_permutation)")

    emb, null = (torch.from_numpy(a)[None] for a in video_text_embeddings())
    real_flash, image_calls = attention.flash_attention, []

    def counted_flash(q, k, v, **kw):
        if k.shape[1] == I2V_IMG_TOKENS:
            image_calls.append(tuple(q.shape))
        return real_flash(q, k, v, **kw)

    want = video_launches(I2V_LAYERS, [2 * I2V_LAYERS] * VIDEO_STEPS, [0] * VIDEO_STEPS)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    with mock.patch.object(attention, "flash_attention", counted_flash):
        latents = sample_video_latents(
            model, emb, null, latent_shape=VIDEO_LATENT, cfg_scale=5.0, num_steps=VIDEO_STEPS,
            solver="dpm-solver", flow_shift=3.0, generator=torch.Generator(dev).manual_seed(SEED),
            clip_fea=fea).cpu().numpy()[0]  # the copy waits for the device
    seconds = time.perf_counter() - t0
    counts = kernels.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check_sampling("i2v", latents, counts, want)
    k9_image = len(image_calls)
    if k9_image != VIDEO_STEPS * I2V_LAYERS or set(image_calls) != {
            (VIDEO_CFG_BATCH, math.prod(VIDEO_GRID), I2V_HEADS, VIDEO_HEAD_DIM)}:
        raise AssertionError(f"K9 over the image keys: {k9_image} calls of {set(image_calls)}")

    # one forward through the kernels against the same forward through their plain versions
    x, t, ctx = video_inputs(dev, cfg.text_dim, 500.0)
    fea2 = fea.to(cfg.dtype).repeat(VIDEO_CFG_BATCH, 1, 1)
    with torch.no_grad():
        v_kern = model(x, t, ctx, clip_fea=fea2)
        before = kernels.launch_counts()
        with plain_kernels():
            v_plain = model(x, t, ctx, clip_fea=fea2)
        if kernels.launch_counts() != before:
            raise AssertionError("the plain forward launched a kernel")
        fwd_ms = median_ms(lambda: model(x, t, ctx, clip_fea=fea2), reps=3, inner=1, warmup=0)
    rel = get_err_ratio(v_plain, v_kern)
    log(f"[i2v] forward through K5-K9 vs plain versions: velocity rel-RMS {rel:.3e} (tol "
        f"{VIDEO_TOL})")
    if not (torch.isfinite(v_kern).all() and rel < VIDEO_TOL):
        raise AssertionError(f"i2v forward: kernels != plain ({rel:.3e})")
    del model, x, ctx, v_kern, v_plain
    torch.cuda.empty_cache()
    step_s = seconds / VIDEO_STEPS
    phase_s = time.perf_counter() - t_phase
    log(f"[i2v] latents {latents.shape} finite, std {latents.std():.3f}; {step_s:.3f} s per "
        f"denoising step (sampling {seconds:.2f} s for {VIDEO_STEPS} steps, host clock); "
        f"{fwd_ms:.1f} ms per forward of the CFG batch (CUDA events, median of 3); peak device "
        f"memory {peak_gb:.1f} GB; K9 over the image keys {k9_image} launches; phase "
        f"{phase_s:.1f} s")
    return {"launches": counts, "k9_image_launches": k9_image, "clip": clip_info,
            "checkpoint_gb": file_bytes / 1e9, "write_s": write_s, "load_s": load_s,
            "step_s": step_s, "forward_ms": fwd_ms, "peak_gb": peak_gb,
            "kernels_vs_plain": rel, "seconds": phase_s}


def layer_grads(layer, x: torch.Tensor, w: torch.Tensor, *args) -> dict:
    """Gradients of sum(layer(x, *args) * w) in x and in every parameter of
    ``layer``, by name."""
    for p in layer.parameters():
        p.grad = None
    x = x.detach().requires_grad_()
    (layer(x, *args).float() * w).sum().backward()
    grads = {"x": x.grad, **{name: p.grad for name, p in layer.named_parameters()}}
    for p in layer.parameters():
        p.grad = None
    return grads


def phase_kernels_video_train(dev: torch.device) -> dict:
    """K5b, K8b, K7b and K9b against their plain versions at the shapes one
    training step of the Wan2.1-1.3B model gives them (batch 1, 31,500
    tokens), then one MHLA3D and one softmax self-attention layer's gradients
    through the kernels against the same layer through the plain versions."""
    import torch.nn.functional as F

    from mhla_tpu_torch.kernels import flash_attention as flash
    from mhla_tpu_torch.kernels import mhla_block
    from mhla_tpu_torch.layers import MHLA3D
    from mhla_tpu_torch.models.wan import WanSelfAttention
    from mhla_tpu_torch.ops.rotary import rope_tables_flat
    from mhla_tpu_torch.utils import get_err_ratio

    b, h, dh = 1, VIDEO_HEADS, VIDEO_HEAD_DIM
    glt = (VIDEO_GRID, VIDEO_LAYOUT, h)
    t, n = math.prod(VIDEO_GRID), math.prod(VIDEO_LAYOUT)
    c, f = t // n, h * dh
    f32, bf16 = torch.float32, torch.bfloat16
    gen = torch.Generator(dev).manual_seed(SEED + 12)
    randn = lambda *s: torch.randn(*s, generator=gen, device=dev)  # noqa: E731
    results = {}
    check = lambda *a, **kw: check_kernel(results, *a, **kw)  # noqa: E731
    slow = dict(reps=5, inner=2, warmup=1)
    tables = rope_tables_flat(VIDEO_GRID, dh, device=dev)

    # K5b as the gradients of q and k take it (float32, the rotation undone),
    # as v's (no RoPE; beside one index_select of the blocked rows by the
    # inverse permutation, the same function) and with the pre-RoPE copy's
    # gradient summed in (bf16 island, normalize_out); K8b as the island
    # epilogue's backward takes it (bf16 gradient in, float32 out) and with
    # RoPE (the transpose of K5b). Each within 1e-6 of plain, two runs equal;
    # operations: 6 an element with RoPE, one more with add, 1 without.
    dyb, dnope = randn(b, n, c, f), randn(b, n, c, f)
    dyb16, dnope16 = dyb.to(bf16), dnope.to(bf16)
    dy = randn(b, t, f).to(bf16)
    inverse = torch.argsort(mhla_block.block_token_index(VIDEO_GRID, VIDEO_LAYOUT, dev))
    flat_f32 = 4 * b * t * f  # every form writes float32
    permute_forms = (
        ("unblockify", "f32 rope^T", lambda: mhla_block.unblockify(dyb, tables, *glt, -1.0, f32),
         lambda: mhla_block.unblockify_plain(dyb, tables, *glt, -1.0, f32),
         nbytes(dyb, *tables), 6, None),
        ("unblockify[v]", "f32 no rope", lambda: mhla_block.unblockify(dyb, None, *glt, 1.0, f32),
         lambda: mhla_block.unblockify_plain(dyb, None, *glt, 1.0, f32), nbytes(dyb), 1,
         lambda: dyb.view(t, f).index_select(0, inverse)),
        ("unblockify[bf16+nope]", "bf16->f32 +add",
         lambda: mhla_block.unblockify(dyb16, tables, *glt, -1.0, f32, dnope16),
         lambda: mhla_block.unblockify_plain(dyb16, tables, *glt, -1.0, f32, dnope16),
         nbytes(dyb16, dnope16, *tables), 7, None),
        ("blockify", "bf16->f32", lambda: mhla_block.blockify(dy, None, *glt, 1.0, f32),
         lambda: mhla_block.blockify_plain(dy, None, *glt, 1.0, f32), nbytes(dy), 1, None),
        ("blockify[rope]", "bf16->f32 rope",
         lambda: mhla_block.blockify(dy, tables, *glt, 1.0, f32),
         lambda: mhla_block.blockify_plain(dy, tables, *glt, 1.0, f32), nbytes(dy, *tables), 6,
         None),
    )
    for name, tag, kern, plain, read, ops, library in permute_forms:
        check(name, tag, kern, plain, True, work=(read + flat_f32, ops * b * t * f, f32),
              library=library, tol=1e-6)
        if not torch.equal(kern(), kern()):
            raise AssertionError(f"{name} {tag}: two runs differ")
        log(f"[kernels] {name} {tag}: two runs equal")
    del dnope, dyb16, dnope16, dy, inverse

    q4 = torch.relu(randn(b, n, c, f)) + 1e-6
    mixed = randn(b, n, f, dh)
    # K7b's bound as K7's: bytes, or two products on the TF32 tensor cores,
    # three TF32 products each in float32, one in bf16
    for dt, suffix, products in ((f32, "", 3), (bf16, "[bf16]", 1)):
        qq, mx, dd = q4.to(dt), mixed.to(dt), dyb.to(dt)
        q5, m5, d5 = qq.unflatten(-1, (h, dh)), mx.unflatten(-2, (h, dh)), dd.unflatten(-1, (h, dh))
        check("block_readout_bwd" + suffix, f"{str(dt)[6:]} C={c}",
              lambda: mhla_block.block_readout_bwd(qq, mx, dd, h),
              lambda: mhla_block.block_readout_bwd_plain(qq, mx, dd, h), True,
              work=(2 * nbytes(qq, mx) + nbytes(dd), products * 4 * b * n * c * h * dh * dh,
                    "tf32"),
              library=lambda: (torch.einsum("bnchv,bnhkv->bnchk", d5, m5),
                               torch.einsum("bnchk,bnchv->bnhkv", q5, d5)),
              tol=K6_F32_TOL if dt == f32 else KERNEL_TOL)
        first = mhla_block.block_readout_bwd(qq, mx, dd, h)
        again = mhla_block.block_readout_bwd(qq, mx, dd, h)
        if not all(torch.equal(x, y) for x, y in zip(first, again)):
            raise AssertionError(f"block_readout_bwd{suffix}: two runs differ")
        log(f"[kernels] block_readout_bwd{suffix}: two runs equal")
        del qq, mx, dd, q5, m5, d5, first, again
    del q4, mixed, dyb

    # K9b at the cross-attention's and the softmax self-attention's shapes, on
    # K9's own output and log-sum-exp
    for tk, name, timing in ((VIDEO_TEXT_LEN, "flash_attention_bwd", {}),
                             (t, "flash_attention_bwd[self]", slow)):
        q, k, v = (randn(b, tt, h, dh).to(bf16) for tt in (t, tk, tk))
        do = randn(b, t, h, dh).to(bf16)
        o, lse = flash._flash_fwd(q, k, v, None, want_lse=True)
        if not torch.equal(o, flash.flash_attention(q, k, v)):
            raise AssertionError("K9's training form and its serving form disagree")
        lse_rel = get_err_ratio(flash.flash_attention_plain(q, k, v, return_lse=True)[1], lse)
        qt, kt, vt = (x.detach().transpose(1, 2).requires_grad_() for x in (q, k, v))
        sdpa_out = F.scaled_dot_product_attention(qt, kt, vt)
        dot = do.transpose(1, 2)
        check(name, f"Tq={t} Tk={tk}",
              lambda: flash.flash_attention_bwd(q, k, v, o, lse, do),
              lambda: flash.flash_attention_bwd_plain(q, k, v, o, lse, do), True,
              tol=FLASH_BWD_TOL,
              work=(nbytes(q, k, v, o, do, lse) + nbytes(q, k, v), 10 * b * h * t * tk * dh, bf16),
              library=lambda: torch.autograd.grad(sdpa_out, (qt, kt, vt), dot, retain_graph=True),
              timing=timing)
        again = flash.flash_attention_bwd(q, k, v, o, lse, do)
        first = flash.flash_attention_bwd(q, k, v, o, lse, do)
        if not all(torch.equal(x, y) for x, y in zip(first, again)):
            raise AssertionError(f"{name}: two runs differ")
        log(f"[kernels] {name}: K9's log-sum-exp vs plain rel-RMS {lse_rel:.2e}; two runs equal")
        if not lse_rel < 1e-5:
            raise AssertionError(f"K9's log-sum-exp disagrees with the plain version ({lse_rel:.3e})")
        del q, k, v, do, o, lse, qt, kt, vt, sdpa_out, dot, again, first

    # one layer of each kind at 31,500 tokens, bf16 activations over float32
    # parameters: gradients through the kernels against the plain versions
    check_layer_grads(dev, "MHLA3D", MHLA3D(f, h, VIDEO_LAYOUT, normalize_out=False, device=dev),
                      (VIDEO_GRID, tables))
    check_layer_grads(dev, "WanSelfAttention", WanSelfAttention(f, h, device=dev), (VIDEO_GRID,))
    return results


def check_layer_grads(dev: torch.device, tag: str, layer, args) -> None:
    """The gradients of sum(layer(x, *args) * w) at batch 1 x 31,500 tokens
    (bf16 activations over float32 parameters from the seeded init, norm
    weights and biases moved off their start) through the kernels against
    the same layer through the plain versions."""
    from mhla_tpu_torch import kernels
    from mhla_tpu_torch.models.wan import init_wan_params
    from mhla_tpu_torch.utils import get_err_ratio

    t, f = math.prod(VIDEO_GRID), VIDEO_HEADS * VIDEO_HEAD_DIM
    gen = torch.Generator(dev).manual_seed(SEED + 14)
    randn = lambda *s: torch.randn(*s, generator=gen, device=dev)  # noqa: E731
    x, w = randn(1, t, f).to(torch.bfloat16), randn(1, t, f)
    init_wan_params(layer, torch.Generator(dev).manual_seed(SEED + 13))
    with torch.no_grad():
        for name, p in layer.named_parameters():
            if "norm" in name:  # norm weights away from 1: their gradients are exercised
                p.add_(0.1 * randn(*p.shape))
            elif name.endswith("bias"):
                p.add_(0.02 * randn(*p.shape))
    kernels.reset_launch_counts()
    got = layer_grads(layer, x, w, *args)
    launched = {k_: v_ for k_, v_ in kernels.launch_counts().items() if v_}
    with plain_kernels():
        ref = layer_grads(layer, x, w, *args)
    if {k_: v_ for k_, v_ in kernels.launch_counts().items() if v_} != launched:
        raise AssertionError("the plain layer launched a kernel")
    torch.cuda.synchronize()
    rels = {name: get_err_ratio(ref[name], got[name]) for name in ref}
    worst = max(rels, key=rels.get)
    log(f"[grads] {tag} at {t} tokens, kernels {launched}: gradients vs plain versions, "
        f"rel-RMS dx {rels['x']:.3e}, worst {worst} {rels[worst]:.3e} (tol {LAYER_GRAD_TOL})")
    if not (all(torch.isfinite(g).all() for g in got.values())
            and rels[worst] < LAYER_GRAD_TOL):
        raise AssertionError(f"{tag} gradients: kernels != plain: {rels}")


def phase_kernels_sparse_train(dev: torch.device) -> dict:
    """K10's training form and K10b against their plain versions at the
    shape one radial-sparse layer gives them in a training step of the
    Wan2.1-1.3B model (batch 1, 31,500 tokens in 21 frames, 12 heads) and at
    a small ragged geometry, then one sparse layer's gradients."""
    import torch.nn.functional as F

    from mhla_tpu_torch.kernels import sparse_attention as sparse
    from mhla_tpu_torch.models.wan import WanSelfAttention
    from mhla_tpu_torch.utils import get_err_ratio

    b, h, dh, frames = 1, VIDEO_HEADS, VIDEO_HEAD_DIM, VIDEO_GRID[0]
    t = math.prod(VIDEO_GRID)
    bf16 = torch.bfloat16
    gen = torch.Generator(dev).manual_seed(SEED + 15)
    randn = lambda *s: torch.randn(*s, generator=gen, device=dev)  # noqa: E731
    results = {}
    check = lambda *a, **kw: check_kernel(results, *a, **kw)  # noqa: E731
    slow = dict(reps=5, inner=2, warmup=1)

    def lse_close(tag, ref, lse):
        rel = get_err_ratio(ref, lse)
        log(f"[kernels] {tag}: K10's masked log-sum-exp vs plain rel-RMS {rel:.2e}")
        if not (torch.isfinite(lse).all() and rel < 1e-5):
            raise AssertionError(f"{tag}: K10's log-sum-exp disagrees with the plain version")

    # 437 tokens in 4 frames of 109 and a last frame of 1: ragged frames, a ragged last tile
    rt, rf = 4 * 100 + 37, 4
    qs, ks, vs, dos = (randn(2, rt, 3, dh).to(bf16) for _ in range(4))
    check("radial_flash_attention[ragged]", f"T={rt} {rf} frames",
          lambda: sparse.radial_flash_attention(qs, ks, vs, rf),
          lambda: sparse.radial_flash_attention_plain(qs, ks, vs, rf), False, tol=FLASH_TOL)
    os_, lses = sparse.radial_flash_attention(qs, ks, vs, rf, return_lse=True)
    if not torch.equal(os_, sparse.radial_flash_attention(qs, ks, vs, rf)):
        raise AssertionError("K10's training form and its serving form disagree (ragged)")
    for training in (False, True):
        k10_walk(sparse, qs, ks, vs, rf, training)
    lse_close(f"T={rt} {rf} frames",
              sparse.radial_flash_attention_plain(qs, ks, vs, rf, return_lse=True)[1], lses)
    check("radial_flash_attention_bwd[ragged]", f"T={rt} {rf} frames",
          lambda: sparse.radial_flash_attention_bwd(qs, ks, vs, os_, lses, dos, rf),
          lambda: sparse.radial_flash_attention_bwd_plain(qs, ks, vs, os_, lses, dos, rf), False,
          tol=FLASH_BWD_TOL)
    walks = {f"T={rt} {rf} frames B=2 H=3": k10b_walk(sparse, qs, ks, vs, os_, lses, dos, rf)}

    q, k, v, do = (randn(b, t, h, dh).to(bf16) for _ in range(4))
    offsets, tiles, _, _ = sparse.radial_fwd_lists(t, frames)
    pairs = sparse.radial_allowed_pairs(t, frames)
    lengths = np.diff(offsets)
    own, step = sparse.FWD_WALK_TILES
    log(f"[kernels] K10's lists at {frames} frames of {t // frames}: {len(tiles)} tiles of "
        f"{own} x {step} in {len(lengths)} lists (its query blocks): longest {lengths.max()}, "
        f"mean {lengths.mean():.1f}, shortest {lengths.min()}")
    for kernel, (offs, tls, _, _) in sparse.radial_bwd_lists(t, frames).items():
        own, step = sparse.BWD_WALK_TILES[kernel]
        lens = np.diff(offs)
        log(f"[kernels] K10b's {kernel} list: blocks of {own} over tiles of {step}, {len(tls)} "
            f"tiles of {len(lens) * (-(-t // step))} in {len(lens)} lists: longest "
            f"{lens.max()}, mean {lens.mean():.1f}, shortest {lens.min()}")
    mask = torch.cat([sparse.radial_block_mask(r, min(t, r + 2048), t, frames, dev)
                      for r in range(0, t, 2048)])
    qt, kt, vt = (x.detach().transpose(1, 2).requires_grad_() for x in (q, k, v))
    dot = do.transpose(1, 2)
    try:  # the yardsticks only: the port never calls them
        sdpa_out = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)
        torch.autograd.grad(sdpa_out, (qt, kt, vt), dot, retain_graph=True)
        torch.cuda.synchronize()
        lib_fwd = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qt.detach(), kt.detach(), vt.detach(), attn_mask=mask)
        lib_bwd = lambda: torch.autograd.grad(  # noqa: E731
            sdpa_out, (qt, kt, vt), dot, retain_graph=True)
    except RuntimeError as exc:
        log(f"[kernels] masked scaled_dot_product_attention cannot run here: {exc}")
        sdpa_out = lib_fwd = lib_bwd = None

    check("radial_flash_attention[lse]", f"T={t} {frames} frames B={b}",
          lambda: sparse.radial_flash_attention(q, k, v, frames, return_lse=True)[0],
          lambda: sparse.radial_flash_attention_plain(q, k, v, frames), True, tol=FLASH_TOL,
          work=(4 * nbytes(q) + 4 * b * h * t, 4 * b * h * dh * pairs, bf16), library=lib_fwd,
          timing=slow)
    o, lse = sparse.radial_flash_attention(q, k, v, frames, return_lse=True)
    if not torch.equal(o, sparse.radial_flash_attention(q, k, v, frames)):
        raise AssertionError("K10's training form and its serving form disagree")
    lse_close(f"T={t} {frames} frames",
              sparse.radial_flash_attention_plain(q, k, v, frames, return_lse=True)[1], lse)
    serving_ms = median_ms(lambda: sparse.radial_flash_attention(q, k, v, frames), **slow)
    log(f"[kernels] K10 without the log-sum-exp at the same shape: {serving_ms:.4f} ms")
    results["radial_flash_attention[lse]"]["serving_ms"] = serving_ms
    for training in (False, True):
        k10_walk(sparse, q, k, v, frames, training)
    check("radial_flash_attention_bwd", f"T={t} {frames} frames B={b}",
          lambda: sparse.radial_flash_attention_bwd(q, k, v, o, lse, do, frames),
          lambda: sparse.radial_flash_attention_bwd_plain(q, k, v, o, lse, do, frames), True,
          tol=FLASH_BWD_TOL,
          work=(nbytes(q, k, v, o, do, lse) + nbytes(q, k, v), 10 * b * h * dh * pairs, bf16),
          library=lib_bwd, timing=slow)
    first = sparse.radial_flash_attention_bwd(q, k, v, o, lse, do, frames)
    again = sparse.radial_flash_attention_bwd(q, k, v, o, lse, do, frames)
    if not all(torch.equal(x, y) for x, y in zip(first, again)):
        raise AssertionError("radial_flash_attention_bwd: two runs differ")
    log("[kernels] radial_flash_attention_bwd: two runs equal")
    walks[f"T={t} {frames} frames B={b} H={h}"] = k10b_walk(sparse, q, k, v, o, lse, do, frames)
    results["k10b_walks"] = walks
    del q, k, v, do, o, lse, qt, kt, vt, dot, sdpa_out, mask, first, again, lib_fwd, lib_bwd

    check_layer_grads(dev, "WanSelfAttention[sparse]",
                      WanSelfAttention(h * dh, h, sparse=True, device=dev), (VIDEO_GRID,))
    return results


def k10_walk(sparse, q, k, v, frames: int, training: bool) -> None:
    """The tiles K10 walked in one call of its serving or training form (its
    ``visits`` counter) against its lists' length times heads and batch
    rows, kept in K10_WALKS; raises unless they agree or unless a second
    call gives the same bits."""
    b, t, h, _ = q.shape
    form = "training" if training else "serving"
    visits = torch.zeros(1, dtype=torch.int32, device=q.device)
    first = _as_tuple(sparse.radial_flash_attention(q, k, v, frames, return_lse=training,
                                                    visits=visits))
    again = _as_tuple(sparse.radial_flash_attention(q, k, v, frames, return_lse=training))
    if not all(torch.equal(x, y) for x, y in zip(first, again)):
        raise AssertionError(f"K10 ({form}) T={t} {frames} frames: two runs differ")
    own, step = sparse.FWD_WALK_TILES
    walked, listed = visits.item(), sparse.radial_fwd_visits(t, frames, h, b)
    n_all = h * b * (-(-t // own)) * (-(-t // step))
    log(f"[kernels] radial_flash_attention ({form}) T={t} {frames} frames B={b} H={h}: two runs "
        f"equal; tiles walked {walked}, the lists hold {listed}, of {n_all} in all "
        f"({walked / n_all:.1%})")
    if walked != listed:
        raise AssertionError(f"K10 walked {walked} tiles where its lists hold {listed}")
    K10_WALKS[f"{form} T={t} {frames} frames B={b} H={h}"] = {
        "walked": walked, "listed": listed, "all": n_all}


def k10b_walk(sparse, q, k, v, o, lse, do, frames: int) -> dict:
    """The tiles K10b's dK/dV and dQ kernels walked in one call (their
    ``visits`` counters) against their lists' lengths times heads and batch
    rows; raises unless they agree."""
    b, t, h, _ = q.shape
    visits = torch.zeros(2, dtype=torch.int32, device=q.device)
    sparse.radial_flash_attention_bwd(q, k, v, o, lse, do, frames, visits=visits)
    walked, listed = visits.tolist(), sparse.radial_bwd_visits(t, frames, h, b)
    full = [h * b * (-(-t // own)) * (-(-t // step))
            for own, step in (sparse.BWD_WALK_TILES[kern] for kern in ("dkv", "dq"))]
    log(f"[kernels] radial_flash_attention_bwd T={t} {frames} frames B={b} H={h}: tiles walked "
        f"(dK/dV, dQ) {walked}, the lists hold {listed}, of {full} in all "
        f"({walked[0] / full[0]:.1%}, {walked[1] / full[1]:.1%})")
    if walked != listed:
        raise AssertionError(f"K10b walked {walked} tiles where its lists hold {listed}")
    return {"walked": walked, "listed": listed, "all": full}


def phase_train_video(dev: torch.device, tag: str, linear_idx, sparse_idx=(),
                      lora: bool = False, lepe: bool = False,
                      layers: int = VIDEO_LAYERS) -> dict:
    """``wan_train.main`` for VIDEO_TRAIN_STEPS steps of the 30-layer model
    (cut to ``layers`` where asked, the widths kept) at 31,500 tokens, batch
    1, with the MHLA layers ``linear_idx``, the softmax layers
    ``sparse_idx`` under the radial mask, with ``lora`` the model frozen but
    for its adapters and with ``lepe`` the LePE convolution in every MHLA
    layer."""
    from mhla_tpu_torch import kernels
    from mhla_tpu_torch.models.wan import init_wan_params
    from mhla_tpu_torch.train import lora_state, wan_train

    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="mhla_wan_train_") as work:
        argv = [
            f"--device={dev.type}", f"--work_dir={work}",
            f"--model.linear_attn_idx={tuple(linear_idx)}".replace(" ", ""),
            f"--train.max_steps={VIDEO_TRAIN_STEPS}", "--train.log_interval=1",
            "--optimizer.warmup_steps=1",  # the entry point's AdamW, warm-up cut to one step
            f"--model.num_layers={layers}",
        ]
        if sparse_idx:
            argv.append(f"--model.sparse_attn_idx={tuple(sparse_idx)}".replace(" ", ""))
        if lora:
            argv.append("--lora.enable=true")
        if lepe:
            argv.append("--model.is_lepe=true")
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        out = wan_train.main(argv)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
    cfg = out["model"].cfg
    n_mhla, n_sparse = len(cfg.linear_attn_idx), len(cfg.sparse_attn_idx or ())
    if n_sparse != len(sparse_idx) or cfg.sparse_dense_from_t is not None:
        raise AssertionError(f"{n_sparse} radial-sparse layers, dense guard at "
                             f"{cfg.sparse_dense_from_t}: training runs the mask in "
                             f"{len(sparse_idx)} layers at every timestep")
    want = video_train_launches(n_mhla, cfg.num_layers - n_mhla - n_sparse,
                                sparse_layers=n_sparse)
    log(f"[train {tag}] launches in {VIDEO_TRAIN_STEPS} steps: {counts}")
    losses, norms = out["losses"], out["grad_norms"]
    if len(losses) != VIDEO_TRAIN_STEPS or not all(map(math.isfinite, losses)):
        raise AssertionError(f"training losses {losses}")
    if not all(math.isfinite(g) and g > 0 for g in norms):
        raise AssertionError(f"gradient norms {norms}")
    got = {name: counts[name] for name in want}
    if got != want:
        raise AssertionError(f"launches of the {tag} training path {got}, expected {want}")
    if (cfg.num_layers, cfg.dim, cfg.remat, cfg.dtype, cfg.is_lepe) != (
            layers, 1536, True, torch.bfloat16, lepe):
        raise AssertionError(f"not the full-size model: {cfg}")
    adapters = {}
    if lora:
        # the base is the seeded init bit for bit; only the adapters moved
        run_cfg = wan_train.parse_cli(wan_train.WanTrainConfig, argv)
        fresh, _ = wan_train.build_model(run_cfg, dev)
        init_wan_params(fresh, torch.Generator(dev).manual_seed(run_cfg.train.seed))
        base = {n.replace(".parametrizations.weight.original", ".weight"): p
                for n, p in out["model"].named_parameters() if not p.requires_grad}
        if set(base) != set(fresh.state_dict()):
            raise AssertionError("the frozen parameters are not the base model's")
        moved = [n for n, p in fresh.named_parameters() if not torch.equal(p, base[n])]
        if moved:
            raise AssertionError(f"LoRA training changed base parameters: {moved[:5]}")
        del fresh, base
        factors = lora_state(out["model"])
        still_zero = [n for n, f in factors.items() if not f["b"].any()]
        if len(factors) != 8 * cfg.num_layers or still_zero:
            raise AssertionError(f"{len(factors)} adapters, B still zero in {still_zero[:5]}")
        adapters = {"adapter_params": sum(f["a"].numel() + f["b"].numel()
                                          for f in factors.values())}
        log(f"[train {tag}] LoRA rank 16 on q, k, v, o of {2 * cfg.num_layers} attentions: "
            f"{adapters['adapter_params'] / 1e6:.2f} M adapter params trained, every B off zero; "
            "the base is bit for bit the seeded init")
    step_s = statistics.median(out["step_seconds"][1:])
    log(f"[train {tag}] Wan2.1-1.3B, {n_mhla} MHLA + {cfg.num_layers - n_mhla} softmax layers "
        f"({n_sparse} radial-sparse), "
        f"{out['params'] / 1e6:.1f} M float32 params, bf16 compute, remat, B=1 x "
        f"{math.prod(VIDEO_GRID)} tokens: losses {[round(x, 4) for x in losses]}; grad norms "
        f"{[round(x, 3) for x in norms]}")
    log(f"[train {tag}] step {step_s:.3f} s (median of steps 2-{VIDEO_TRAIN_STEPS}, host clock; "
        f"step 1 {out['step_seconds'][0]:.3f} s) = {1 / step_s:.3f} videos/s; peak device "
        f"memory {peak_gb:.1f} GB; checkpoint {out['checkpoint_bytes'] / 1e9:.1f} GB saved in "
        f"{out['save_seconds']:.1f} s")
    return {"launches": counts, "step_s": step_s, "videos_s": 1 / step_s, "peak_gb": peak_gb,
            "losses": losses, "grad_norms": norms, "save_s": out["save_seconds"],
            "checkpoint_gb": out["checkpoint_bytes"] / 1e9, **adapters}


# The image harnesses at their configs' widths, seeded init, synthetic data:
# DiT-S/2 (configs/dit_s2.yaml: hidden 384, depth 12, 6 heads, patch 2, 32 x
# 32 x 4 latents = 256 tokens in blocks of 16, batch 256) and DeiT-small MHLA
# (configs/deit_small_mhla.yaml: 384 wide, 12 blocks, 6 heads, 256 px, patches
# of 16 in pieces of 4, batch 512). Both run MHLA2D's plain blockwise op, as
# JAX runs its jnp einsums: they launch no kernel.
IMAGE_TRAIN_STEPS = 6
VIT_BATCH = 512  # the config's batch
FID_SAMPLES, FID_STEPS, FID_CFG = 32, 10, 1.5
CONFIGS = Path(__file__).resolve().parent / "configs"


def check_no_launches(tag: str) -> None:
    from mhla_tpu_torch import kernels

    launched = {k_: v_ for k_, v_ in kernels.launch_counts().items() if v_}
    if launched:
        raise AssertionError(f"{tag} launched kernels {launched}: its attention is the plain op")


def image_train_summary(tag: str, out: dict, batch: int, peak_gb: float) -> dict:
    losses, secs = out["losses"], out["step_seconds"]
    if len(losses) != IMAGE_TRAIN_STEPS or not all(map(math.isfinite, losses)):
        raise AssertionError(f"{tag} losses {losses}")
    step_s = statistics.median(secs[1:])
    log(f"[{tag}] {out['params'] / 1e6:.1f} M float32 params, bf16 compute, batch {batch}: "
        f"losses {[round(x, 4) for x in losses]}; step {step_s * 1e3:.1f} ms (median of steps "
        f"2-{IMAGE_TRAIN_STEPS}, host clock; step 1 {secs[0]:.2f} s) = {batch / step_s:.1f} "
        f"images/s; peak device memory {peak_gb:.1f} GB")
    return {"losses": losses, "step_ms": step_s * 1e3, "images_s": batch / step_s,
            "peak_gb": peak_gb}


def phase_train_dit(dev: torch.device, work: str) -> dict:
    """(w) ``dit_train.main configs/dit_s2.yaml`` for IMAGE_TRAIN_STEPS steps;
    every trainable mixing matrix must lie in [0, 1] after them."""
    from mhla_tpu_torch import kernels
    from mhla_tpu_torch.train import dit_train

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    out = dit_train.main([str(CONFIGS / "dit_s2.yaml"), f"--device={dev.type}",
                          f"--work_dir={work}", f"--train.max_steps={IMAGE_TRAIN_STEPS}",
                          "--train.log_interval=1"])
    torch.cuda.synchronize()
    check_no_launches("DiT training")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    model = out["model"]
    cfg = model.cfg
    if (cfg.hidden_size, cfg.depth, cfg.num_heads, cfg.patch_size, cfg.input_size,
            cfg.block_size, cfg.dtype) != (384, 12, 6, 2, 32, 16, torch.bfloat16):
        raise AssertionError(f"not DiT-S/2 at configs/dit_s2.yaml's widths: {cfg}")
    mix = [p.detach() for n, p in model.named_parameters() if n.endswith("piece_attn.weight")]
    lo, hi = min(float(p.min()) for p in mix), max(float(p.max()) for p in mix)
    moved = sum(not torch.equal(p, mix[0]) for p in mix)
    log(f"[train dit] {len(mix)} trainable 16 x 16 mixing matrices within [{lo:.4f}, {hi:.4f}] "
        f"after {IMAGE_TRAIN_STEPS} steps ({moved} differ from block 0's)")
    if len(mix) != cfg.depth or lo < 0.0 or hi > 1.0:
        raise AssertionError(f"mixing matrices outside [0, 1]: {lo}, {hi}")
    return image_train_summary("train dit", out, 256, peak_gb)


def phase_fid(dev: torch.device, work: str) -> dict:
    """(x) ``fid_cli.main`` on (w)'s checkpoint: FID_SAMPLES CFG samples of
    FID_STEPS respaced ancestral steps into the latent-space npz."""
    from mhla_tpu_torch import kernels
    from mhla_tpu_torch.eval import fid_cli

    kernels.reset_launch_counts()
    out = fid_cli.main([f"--device={dev.type}", f"--ckpt={work}",
                        f"--num_samples={FID_SAMPLES}", f"--batch_size={FID_SAMPLES}",
                        f"--num_sampling_steps={FID_STEPS}", f"--cfg_scale={FID_CFG}",
                        f"--out={work}/fid/samples.npz"])
    check_no_launches("DiT sampling")
    arr = np.load(out["npz"])["arr_0"]
    step_s = out["sample_seconds"] / FID_STEPS
    log(f"[fid] DiT-S/2 EMA weights of (w), {FID_SAMPLES} samples (CFG {FID_CFG}, batch "
        f"{2 * FID_SAMPLES} with the null half), {FID_STEPS} steps: {step_s:.3f} s per sampling "
        f"step (host clock, packing included); npz {arr.shape} {arr.dtype}, mean {arr.mean():.1f}")
    if arr.shape != (FID_SAMPLES, 32, 32, 4) or arr.dtype != np.uint8 or arr.std() == 0:
        raise AssertionError(f"sample npz {arr.shape} {arr.dtype}")
    return {"s_per_step": step_s, "shape": list(arr.shape), "dtype": str(arr.dtype)}


def phase_train_vit(dev: torch.device, work: str) -> dict:
    """(y) ``vit_train.main configs/deit_small_mhla.yaml`` for
    IMAGE_TRAIN_STEPS steps with mixup / cutmix and a validation of the live
    and the EMA weights after the last."""
    from mhla_tpu_torch import kernels
    from mhla_tpu_torch.train import vit_train

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    out = vit_train.main([str(CONFIGS / "deit_small_mhla.yaml"), f"--device={dev.type}",
                          f"--work_dir={work}", f"--train.max_steps={IMAGE_TRAIN_STEPS}",
                          f"--train.eval_interval={IMAGE_TRAIN_STEPS}",
                          f"--train.batch_size={VIT_BATCH}", "--train.log_interval=1"])
    torch.cuda.synchronize()
    check_no_launches("ViT training")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    cfg = out["model"].cfg
    if (cfg.embed_dim, cfg.depth, cfg.num_heads, cfg.img_size, cfg.patch_size, cfg.piece_size,
            cfg.attn_type, cfg.dtype) != (384, 12, 6, 256, 16, 4, "mhla", torch.bfloat16):
        raise AssertionError(f"not DeiT-small MHLA at its config's widths: {cfg}")
    log(f"[train vit] DeiT-small MHLA, batch {VIT_BATCH} (the config's 512), mixup / cutmix on: "
        f"validation top-1 {out['val_acc']:.4f}, EMA {out['val_acc_ema']:.4f} (8 synthetic "
        f"batches)")
    return {**image_train_summary("train vit", out, VIT_BATCH, peak_gb),
            "val_acc": out["val_acc"], "val_acc_ema": out["val_acc_ema"]}


def phase_image_harnesses(dev: torch.device) -> dict:
    with tempfile.TemporaryDirectory(prefix="mhla_dit_") as work:
        dit = phase_train_dit(dev, work)
        fid = phase_fid(dev, work)
    with tempfile.TemporaryDirectory(prefix="mhla_vit_") as work:
        vit = phase_train_vit(dev, work)
    return {"train_dit": dit, "fid": fid, "train_vit": vit}


def phase_train_video_lepe(dev: torch.device, full: dict) -> dict:
    """(z) One ``MHLA3D(is_lepe=True)`` layer's gradients through the kernels
    against the plain versions at 31,500 tokens, then the full-MHLA model,
    cut to LEPE_LAYERS of its 30 layers, with the LePE convolution trained
    through ``wan_train.main``: the launches of (g), ``full``, scaled to
    that depth (the convolution is one PyTorch call outside the island)."""
    from mhla_tpu_torch.layers import MHLA3D
    from mhla_tpu_torch.ops.rotary import rope_tables_flat

    f = VIDEO_HEADS * VIDEO_HEAD_DIM
    tables = rope_tables_flat(VIDEO_GRID, VIDEO_HEAD_DIM, device=dev)
    check_layer_grads(dev, "MHLA3D(is_lepe=True)",
                      MHLA3D(f, VIDEO_HEADS, VIDEO_LAYOUT, normalize_out=False, is_lepe=True,
                             device=dev), (VIDEO_GRID, tables))
    del tables
    out = phase_train_video(dev, "full + LePE", range(LEPE_LAYERS), lepe=True, layers=LEPE_LAYERS)
    scaled = {name: n * LEPE_LAYERS // VIDEO_TRAIN_LAYERS for name, n in full["launches"].items()}
    if out["launches"] != scaled:
        raise AssertionError(f"LePE changed the launches: {out['launches']} vs {scaled}")
    log(f"[train full + LePE] {LEPE_LAYERS} of 30 layers: launches (g)'s scaled to that depth; "
        f"step {out['step_s']:.3f} s ((g), {VIDEO_TRAIN_LAYERS} layers without LePE: "
        f"{full['step_s']:.3f} s)")
    return out


def phase_distill(dev: torch.device) -> dict:
    """(ah) teacher distillation from tar shards through ``wan_train.main``:
    a teacher checkpoint of the full-MHLA model at DISTILL_LAYERS layers
    (seed 1, no step), two tar shards of seeded latents and text
    embeddings, then VIDEO_TRAIN_STEPS steps of the same configuration with
    ``distill.enable``. The student launches what (z)'s training does; the
    teacher adds one forward a step."""
    from mhla_tpu_torch import kernels
    from mhla_tpu_torch.data import write_tar_shard
    from mhla_tpu_torch.train import wan_train

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    common = [f"--device={dev.type}", f"--model.num_layers={DISTILL_LAYERS}",
              f"--model.linear_attn_idx={tuple(range(DISTILL_LAYERS))}".replace(" ", ""),
              "--optimizer.warmup_steps=1", "--train.log_interval=1"]
    with tempfile.TemporaryDirectory(prefix="mhla_distill_") as work:
        t0 = time.perf_counter()
        teacher = wan_train.main(common + [f"--work_dir={work}/teacher", "--train.max_steps=0",
                                           "--train.seed=1"])
        teacher_s = time.perf_counter() - t0
        teacher_gb = teacher.pop("checkpoint_bytes") / 1e9
        del teacher
        torch.cuda.empty_cache()
        # two shards of two clips: latents (21, 60, 100, 16), text embeddings [512, 4096]
        rng = np.random.default_rng(SEED + 40)
        Path(f"{work}/latents").mkdir()
        t0 = time.perf_counter()
        for s in range(2):
            write_tar_shard(f"{work}/latents/part-{s:04d}.tar", [
                {"__key__": f"clip_{s}_{i}",
                 "latent.npy": rng.standard_normal(VIDEO_LATENT, dtype=np.float32),
                 "text_emb.npy": 0.02 * rng.standard_normal((VIDEO_TEXT_LEN, 4096),
                                                            dtype=np.float32)}
                for i in range(2)])
        shards_s = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        out = wan_train.main(common + [
            f"--work_dir={work}/student", f"--train.max_steps={VIDEO_TRAIN_STEPS}",
            f"--data.latent_dir={work}/latents", "--distill.enable=true",
            f"--distill.teacher_ckpt={work}/teacher"])
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
    cfg = out["model"].cfg
    if (cfg.num_layers, cfg.dim, cfg.remat, cfg.dtype, len(cfg.linear_attn_idx)) != (
            DISTILL_LAYERS, 1536, True, torch.bfloat16, DISTILL_LAYERS):
        raise AssertionError(f"not the full-MHLA model at {DISTILL_LAYERS} layers: {cfg}")
    want = video_train_launches(DISTILL_LAYERS, 0)
    for name, per in VIDEO_KERNELS.items():  # the teacher's forward, once a step
        want[name] += VIDEO_TRAIN_STEPS * DISTILL_LAYERS * per
    log(f"[distill] launches in {VIDEO_TRAIN_STEPS} steps: {counts}")
    got = {name: counts[name] for name in want}
    if got != want:
        raise AssertionError(f"launches of the distillation path {got}, expected {want}")
    losses, logit, attn = out["losses"], out["distill_logit"], out["distill_attn"]
    if len(losses) != VIDEO_TRAIN_STEPS or not all(
            math.isfinite(v) for v in losses + logit + attn):
        raise AssertionError(f"losses {losses}, distill_logit {logit}, distill_attn {attn}")
    if not (min(logit) > 0 and min(attn) > 0):
        raise AssertionError(f"the teacher equals the student: {logit}, {attn}")
    step_s = statistics.median(out["step_seconds"][1:])
    phase_s = time.perf_counter() - t_phase
    log(f"[distill] Wan2.1-1.3B full MHLA at {DISTILL_LAYERS} of 30 layers, B=1 x "
        f"{math.prod(VIDEO_GRID)} tokens from 2 tar shards ({shards_s:.1f} s to write), the "
        f"teacher a {teacher_gb:.1f} GB checkpoint of seed 1 ({teacher_s:.1f} s to build and save): "
        f"losses {[round(x, 4) for x in losses]}, distill_logit {[round(x, 5) for x in logit]}, "
        f"distill_attn {[round(x, 5) for x in attn]}")
    log(f"[distill] step {step_s:.3f} s (median of steps 2-{VIDEO_TRAIN_STEPS}, host clock; step "
        f"1 {out['step_seconds'][0]:.3f} s); peak device memory {peak_gb:.1f} GB; phase "
        f"{phase_s:.1f} s")
    return {"launches": counts, "step_s": step_s, "peak_gb": peak_gb, "losses": losses,
            "distill_logit": logit, "distill_attn": attn, "teacher_checkpoint_gb": teacher_gb,
            "teacher_s": teacher_s, "seconds": phase_s}


def main() -> None:
    smi = phase_device()
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_build(dev)
    log_time("build")
    kern = phase_kernels(dev)
    serve = phase_serve(dev)
    kern.update(phase_grads(dev))
    train = phase_train(dev)
    log_time("340M LM")
    kern.update(phase_kernels_packed(dev))
    serve_hybrid = phase_serve_hybrid(dev)
    train_packed = phase_train_hybrid(dev)
    train_unpacked = phase_train_hybrid(dev, varlen=False, steps=2)
    log_time("hybrid LM")
    kern.update(phase_kernels_long(dev))
    with tempfile.TemporaryDirectory(prefix="mhla_ppl_") as work:
        ppl, long_model = phase_ppl(dev, work)
    serve_long = phase_serve_long(dev, long_model)
    del long_model
    train_long = phase_train_long(dev, "train long", LONG_POSITIONS, 1, LONG_TRAIN_SEQ,
                                  LONG_TRAIN_STEPS, varlen=False)
    train_d256_packed = phase_train_long(dev, "train d256 packed", TRAIN_SEQ, TRAIN_BATCH,
                                         TRAIN_SEQ, LONG_TRAIN_STEPS, varlen=True)
    log_time("long context")
    long_phases = {"ppl": ppl, "train_long": train_long, "train_d256_packed": train_d256_packed}
    kern.update(phase_kernels_delta(dev))
    serve_gdn = phase_serve_baseline(dev, "gated_deltanet", "gdn")
    train_gdn = phase_train_baseline(dev, "gated_deltanet", "gdn")
    log_time("Gated DeltaNet LM")
    kern.update(phase_kernels_gla(dev))
    serve_gla = phase_serve_baseline(dev, "gla", "gla")
    train_gla = phase_train_baseline(dev, "gla", "gla")
    train_simple_gla = phase_train_baseline(dev, "simple_gla", "simple_gla", steps=2)
    log_time("GLA LM")
    kern.update(phase_kernels_mamba2(dev))
    serve_mamba2 = phase_serve_baseline(dev, "mamba2", "mamba2")
    train_mamba2 = phase_train_baseline(dev, "mamba2", "mamba2")
    log_time("Mamba2 LM")
    serve_mamba = phase_serve_baseline(dev, "mamba", "mamba", both_requests=False)
    train_mamba = phase_train_baseline(dev, "mamba", "mamba", steps=3, layers=MAMBA_TRAIN_LAYERS)
    log_time("Mamba LM")
    serve_linear = phase_serve_baseline(dev, "linear_attn", "linear_attn")
    train_linear = phase_train_baseline(dev, "linear_attn", "linear_attn", steps=3)
    log_time("linear-attention LM")
    options = phase_lm_options(dev)
    log_time("MHLA LM options")
    kern.update(phase_kernels_video(dev))
    video = phase_video(dev)
    kern.update(phase_kernels_hybrid(dev))
    hybrid, hybrid_model = phase_video_hybrid(dev)
    sparse = phase_video_sparse(dev, hybrid_model)
    del hybrid_model
    log_time("video sampling")
    t2v = phase_t2v(dev)
    log_time("text to video")
    kern.update(phase_kernels_i2v(dev))
    i2v = phase_i2v(dev)
    log_time("image to video")
    kern.update(phase_kernels_video_train(dev))
    train_full = phase_train_video(dev, "full", range(VIDEO_TRAIN_LAYERS), layers=VIDEO_TRAIN_LAYERS)
    train_hybrid = phase_train_video(dev, "hybrid", VIDEO_TRAIN_LINEAR, layers=VIDEO_TRAIN_LAYERS)
    log_time("video training (full, hybrid)")
    train_lepe = phase_train_video_lepe(dev, train_full)
    log_time("video training (full + LePE)")
    distill = phase_distill(dev)
    log_time("video distillation from tar shards")
    kern.update(phase_kernels_sparse_train(dev))
    train_sparse = phase_train_video(dev, "hybrid_sparse", VIDEO_TRAIN_LINEAR,
                                     VIDEO_TRAIN_SOFTMAX, layers=VIDEO_TRAIN_LAYERS)
    train_lora = phase_train_video(dev, "hybrid_sparse + LoRA", VIDEO_TRAIN_LINEAR,
                                   VIDEO_TRAIN_SOFTMAX, lora=True, layers=VIDEO_TRAIN_LAYERS)
    log_time("video training (sparse, LoRA)")
    image = phase_image_harnesses(dev)
    log_time("image harnesses (DiT-S/2 training and sampling, DeiT-small training)")
    # each kernel's launches on the path that brought it in; K9's on the hybrid
    # sampling path and K9b's on the hybrid training path, which run them at
    # both of their shapes; K10b's on the hybrid_sparse training path
    launches = {**{n: serve["launches"][n] for n in FWD_KERNELS},
                **{n: train["launches"][n] for n in BWD_KERNELS},
                **{n: video["launches"][n] for n in VIDEO_KERNELS},
                "flash_attention": hybrid["launches"]["flash_attention"],
                "radial_flash_attention": sparse["launches"]["radial_flash_attention"],
                "flash_attention[tk257]": i2v["k9_image_launches"],
                **{n: train_full["launches"][n] for n in VIDEO_BWD_KERNELS},
                "flash_attention_bwd": train_hybrid["launches"]["flash_attention_bwd"],
                "radial_flash_attention_bwd":
                    train_sparse["launches"]["radial_flash_attention_bwd"],
                **{form: train_packed["launches"][counter]
                   for form, counter in PACKED_FORMS.items()},
                "flash_attention[causal]": serve_hybrid["launches"]["flash_attention[causal]"],
                "flash_attention_bwd[causal]":
                    train_unpacked["launches"]["flash_attention_masked_bwd"],
                "delta_chunk_fwd": serve_gdn["launches"]["delta_chunk_fwd"],
                "delta_chunk_bwd": train_gdn["launches"]["delta_chunk_bwd"],
                "gla_chunk_fwd": serve_gla["launches"]["gla_chunk_fwd"],
                "gla_chunk_bwd": train_gla["launches"]["gla_chunk_bwd"],
                "gla_chunk_fwd_scalar": serve_mamba2["launches"]["gla_chunk_fwd_scalar"],
                "gla_chunk_bwd_scalar": train_mamba2["launches"]["gla_chunk_bwd_scalar"],
                **{form: long_phases[phase]["launches"][counter]
                   for form, (phase, counter) in LONG_FORMS.items()}}
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    kernels_line = [
        {"name": name, "route": route, "source": source, "replaces": replaces,
         "launches": launches[name], **{key: kern[name][key] for key in keys}}
        for name, (route, source, replaces) in KERNEL_META.items()
    ]
    for phase in (train, video, hybrid, sparse, t2v, i2v, distill, train_full, train_hybrid, train_sparse,
                  train_lora, train_lepe, serve_hybrid, train_packed, train_unpacked, serve_gdn, train_gdn,
                  serve_gla, train_gla, train_simple_gla, ppl, serve_long, train_long,
                  train_d256_packed, serve_mamba2, train_mamba2, serve_mamba, train_mamba,
                  serve_linear, train_linear):
        phase.pop("launches")
    log(json.dumps({"serve": serve["rates"], "train": train,
                    "serve_hybrid_lm": serve_hybrid["rates"], "train_hybrid_lm_packed": train_packed,
                    "train_hybrid_lm": train_unpacked, "tile_walks": kern["walks"],
                    "ppl_long": ppl, "serve_long": serve_long, "train_long": train_long,
                    "train_hybrid_d256_packed": train_d256_packed,
                    "tile_walks_d256": kern["walks_d256"], "mix_wide": kern["mix_wide_times"],
                    "mix_n32": kern["mix_n32_times"], "k2b_long": kern["k2b_long"],
                    "k2_times": kern["k2_times"], "k2_yardsticks": kern["k2_yardsticks"],
                    "k4_train": kern["k4_train"],
                    "host_at_a": kern["host_at_a"], "host_device": HOST_DEVICE,
                    "flash_d256_times": kern["flash_d256_times"], "vs_earlier_kernels": REDESIGN_TIMES,
                    "flash_d256_unmasked": {name: kern[name] for name in (
                        "flash_attention[d256]", "flash_attention_bwd[d256]")},
                    "serve_gdn": serve_gdn["rates"], "train_gdn": train_gdn,
                    "gla_kernel_forms": kern["gla_shapes"], "serve_gla": serve_gla["rates"],
                    "train_gla": train_gla, "train_simple_gla": train_simple_gla,
                    "serve_mamba2": serve_mamba2["rates"], "train_mamba2": train_mamba2,
                    "serve_mamba": serve_mamba["rates"], "train_mamba": train_mamba,
                    "serve_linear_attn": serve_linear["rates"], "train_linear_attn": train_linear,
                    "mamba2_shared_qk_bounds": kern["mamba2_shared_qk_bounds"],
                    "lm_options": options,
                    "video": video, "hybrid": hybrid, "text_to_video": t2v,
                    "image_to_video": i2v, "distillation": distill,
                    "hybrid_sparse": sparse, "train_video_full": train_full,
                    "train_video_hybrid": train_hybrid,
                    "train_video_hybrid_sparse": train_sparse,
                    "train_video_hybrid_sparse_lora": train_lora,
                    "train_video_full_lepe": train_lepe, **image,
                    "sparse_train_kernels": {name: kern[name] for name in (
                        "radial_flash_attention[lse]", "radial_flash_attention_bwd")},
                    "k10_walks": K10_WALKS, "k10b_walks": kern["k10b_walks"],
                    "k6_training_shape": kern["mix_states_dense[M^T]"],
                    "k7_training_shape": kern["block_readout[B=1]"],
                    "card": smi}))
    log(json.dumps({"kernels": kernels_line}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    sys.exit(main())
