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
             after warm-up) and at the training shape B=8 T=2048, bf16.
4. serve   — the 340M MHLA LM (MHLALMConfig() defaults, bf16, weights from
             a seeded init) serves two requests through ``generate``:
             4 x 1984 prompt + 64 greedy tokens (fills the 2048 context)
             and 1 x 781 + 32. Checks finite logits, that every forward
             kernel launched, and chunk == recurrent: the decode-step logits
             match one full forward over prompt + generated tokens.
5. grads   — each backward kernel (K1b-K4b) against its plain version at
             the training shape B=8 T=2048 (timed) and at B=1 T=781 (the
             ragged last chunk), bf16; then the gradients of fmap+RoPE and
             the chunk op through the kernels against autograd of the
             plain definitions on the same CUDA tensors, at both shapes.
6. train   — ``mhla_tpu_torch.train.lm_train.main`` trains the 340M model
             6 steps at B=8 T=2048 (float32 parameters, bf16 compute,
             AdamW at 3e-4 after a 1-step warm-up). Checks finite, falling
             loss, that every backward kernel launched, that the mixing
             matrices stay tril in [1e-5, 1] and got a non-zero gradient;
             prints step time, tok/s and the checkpoint's save time.
7. kernels (video) — K5-K9 against their plain versions at the shapes of
             the Wan2.1-1.3B sampler: CFG batch 2, 31,500 tokens in 150
             blocks of 210, cross-attention against 512 text tokens.
8. video   — ``mhla_tpu_torch.eval.video_infer_cli.main`` samples 4
             DPM-Solver++ steps with CFG 5.0 of the 30-layer full-MHLA
             model at latents (21, 60, 100, 16). Checks finite latents, the
             exact launch counts of K5-K9 and one forward through the
             kernels against the same forward through their plain versions.
9. kernels (hybrid) — K10 (radial flash attention) against its plain
             version at [2, 31,500, 12, 128] in 21 frames and at a small
             ragged geometry, and K9 at Tq = Tk = 31,500; each beside its
             bound and one ``scaled_dot_product_attention`` call.
10. video (hybrid) — the CLI samples the hybrid model (layers 0, 3, ..., 27
             dense softmax on K9, the other 20 MHLA), 4 steps: finite
             latents, exact launch counts.
11. video (hybrid_sparse) — ``sample_video_latents`` on the same weights
             with those ten layers radial-sparse, 4 steps at t x 1000 =
             1000, 900, 750, 501: K10 launches in the two steps below the
             dense guard (850) and K9 takes its place in the two above.
             Checks the exact launch counts, the forward at t = 501 through
             the kernels against the plain versions, and that the guarded
             forward at t = 900 equals the hybrid model's.

The last two lines are a JSON object with every kernel's numbers and
``{"ok": true, "device": {...}}``. Needs a CUDA device; there is no CPU mode.
"""

from __future__ import annotations

import contextlib
import json
import math
import statistics
import subprocess
import sys
import tempfile
import time
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
# Relative-RMS tolerance of decode-step logits against one full chunked
# forward, bf16: the chunked path rounds the chunk states, the mixed states
# and the masked scores to bf16 (as the JAX op does) while the recurrent
# path keeps its state in float32, and the differences pass through 24
# layers of a bf16 residual stream. The same comparison of this model on
# the CPU's plain paths gives 3.1e-2 in bf16 and 3.7e-6 in float32, so
# 3e-2 is the bf16 floor; a wrong slot, position or mixing row gives O(1).
SERVE_TOL = 5e-2
# Relative-RMS tolerance of the op's gradients (dx_q, dx_k, dv, dM) through
# the kernels against autograd of the plain definitions (fmap_rope_plain,
# ops.mhla_chunk), bf16: the two round at different points (the plain op
# rounds the scaled q and its own autograd rounds nothing in the backward,
# the kernel path folds the scale into M and rounds dA, dmixed, dS and the
# intra terms to bf16 as the JAX backward does). The same comparison on the
# CPU's plain paths, at both shapes of phase 5 (B=8 T=2048, B=1 T=781) and
# two seeds, gives at most 5.2e-3 (dx_k; dx_q 4.8e-3, dv 4.2e-3, dM 3.3e-3):
# that is the bf16 floor, and the tolerance leaves 2x for the card's other
# summation orders and atomics. A dropped term, a wrong transpose or a missing mask gives O(1).
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

SEED = 0
PROMPT_A, NEW_A, BATCH_A = 1984, 64, 4
PROMPT_B, NEW_B, BATCH_B = 781, 32, 1

KERNEL_META = {
    "fmap_rope": ("triton", "mhla_tpu_torch/kernels/fmap_rope.py",
                  "mhla_tpu/kernels/fmap_rope_pallas.py:66"),
    "chunk_states": ("cuda", "mhla_tpu_torch/csrc/mhla_chunk.cu",
                     "mhla_tpu/kernels/mhla_chunk_pallas.py:101"),
    "mix_states": ("cuda", "mhla_tpu_torch/csrc/mhla_chunk.cu",
                   "mhla_tpu/kernels/mhla_chunk_pallas.py:293"),
    "chunk_output": ("cuda", "mhla_tpu_torch/csrc/mhla_chunk.cu",
                     "mhla_tpu/kernels/mhla_chunk_pallas.py:589"),
    "fmap_rope_bwd": ("triton", "mhla_tpu_torch/kernels/fmap_rope.py",
                      "mhla_tpu/kernels/fmap_rope_pallas.py:72"),
    "chunk_output_bwd": ("cuda", "mhla_tpu_torch/csrc/mhla_chunk_bwd.cu",
                         "mhla_tpu/kernels/mhla_chunk_pallas.py:623"),
    "mix_states_bwd": ("cuda", "mhla_tpu_torch/csrc/mhla_chunk_bwd.cu",
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
    "radial_flash_attention": ("cuda", "mhla_tpu_torch/csrc/radial_fwd.cu",
                               "mhla_tpu/kernels/sparse_attention.py:312"),
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
DENSE_FROM_T, STEPS_BELOW_GUARD = 850.0, 2
T_SPARSE, T_GUARDED = 501.0, 900.0  # two of the sampler's timesteps, one on each side


def video_launches(mhla_layers: int, k9_per_step, k10_per_step) -> dict:
    """Launches of K5-K10 in VIDEO_STEPS steps: ``k9_per_step`` and
    ``k10_per_step`` are the per-step counts, one entry per step."""
    want = {name: VIDEO_STEPS * mhla_layers * per for name, per in VIDEO_KERNELS.items()}
    want["flash_attention"] = sum(k9_per_step)
    want["radial_flash_attention"] = sum(k10_per_step)
    return want


def log(msg: str) -> None:
    print(msg, flush=True)


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
# the tensor cores 989 TFLOP/s, float32 outside them 67 TFLOP/s.
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}


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
        msg += (f"  kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  bound {r['bound_ms']:.4f} ms "
                f"({r['bound_by']})")
        if library is not None:
            msg += f"  library {r['library_ms']:.4f} ms"
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
    return results


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
    for dt, suffix, timed in ((f32, "", True), (bf16, "[bf16]", True)):
        st, qq, mx = states.to(dt), q4.to(dt), mixed.to(dt)
        check("mix_states_dense" + suffix, f"{str(dt)[6:]} N={n}",
              lambda: mhla_block.mix_states_dense(m, st),
              lambda: mhla_block.mix_states_dense_plain(m, st), timed,
              work=(nbytes(m) + 2 * nbytes(st), 2 * n * n * b * f * dh, dt),
              library=lambda: torch.matmul(m.to(dt), st.view(b, n, f * dh)))
        check("block_readout" + suffix, f"{str(dt)[6:]} C={c}",
              lambda: mhla_block.block_readout(qq, mx, h),
              lambda: mhla_block.block_readout_plain(qq, mx, h), timed,
              work=(2 * nbytes(qq) + nbytes(mx), 2 * b * n * c * h * dh * dh, dt),
              library=lambda: torch.einsum("bnchk,bnhkv->bnchv", qq.unflatten(-1, (h, dh)),
                                           mx.unflatten(-2, (h, dh))))
        del st, qq, mx
    del states, mixed

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

    # 5 frames of 100 tokens: tiles that straddle frames, a ragged last tile
    qs, ks, vs = (randn(b, 500, 3, dh).to(bf16) for _ in range(3))
    check("radial_flash_attention", "T=500 5 frames",
          lambda: sparse.radial_flash_attention(qs, ks, vs, 5),
          lambda: sparse.radial_flash_attention_plain(qs, ks, vs, 5), False, tol=FLASH_TOL)

    q, k, v = (randn(b, t, h, dh).to(bf16) for _ in range(3))
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    t0 = time.perf_counter()
    offsets, tiles, full = sparse.radial_schedule(t, frames)
    t_sched = time.perf_counter() - t0
    pairs = sparse.radial_allowed_pairs(t, frames)
    log(f"[kernels] radial mask at {frames} frames of {t // frames}: {pairs / t**2:.4f} of the "
        f"pairs allowed; schedule of 64 x 64 tiles: {len(tiles)} of {(len(offsets) - 1)**2} tiles "
        f"= {len(tiles) / (len(offsets) - 1)**2:.4f}, {full.mean():.4f} of them full, "
        f"{np.diff(offsets).min()} to {np.diff(offsets).max()} per query tile; built on the "
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
        check("mix_states_bwd", tag,
              lambda: mhla_chunk.mix_states_bwd(m_strict, dmixed4, states4),
              lambda: mhla_chunk.mix_states_bwd_plain(m_strict, dmixed4, states4), timed,
              (2 * nbytes(m_strict) + 3 * nbytes(states4), 4 * pairs * b * h * dk * dv, bf16))
        check("chunk_states_bwd", tag,
              lambda: mhla_chunk.chunk_states_bwd(k4, v4, dstates4, dk_i, dv_i, h),
              lambda: mhla_chunk.chunk_states_bwd_plain(k4, v4, dstates4, dk_i, dv_i, h),
              timed,
              (3 * nbytes(k4, v4) + nbytes(dstates4), 4 * b * n * c * h * dk * dv, bf16))

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
    n_mix = 0
    for name, p in out["model"].named_parameters():
        if name.endswith("mixing_matrix"):
            n_mix += 1
            low = p[torch.tril(torch.ones_like(p, dtype=torch.bool))]
            if torch.count_nonzero(torch.triu(p, 1)) or low.min() < 1e-5 or low.max() > 1:
                raise AssertionError(f"{name} left tril [1e-5, 1] after the steps")
            if p.grad is None or not torch.count_nonzero(p.grad):
                raise AssertionError(f"{name} got no gradient")
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


def plain_kernels(only=None):
    """Context in which the video model's wrappers K5-K10 (or those named in
    ``only``) run their plain PyTorch versions on whatever device their
    tensors lie."""
    from mhla_tpu_torch.kernels import flash_attention as flash
    from mhla_tpu_torch.kernels import mhla_block, sparse_attention
    from mhla_tpu_torch.layers import attention, mhla_vision

    stack = contextlib.ExitStack()
    for module, name, plain in (
        (mhla_vision, "blockify_island", mhla_block.blockify_island_plain),
        (mhla_vision, "unblockify_island", mhla_block.unblockify_island_plain),
        (mhla_block, "mix_states_dense", mhla_block.mix_states_dense_plain),
        (mhla_block, "block_readout", mhla_block.block_readout_plain),
        (attention, "flash_attention", flash.flash_attention_plain),
        (sparse_attention, "radial_flash_attention",
         sparse_attention.radial_flash_attention_plain),
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


def main() -> None:
    smi = phase_device()
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_build(dev)
    kern = phase_kernels(dev)
    serve = phase_serve(dev)
    kern.update(phase_grads(dev))
    train = phase_train(dev)
    kern.update(phase_kernels_video(dev))
    video = phase_video(dev)
    kern.update(phase_kernels_hybrid(dev))
    hybrid, hybrid_model = phase_video_hybrid(dev)
    sparse = phase_video_sparse(dev, hybrid_model)
    del hybrid_model
    # each kernel's launches on the path that brought it in; K9's on the hybrid
    # path, which runs it at both of its shapes
    launches = {**{n: serve["launches"][n] for n in FWD_KERNELS},
                **{n: train["launches"][n] for n in BWD_KERNELS},
                **{n: video["launches"][n] for n in VIDEO_KERNELS},
                "flash_attention": hybrid["launches"]["flash_attention"],
                "radial_flash_attention": sparse["launches"]["radial_flash_attention"]}
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    kernels_line = [
        {"name": name, "route": route, "source": source, "replaces": replaces,
         "launches": launches[name], **{key: kern[name][key] for key in keys}}
        for name, (route, source, replaces) in KERNEL_META.items()
    ]
    for phase in (train, video, hybrid, sparse):
        phase.pop("launches")
    log(json.dumps({"serve": serve["rates"], "train": train, "video": video, "hybrid": hybrid,
                    "hybrid_sparse": sparse, "card": smi}))
    log(json.dumps({"kernels": kernels_line}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    sys.exit(main())
