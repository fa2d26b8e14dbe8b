#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one or more lines each; a failure in any phase raises and the run
exits non-zero:

1. device  — the card's name and power limit (nvidia-smi), torch and CUDA.
2. build   — K2-K4 from mhla_tpu_torch/csrc (nvcc) and K1 (Triton).
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

The last two lines are a JSON object with every kernel's numbers and
``{"ok": true, "device": {...}}``. Needs a CUDA device; there is no CPU mode.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import tempfile
import time

import torch

# Relative-RMS tolerance of a kernel against its plain version, both in
# bf16 on the card: both accumulate in float32 and round once to bf16 at
# the same points, so only the order of the float32 sums differs. That can
# flip a rounding by one bf16 ulp on a few elements; a half ulp is
# 2^-9 = 1.95e-3 relative, so an RMS above it is no longer rounding.
KERNEL_TOL = 2e-3
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
}
FWD_KERNELS = ("fmap_rope", "chunk_states", "mix_states", "chunk_output")
BWD_KERNELS = ("fmap_rope_bwd", "chunk_output_bwd", "mix_states_bwd", "chunk_states_bwd")
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ = 6, 8, 2048


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


def check_kernel(results: dict, name: str, shape_tag: str, kern, plain, timed: bool) -> None:
    """Run ``kern`` and ``plain`` once, hold every output of the kernel
    against the plain version's (relative RMS below KERNEL_TOL), and time
    both when ``timed``."""
    from mhla_tpu_torch.utils import get_abs_err, get_err_ratio

    outs_k, outs_p = _as_tuple(kern()), _as_tuple(plain())
    torch.cuda.synchronize()
    rel = max(get_err_ratio(p, k) for p, k in zip(outs_p, outs_k))
    err = max(get_abs_err(p, k) for p, k in zip(outs_p, outs_k))
    finite = all(torch.isfinite(k.float()).all() for k in outs_k)
    if not (finite and rel < KERNEL_TOL):
        raise AssertionError(
            f"{name} {shape_tag}: rel-RMS {rel:.3e} (tol {KERNEL_TOL}) max|d| {err:.3e}")
    r = results.setdefault(name, {"max_abs_err": 0.0})
    r["max_abs_err"] = max(r["max_abs_err"], err)
    msg = (f"[kernels] {name:16s} {shape_tag:18s} rel-RMS {rel:.2e} (tol {KERNEL_TOL}) "
           f"max|d| {err:.2e}")
    if timed:
        ms, plain_ms = median_ms(kern), median_ms(plain)
        r.update(ms=ms, plain_ms=plain_ms)
        msg += f"  kernel {ms:.4f} ms  plain {plain_ms:.4f} ms"
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
              lambda: fmap_rope.fmap_rope_plain(x, cos, sin, h, "relu"), timed)
        n = -(-t // c)
        tp = n * c

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
        check("chunk_states", tag, lambda: mhla_chunk.chunk_states(k4, v4, h),
              lambda: mhla_chunk.chunk_states_plain(k4, v4, h), timed)
        check("mix_states", tag, lambda: mhla_chunk.mix_states(m_strict, states4),
              lambda: mhla_chunk.mix_states_plain(m_strict, states4), timed)
        check("chunk_output", tag,
              lambda: mhla_chunk.chunk_output(q4, k4, v4, mixed4, m_diag, h),
              lambda: mhla_chunk.chunk_output_plain(q4, k4, v4, mixed4, m_diag, h), timed)

    x1 = randn(4, 1, h * dk).to(bf16)
    check("fmap_rope", "B=4 T=1 offset=1984",
          lambda: fmap_rope.fused_fmap_rope_flat(x1, cos, sin, h, "relu", offset=1984),
          lambda: fmap_rope.fmap_rope_plain(x1, cos, sin, h, "relu", offset=1984), False)
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
              lambda: fmap_rope.fmap_rope_bwd_plain(dy, x, cos, sin, h, "relu"), timed)
        n = -(-t // c)

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
              timed)
        check("mix_states_bwd", tag,
              lambda: mhla_chunk.mix_states_bwd(m_strict, dmixed4, states4),
              lambda: mhla_chunk.mix_states_bwd_plain(m_strict, dmixed4, states4), timed)
        check("chunk_states_bwd", tag,
              lambda: mhla_chunk.chunk_states_bwd(k4, v4, dstates4, dk_i, dv_i, h),
              lambda: mhla_chunk.chunk_states_bwd_plain(k4, v4, dstates4, dk_i, dv_i, h),
              timed)

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
    launches = {**{n: serve["launches"][n] for n in FWD_KERNELS},
                **{n: train["launches"][n] for n in BWD_KERNELS}}
    kernels_line = [
        {
            "name": name,
            "route": route,
            "source": source,
            "replaces": replaces,
            "launches": launches[name],
            "max_abs_err": kern[name]["max_abs_err"],
            "ms": kern[name]["ms"],
            "plain_ms": kern[name]["plain_ms"],
        }
        for name, (route, source, replaces) in KERNEL_META.items()
    ]
    train.pop("launches")
    log(json.dumps({"serve": serve["rates"], "train": train, "card": smi}))
    log(json.dumps({"kernels": kernels_line}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    sys.exit(main())
