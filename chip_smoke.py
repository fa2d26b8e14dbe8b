#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one or more lines each; a failure in any phase raises and the run
exits non-zero:

1. device  — the card's name and power limit (nvidia-smi), torch and CUDA.
2. build   — K2-K4 from mhla_tpu_torch/csrc (nvcc) and K1 (Triton).
3. kernels — each kernel against its plain PyTorch version on the card at
             the 340M serving shapes in bf16, with both times (CUDA events,
             median after warm-up).
4. serve   — the 340M MHLA LM (MHLALMConfig() defaults, bf16, weights from
             a seeded init) serves two requests through ``generate``:
             4 x 1984 prompt + 64 greedy tokens (fills the 2048 context)
             and 1 x 781 + 32. Checks finite logits, that every kernel
             launched, and chunk == recurrent: the decode-step logits match
             one full forward over prompt + generated tokens.

The last two lines are a JSON object with every kernel's numbers and
``{"ok": true, "device": {...}}``. Needs a CUDA device; there is no CPU mode.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
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
}


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


def phase_kernels(dev: torch.device) -> dict:
    """Each kernel against its plain version at the serving shapes."""
    from mhla_tpu_torch.kernels import fmap_rope, mhla_chunk
    from mhla_tpu_torch.ops import rotary_cos_sin
    from mhla_tpu_torch.ops.mhla_chunk import init_causal_mixing_matrix
    from mhla_tpu_torch.utils import get_abs_err, get_err_ratio

    h, dk, dv, c = 4, 128, 256, 64
    bf16 = torch.bfloat16
    gen = torch.Generator(dev).manual_seed(SEED)
    randn = lambda *s: torch.randn(*s, generator=gen, device=dev)  # noqa: E731
    cos, sin = rotary_cos_sin(2048, dk, device=dev)
    results = {name: {"max_abs_err": 0.0} for name in KERNEL_META}

    def check(name, shape_tag, kern, plain, timed):
        out_k, out_p = kern(), plain()
        torch.cuda.synchronize()
        rel, err = get_err_ratio(out_p, out_k), get_abs_err(out_p, out_k)
        if not (torch.isfinite(out_k.float()).all() and rel < KERNEL_TOL):
            raise AssertionError(
                f"{name} {shape_tag}: rel-RMS {rel:.3e} (tol {KERNEL_TOL}) max|d| {err:.3e}")
        r = results[name]
        r["max_abs_err"] = max(r["max_abs_err"], err)
        msg = (f"[kernels] {name:13s} {shape_tag:18s} rel-RMS {rel:.2e} (tol {KERNEL_TOL}) "
               f"max|d| {err:.2e}")
        if timed:
            ms, plain_ms = median_ms(kern), median_ms(plain)
            r.update(ms=ms, plain_ms=plain_ms)
            msg += f"  kernel {ms:.4f} ms  plain {plain_ms:.4f} ms"
        log(msg)

    for b, t, timed in ((4, 2048, True), (1, 781, False)):
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
    if not all(counts[name] > 0 for name in KERNEL_META):
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


def main() -> None:
    smi = phase_device()
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_build(dev)
    kern = phase_kernels(dev)
    serve = phase_serve(dev)
    kernels_line = [
        {
            "name": name,
            "route": route,
            "source": source,
            "replaces": replaces,
            "launches": serve["launches"][name],
            "max_abs_err": kern[name]["max_abs_err"],
            "ms": kern[name]["ms"],
            "plain_ms": kern[name]["plain_ms"],
        }
        for name, (route, source, replaces) in KERNEL_META.items()
    ]
    log(json.dumps({"serve": serve["rates"], "card": smi}))
    log(json.dumps({"kernels": kernels_line}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    sys.exit(main())
