"""Profile training steps of the Wan video model on one CUDA device.

    python -m mhla_tpu_torch.train.profile_wan_step [--config=full|hybrid|hybrid_sparse] [--lora]

Builds what ``wan_train.main`` trains (Wan2.1-1.3B, float32 parameters from
a seeded init, bf16 compute, per-block remat, AdamW with EMA, one synthetic
video of 31,500 tokens per step) through ``wan_train.build_training``, in its
``full`` form (all 30 layers MHLA), its ``hybrid`` form (the entry point's
default: layers 0, 3, ..., 27 softmax) or ``hybrid_sparse`` (those ten layers
under the radial mask, ``model.sparse_attn_idx``); ``--lora`` freezes the
model and trains adapters (``lora.enable``). It runs a warm-up step, times
``STEPS`` steps on the host clock (each ending in the loss's device-to-host
copy) and records one more under ``torch.profiler``. Prints the step time,
videos per second, peak device memory, the device's busy share of the
profiled step and the device time by kernel group and by kernel. Needs a
CUDA device; there is no CPU mode.
"""

from __future__ import annotations

import argparse
import statistics
import time

import torch

from .profile_step import summarize_profile
from .wan_train import WanTrainConfig, build_training

WARMUP, STEPS, TOP = 1, 3, 30

_GROUPS = (
    ("K5/K8 island in and out (Triton)", r"_island_fwd|_unisland_fwd"),
    ("K5b/K8b unblockify and blockify (Triton)", r"_permute_rope"),
    ("K6 dense mix, forward and transposed (CUDA)", r"mix_dense_kernel"),
    ("K7 readout (CUDA)", r"readout_kernel"),
    ("K7b readout backward (CUDA)", r"readout_bwd_kernel"),
    ("K9 flash attention (CUDA)", r"flash_fwd_kernel"),
    ("K10 radial flash attention (CUDA)", r"radial_fwd_kernel"),
    ("K10b radial flash attention backward (CUDA)", r"radial_bwd_"),
    ("delta pass of K9b and K10b (CUDA)", r"flash_bwd_delta"),
    ("K9b flash attention backward (CUDA)", r"flash_bwd_"),
    ("GEMM (cuBLAS)", r"gemm|gemv|cutlass|xmma|nvjet|cublas|sm90_"),
    ("optimizer and EMA (foreach)", r"multi_tensor|foreach"),
    ("reductions", r"reduce|norm_kernel|softmax"),
)


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--config", choices=("full", "hybrid", "hybrid_sparse"), default="full")
    parser.add_argument("--lora", action="store_true")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_wan_step: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = WanTrainConfig()
    cfg.optimizer.warmup_steps = 1  # the profiled steps move the parameters
    if args.config == "full":
        cfg.model.linear_attn_idx = tuple(range(30))
    elif args.config == "hybrid_sparse":
        cfg.model.sparse_attn_idx = tuple(range(0, 30, 3))
    cfg.lora.enable = args.lora
    model, state, step, data = build_training(cfg)
    dev = torch.device(cfg.device)

    def batch():
        z, c = next(data)
        return torch.from_numpy(z).to(dev), torch.from_numpy(c).to(dev)

    torch.cuda.reset_peak_memory_stats()
    for _ in range(WARMUP):
        state, metrics = step(state, batch())
    torch.cuda.synchronize()
    times = []
    for _ in range(STEPS):
        b = batch()
        t0 = time.perf_counter()
        state, metrics = step(state, b)
        float(metrics["loss"])
        times.append(time.perf_counter() - t0)
    step_s = statistics.median(times)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    b = batch()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        state, metrics = step(state, b)
        float(metrics["loss"])
        wall_us = (time.perf_counter() - t0) * 1e6
    mc = model.cfg
    print(f"[profile] {torch.cuda.get_device_name(0)}; {args.config}{' + LoRA' if args.lora else ''}: "
          f"{mc.num_layers} layers ({len(mc.linear_attn_idx or ())} MHLA, "
          f"{len(mc.sparse_attn_idx or ())} radial-sparse), B={cfg.train.batch_size}, remat: step "
          f"{step_s * 1e3:.1f} ms (median of {STEPS}; {[round(t * 1e3, 1) for t in times]}) = "
          f"{cfg.train.batch_size / step_s:.3f} videos/s; peak device memory {peak_gb:.1f} GB")
    return {"step_ms": step_s * 1e3, "videos_s": cfg.train.batch_size / step_s,
            "peak_gb": peak_gb, **summarize_profile(prof, wall_us, _GROUPS)}


if __name__ == "__main__":
    main()
