"""Profile training steps of the causal MHLA LM on one CUDA device.

    python -m mhla_tpu_torch.train.profile_step [--config=mhla|hybrid|gated_deltanet|gla|simple_gla]
        [--varlen]

Builds what ``lm_train.main`` trains by default (the 340M model,
``MHLALMConfig()`` widths, float32 parameters, bf16 compute, seeded init,
B=8 T=2048 synthetic tokens) through ``lm_train.build_training``; with
``--config=hybrid`` the same model with causal softmax attention (8 heads of
128) in every third layer from 0 (``HYBRID_ATTN``); with
``--config=gated_deltanet`` the Gated DeltaNet LM at the same widths
(``attn_extends='gated_deltanet'``: 4 heads, Dk 128, Dv 256, K11 / K11b in
every layer); with ``--config=gla`` the GLA LM at the same widths
(``attn_extends='gla'``: 4 heads, Dk 128, Dv 256, K12 / K12b in every layer)
and with ``--config=simple_gla`` its one-decay-per-head form; and with
``--varlen`` (not with gated_deltanet or the GLA forms)
packed documents with segment ids (``--train.varlen=true``). It runs
warm-up steps, then times ``STEPS`` steps on the host clock (each ending in
a device sync) and records one more under ``torch.profiler``. Prints the
step time, tokens per second, the device's busy share of that step (the
union of its kernels' intervals over the step's wall time) and the device
time by kernel group and by kernel. Needs a CUDA device; there is no CPU
mode.
"""

from __future__ import annotations

import argparse
import re
import statistics
import time
from collections import defaultdict

import torch

from ..models import MHLALMConfig
from .lm_train import LMTrainConfig, TrainLoopConfig, build_training, to_device
from .trainer import OptimizerConfig

WARMUP, STEPS, TOP = 3, 5, 25
# the hybrid 340M model: the Wan hybrid schedule (softmax in every third layer
# from 0, configs/wan_1300m_hybrid_mhla.yaml) on the 24 layers, 8 heads of 128
HYBRID_ATTN = {"layers": list(range(0, 24, 3)), "num_heads": 8}

_GROUPS = (
    ("K11/K11b delta rule (CUDA)", r"delta_(prep|fwd_chain|bwd_chain|bwd_grads)"),
    ("K12/K12b GLA (CUDA)", r"chunk_outer_kernel|chain_kernel|readout_kernel|grads_kernel"),
    ("K9 flash forward (CUDA)", r"flash_fwd_kernel|seg_tile_ranges"),
    ("K9b flash backward (CUDA)", r"flash_bwd_"),
    ("K1/K1b fmap_rope (Triton)", r"_fmap_rope"),
    ("K2-K4 chunk forward (CUDA)", r"chunk_states_kernel|mix_states_kernel|chunk_output_kernel"),
    ("K2b-K4b chunk backward (CUDA)", r"_bwd_kernel"),
    ("GEMM (cuBLAS)", r"gemm|gemv|cutlass|xmma|nvjet|cublas|sm90_"),
    ("optimizer (foreach)", r"multi_tensor|foreach"),
    ("reductions", r"reduce|norm_kernel|softmax|logsumexp"),
)


def _union_us(intervals) -> float:
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


def summarize_profile(prof, wall_us: float, groups, what: str = "step", top: int = TOP) -> dict:
    """Print the device side of one profiled window of ``wall_us`` host
    microseconds: kernel time and launches, the busy share (the union of the
    kernels' intervals over the wall time), the time by kernel group
    (``groups``: (label, regex on the kernel's name) pairs, first match wins,
    the rest is elementwise work and copies) and the ``top`` kernels.
    Returns ``busy``, ``kernel_ms`` and ``groups_ms``."""
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name, by_group = defaultdict(float), defaultdict(float)
    counts = defaultdict(int)
    for e in kernels:
        us = e.time_range.elapsed_us()
        label = next((g for g, pattern in groups if re.search(pattern, e.name)),
                     "elementwise and copies")
        by_name[e.name] += us
        by_group[label] += us
        counts[e.name] += 1
    kernel_us = sum(by_name.values())
    busy_us = _union_us((e.time_range.start, e.time_range.end) for e in kernels)
    print(f"[profile] profiled {what}: wall {wall_us / 1e3:.1f} ms, device kernels "
          f"{kernel_us / 1e3:.1f} ms in {len(kernels)} launches, busy "
          f"{busy_us / 1e3:.1f} ms = {busy_us / wall_us:.1%} of wall")
    for label, us in sorted(by_group.items(), key=lambda kv: -kv[1]):
        print(f"[profile] group {label:44s} {us / 1e3:9.2f} ms  {us / kernel_us:6.1%}")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]:
        print(f"[profile] {us / 1e3:9.3f} ms  {counts[name]:5d}x  {name[:110]}")
    return {"busy": busy_us / wall_us, "kernel_ms": kernel_us / 1e3,
            "groups_ms": {k: v / 1e3 for k, v in by_group.items()}}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", choices=("mhla", "hybrid", "gated_deltanet", "gla", "simple_gla"),
                    default="mhla")
    ap.add_argument("--varlen", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_step: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    model = MHLALMConfig(
        attn=HYBRID_ATTN if args.config == "hybrid" else None,
        attn_extends="mhla" if args.config in ("mhla", "hybrid") else args.config,
    )
    cfg = LMTrainConfig(model=model,
                        optimizer=OptimizerConfig(warmup_steps=1, total_steps=20000),
                        train=TrainLoopConfig(varlen=args.varlen))
    _, state, step, data = build_training(cfg)
    dev = torch.device(cfg.device)
    batches = [to_device(next(data), dev) for _ in range(WARMUP + STEPS + 1)]
    for b in batches[:WARMUP]:
        state, metrics = step(state, b)
    torch.cuda.synchronize()
    times = []
    for b in batches[WARMUP: WARMUP + STEPS]:
        t0 = time.perf_counter()
        state, metrics = step(state, b)
        float(metrics["loss"])
        times.append(time.perf_counter() - t0)
    step_s = statistics.median(times)

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        state, metrics = step(state, batches[-1])
        float(metrics["loss"])
        wall_us = (time.perf_counter() - t0) * 1e6
    b, t, layers = cfg.train.batch_size, cfg.train.seq_len, cfg.model.num_hidden_layers
    tokens = b * t
    print(f"[profile] {torch.cuda.get_device_name(0)}; {args.config}"
          f"{' varlen' if args.varlen else ''}, {layers} layers, B={b} T={t}: step {step_s * 1e3:.1f} ms (median of {STEPS}; "
          f"{[round(t * 1e3, 1) for t in times]}) = {tokens / step_s:,.0f} tok/s")
    return {"step_ms": step_s * 1e3, "tok_s": tokens / step_s,
            **summarize_profile(prof, wall_us, _GROUPS)}


if __name__ == "__main__":
    main()
