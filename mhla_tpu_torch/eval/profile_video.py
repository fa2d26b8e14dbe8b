"""Profile one model call of the video sampler on one CUDA device.

    python -m mhla_tpu_torch.eval.profile_video [--config=full|hybrid|hybrid_sparse] [--t=500]

Builds Wan2.1-1.3B as ``video_infer_cli.main`` builds it (float32
parameters from a seeded init, bf16 compute) in one of three forms: ``full``
(the CLI's default: all 30 layers MHLA), ``hybrid`` (layers 0, 3, ..., 27
dense softmax, the other 20 MHLA) or ``hybrid_sparse`` (those ten layers
radial-sparse: below ``--t=850`` they run K10, from there on dense
attention). It runs the call a denoising step makes: one forward of the CFG
batch (2 x 31,500 tokens against 512 text tokens) at timestep ``--t``. After a warm-up call it
times ``CALLS`` calls on the host clock (each ending in a device sync) and
records one more under ``torch.profiler``. Prints the time per call, the
device's busy share of the profiled call and the device time by kernel
group and by kernel. Needs a CUDA device; there is no CPU mode.
"""

from __future__ import annotations

import argparse
import re
import statistics
import time
from collections import defaultdict

import torch

from ..train.profile_step import _union_us
from .video_infer_cli import VideoInferConfig, _build_model

CALLS, TOP = 3, 25
SOFTMAX_LAYERS = tuple(range(0, 30, 3))  # configs/wan_1300m_hybrid_mhla.yaml
HYBRID_LINEAR_IDX = tuple(i for i in range(30) if i not in SOFTMAX_LAYERS)

_GROUPS = (
    ("K5/K8 island in and out (Triton)", r"_island_fwd|_unisland_fwd"),
    ("K6/K7 dense mix and readout (CUDA)", r"mix_dense_kernel|readout_kernel"),
    ("K9 flash attention (CUDA)", r"flash_fwd_kernel"),
    ("K10 radial flash attention (CUDA)", r"radial_fwd_kernel"),
    ("GEMM (cuBLAS)", r"gemm|gemv|cutlass|xmma|nvjet|cublas|sm90_"),
    ("reductions", r"reduce|norm_kernel|softmax"),
)


def _group(name: str) -> str:
    for label, pattern in _GROUPS:
        if re.search(pattern, name):
            return label
    return "elementwise and copies"


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--config", choices=("full", "hybrid", "hybrid_sparse"), default="full")
    parser.add_argument("--t", type=float, default=500.0, help="timestep (flow time x 1000)")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_video: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = VideoInferConfig()
    if args.config != "full":
        cfg.linear_attn_idx = HYBRID_LINEAR_IDX
    dev = torch.device(cfg.device)
    # the CLI has no field for the sparse layers, as in the JAX package
    sparse = {"sparse_attn_idx": SOFTMAX_LAYERS} if args.config == "hybrid_sparse" else {}
    model = _build_model(cfg, dev, **sparse)
    mcfg = model.cfg
    gen = torch.Generator(dev).manual_seed(1)
    x = torch.randn(2, *cfg.sampling.latent_shape, generator=gen, device=dev)
    ctx = torch.randn(2, mcfg.text_len, mcfg.text_dim, generator=gen, device=dev)
    t = torch.full((2,), args.t, device=dev)

    def call():
        with torch.no_grad():
            model(x, t, ctx)
        torch.cuda.synchronize()

    call()
    times = []
    for _ in range(CALLS):
        t0 = time.perf_counter()
        call()
        times.append(time.perf_counter() - t0)
    call_s = statistics.median(times)

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        call()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name, by_group = defaultdict(float), defaultdict(float)
    counts = defaultdict(int)
    for e in kernels:
        us = e.time_range.elapsed_us()
        by_name[e.name] += us
        by_group[_group(e.name)] += us
        counts[e.name] += 1
    kernel_us = sum(by_name.values())
    busy_us = _union_us((e.time_range.start, e.time_range.end) for e in kernels)
    print(f"[profile] {torch.cuda.get_device_name(0)}; {args.config} at t = {args.t:g}: "
          f"{mcfg.num_layers} layers, CFG batch 2 x "
          f"{x[0, ..., 0].numel() // 4} tokens: forward {call_s * 1e3:.1f} ms (median of "
          f"{CALLS}; {[round(s * 1e3, 1) for s in times]})")
    print(f"[profile] profiled call: wall {wall_us / 1e3:.1f} ms, device kernels "
          f"{kernel_us / 1e3:.1f} ms in {len(kernels)} launches, busy "
          f"{busy_us / 1e3:.1f} ms = {busy_us / wall_us:.1%} of wall")
    for label, us in sorted(by_group.items(), key=lambda kv: -kv[1]):
        print(f"[profile] group {label:36s} {us / 1e3:9.2f} ms  {us / kernel_us:6.1%}")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]:
        print(f"[profile] {us / 1e3:9.3f} ms  {counts[name]:5d}x  {name[:110]}")
    return {"forward_ms": call_s * 1e3, "busy": busy_us / wall_us, "kernel_ms": kernel_us / 1e3,
            "groups_ms": {k: v / 1e3 for k, v in by_group.items()}}


if __name__ == "__main__":
    main()
