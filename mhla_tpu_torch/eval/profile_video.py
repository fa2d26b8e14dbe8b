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
import statistics
import time

import torch

from ..train.profile_step import summarize_profile
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
    print(f"[profile] {torch.cuda.get_device_name(0)}; {args.config} at t = {args.t:g}: "
          f"{mcfg.num_layers} layers, CFG batch 2 x "
          f"{x[0, ..., 0].numel() // 4} tokens: forward {call_s * 1e3:.1f} ms (median of "
          f"{CALLS}; {[round(s * 1e3, 1) for s in times]})")
    return {"forward_ms": call_s * 1e3, **summarize_profile(prof, wall_us, _GROUPS, "call")}


if __name__ == "__main__":
    main()
