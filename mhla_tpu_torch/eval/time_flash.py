"""Time K9 / K9b (``kernels/flash_attention.py``) at the shapes PERF.md
lists, beside the library's flash or memory-efficient SDPA call (forward,
and its backward through autograd), on the card.

It imports ``mhla_tpu_torch`` and ``chip_smoke`` (for the packed segment
ids) from the current directory, so the same file times another checkout
too, such as a parent tree unpacked under the gitignored ``work_dirs/``:

    python3 mhla_tpu_torch/eval/time_flash.py change
    (cd work_dirs/parent && python3 ../../mhla_tpu_torch/eval/time_flash.py parent)

Each form prints one line: the tag, the form and a JSON object of times in
ms (CUDA events, the median of 7 timings of 3 back-to-back calls). Compare
two trees inside one run, in turns (parent, change, change, parent).
"""

from __future__ import annotations

import json
import os
import statistics
import sys

# (name, B, Tq, Tk, heads, head dim, causal, packed segment ids, backward too)
FORMS = [
    ("cross [2, 31500 x 512, 12, 128]", 2, 31500, 512, 12, 128, False, False, True),
    ("self [2, 31500, 12, 128]", 2, 31500, 31500, 12, 128, False, False, False),
    ("self [1, 31500, 12, 128]", 1, 31500, 31500, 12, 128, False, False, True),
    ("cross [1, 31500 x 512, 12, 128]", 1, 31500, 512, 12, 128, False, False, True),
    ("causal [8, 2048, 8, 128]", 8, 2048, 2048, 8, 128, True, False, True),
    ("causal+segment [8, 2048, 8, 128]", 8, 2048, 2048, 8, 128, True, True, True),
    ("d256 [8, 2048, 4, 256]", 8, 2048, 2048, 4, 256, False, False, True),
    ("causal d256 [8, 2048, 4, 256]", 8, 2048, 2048, 4, 256, True, False, True),
    ("causal+segment d256 [8, 2048, 4, 256]", 8, 2048, 2048, 4, 256, True, True, True),
    ("causal d256 [1, 16384, 4, 256]", 1, 16384, 16384, 4, 256, True, False, True),
    ("causal d256 [1, 28672, 4, 256]", 1, 28672, 28672, 4, 256, True, False, False),
]


def median_ms(fn, reps: int = 7, inner: int = 3, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def time_form(flash, chip_smoke, tag, name, b, tq, tk, h, d, causal, packed, bwd) -> dict:
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    dev, bf16 = torch.device("cuda"), torch.bfloat16
    gen = torch.Generator(dev).manual_seed(0)
    q, do = (torch.randn(b, tq, h, d, generator=gen, device=dev).to(bf16) for _ in range(2))
    k, v = (torch.randn(b, tk, h, d, generator=gen, device=dev).to(bf16) for _ in range(2))
    seg = chip_smoke.packed_segment_ids(dev, b, tq) if packed else None
    r = {"fwd_ms": median_ms(lambda: flash.flash_attention(q, k, v, causal=causal,
                                                           segment_ids=seg))}
    o, lse = flash._flash_fwd(q, k, v, None, True, causal, seg)
    if bwd:
        r["bwd_ms"] = median_ms(lambda: flash.flash_attention_bwd(q, k, v, o, lse, do, None,
                                                                  causal, seg))
    keep = None
    if seg is not None:
        ar = torch.arange(tq, device=dev)
        keep = ((seg[:, :, None] == seg[:, None, :]) & (ar[:, None] >= ar[None, :]))[:, None]
    qt, kt, vt = (x.detach().transpose(1, 2).requires_grad_(bwd) for x in (q, k, v))
    with sdpa_kernel([SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION]):
        r["sdpa_fwd_ms"] = median_ms(lambda: F.scaled_dot_product_attention(
            qt.detach(), kt.detach(), vt.detach(), attn_mask=keep,
            is_causal=causal and keep is None))
        if bwd:
            out = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=keep,
                                                 is_causal=causal and keep is None)
            dot = do.transpose(1, 2)
            r["sdpa_bwd_ms"] = median_ms(lambda: torch.autograd.grad(out, (qt, kt, vt), dot,
                                                                     retain_graph=True))
    print(tag, name, json.dumps(r), flush=True)
    return r


def main(argv) -> None:
    sys.path.insert(0, os.getcwd())  # the checkout being timed
    import torch

    import chip_smoke
    from mhla_tpu_torch.kernels import flash_attention as flash

    if not torch.cuda.is_available():
        raise SystemExit("time_flash.py: no CUDA device")
    tag = argv[1] if len(argv) > 1 else "tree"
    print(tag, torch.cuda.get_device_name(0), flush=True)
    for form in FORMS:
        time_form(flash, chip_smoke, tag, *form)
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main(sys.argv)
