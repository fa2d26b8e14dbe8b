"""Time K2b and the wide K3 / K3b (``kernels/mhla_chunk.py``) at the shapes
PERF.md lists, beside one PyTorch call of the same function, on the card;
with ``steps``, also the training steps of ``chip_smoke.py``'s phases (c),
(l), (u) and (v) as that tree's own ``chip_smoke.py`` runs them.

It imports ``mhla_tpu_torch`` and ``chip_smoke`` from the current directory,
so the same file times another checkout too, such as a parent tree unpacked
under the gitignored ``work_dirs/``:

    python3 mhla_tpu_torch/eval/time_chunk_bwd.py change [steps]
    (cd work_dirs/parent && python3 ../../mhla_tpu_torch/eval/time_chunk_bwd.py parent [steps])

Each form prints one line: the tag, the form and a JSON object of times in
ms (CUDA events, the median of 7 timings of 10 back-to-back calls, as
``chip_smoke.py`` times them, so the host's cost of enqueueing the first call
weighs little); each step
phase the median step time of its steps after the first. Compare two trees
inside one run, in turns (parent, change, change, parent).
"""

from __future__ import annotations

import json
import os
import statistics
import sys

# K2b: (batch, tokens) at 4 heads of Dk 128, Dv 256, chunk 64: (c)'s
# training rows and (u)'s long-context row
K2B_SHAPES = [(8, 2048), (1, 16384)]
# the wide K3 / K3b: chunk slots N at one batch row of 4 x 128 x 256 states
WIDE_SLOTS = [64, 256, 448, 512]
# K3b at N = 32 (batch, per-row M): the 32-slot kernel or the one of every N
N32_FORMS = [(8, False), (8, True)]


def median_ms(fn, reps: int = 7, inner: int = 10, warmup: int = 2) -> float:
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


def time_k2b(mc, tag: str, b: int, t: int) -> None:
    import torch

    h, dk, dv, c = 4, 128, 256, 64
    n = t // c
    dev, bf16 = torch.device("cuda"), torch.bfloat16
    gen = torch.Generator(dev).manual_seed(0)
    rnd = lambda *s: torch.randn(*s, generator=gen, device=dev).to(bf16)  # noqa: E731
    k4, dk_i = rnd(b, n, c, h * dk), rnd(b, n, c, h * dk)
    v4, dv_i = rnd(b, n, c, h * dv), rnd(b, n, c, h * dv)
    ds4 = rnd(b, n, h * dk, dv)
    k5, v5, ds5 = k4.view(b, n, c, h, dk), v4.view(b, n, c, h, dv), ds4.view(b, n, h, dk, dv)
    dki5, dvi5 = dk_i.view(b, n, c, h, dk), dv_i.view(b, n, c, h, dv)
    r = {"ms": median_ms(lambda: mc.chunk_states_bwd(k4, v4, ds4, dk_i, dv_i, h)),
         "library_ms": median_ms(lambda: (
             torch.einsum("bnchv,bnhkv->bnchk", v5, ds5).add_(dki5),
             torch.einsum("bnchk,bnhkv->bnchv", k5, ds5).add_(dvi5)))}
    print(tag, f"K2b B={b} T={t}", json.dumps(r), flush=True)


def wide_inputs(b: int, n: int, per_row: bool):
    import torch

    dev, bf16 = torch.device("cuda"), torch.bfloat16
    gen = torch.Generator(dev).manual_seed(1)
    shape = (b, n, n) if per_row else (n, n)
    m = torch.rand(*shape, generator=gen, device=dev)
    m_strict = torch.tril(m * 128**-0.5, -1).to(bf16).float().contiguous()
    states4, dmixed4 = (torch.randn(b, n, 512, 256, generator=gen, device=dev).to(bf16)
                        for _ in range(2))
    return m_strict, states4, dmixed4


def time_wide(mc, tag: str, n: int) -> None:
    import torch

    m_strict, states4, dmixed4 = wide_inputs(1, n, False)
    m_bf, r_ = m_strict.to(torch.bfloat16), 512 * 256
    s2, d2 = states4.view(n, r_), dmixed4.view(n, r_)
    r = {"K3_ms": median_ms(lambda: mc.mix_states(m_strict, states4)),
         "K3_library_ms": median_ms(lambda: torch.matmul(m_bf, s2)),
         "K3b_ms": median_ms(lambda: mc.mix_states_bwd(m_strict, dmixed4, states4)),
         "K3b_library_ms": median_ms(lambda: (torch.matmul(m_bf.T, d2),
                                              torch.matmul(d2, s2.T)))}
    print(tag, f"wide N={n}", json.dumps(r), flush=True)


def time_n32(mc, tag: str, b: int, per_row: bool) -> None:
    """K3b at N = 32, through whichever kernel the tree routes it to, and
    the wide K3 there (not routed: the 32-slot K3 runs at N <= 32)."""
    m_strict, states4, dmixed4 = wide_inputs(b, 32, per_row)
    r = {"K3b_ms": median_ms(lambda: mc.mix_states_bwd(m_strict, dmixed4, states4)),
         "K3_wide_ms": median_ms(lambda: mc._mix_states_wide(m_strict, states4))}
    print(tag, f"N=32 B={b} {'per-row' if per_row else 'shared'} M", json.dumps(r), flush=True)


def time_steps(chip_smoke, tag: str) -> None:
    """The tree's own training phases: (c) 340M at B=8 T=2048, (l) the
    hybrid on packed rows, (u) the long-context hybrid at B=1 T=16,384, (v)
    its heads at a 2,048 context on packed rows."""
    import torch

    dev = torch.device("cuda")
    cs = chip_smoke
    runs = {
        "(c)": lambda: cs.phase_train(dev),
        "(l)": lambda: cs.phase_train_hybrid(dev),
        "(u)": lambda: cs.phase_train_long(dev, "train long", cs.LONG_POSITIONS, 1,
                                           cs.LONG_TRAIN_SEQ, cs.LONG_TRAIN_STEPS, varlen=False),
        "(v)": lambda: cs.phase_train_long(dev, "train d256 packed", cs.TRAIN_SEQ,
                                           cs.TRAIN_BATCH, cs.TRAIN_SEQ, cs.LONG_TRAIN_STEPS,
                                           varlen=True),
    }
    for name, run in runs.items():
        out = run()
        print(tag, f"step {name}", json.dumps({"step_ms": out["step_ms"]}), flush=True)
        torch.cuda.empty_cache()


def main(argv) -> None:
    sys.path.insert(0, os.getcwd())  # the checkout being timed
    import torch

    import chip_smoke
    from mhla_tpu_torch.kernels import mhla_chunk as mc

    if not torch.cuda.is_available():
        raise SystemExit("time_chunk_bwd.py: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    tag = argv[1] if len(argv) > 1 else "tree"
    print(tag, torch.cuda.get_device_name(0), flush=True)
    for b, t in K2B_SHAPES:
        time_k2b(mc, tag, b, t)
    for n in WIDE_SLOTS:
        time_wide(mc, tag, n)
        torch.cuda.empty_cache()
    for b, per_row in N32_FORMS:
        time_n32(mc, tag, b, per_row)
    if "steps" in argv[2:]:
        time_steps(chip_smoke, tag)


if __name__ == "__main__":
    main(sys.argv)
