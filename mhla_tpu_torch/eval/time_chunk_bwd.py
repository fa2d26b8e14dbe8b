"""Time K2 / K2b and K3 / K3b (``kernels/mhla_chunk.py``) at the shapes
PERF.md lists, beside one PyTorch call of the same function, on the card;
with ``steps``, also (a)'s prefill of 4 x 1,984 tokens, one 28,672-token
block of (s)'s evaluation and the training steps of ``chip_smoke.py``'s
phases (c), (l), (u) and (v) as that tree's own ``chip_smoke.py`` runs them.

It imports ``mhla_tpu_torch`` and ``chip_smoke`` from the current directory,
so the same file times another checkout too, such as a parent tree unpacked
under the gitignored ``work_dirs/``:

    python3 mhla_tpu_torch/eval/time_chunk_bwd.py change [steps | steps=a,l]
    (cd work_dirs/parent && python3 ../../mhla_tpu_torch/eval/time_chunk_bwd.py parent [steps])

``steps=a,l`` times those steps alone (letters of a, s, c, l, u, v). Each
form prints one line: the tag, the form and a JSON object of times in ms
(CUDA events, the median of 7 timings of 10 back-to-back calls, as
``chip_smoke.py`` times them, so the host's cost of enqueueing the first call
weighs little); each step phase the median step time of its steps after the
first (the prefill and the block: of 5 and 3 runs after one warm-up, host
clock to a sync; the prefill also the card's time alone, host-bound as it
is). Compare two trees inside one run, in turns (parent, change, change,
parent).
"""

from __future__ import annotations

import json
import os
import statistics
import sys
import time

# K2 and K2b: (batch, tokens) at 4 heads of Dk 128, Dv 256, chunk 64: (a)'s
# prefill rows (K2), (c)'s training rows and (u)'s long-context row
K2_SHAPES = [(4, 1984), (4, 2048), (8, 2048), (1, 16384)]
K2B_SHAPES = [(8, 2048), (1, 16384)]
# the wide K3 / K3b: chunk slots N at one batch row of 4 x 128 x 256 states
WIDE_SLOTS = [64, 256, 448, 512]
# K3 and K3b at N = 32 (batch, per-row M): serving 4 x 2048, training 8 x 2048
N32_FORMS = [(4, False), (8, False), (8, True)]


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


def time_k2(mc, tag: str, b: int, t: int) -> None:
    import torch

    h, dk, dv, c = 4, 128, 256, 64
    n = -(-t // c)
    dev, bf16 = torch.device("cuda"), torch.bfloat16
    gen = torch.Generator(dev).manual_seed(0)
    k4 = torch.randn(b, n, c, h * dk, generator=gen, device=dev).to(bf16)
    v4 = torch.randn(b, n, c, h * dv, generator=gen, device=dev).to(bf16)
    k5, v5 = k4.view(b, n, c, h, dk), v4.view(b, n, c, h, dv)
    r = {"ms": median_ms(lambda: mc.chunk_states(k4, v4, h)),
         "library_ms": median_ms(lambda: torch.einsum("bnchk,bnchv->bnhkv", k5, v5))}
    print(tag, f"K2 B={b} T={t}", json.dumps(r), flush=True)


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
    """K3 and K3b at N = 32, through whichever kernels the tree routes them
    to, beside the einsum of K3's form of M."""
    import torch

    m_strict, states4, dmixed4 = wide_inputs(b, 32, per_row)
    m_bf = m_strict.to(torch.bfloat16)
    eq = "bij,bjrd->bird" if per_row else "ij,bjrd->bird"
    r = {"K3_ms": median_ms(lambda: mc.mix_states(m_strict, states4)),
         "K3_library_ms": median_ms(lambda: torch.einsum(eq, m_bf, states4)),
         "K3b_ms": median_ms(lambda: mc.mix_states_bwd(m_strict, dmixed4, states4))}
    print(tag, f"N=32 B={b} {'per-row' if per_row else 'shared'} M", json.dumps(r), flush=True)


def host_median_s(fn, reps: int) -> float:
    """Median host-clock seconds of ``fn()`` to a sync, after one warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def card_ms(fn, reps: int) -> float:
    """The card's median ms for ``fn()``: CUDA events around it, enqueued
    behind a sleep kernel long enough for the host to enqueue all of it, so
    the host's pace does not count (a prefill is host-bound)."""
    import torch

    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(200_000_000)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def time_prefill(chip_smoke, tag: str) -> None:
    """(a)'s prefill: one cache-building forward of the 340M model (bf16,
    seeded init) over 4 x 1,984 tokens under ``torch.no_grad``."""
    import torch

    from mhla_tpu_torch.models import MHLAForCausalLM, MHLALMConfig, init_lm_params

    dev = torch.device("cuda")
    cs = chip_smoke
    cfg = MHLALMConfig(dtype=torch.bfloat16)
    model = MHLAForCausalLM(cfg, device=dev)
    init_lm_params(model, torch.Generator(dev).manual_seed(cs.SEED))
    model = model.to(torch.bfloat16).eval()
    ids = torch.randint(0, cfg.vocab_size, (cs.BATCH_A, cs.PROMPT_A),
                        generator=torch.Generator(dev).manual_seed(cs.SEED + 1), device=dev)
    with torch.no_grad():
        t = host_median_s(lambda: model(ids, use_cache=True), 5)
        dev_ms = card_ms(lambda: model(ids, use_cache=True), 3)
    print(tag, "step (a)", json.dumps({"step_ms": t * 1e3, "device_ms": dev_ms}),
          flush=True)
    del model


def time_ppl_block(chip_smoke, tag: str) -> None:
    """One 28,672-token block of (s): the evaluator over one block of the
    long-context hybrid (seeded init, bf16 compute), as ``chip_smoke.py``'s
    ppl phase builds it."""
    import tempfile

    import numpy as np
    import torch

    from mhla_tpu_torch.eval import PerplexityEvaluator, ppl_cli

    cs = chip_smoke
    with tempfile.TemporaryDirectory(prefix="time_ppl_") as work:
        cfg = ppl_cli.PPLConfig(model_json=cs.long_model_json(work), device="cuda")
        model = ppl_cli.build_model(cfg)
    evaluator = PerplexityEvaluator(model, cs.PPL_BLOCK, cs.PPL_BUCKET)
    tokens = np.random.default_rng(cs.SEED + 32).integers(
        0, model.config.vocab_size, cs.PPL_BLOCK)
    t = host_median_s(lambda: evaluator.evaluate_tokens(tokens), 3)
    print(tag, "step (s)", json.dumps({"step_ms": t * 1e3}), flush=True)
    del model, evaluator


def time_steps(chip_smoke, tag: str, only=None) -> None:
    """(a)'s prefill, one block of (s), and the tree's own training phases:
    (c) 340M at B=8 T=2048, (l) the hybrid on packed rows, (u) the
    long-context hybrid at B=1 T=16,384, (v) its heads at a 2,048 context on
    packed rows; ``only`` names a subset (letters)."""
    import torch

    dev = torch.device("cuda")
    cs = chip_smoke
    runs = {
        "a": lambda: time_prefill(cs, tag),
        "s": lambda: time_ppl_block(cs, tag),
        "c": lambda: cs.phase_train(dev),
        "l": lambda: cs.phase_train_hybrid(dev),
        "u": lambda: cs.phase_train_long(dev, "train long", cs.LONG_POSITIONS, 1,
                                         cs.LONG_TRAIN_SEQ, cs.LONG_TRAIN_STEPS, varlen=False),
        "v": lambda: cs.phase_train_long(dev, "train d256 packed", cs.TRAIN_SEQ,
                                         cs.TRAIN_BATCH, cs.TRAIN_SEQ, cs.LONG_TRAIN_STEPS,
                                         varlen=True),
    }
    for name, run in runs.items():
        if only is not None and name not in only:
            continue
        out = run()
        if out is not None:
            print(tag, f"step ({name})", json.dumps({"step_ms": out["step_ms"]}), flush=True)
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
    steps = [a for a in argv[2:] if a.startswith("steps")]
    if steps and steps[0].startswith("steps="):  # the steps alone, e.g. steps=a,l
        time_steps(chip_smoke, tag, steps[0][len("steps="):].split(","))
        return
    for b, t in K2_SHAPES:
        time_k2(mc, tag, b, t)
    for b, t in K2B_SHAPES:
        time_k2b(mc, tag, b, t)
    for n in WIDE_SLOTS:
        time_wide(mc, tag, n)
        torch.cuda.empty_cache()
    for b, per_row in N32_FORMS:
        time_n32(mc, tag, b, per_row)
    if steps:
        time_steps(chip_smoke, tag)


if __name__ == "__main__":
    main(sys.argv)
