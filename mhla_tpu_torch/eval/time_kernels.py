"""Time the port's redesigned kernels on the card, beside one PyTorch call of
the same function, and with ``steps`` the end-to-end steps they run in. One
group a process:

- ``chunk``: K2 / K2b, K3 / K3b and K4 / K4b (``kernels/mhla_chunk.py``) at
  the shapes PERF.md lists (K4 / K4b at (a)'s, (c)'s and, per-row, (l)'s
  rows); steps (a)'s prefill of 4 x 1,984 tokens, one 28,672-token block of
  (s)'s evaluation and the training steps of ``chip_smoke.py``'s phases (c),
  (l), (u) and (v) as that tree's own ``chip_smoke.py`` runs them (letters
  a, s, c, l, u, v).
- ``flash``: K9 / K9b (``kernels/flash_attention.py``) in every form, beside
  the library's flash or memory-efficient SDPA call (forward, and its
  backward through autograd). No steps.
- ``video``: K6 (``kernels/mhla_block.py``), K10 in its serving and its
  training form and K10b (``kernels/sparse_attention.py``) at the video
  model's shapes; steps the training steps of (i) hybrid_sparse and (j)
  hybrid_sparse + LoRA, one CFG forward of (d), the full-MHLA sampler, and
  one of (f), the hybrid_sparse sampler, at t = 501, below its dense guard
  (letters i, j, d, f).
- ``gla``: K12 and K12b (``kernels/gla_chunk.py``) at (q)'s training shape
  [8, 2048, 4, 128|256] in float32 (the GLA layer's form), K12 at (p)'s
  prefill of 4 x 1,984 tokens (serving: no entry states kept), both at
  ``benchmarks/gla_bench.py``'s [1, 32768, 8, 128|128] in bf16, each with
  its wrapper's host cost a call and the card's time for each of its
  launches (``torch.profiler``: the state pass, the readout or gradients
  pass, and the bf16 form's float32 copies); steps the training steps of
  (q), the GLA LM, and (r), the simple GLA LM (letters q, r).

It imports ``mhla_tpu_torch`` and ``chip_smoke`` from the current directory,
so the same file times another checkout too, such as a parent tree unpacked
under the gitignored ``work_dirs/``:

    python3 mhla_tpu_torch/eval/time_kernels.py GROUP change [steps | steps=a,l]
    (cd work_dirs/parent && python3 ../../mhla_tpu_torch/eval/time_kernels.py GROUP parent [steps])

``steps=a,l`` times those steps alone. Each form prints one line: the tag,
the form and a JSON object of times in ms. Kernels: CUDA events, the median
of 7 timings of back-to-back calls after warm-up (10 calls in ``chunk``, as
``chip_smoke.py`` times them, so the host's cost of enqueueing the first
call weighs little; 3 in the others). Steps: the median on the host clock to
a sync after one warm-up (the prefill also the card's time alone, host-bound
as it is). Compare two trees inside one run, in turns (parent, change,
change, parent).
"""

from __future__ import annotations

import json
import os
import statistics
import sys
import time


def median_ms(fn, inner: int, reps: int = 7, warmup: int = 2) -> float:
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


def host_median_ms(fn, reps: int) -> float:
    """Median host-clock ms of ``fn()`` to a sync, after one warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
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


def report(tag: str, form: str, r: dict) -> None:
    print(tag, form, json.dumps(r), flush=True)


# --- chunk: K2 / K2b, K3 / K3b, K4 / K4b ------------------------------------

# K2 and K2b: (batch, tokens) at 4 heads of Dk 128, Dv 256, chunk 64: (a)'s
# prefill rows (K2), (c)'s training rows and (u)'s long-context row
K2_SHAPES = [(4, 1984), (4, 2048), (8, 2048), (1, 16384)]
K2B_SHAPES = [(8, 2048), (1, 16384)]
# the wide K3 / K3b: chunk slots N at one batch row of 4 x 128 x 256 states
WIDE_SLOTS = [64, 256, 448, 512]
# K3 and K3b at N = 32 (batch, per-row M): serving 4 x 2048, training 8 x 2048
N32_FORMS = [(4, False), (8, False), (8, True)]
# K4 (and, at training rows, K4b): (batch, per-row md) at T = 2048: (a)'s
# serving rows, (c)'s training rows, (l)'s packed rows (one md per row)
K4_FORMS = [(4, False), (8, False), (8, True)]
CHUNK_INNER = 10


def time_k2(mc, tag: str, b: int, t: int) -> None:
    import torch

    h, dk, dv, c = 4, 128, 256, 64
    n = -(-t // c)
    dev, bf16 = torch.device("cuda"), torch.bfloat16
    gen = torch.Generator(dev).manual_seed(0)
    k4 = torch.randn(b, n, c, h * dk, generator=gen, device=dev).to(bf16)
    v4 = torch.randn(b, n, c, h * dv, generator=gen, device=dev).to(bf16)
    k5, v5 = k4.view(b, n, c, h, dk), v4.view(b, n, c, h, dv)
    report(tag, f"K2 B={b} T={t}", {
        "ms": median_ms(lambda: mc.chunk_states(k4, v4, h), CHUNK_INNER),
        "library_ms": median_ms(lambda: torch.einsum("bnchk,bnchv->bnhkv", k5, v5),
                                CHUNK_INNER)})


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
    report(tag, f"K2b B={b} T={t}", {
        "ms": median_ms(lambda: mc.chunk_states_bwd(k4, v4, ds4, dk_i, dv_i, h), CHUNK_INNER),
        "library_ms": median_ms(lambda: (
            torch.einsum("bnchv,bnhkv->bnchk", v5, ds5).add_(dki5),
            torch.einsum("bnchk,bnhkv->bnchv", k5, ds5).add_(dvi5)), CHUNK_INNER)})


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
    report(tag, f"wide N={n}", {
        "K3_ms": median_ms(lambda: mc.mix_states(m_strict, states4), CHUNK_INNER),
        "K3_library_ms": median_ms(lambda: torch.matmul(m_bf, s2), CHUNK_INNER),
        "K3b_ms": median_ms(lambda: mc.mix_states_bwd(m_strict, dmixed4, states4), CHUNK_INNER),
        "K3b_library_ms": median_ms(lambda: (torch.matmul(m_bf.T, d2), torch.matmul(d2, s2.T)),
                                    CHUNK_INNER)})


def time_n32(mc, tag: str, b: int, per_row: bool) -> None:
    """K3 and K3b at N = 32, through whichever kernels the tree routes them
    to, beside the einsum of K3's form of M."""
    import torch

    m_strict, states4, dmixed4 = wide_inputs(b, 32, per_row)
    m_bf = m_strict.to(torch.bfloat16)
    eq = "bij,bjrd->bird" if per_row else "ij,bjrd->bird"
    report(tag, f"N=32 B={b} {'per-row' if per_row else 'shared'} M", {
        "K3_ms": median_ms(lambda: mc.mix_states(m_strict, states4), CHUNK_INNER),
        "K3_library_ms": median_ms(lambda: torch.einsum(eq, m_bf, states4), CHUNK_INNER),
        "K3b_ms": median_ms(lambda: mc.mix_states_bwd(m_strict, dmixed4, states4), CHUNK_INNER)})


def time_k4(mc, tag: str, b: int, per_row: bool) -> None:
    """K4, and at training rows K4b, at B x 2048 tokens of 4 heads (Dk 128,
    Dv 256, 32 chunks) with a shared or a per-row diagonal."""
    import torch

    h, dk, dv, c, n = 4, 128, 256, 64, 32
    dev, bf16 = torch.device("cuda"), torch.bfloat16
    gen = torch.Generator(dev).manual_seed(0)
    rnd = lambda *s: torch.randn(*s, generator=gen, device=dev).to(bf16)  # noqa: E731
    q4, k4 = torch.relu(rnd(b, n, c, h * dk)), torch.relu(rnd(b, n, c, h * dk))
    v4, do4, mixed4 = rnd(b, n, c, h * dv), rnd(b, n, c, h * dv), rnd(b, n, h * dk, dv)
    md = torch.rand(*((b, n) if per_row else (n,)), generator=gen, device=dev)
    r = {"K4_ms": median_ms(lambda: mc.chunk_output(q4, k4, v4, mixed4, md, h), CHUNK_INNER)}
    if b == 8:
        r["K4b_ms"] = median_ms(lambda: mc.chunk_output_bwd(q4, k4, v4, mixed4, md, do4, h),
                                CHUNK_INNER)
    report(tag, f"K4 B={b} T=2048 {'per-row' if per_row else 'shared'} md", r)


def time_prefill(cs, tag: str) -> None:
    """(a)'s prefill: one cache-building forward of the 340M model (bf16,
    seeded init) over 4 x 1,984 tokens under ``torch.no_grad``."""
    import torch

    from mhla_tpu_torch.models import MHLAForCausalLM, MHLALMConfig, init_lm_params

    dev = torch.device("cuda")
    cfg = MHLALMConfig(dtype=torch.bfloat16)
    model = MHLAForCausalLM(cfg, device=dev)
    init_lm_params(model, torch.Generator(dev).manual_seed(cs.SEED))
    model = model.to(torch.bfloat16).eval()
    ids = torch.randint(0, cfg.vocab_size, (cs.BATCH_A, cs.PROMPT_A),
                        generator=torch.Generator(dev).manual_seed(cs.SEED + 1), device=dev)
    with torch.no_grad():
        report(tag, "step (a)", {"step_ms": host_median_ms(lambda: model(ids, use_cache=True), 5),
                                 "device_ms": card_ms(lambda: model(ids, use_cache=True), 3)})
    del model


def time_ppl_block(cs, tag: str) -> None:
    """One 28,672-token block of (s): the evaluator over one block of the
    long-context hybrid (seeded init, bf16 compute), as ``chip_smoke.py``'s
    ppl phase builds it."""
    import tempfile

    import numpy as np

    from mhla_tpu_torch.eval import PerplexityEvaluator, ppl_cli

    with tempfile.TemporaryDirectory(prefix="time_ppl_") as work:
        cfg = ppl_cli.PPLConfig(model_json=cs.long_model_json(work), device="cuda")
        model = ppl_cli.build_model(cfg)
    evaluator = PerplexityEvaluator(model, cs.PPL_BLOCK, cs.PPL_BUCKET)
    tokens = np.random.default_rng(cs.SEED + 32).integers(
        0, model.config.vocab_size, cs.PPL_BLOCK)
    report(tag, "step (s)", {"step_ms": host_median_ms(lambda: evaluator.evaluate_tokens(tokens),
                                                       3)})
    del model, evaluator


def chunk_kernels(cs, tag: str) -> None:
    from mhla_tpu_torch.kernels import mhla_chunk as mc

    for b, t in K2_SHAPES:
        time_k2(mc, tag, b, t)
    for b, t in K2B_SHAPES:
        time_k2b(mc, tag, b, t)
    for n in WIDE_SLOTS:
        time_wide(mc, tag, n)
    for b, per_row in N32_FORMS:
        time_n32(mc, tag, b, per_row)
    for b, per_row in K4_FORMS:
        time_k4(mc, tag, b, per_row)


def chunk_steps(cs, tag: str) -> dict:
    """(a)'s prefill, one block of (s), and the tree's own training phases:
    (c) 340M at B=8 T=2048, (l) the hybrid on packed rows, (u) the
    long-context hybrid at B=1 T=16,384, (v) its heads at a 2,048 context on
    packed rows."""
    import torch

    dev = torch.device("cuda")

    def phase(name, run):
        out = run()
        report(tag, f"step ({name})", {"step_ms": out["step_ms"]})

    return {
        "a": lambda: time_prefill(cs, tag),
        "s": lambda: time_ppl_block(cs, tag),
        "c": lambda: phase("c", lambda: cs.phase_train(dev)),
        "l": lambda: phase("l", lambda: cs.phase_train_hybrid(dev)),
        "u": lambda: phase("u", lambda: cs.phase_train_long(
            dev, "train long", cs.LONG_POSITIONS, 1, cs.LONG_TRAIN_SEQ, cs.LONG_TRAIN_STEPS,
            varlen=False)),
        "v": lambda: phase("v", lambda: cs.phase_train_long(
            dev, "train d256 packed", cs.TRAIN_SEQ, cs.TRAIN_BATCH, cs.TRAIN_SEQ,
            cs.LONG_TRAIN_STEPS, varlen=True)),
    }


# --- flash: K9 / K9b -------------------------------------------------------

# (name, B, Tq, Tk, heads, head dim, causal, packed segment ids, backward too)
FLASH_FORMS = [
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


def time_flash_form(flash, cs, tag, name, b, tq, tk, h, d, causal, packed, bwd) -> None:
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    dev, bf16 = torch.device("cuda"), torch.bfloat16
    gen = torch.Generator(dev).manual_seed(0)
    q, do = (torch.randn(b, tq, h, d, generator=gen, device=dev).to(bf16) for _ in range(2))
    k, v = (torch.randn(b, tk, h, d, generator=gen, device=dev).to(bf16) for _ in range(2))
    seg = cs.packed_segment_ids(dev, b, tq) if packed else None
    r = {"fwd_ms": median_ms(lambda: flash.flash_attention(q, k, v, causal=causal,
                                                           segment_ids=seg), 3)}
    o, lse = flash._flash_fwd(q, k, v, None, True, causal, seg)
    if bwd:
        r["bwd_ms"] = median_ms(lambda: flash.flash_attention_bwd(q, k, v, o, lse, do, None,
                                                                  causal, seg), 3)
    keep = None
    if seg is not None:
        ar = torch.arange(tq, device=dev)
        keep = ((seg[:, :, None] == seg[:, None, :]) & (ar[:, None] >= ar[None, :]))[:, None]
    qt, kt, vt = (x.detach().transpose(1, 2).requires_grad_(bwd) for x in (q, k, v))
    with sdpa_kernel([SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION]):
        r["sdpa_fwd_ms"] = median_ms(lambda: F.scaled_dot_product_attention(
            qt.detach(), kt.detach(), vt.detach(), attn_mask=keep,
            is_causal=causal and keep is None), 3)
        if bwd:
            out = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=keep,
                                                 is_causal=causal and keep is None)
            dot = do.transpose(1, 2)
            r["sdpa_bwd_ms"] = median_ms(lambda: torch.autograd.grad(out, (qt, kt, vt), dot,
                                                                     retain_graph=True), 3)
    report(tag, name, r)


def flash_kernels(cs, tag: str) -> None:
    from mhla_tpu_torch.kernels import flash_attention as flash

    for form in FLASH_FORMS:
        time_flash_form(flash, cs, tag, *form)


# --- video: K6, K10, K10b --------------------------------------------------

VIDEO_FRAMES, VIDEO_TOKENS, VIDEO_HEADS = 21, 31500, 12
SOFTMAX_LAYERS = tuple(range(0, 30, 3))  # configs/wan_1300m_hybrid_mhla.yaml


def time_k6(tag: str) -> None:
    """K6 at (d)'s [2, 150, 1536, 128] on M in float32 and bf16, and at the
    training shape, batch 1, on M^T (the backward's form), each beside
    ``torch.matmul`` of the same product (TF32 off)."""
    import torch

    from mhla_tpu_torch.kernels import mhla_block
    from mhla_tpu_torch.ops.block_mix import block_mixing_matrix

    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(0)
    m = torch.from_numpy(block_mixing_matrix((3, 5, 10))).to(dev)
    n, r = m.shape[0], 1536 * 128
    for b, dt, mat, form in ((2, torch.float32, m, "float32 [2, 150, 1536, 128] M"),
                             (2, torch.bfloat16, m, "bf16 [2, 150, 1536, 128] M"),
                             (1, torch.float32, m.T.contiguous(),
                              "float32 [1, 150, 1536, 128] M^T")):
        s = torch.randn(b, n, 1536, 128, generator=gen, device=dev).to(dt)
        md = mat.to(dt)
        report(tag, f"K6 {form}", {
            "ms": median_ms(lambda: mhla_block.mix_states_dense(mat, s), 3),
            "library_ms": median_ms(lambda: torch.matmul(md, s.view(b, n, r)), 3)})
        del s


def time_k10(tag: str) -> None:
    """K10 at (f)'s [2, 31,500, 12, 128] in 21 frames (serving form) and at
    (i)'s [1, 31,500, 12, 128] (training form, which also writes lse)."""
    import torch

    from mhla_tpu_torch.kernels import sparse_attention as sparse

    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(1)
    for b, lse, form in ((2, False, "serving [2, 31500, 12, 128]"),
                         (1, True, "training [1, 31500, 12, 128]")):
        q, k, v = (torch.randn(b, VIDEO_TOKENS, VIDEO_HEADS, 128, generator=gen, device=dev)
                   .to(torch.bfloat16) for _ in range(3))
        report(tag, f"K10 {form} 21 frames", {
            "ms": median_ms(lambda: sparse.radial_flash_attention(q, k, v, VIDEO_FRAMES,
                                                                  return_lse=lse),
                            2, reps=5, warmup=1)})
        del q, k, v


def time_k10b(tag: str) -> None:
    """K10b at (i)'s [1, 31,500, 12, 128] in 21 frames, on K10's output."""
    import torch

    from mhla_tpu_torch.kernels import sparse_attention as sparse

    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(1)
    q, k, v, do = (torch.randn(1, VIDEO_TOKENS, VIDEO_HEADS, 128, generator=gen, device=dev)
                   .to(torch.bfloat16) for _ in range(4))
    o, lse = sparse.radial_flash_attention(q, k, v, VIDEO_FRAMES, return_lse=True)
    report(tag, "K10b [1, 31500, 12, 128] 21 frames", {
        "ms": median_ms(lambda: sparse.radial_flash_attention_bwd(q, k, v, o, lse, do,
                                                                   VIDEO_FRAMES),
                        2, reps=5, warmup=1)})


def time_train_step(tag: str, lora: bool) -> None:
    """(i) or, with ``lora``, (j): ten radial-sparse softmax layers; the
    median of 4 steps after one."""
    import torch

    from mhla_tpu_torch.train.wan_train import WanTrainConfig, build_training

    cfg = WanTrainConfig()
    cfg.optimizer.warmup_steps = 1
    cfg.model.sparse_attn_idx = SOFTMAX_LAYERS
    cfg.lora.enable = lora
    model, state, step, data = build_training(cfg)
    dev = torch.device(cfg.device)
    holder = {"state": state}

    def one():
        z, c = next(data)
        holder["state"], metrics = step(holder["state"], (torch.from_numpy(z).to(dev),
                                                          torch.from_numpy(c).to(dev)))
        float(metrics["loss"])

    report(tag, f"step ({'j' if lora else 'i'})", {"step_ms": host_median_ms(one, 4)})
    del model, state, step, data, holder


def time_cfg_forward(tag: str) -> None:
    """One forward of (d)'s CFG batch (2 x 31,500 tokens) at t = 500; the
    median of 5 calls after one."""
    import torch

    from mhla_tpu_torch.eval.video_infer_cli import VideoInferConfig, _build_model

    cfg = VideoInferConfig()
    dev = torch.device(cfg.device)
    model = _build_model(cfg, dev)
    gen = torch.Generator(dev).manual_seed(1)
    x = torch.randn(2, *cfg.sampling.latent_shape, generator=gen, device=dev)
    ctx = torch.randn(2, model.cfg.text_len, model.cfg.text_dim, generator=gen, device=dev)
    t = torch.full((2,), 500.0, device=dev)

    def call():
        with torch.no_grad():
            model(x, t, ctx)

    report(tag, "forward (d)", {"forward_ms": host_median_ms(call, 5)})
    del model


def time_sparse_forward(cs, tag: str) -> None:
    """One forward of (f)'s CFG batch: the hybrid model with its ten softmax
    layers radial-sparse, at t = 501 (K10 below the dense guard); the median
    of 5 calls after one."""
    import torch

    from mhla_tpu_torch.eval.video_infer_cli import VideoInferConfig, _build_model

    cfg = VideoInferConfig()
    cfg.linear_attn_idx = cs.HYBRID_LINEAR_IDX
    dev = torch.device(cfg.device)
    model = _build_model(cfg, dev, sparse_attn_idx=cs.SOFTMAX_LAYERS)
    gen = torch.Generator(dev).manual_seed(1)
    x = torch.randn(2, *cfg.sampling.latent_shape, generator=gen, device=dev)
    ctx = torch.randn(2, model.cfg.text_len, model.cfg.text_dim, generator=gen, device=dev)
    t = torch.full((2,), cs.T_SPARSE, device=dev)

    def call():
        with torch.no_grad():
            model(x, t, ctx)

    report(tag, "forward (f)", {"forward_ms": host_median_ms(call, 5)})
    del model


def video_kernels(cs, tag: str) -> None:
    time_k6(tag)
    time_k10(tag)
    time_k10b(tag)


def video_steps(cs, tag: str) -> dict:
    return {"i": lambda: time_train_step(tag, False), "j": lambda: time_train_step(tag, True),
            "d": lambda: time_cfg_forward(tag), "f": lambda: time_sparse_forward(cs, tag)}


# --- gla: K12 / K12b --------------------------------------------------------

# (form, B, T, H, Dv, dtype name, backward too, entry states kept)
GLA_FORMS = [
    ("(q) [8, 2048, 4, 128|256] float32", 8, 2048, 4, 256, "float32", True, True),
    ("(p) [4, 1984, 4, 128|256] float32", 4, 1984, 4, 256, "float32", False, False),
    ("bench [1, 32768, 8, 128|128] bf16", 1, 32768, 8, 128, "bfloat16", True, True),
]


def device_ms_by_kernel(fn, reps: int = 5) -> dict:
    """The card's time, ms a call, of each CUDA kernel ``fn`` launches, by
    name (cut to 60 characters), over ``reps`` profiled calls."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            out[e.name[:60]] = out.get(e.name[:60], 0.0) + e.device_time / reps / 1e3
    return out


def gla_kernels(cs, tag: str) -> None:
    import torch

    from mhla_tpu_torch.kernels import gla_chunk as gc

    dev = torch.device("cuda")
    for form, b, t, h, dv, dtype, bwd, keep in GLA_FORMS:
        qd, kd, v4, egl, s0, do, ds = cs.gla_kernel_inputs(dev, b, t, h, dv,
                                                           getattr(torch, dtype))
        c = cs.BASE_CHUNK
        fwd = lambda: gc.gla_chunk_fwd(qd, kd, v4, egl, s0, c, keep)  # noqa: E731
        report(tag, f"K12 {form}", {"ms": median_ms(fwd, 3), "host_us": cs.host_us(fwd, 10, 3),
                                    "launches_ms": device_ms_by_kernel(fwd)})
        if bwd:
            states = gc.gla_chunk_fwd(qd, kd, v4, egl, s0, c, True)[2]
            back = lambda: gc.gla_chunk_bwd(qd, kd, v4, egl, states, do, ds, c)  # noqa: E731
            report(tag, f"K12b {form}", {"ms": median_ms(back, 3),
                                         "host_us": cs.host_us(back, 10, 3),
                                         "launches_ms": device_ms_by_kernel(back)})
            del states
        del qd, kd, v4, egl, s0, do, ds
        torch.cuda.empty_cache()


def gla_steps(cs, tag: str) -> dict:
    """The training steps of (q), the GLA LM (6 steps, the median of steps
    2-6), and (r), the simple GLA LM (2 steps, step 2)."""
    import torch

    dev = torch.device("cuda")

    def phase(name, extends, steps):
        out = cs.phase_train_baseline(dev, extends, extends, steps=steps)
        report(tag, f"step ({name})", {"step_ms": out["step_ms"]})

    return {"q": lambda: phase("q", "gla", cs.TRAIN_STEPS),
            "r": lambda: phase("r", "simple_gla", 2)}


GROUPS = {"chunk": (chunk_kernels, chunk_steps), "flash": (flash_kernels, None),
          "video": (video_kernels, video_steps), "gla": (gla_kernels, gla_steps)}


def main(argv) -> None:
    if len(argv) < 2 or argv[1] not in GROUPS:
        raise SystemExit(f"usage: time_kernels.py {{{'|'.join(GROUPS)}}} TAG [steps | steps=x,y]")
    sys.path.insert(0, os.getcwd())  # the checkout being timed
    import torch

    import chip_smoke

    if not torch.cuda.is_available():
        raise SystemExit("time_kernels.py: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kernels, steps = GROUPS[argv[1]]
    tag = argv[2] if len(argv) > 2 else "tree"
    print(tag, torch.cuda.get_device_name(0), flush=True)
    asked = [a for a in argv[3:] if a.startswith("steps")]
    only = asked[0][len("steps="):].split(",") if asked and "=" in asked[0] else None
    if only is None:
        kernels(chip_smoke, tag)
        torch.cuda.empty_cache()
    if asked and steps is not None:
        for name, run in steps(chip_smoke, tag).items():
            if only is None or name in only:
                run()
                torch.cuda.empty_cache()


if __name__ == "__main__":
    main(sys.argv)
