"""The port stands alone: ``mhla_tpu_torch`` imports neither ``jax`` nor
``mhla_tpu``, and on the CPU no kernel launches (the wrappers run their
plain versions)."""

import ast
import subprocess
import sys
import textwrap
from pathlib import Path

import torch

from mhla_tpu_torch import kernels
from mhla_tpu_torch.eval import sample_video_latents
from mhla_tpu_torch.models import (
    MHLAForCausalLM,
    MHLALMConfig,
    WanModel,
    build_wan_config,
    generate,
    init_lm_params,
    init_wan_params,
)

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "mhla_tpu_torch"
TINY = dict(hidden_size=512, num_hidden_layers=2, num_heads=2, vocab_size=100)

_RUN_TINY = textwrap.dedent(
    f"""
    import sys
    import torch
    import mhla_tpu_torch.kernels, mhla_tpu_torch.layers, mhla_tpu_torch.ops
    import mhla_tpu_torch.utils, mhla_tpu_torch.diffusion, mhla_tpu_torch.eval.video_infer_cli
    from mhla_tpu_torch.models import MHLAForCausalLM, MHLALMConfig, generate, init_lm_params
    cfg = MHLALMConfig(**{TINY!r})
    model = init_lm_params(MHLAForCausalLM(cfg), torch.Generator().manual_seed(0))
    ids = torch.randint(0, cfg.vocab_size, (2, 70), generator=torch.Generator().manual_seed(1))
    out = generate(model, ids, max_new_tokens=4)
    assert out.shape == (2, 74)
    leaked = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "flax", "mhla_tpu", "triton"))
    print("LEAKED", leaked)
    """
)


_RUN_TINY_WAN_TRAINING = textwrap.dedent(
    """
    import sys
    import torch
    from mhla_tpu_torch import kernels
    from mhla_tpu_torch.train import wan_train
    # head dim 128 (the fused island) and 2,048 tokens (the flash route), remat on
    cfg = wan_train.parse_cli(wan_train.WanTrainConfig, [
        "--device=cpu", "--bf16=false", "--model.dim=256", "--model.ffn_dim=256",
        "--model.num_heads=2", "--model.num_layers=2", "--model.linear_attn_idx=(0,)",
        "--model.sparse_attn_idx=(1,)",  # layer 1: softmax under the radial mask
        "--model.block_layout=(2,2,2)", "--data.latent_frames=8", "--data.latent_height=32",
        "--data.latent_width=32", "--data.text_len=128", "--data.text_dim=32",
        "--optimizer.warmup_steps=1"])
    model, state, step, data = wan_train.build_training(cfg)
    kernels.reset_launch_counts()
    z, c = next(data)
    state, metrics = step(state, (torch.from_numpy(z), torch.from_numpy(c)))
    assert torch.isfinite(metrics["loss"]) and float(metrics["grad_norm"]) > 0
    assert all(p.grad is not None for p in model.parameters())
    counts = kernels.launch_counts()
    assert len(counts) == 27 and not any(counts.values()), counts
    leaked = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "flax", "mhla_tpu", "triton"))
    print("LEAKED", leaked)
    """
)


def _is_banned(module: str) -> bool:
    return module.split(".")[0] in ("jax", "jaxlib", "flax", "mhla_tpu")


def test_subprocess_runs_tiny_model_without_jax():
    res = subprocess.run(
        [sys.executable, "-c", _RUN_TINY], cwd=ROOT, capture_output=True, text=True,
        timeout=300,
    )
    assert res.returncode == 0, res.stderr
    assert "LEAKED []" in res.stdout, res.stdout


def test_subprocess_takes_a_tiny_wan_training_step_without_jax():
    """One step of the video trainer on the CPU, through the fused island's,
    the flash attention's (cross-attention) and the radial-sparse
    attention's autograd Functions under remat: every gradient
    arrives, no kernel launches, nothing of JAX is imported."""
    res = subprocess.run(
        [sys.executable, "-c", _RUN_TINY_WAN_TRAINING], cwd=ROOT, capture_output=True, text=True,
        timeout=600,
    )
    assert res.returncode == 0, res.stderr
    assert "LEAKED []" in res.stdout, res.stdout


def test_no_source_file_imports_jax_or_the_jax_package():
    for path in sorted(PKG.rglob("*.py")):
        if "_build" in path.relative_to(PKG).parts:  # build outputs, not sources
            continue
        for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
            if isinstance(node, ast.Import):
                names = [alias.name for alias in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            assert not any(_is_banned(n) for n in names), f"{path}: imports {names}"


def test_launch_counters_stay_zero_on_cpu():
    kernels.reset_launch_counts()
    cfg = MHLALMConfig(**TINY)
    model = init_lm_params(MHLAForCausalLM(cfg), torch.Generator().manual_seed(0))
    ids = torch.randint(0, cfg.vocab_size, (1, 70), generator=torch.Generator().manual_seed(2))
    generate(model, ids, max_new_tokens=3)
    logits, _ = model(ids)
    logits.float().sum().backward()  # the training path's backward
    # the hybrid on packed rows at a length that takes the masked flash route
    hybrid = MHLAForCausalLM(MHLALMConfig(**{**TINY, "attn": {"layers": [0], "num_heads": 4}}))
    seg = torch.repeat_interleave(torch.arange(4), 512)[None]
    logits, _ = hybrid(torch.zeros(1, 2048, dtype=torch.long), segment_ids=seg)
    logits.float().sum().backward()
    counts = kernels.launch_counts()
    assert set(counts) == {
        "fmap_rope", "chunk_states", "mix_states", "chunk_output",
        "fmap_rope_bwd", "chunk_output_bwd", "mix_states_bwd", "chunk_states_bwd",
        "blockify_island", "mix_states_dense", "block_readout", "unblockify_island",
        "flash_attention", "radial_flash_attention",
        "unblockify", "blockify", "block_readout_bwd", "flash_attention_bwd",
        "radial_flash_attention_bwd", "flash_attention_masked", "flash_attention_masked_bwd",
        "delta_chunk_fwd", "delta_chunk_bwd", "gla_chunk_fwd", "gla_chunk_bwd",
        "gla_chunk_fwd_scalar", "gla_chunk_bwd_scalar",
    }
    assert all(n == 0 for n in counts.values()), counts


def test_launch_counters_stay_zero_on_cpu_through_a_gated_deltanet_step():
    """The Gated DeltaNet LM at Dk = 128 (the fused path's route): a prefill
    of 130 tokens, decode, and a training step's backward through K11 /
    K11b's autograd Function, all on their plain versions."""
    kernels.reset_launch_counts()
    cfg = MHLALMConfig(**{**TINY, "attn_extends": "gated_deltanet"})
    model = init_lm_params(MHLAForCausalLM(cfg), torch.Generator().manual_seed(0))
    ids = torch.randint(0, cfg.vocab_size, (2, 130), generator=torch.Generator().manual_seed(3))
    out = generate(model, ids, max_new_tokens=3)
    assert out.shape == (2, 133)
    logits, _ = model(ids)
    logits.float().sum().backward()
    assert all(p.grad is not None for p in model.parameters())
    counts = kernels.launch_counts()
    assert counts["delta_chunk_fwd"] == counts["delta_chunk_bwd"] == 0
    assert all(n == 0 for n in counts.values()), counts


def test_launch_counters_stay_zero_on_cpu_through_a_gla_step():
    """The GLA LM (and simple GLA) at Dk = 128 (the fused path's route): a
    prefill of 130 tokens, decode, and a training step's backward through
    K12 / K12b's autograd Function, all on their plain versions."""
    for extends in ("gla", "simple_gla"):
        kernels.reset_launch_counts()
        cfg = MHLALMConfig(**{**TINY, "attn_extends": extends})
        model = init_lm_params(MHLAForCausalLM(cfg), torch.Generator().manual_seed(0))
        ids = torch.randint(0, cfg.vocab_size, (2, 130),
                            generator=torch.Generator().manual_seed(3))
        assert generate(model, ids, max_new_tokens=3).shape == (2, 133)
        logits, _ = model(ids)
        logits.float().sum().backward()
        assert all(p.grad is not None for p in model.parameters())
        counts = kernels.launch_counts()
        assert all(n == 0 for n in counts.values()), counts


def test_launch_counters_stay_zero_on_cpu_through_video_sampling():
    """A tiny Wan model with head dim 128 (the fused island's route) and a
    query long enough for the flash route, sampled for two steps with CFG."""
    kernels.reset_launch_counts()
    cfg = build_wan_config(num_layers=1, dim=256, num_heads=2, ffn_dim=256, text_len=128,
                           text_dim=32, linear_attn_idx=(0,), block_layout=(2, 2, 2))
    model = init_wan_params(WanModel(cfg), torch.Generator().manual_seed(0)).eval()
    latents = sample_video_latents(
        model, torch.zeros(1, 128, 32), latent_shape=(8, 32, 32, 16), num_steps=2
    )
    assert latents.shape == (1, 8, 32, 32, 16) and torch.isfinite(latents).all()
    counts = kernels.launch_counts()
    assert all(n == 0 for n in counts.values()), counts


def test_launch_counters_stay_zero_on_cpu_through_hybrid_sparse_sampling():
    """MHLA, radial-sparse and dense softmax layers at a query length that
    takes the flash route; four steps with shift 3.0 call the model on both
    sides of the sparse layers' dense guard (t x 1000 = 1000, 900, 750, 501)."""
    kernels.reset_launch_counts()
    cfg = build_wan_config(num_layers=3, dim=256, num_heads=2, ffn_dim=256, text_len=128,
                           text_dim=32, linear_attn_idx=(0,), sparse_attn_idx=(1,),
                           block_layout=(2, 2, 2))
    model = init_wan_params(WanModel(cfg), torch.Generator().manual_seed(0)).eval()
    assert [b.attn_type for b in model.blocks] == ["mhla_uni", "sparse", "flash"]
    latents = sample_video_latents(
        model, torch.zeros(1, 128, 32), latent_shape=(8, 32, 32, 16), num_steps=4, flow_shift=3.0
    )
    assert latents.shape == (1, 8, 32, 32, 16) and torch.isfinite(latents).all()
    counts = kernels.launch_counts()
    assert len(counts) == 27 and all(n == 0 for n in counts.values()), counts


def test_launch_counters_stay_zero_on_cpu_through_image_training_steps(tmp_path):
    """A DiT step and a ViT step through their trainers' loss functions (the
    MHLA2D layers, the LePE convolutions, the diffusion losses, mixup)."""
    import numpy as np

    from mhla_tpu_torch.train import dit_train, init_train_state, make_train_step, vit_train

    kernels.reset_launch_counts()
    dcfg = dit_train.parse_cli(dit_train.DiTTrainConfig, [
        "--device=cpu", "--depth=1", "--hidden_size=64", "--num_heads=2", "--input_size=8",
        "--block_size=4", "--num_classes=10"])
    dit, _ = dit_train.build_model(dcfg)
    diffusion = dit_train.create_diffusion(None)[0]
    state = init_train_state(dit, dcfg.optimizer, ema=True)
    step = make_train_step(dit_train.make_loss_fn(diffusion), 0.9, seed=0)
    x, y = next(dit_train.latent_batches(dcfg, np.random.default_rng(0)))
    state, metrics = step(state, (torch.from_numpy(x)[:2], torch.from_numpy(y)[:2]))
    assert torch.isfinite(metrics["loss"])
    vcfg = vit_train.parse_cli(vit_train.ViTTrainConfig, [
        "--device=cpu", "--model_name=deit_tiny_mhla", "--img_size=32", "--piece_size=2",
        "--num_classes=10"])
    vit = vit_train.build_model(vcfg)
    state = init_train_state(vit, vcfg.optimizer)
    step = make_train_step(vit_train.make_loss_fn(vcfg))
    draws = vit_train.draw_mix(32, 32, 0.8, 1.0, torch.Generator().manual_seed(0))
    imgs = torch.randn(2, 32, 32, 3)
    state, metrics = step(state, (imgs, torch.tensor([1, 2]), draws))
    assert torch.isfinite(metrics["loss"])
    counts = kernels.launch_counts()
    assert len(counts) == 27 and all(n == 0 for n in counts.values()), counts
