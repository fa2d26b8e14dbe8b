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


def _is_banned(module: str) -> bool:
    return module.split(".")[0] in ("jax", "jaxlib", "flax", "mhla_tpu")


def test_subprocess_runs_tiny_model_without_jax():
    res = subprocess.run(
        [sys.executable, "-c", _RUN_TINY], cwd=ROOT, capture_output=True, text=True,
        timeout=300,
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
    counts = kernels.launch_counts()
    assert set(counts) == {
        "fmap_rope", "chunk_states", "mix_states", "chunk_output",
        "fmap_rope_bwd", "chunk_output_bwd", "mix_states_bwd", "chunk_states_bwd",
        "blockify_island", "mix_states_dense", "block_readout", "unblockify_island",
        "flash_attention", "radial_flash_attention",
    }
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
    assert len(counts) == 14 and all(n == 0 for n in counts.values()), counts
