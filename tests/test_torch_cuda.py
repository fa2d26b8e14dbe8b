"""Card-only tests of the port's kernels: each kernel against its plain
PyTorch version on a CUDA device, the launch counters, and the wrappers'
refusals. Without a card every test skips.

This file imports only torch and the port, so it also runs on a machine
without JAX; there the JAX-importing ``tests/conftest.py`` is left out:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import pytest
import torch

from mhla_tpu_torch import kernels
from mhla_tpu_torch.kernels import fmap_rope, mhla_chunk
from mhla_tpu_torch.models import MHLAForCausalLM, MHLALMConfig, generate, init_lm_params
from mhla_tpu_torch.ops import rotary_cos_sin
from mhla_tpu_torch.utils import assert_close

pytestmark = pytest.mark.cuda

# Kernel against plain version, both bf16 with float32 sums and the same
# rounding points: only the summation order differs, which can move a few
# outputs by one bf16 rounding (half an ulp is 2^-9 = 1.95e-3 relative).
KERNEL_TOL = 2e-3


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _randn(dev, *shape, seed=0):
    return torch.randn(*shape, generator=torch.Generator(dev).manual_seed(seed), device=dev)


@pytest.mark.parametrize("fmap", ["relu", "elu", "identity"])
@pytest.mark.parametrize("t,offset", [(781, 0), (1, 1984)])
def test_fmap_rope_kernel_matches_plain(dev, fmap, t, offset):
    cos, sin = rotary_cos_sin(2048, 128, device=dev)
    x = _randn(dev, 2, t, 512).to(torch.bfloat16)
    before = fmap_rope.launches["fmap_rope"]
    out = fmap_rope.fused_fmap_rope_flat(x, cos, sin, 4, fmap, offset=offset)
    assert fmap_rope.launches["fmap_rope"] == before + 1
    ref = fmap_rope.fmap_rope_plain(x, cos, sin, 4, fmap, offset=offset)
    assert_close(f"fmap_rope {fmap} t={t}", ref, out, KERNEL_TOL)


def test_fmap_rope_kernel_reads_strided_rows(dev):
    """A column slice of a wider projection output (the layer's q and k)."""
    cos, sin = rotary_cos_sin(2048, 128, device=dev)
    wide = _randn(dev, 2, 100, 1536).to(torch.bfloat16)
    x = wide[..., 512:1024]
    out = fmap_rope.fused_fmap_rope_flat(x, cos, sin, 4, "relu", offset=7)
    ref = fmap_rope.fmap_rope_plain(x.contiguous(), cos, sin, 4, "relu", offset=7)
    assert_close("fmap_rope strided", ref, out, KERNEL_TOL)


@pytest.mark.parametrize("b,t", [(1, 781), (2, 2048)])
def test_chunk_kernels_match_plain(dev, b, t):
    h, dk, dv = 4, 128, 256
    q = torch.relu(_randn(dev, b, t, h * dk, seed=1)).to(torch.bfloat16)
    k = torch.relu(_randn(dev, b, t, h * dk, seed=2)).to(torch.bfloat16)
    v = _randn(dev, b, t, h * dv, seed=3).to(torch.bfloat16)
    m = torch.tril(torch.rand(32, 32, generator=torch.Generator(dev).manual_seed(4), device=dev))
    before = dict(mhla_chunk.launches)
    o, s = mhla_chunk.mhla_chunk_fused_flat(q, k, v, m, num_heads=h, output_final_state=True)
    assert all(mhla_chunk.launches[n] == before[n] + 1 for n in before)
    o_cpu, s_cpu = mhla_chunk.mhla_chunk_fused_flat(
        q.cpu(), k.cpu(), v.cpu(), m.cpu(), num_heads=h, output_final_state=True
    )
    assert_close("chunk o kernels vs plain", o_cpu, o, KERNEL_TOL)
    assert_close("chunk states kernels vs plain", s_cpu, s, KERNEL_TOL)


def test_wrappers_raise_instead_of_falling_back(dev):
    k4 = torch.zeros(1, 2, 64, 512, device=dev)  # float32: the kernel takes bf16
    with pytest.raises(TypeError):
        mhla_chunk.chunk_states(k4, k4, 4)
    with pytest.raises(ValueError):
        mhla_chunk.mix_states(torch.zeros(40, 40, device=dev),
                              torch.zeros(1, 40, 512, 256, dtype=torch.bfloat16, device=dev))


def test_tiny_lm_serves_through_the_kernels(dev):
    cfg = MHLALMConfig(hidden_size=512, num_hidden_layers=2, num_heads=2, vocab_size=100,
                       dtype=torch.bfloat16)
    model = init_lm_params(MHLAForCausalLM(cfg, device=dev), torch.Generator(dev).manual_seed(0))
    model = model.to(torch.bfloat16).eval()
    ids = torch.randint(0, 100, (2, 120), generator=torch.Generator(dev).manual_seed(1), device=dev)
    kernels.reset_launch_counts()
    out, scores = generate(model, ids, max_new_tokens=12, output_scores=True)
    assert all(n > 0 for n in kernels.launch_counts().values()), kernels.launch_counts()
    with torch.no_grad():
        full, _ = model(out[:, :-1])
    # bf16 chunk vs recurrent: see SERVE_TOL in chip_smoke.py
    assert_close("tiny LM chunk vs recurrent", full[:, 119:], scores, 5e-2)
