"""Card-only tests of the port's kernels: each kernel (forward and
backward) against its plain PyTorch version on a CUDA device, the op's
gradients through the kernels, the launch counters, the wrappers'
refusals, and a tiny LM that serves and trains through the kernels.
Without a card every test skips.

This file imports only torch and the port, so it also runs on a machine
without JAX; there the JAX-importing ``tests/conftest.py`` is left out:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import pytest
import torch

from mhla_tpu_torch import kernels
from mhla_tpu_torch.kernels import fmap_rope, mhla_chunk
from mhla_tpu_torch.models import (
    MHLAForCausalLM,
    MHLALMConfig,
    cross_entropy_loss,
    generate,
    init_lm_params,
)
from mhla_tpu_torch.ops import rotary_cos_sin
from mhla_tpu_torch.train import OptimizerConfig, init_train_state, make_train_step
from mhla_tpu_torch.utils import assert_close

pytestmark = pytest.mark.cuda

# Kernel against plain version, both bf16 with float32 sums and the same
# rounding points: only the summation order differs, which can move a few
# outputs by one bf16 rounding (half an ulp is 2^-9 = 1.95e-3 relative).
KERNEL_TOL = 2e-3
_FWD_CHUNK = ("chunk_states", "mix_states", "chunk_output")


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
    assert all(mhla_chunk.launches[n] == before[n] + 1 for n in _FWD_CHUNK)
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
    counts = kernels.launch_counts()
    assert all(counts[n] > 0 for n in ("fmap_rope",) + _FWD_CHUNK), counts
    with torch.no_grad():
        full, _ = model(out[:, :-1])
    # bf16 chunk vs recurrent: see SERVE_TOL in chip_smoke.py
    assert_close("tiny LM chunk vs recurrent", full[:, 119:], scores, 5e-2)


@pytest.mark.parametrize("fmap", ["relu", "elu", "identity"])
def test_fmap_rope_bwd_kernel_matches_plain(dev, fmap):
    """K1b on a strided x (the layer's q/k slices) and offset 7."""
    cos, sin = rotary_cos_sin(2048, 128, device=dev)
    x = _randn(dev, 2, 100, 1536).to(torch.bfloat16)[..., 512:1024]
    dy = _randn(dev, 2, 100, 512, seed=5).to(torch.bfloat16)
    before = fmap_rope.launches["fmap_rope_bwd"]
    dx = fmap_rope.fmap_rope_bwd(dy, x, cos, sin, 4, fmap, offset=7)
    assert fmap_rope.launches["fmap_rope_bwd"] == before + 1
    ref = fmap_rope.fmap_rope_bwd_plain(dy, x.contiguous(), cos, sin, 4, fmap, offset=7)
    assert_close(f"fmap_rope_bwd {fmap}", ref, dx, KERNEL_TOL)


@pytest.mark.parametrize("b,t", [(1, 781), (2, 2048)])
def test_backward_chunk_kernels_match_plain(dev, b, t):
    h, dk, dv, c = 4, 128, 256, 64
    n = -(-t // c)
    bf16 = torch.bfloat16

    def tokens(d, relu, seed):
        y = _randn(dev, b, n * c, h * d, seed=seed)
        y[:, t:] = 0
        y = torch.relu(y) if relu else y
        return y.to(bf16).reshape(b, n, c, h * d).contiguous()

    q4, k4, v4, do4 = tokens(dk, True, 1), tokens(dk, True, 2), tokens(dv, False, 3), tokens(dv, False, 4)
    m = torch.tril(torch.rand(n, n, generator=torch.Generator(dev).manual_seed(5), device=dev))
    m_strict = torch.tril(m, -1).to(bf16).float().contiguous()
    m_diag = torch.diagonal(m).contiguous()
    states4 = mhla_chunk.chunk_states_plain(k4, v4, h)
    mixed4 = mhla_chunk.mix_states_plain(m_strict, states4)
    before = dict(mhla_chunk.launches)
    got = mhla_chunk.chunk_output_bwd(q4, k4, v4, mixed4, m_diag, do4, h)
    ref = mhla_chunk.chunk_output_bwd_plain(q4, k4, v4, mixed4, m_diag, do4, h)
    for name, r, g in zip(("dq", "dk_intra", "dv_intra", "dmixed", "dmd"), ref, got):
        assert_close(f"chunk_output_bwd {name}", r, g, KERNEL_TOL)
    _, dk_i, dv_i, dmixed4, _ = ref
    got = mhla_chunk.mix_states_bwd(m_strict, dmixed4, states4)
    ref = mhla_chunk.mix_states_bwd_plain(m_strict, dmixed4, states4)
    for name, r, g in zip(("dstates", "dMs"), ref, got):
        assert_close(f"mix_states_bwd {name}", r, g, KERNEL_TOL)
    got = mhla_chunk.chunk_states_bwd(k4, v4, ref[0], dk_i, dv_i, h)
    want = mhla_chunk.chunk_states_bwd_plain(k4, v4, ref[0], dk_i, dv_i, h)
    for name, r, g in zip(("dk", "dv"), want, got):
        assert_close(f"chunk_states_bwd {name}", r, g, KERNEL_TOL)
    for name in ("chunk_output_bwd", "mix_states_bwd", "chunk_states_bwd"):
        assert mhla_chunk.launches[name] == before[name] + 1


def test_op_gradients_through_kernels_match_plain_autograd(dev):
    """dx_q, dx_k, dv and dM of fmap+RoPE and the chunk op through K1-K4 and
    K1b-K4b against autograd of the plain definitions (chip_smoke.py's
    comparison and tolerance, whose derivation is written there)."""
    import chip_smoke

    got = chip_smoke.op_grads(dev, 1, 781, kernels_path=True)
    ref = chip_smoke.op_grads(dev, 1, 781, kernels_path=False)
    for name, r, g in zip(("dx_q", "dx_k", "dv", "dM"), ref, got):
        assert_close(f"op gradient {name}", r, g, chip_smoke.OP_GRAD_TOL)


def test_backward_wrappers_raise_instead_of_falling_back(dev):
    x = torch.zeros(1, 2, 64, 512, device=dev)  # float32: the kernels take bf16
    m = torch.zeros(2, 2, device=dev)
    with pytest.raises(TypeError):
        mhla_chunk.chunk_output_bwd(x, x, x, torch.zeros(1, 2, 512, 128, device=dev),
                                    torch.zeros(2, device=dev), x, 4)
    with pytest.raises(TypeError):
        mhla_chunk.chunk_states_bwd(x, x, torch.zeros(1, 2, 512, 128, device=dev), x, x, 4)
    big = torch.zeros(1, 40, 512, 256, dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError):
        mhla_chunk.mix_states_bwd(torch.zeros(40, 40, device=dev), big, big)
    with pytest.raises(TypeError):
        mhla_chunk.mix_states_bwd(m, big[:, :2].float(), big[:, :2].float())
    with pytest.raises(ValueError):  # Dv = 64 is not a multiple of the 128-column tile
        y = torch.zeros(1, 2, 64, 256, dtype=torch.bfloat16, device=dev)
        mhla_chunk.chunk_output_bwd(y, y, y, torch.zeros(1, 2, 256, 64, dtype=torch.bfloat16,
                                                         device=dev),
                                    torch.zeros(2, device=dev), y, 4)
    cos, sin = rotary_cos_sin(64, 128, device=dev)
    with pytest.raises(TypeError):
        z = torch.zeros(1, 8, 256, dtype=torch.float64, device=dev)
        fmap_rope.fmap_rope_bwd(z, z, cos, sin, 2, "relu")


def test_tiny_lm_trains_through_the_kernels(dev):
    """float32 parameters, bf16 compute: 3 steps of the trainer launch every
    kernel, gradients reach the projections and the mixing matrix, and the
    mixing matrices stay tril in [1e-5, 1]."""
    cfg = MHLALMConfig(hidden_size=512, num_hidden_layers=2, num_heads=2, vocab_size=100,
                       dtype=torch.bfloat16)
    model = init_lm_params(MHLAForCausalLM(cfg, device=dev), torch.Generator(dev).manual_seed(0))
    state = init_train_state(model, OptimizerConfig(warmup_steps=1, learning_rate=1e-3))

    def loss_fn(m, batch):
        logits, _ = m(batch)
        assert logits.dtype == torch.bfloat16 and logits.grad_fn is not None
        return cross_entropy_loss(logits, batch), {}

    step = make_train_step(loss_fn)
    ids = torch.randint(0, 100, (2, 200), generator=torch.Generator(dev).manual_seed(1),
                        device=dev)
    kernels.reset_launch_counts()
    losses = []
    for _ in range(3):
        state, metrics = step(state, ids)
        losses.append(float(metrics["loss"]))
    counts = kernels.launch_counts()
    assert all(n > 0 for n in counts.values()), counts
    assert all(torch.isfinite(torch.tensor(losses))) and losses[-1] < losses[0], losses
    attn = model.model.layers[0].attn
    for p in (attn.q_proj.weight, attn.k_proj.weight, attn.v_proj.weight, attn.mixing_matrix):
        assert p.dtype == torch.float32 and torch.count_nonzero(p.grad) > 0
    mm = attn.mixing_matrix
    assert torch.count_nonzero(torch.triu(mm, 1)) == 0
    low = mm[torch.tril(torch.ones_like(mm, dtype=torch.bool))]
    assert low.min() >= 1e-5 and low.max() <= 1.0
