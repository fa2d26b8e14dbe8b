"""Card-only tests of the port's kernels: each kernel (forward and
backward) against its plain PyTorch version on a CUDA device, the op's
gradients through the kernels, the launch counters, the wrappers'
refusals, a tiny LM that serves and trains through the kernels, and a tiny
video model that samples through them. Without a card every test skips.

This file imports only torch and the port, so it also runs on a machine
without JAX; there the JAX-importing ``tests/conftest.py`` is left out:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import pytest
import torch

from mhla_tpu_torch import kernels
from mhla_tpu_torch.eval import sample_video_latents
from mhla_tpu_torch.kernels import flash_attention as flash
from mhla_tpu_torch.kernels import fmap_rope, mhla_block, mhla_chunk
from mhla_tpu_torch.kernels import sparse_attention as sparse
from mhla_tpu_torch.models import (
    MHLAForCausalLM,
    MHLALMConfig,
    cross_entropy_loss,
    WanModel,
    build_wan_config,
    generate,
    init_lm_params,
    init_wan_params,
)
from mhla_tpu_torch.ops import block_mixing_matrix, rope_tables_flat, rotary_cos_sin
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
    lm_kernels = ("fmap_rope", "fmap_rope_bwd") + _FWD_CHUNK + tuple(f"{n}_bwd" for n in _FWD_CHUNK)
    assert all(counts[n] > 0 for n in lm_kernels), counts
    assert all(torch.isfinite(torch.tensor(losses))) and losses[-1] < losses[0], losses
    attn = model.model.layers[0].attn
    for p in (attn.q_proj.weight, attn.k_proj.weight, attn.v_proj.weight, attn.mixing_matrix):
        assert p.dtype == torch.float32 and torch.count_nonzero(p.grad) > 0
    mm = attn.mixing_matrix
    assert torch.count_nonzero(torch.triu(mm, 1)) == 0
    low = mm[torch.tril(torch.ones_like(mm, dtype=torch.bool))]
    assert low.min() >= 1e-5 and low.max() <= 1.0


# ---------------------------------------------------------------------------
# video: K5-K9
# ---------------------------------------------------------------------------

_F32, _BF16 = torch.float32, torch.bfloat16


@pytest.mark.parametrize("grid,layout", [((21, 12, 10), (3, 2, 2)), ((4, 4, 8), (2, 2, 2))])
@pytest.mark.parametrize("form", ["qk", "qk_nope_bf16_island", "v", "no_rope", "strided"])
def test_blockify_island_kernel_matches_plain(dev, grid, layout, form):
    """K5 on odd partitions (7, 6, 5) and on even ones, in the forms the
    layer gives it, and on a column slice of a wider projection output."""
    h, dh = 2, 128
    t = grid[0] * grid[1] * grid[2]
    x = _randn(dev, 2, t, 3 * h * dh).to(_BF16)
    x = x[..., h * dh: 2 * h * dh] if form == "strided" else x[..., : h * dh].contiguous()
    gamma = 1 + 0.1 * _randn(dev, h * dh, seed=1)
    tables = rope_tables_flat(grid, dh, device=dev)
    args = {
        "qk": (tables, gamma, grid, layout, h, 1e-6, 1e-6),
        "strided": (tables, gamma, grid, layout, h, 1e-6, 1e-6),
        "qk_nope_bf16_island": (tables, gamma, grid, layout, h, 1e-6, 1e-6, _BF16, _BF16, True),
        "v": (None, None, grid, layout, h),
        "no_rope": (None, gamma, grid, layout, h, 1e-6, 1e-6, None, _F32, False),
    }[form]
    before = mhla_block.launches["blockify_island"]
    got = mhla_block.blockify_island(x, *args)
    assert mhla_block.launches["blockify_island"] == before + 1
    ref = mhla_block.blockify_island_plain(x, *args)
    for r, g in zip(ref, got):
        assert (r is None) == (g is None)
        if r is not None:
            assert g.dtype == r.dtype
            assert_close(f"blockify_island {form}", r, g, KERNEL_TOL)


@pytest.mark.parametrize("in_dt,mid,out_dt", [(_F32, _BF16, _BF16), (_BF16, None, _BF16),
                                              (_F32, None, _F32)])
def test_unblockify_island_kernel_matches_plain(dev, in_dt, mid, out_dt):
    grid, layout, h, dh = (21, 12, 10), (3, 2, 2), 2, 128
    xb = _randn(dev, 2, 12, 210, h * dh).to(in_dt)
    g = 1 + 0.1 * _randn(dev, dh, seed=1)
    before = mhla_block.launches["unblockify_island"]
    got = mhla_block.unblockify_island(xb, g, grid, layout, h, 1e-6, mid, out_dt)
    assert mhla_block.launches["unblockify_island"] == before + 1
    ref = mhla_block.unblockify_island_plain(xb, g, grid, layout, h, 1e-6, mid, out_dt)
    assert got.dtype == out_dt
    assert_close("unblockify_island", ref, got, KERNEL_TOL)


@pytest.mark.parametrize("dtype", [_F32, _BF16])
@pytest.mark.parametrize("n,c", [(150, 210), (8, 24), (33, 1)])
def test_dense_mix_and_readout_kernels_match_plain(dev, dtype, n, c):
    """K6 and K7 at the video model's N = 150 blocks of C = 210 tokens
    (neither a multiple of a tile) and at small sizes."""
    b, h, dk = 2, 2, 128
    m = torch.rand(n, n, generator=torch.Generator(dev).manual_seed(2), device=dev)
    states = _randn(dev, b, n, h * dk, dk, seed=3).to(dtype)
    q4 = torch.relu(_randn(dev, b, n, c, h * dk, seed=4)).to(dtype)
    before = dict(mhla_block.launches)
    mixed = mhla_block.mix_states_dense(m, states)
    out = mhla_block.block_readout(q4, mixed, h)
    assert mhla_block.launches["mix_states_dense"] == before["mix_states_dense"] + 1
    assert mhla_block.launches["block_readout"] == before["block_readout"] + 1
    mixed_ref = mhla_block.mix_states_dense_plain(m, states)
    assert_close("mix_states_dense", mixed_ref, mixed, KERNEL_TOL)
    assert_close("block_readout", mhla_block.block_readout_plain(q4, mixed_ref, h), out,
                 KERNEL_TOL)


@pytest.mark.parametrize("normalize", [False, True])
def test_blockwise_fused_op_matches_the_einsum_op(dev, normalize):
    b, n, c, h, d = 1, 8, 24, 2, 128
    q, k = (torch.relu(_randn(dev, b, n, c, h * d, seed=s)) + 1e-6 for s in (1, 2))
    v = _randn(dev, b, n, c, h * d, seed=3)
    m = torch.from_numpy(block_mixing_matrix((2, 2, 2))).to(dev)
    out = mhla_block.mhla_blockwise_fused(q, k, v, m, h, normalize=normalize)
    ref = mhla_block.mhla_blockwise_fused(q.cpu(), k.cpu(), v.cpu(), m.cpu(), h,
                                          normalize=normalize)
    assert_close("mhla_blockwise_fused", ref, out, 1e-5)  # float32 island


@pytest.mark.parametrize("tq,tk", [(3000, 512), (1000, 1000), (70, 33), (1, 5), (64, 129)])
def test_flash_attention_kernel_matches_plain(dev, tq, tk):
    """K9 for Tq != Tk and Tq == Tk, multiples of no tile: rows past Tq are
    not stored and keys past Tk receive no mass (FLASH_TOL in chip_smoke.py)."""
    import chip_smoke

    q, k, v = (_randn(dev, 2, t, 3, 128, seed=s).to(_BF16) for s, t in ((1, tq), (2, tk), (3, tk)))
    before = flash.launches["flash_attention"]
    out = flash.flash_attention(q, k, v)
    assert flash.launches["flash_attention"] == before + 1
    assert_close(f"flash {tq}x{tk}", flash.flash_attention_plain(q, k, v), out,
                 chip_smoke.FLASH_TOL)
    # against float32 softmax attention: bf16 rounding of the probabilities and the output
    ref = flash.flash_attention_plain(q.float(), k.float(), v.float())
    assert_close(f"flash {tq}x{tk} vs float32", ref, out, 1e-2)


def test_flash_attention_kernel_at_long_equal_lengths(dev):
    """K9 at Tq = Tk past 8,192 (the plain version walks the rows in blocks)
    and no multiple of the tile."""
    import chip_smoke

    q, k, v = (_randn(dev, 1, 9001, 2, 128, seed=s).to(_BF16) for s in (1, 2, 3))
    out = flash.flash_attention(q, k, v)
    assert_close("flash 9001 x 9001", flash.flash_attention_plain(q, k, v, block_rows=2000), out,
                 chip_smoke.FLASH_TOL)


# frames x tokens per frame: below, at and above the 64-token tile; T a
# multiple of the tile and not; enough frames for windows of 1/2, 1/4, 1/8, 1/16
@pytest.mark.parametrize("frames,hw", [(6, 7), (5, 100), (3, 64), (4, 640), (8, 568), (21, 150),
                                       (40, 3)])
def test_radial_flash_kernel_matches_plain(dev, frames, hw):
    """K10: full tiles (no mask work), masked tiles, tiles that are wholly
    masked for some rows, rows past T and keys past T."""
    import chip_smoke

    t = frames * hw
    q, k, v = (_randn(dev, 2, t, 3, 128, seed=s).to(_BF16) for s in (1, 2, 3))
    before = sparse.launches["radial_flash_attention"]
    out = sparse.sparse_flash_attention(q, k, v, frames)
    assert sparse.launches["radial_flash_attention"] == before + 1
    assert out.dtype == _BF16 and torch.isfinite(out.float()).all()
    assert_close(f"radial {frames}x{hw}", sparse.radial_flash_attention_plain(q, k, v, frames),
                 out, chip_smoke.FLASH_TOL)
    # against float32 masked softmax attention: bf16 rounding of the probabilities and the output
    ref = sparse.radial_flash_attention_plain(q.float(), k.float(), v.float(), frames)
    assert_close(f"radial {frames}x{hw} vs float32", ref, out, 1e-2)
    # float32 inputs stream as bf16 and come back as float32
    out32 = sparse.sparse_flash_attention(q.float(), k.float(), v.float(), frames)
    assert out32.dtype == _F32 and torch.equal(out32, out.float())
    if frames >= 4:  # the mask bites: dense attention differs
        assert not torch.allclose(out.float(), flash.flash_attention(q, k, v).float(), atol=1e-2)


def test_radial_wrapper_raises_instead_of_falling_back(dev):
    q = torch.zeros(1, 128, 2, 128, device=dev)
    with pytest.raises(TypeError):  # float32 streams: the kernel takes bf16
        sparse.sparse_flash_attention(q, q, q, 4, compute_dtype=_F32)
    with pytest.raises(TypeError):
        sparse.radial_flash_attention(q, q, q, 4)
    z = torch.zeros(1, 128, 2, 64, dtype=_BF16, device=dev)
    with pytest.raises(ValueError):  # head dim 64
        sparse.radial_flash_attention(z, z, z, 4)
    with pytest.raises(ValueError):  # tensors on several devices
        sparse.radial_flash_attention(q.to(_BF16), q.to(_BF16).cpu(), q.to(_BF16), 4)
    with pytest.raises(NotImplementedError):
        sparse.sparse_flash_attention(q.to(_BF16), q.to(_BF16), q.to(_BF16), 5)


def test_video_wrappers_raise_instead_of_falling_back(dev):
    q = torch.zeros(1, 8, 2, 128, device=dev)
    with pytest.raises(TypeError):  # float32: the kernel takes bf16
        flash.flash_attention(q, q, q)
    with pytest.raises(ValueError):  # head dim 64
        z = torch.zeros(1, 8, 2, 64, dtype=_BF16, device=dev)
        flash.flash_attention(z, z, z)
    with pytest.raises(ValueError):  # more blocks than K6 keeps rows for
        mhla_block.mix_states_dense(torch.zeros(300, 300, device=dev),
                                    torch.zeros(1, 300, 128, 128, device=dev))
    with pytest.raises(TypeError):
        x = torch.zeros(1, 2, 8, 256, dtype=torch.float16, device=dev)
        mhla_block.block_readout(x, torch.zeros(1, 2, 256, 128, dtype=torch.float16, device=dev), 2)
    with pytest.raises(ValueError):  # head dim 96: Dh/2 is no power of two
        mhla_block.blockify_island(torch.zeros(1, 64, 192, device=dev), None, None,
                                   (4, 4, 4), (2, 2, 2), 2)
    with pytest.raises(ValueError):  # tensors on several devices
        mhla_block.unblockify_island(torch.zeros(1, 8, 8, 256, device=dev), torch.ones(128),
                                     (4, 4, 4), (2, 2, 2), 2)


@pytest.mark.parametrize("island", [None, _BF16])
def test_tiny_wan_samples_through_the_kernels(dev, island):
    """bf16 compute over float32 parameters, 2,048 tokens (the flash route)
    in 8 blocks: two sampler steps launch every video kernel the expected
    number of times, and one forward through the kernels agrees with the
    same forward through their plain versions."""
    import chip_smoke

    cfg = build_wan_config(num_layers=2, dim=256, num_heads=2, ffn_dim=512, text_len=128,
                           text_dim=64, linear_attn_idx=(0, 1), block_layout=(2, 2, 2),
                           dtype=_BF16, attn_compute_dtype=island)
    model = init_wan_params(WanModel(cfg, device=dev), torch.Generator(dev).manual_seed(0)).eval()
    text = _randn(dev, 1, 128, 64)
    kernels.reset_launch_counts()
    latents = sample_video_latents(model, text, latent_shape=(8, 32, 32, 16), num_steps=2)
    counts = kernels.launch_counts()
    assert torch.isfinite(latents).all() and latents.shape == (1, 8, 32, 32, 16)
    want = {name: 2 * 2 * per for name, per in chip_smoke.VIDEO_KERNELS.items()}
    assert {name: counts[name] for name in want} == want
    x, t = _randn(dev, 2, 8, 32, 32, 16, seed=1), torch.full((2,), 500.0, device=dev)
    ctx = text.expand(2, -1, -1)
    with torch.no_grad():
        got = model(x, t, ctx)
        with chip_smoke.plain_kernels():
            ref = model(x, t, ctx)
    assert kernels.launch_counts()["flash_attention"] == want["flash_attention"] + 2
    assert_close("tiny Wan kernels vs plain", ref, got, chip_smoke.VIDEO_TOL)


def test_tiny_hybrid_wan_samples_through_the_kernels(dev):
    """Layers mhla_uni, sparse, flash over 2,048 tokens in 8 frames: four
    sampler steps with shift 3.0 cross the sparse layer's dense guard (t x
    1000 = 1000, 900, 750, 501), so K10 launches in two of them and K9 takes
    its place in the other two; the forward below the guard agrees with the
    same forward through the plain versions, the one above it equals the
    model without ``sparse_attn_idx``."""
    import dataclasses

    import chip_smoke

    cfg = build_wan_config(num_layers=3, dim=256, num_heads=2, ffn_dim=512, text_len=128,
                           text_dim=64, linear_attn_idx=(0,), sparse_attn_idx=(1,),
                           block_layout=(2, 2, 2), dtype=_BF16)
    model = init_wan_params(WanModel(cfg, device=dev), torch.Generator(dev).manual_seed(0)).eval()
    text = _randn(dev, 1, 128, 64)
    kernels.reset_launch_counts()
    latents = sample_video_latents(model, text, latent_shape=(8, 32, 32, 16), num_steps=4,
                                   flow_shift=3.0)
    counts = kernels.launch_counts()
    assert torch.isfinite(latents).all()
    assert counts["radial_flash_attention"] == 2
    assert counts["flash_attention"] == 4 * 3 + 4 + 2  # cross, the flash layer, the guarded calls
    assert counts["blockify_island"] == 4 * 3 and counts["block_readout"] == 4
    x, ctx = _randn(dev, 2, 8, 32, 32, 16, seed=1), text.expand(2, -1, -1)
    dense = WanModel(dataclasses.replace(cfg, sparse_attn_idx=None), device=dev).eval()
    dense.load_state_dict(model.state_dict())
    with torch.no_grad():
        low, high = torch.full((2,), 501.0, device=dev), torch.full((2,), 900.0, device=dev)
        got = model(x, low, ctx)
        with chip_smoke.plain_kernels():
            ref = model(x, low, ctx)
        assert_close("tiny hybrid kernels vs plain", ref, got, chip_smoke.VIDEO_TOL)
        assert torch.equal(model(x, high, ctx), dense(x, high, ctx))
        assert not torch.equal(got, dense(x, low, ctx))
