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
    with pytest.raises(ValueError):  # beyond the 832 slots the strip form stages
        mhla_chunk.mix_states(torch.zeros(900, 900, device=dev),
                              torch.zeros(1, 900, 16, 128, dtype=torch.bfloat16, device=dev))


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


@pytest.mark.parametrize("b,t", [(1, 781), (2, 2048), (1, 16384)])
def test_backward_chunk_kernels_match_plain(dev, b, t):
    """K4b, K3b and K2b against their plain versions at a ragged last
    chunk, at training rows and at the long-context row (256 chunks); K2b
    bit for bit over two runs."""
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
    again = mhla_chunk.chunk_states_bwd(k4, v4, ref[0], dk_i, dv_i, h)
    assert all(torch.equal(g, a) for g, a in zip(got, again))
    for name in ("chunk_output_bwd", "mix_states_bwd"):
        assert mhla_chunk.launches[name] == before[name] + 1
    assert mhla_chunk.launches["chunk_states_bwd"] == before["chunk_states_bwd"] + 2


@pytest.mark.parametrize("dk,dv,c,t", [(64, 128, 64, 300), (128, 256, 16, 200),
                                       (128, 256, 48, 500), (128, 128, 80, 333),
                                       (256, 512, 64, 256), (256, 256, 32, 100),
                                       (16, 128, 64, 130), (32, 128, 64, 300),
                                       (96, 256, 64, 500), (192, 256, 48, 333)])
def test_chunk_states_bwd_kernel_forms_match_plain(dev, dk, dv, c, t):
    """K2b at each key tile it instantiates (64, 128, 256) and at head dims
    between them that it pads (16, 32, 96, 192), Dv of one to four
    128-column pieces, chunks below and above its 64-row items, and a last
    chunk that ends past the tokens, with bf16 intra terms added; the same
    bits twice."""
    h, bf16 = 2, torch.bfloat16
    n = -(-t // c)
    k4, v4, dk_i, dv_i = (_randn(dev, 2, n, c, h * d, seed=s).to(bf16)
                          for s, d in ((1, dk), (2, dv), (3, dk), (4, dv)))
    ds4 = _randn(dev, 2, n, h * dk, dv, seed=5).to(bf16)
    before = mhla_chunk.launches["chunk_states_bwd"]
    got = mhla_chunk.chunk_states_bwd(k4, v4, ds4, dk_i, dv_i, h)
    want = mhla_chunk.chunk_states_bwd_plain(k4, v4, ds4, dk_i, dv_i, h)
    for name, r, g in zip(("dk", "dv"), want, got):
        assert_close(f"chunk_states_bwd {name} Dk={dk} Dv={dv} C={c}", r, g, KERNEL_TOL)
    again = mhla_chunk.chunk_states_bwd(k4, v4, ds4, dk_i, dv_i, h)
    assert all(torch.equal(g, a) for g, a in zip(got, again))
    assert mhla_chunk.launches["chunk_states_bwd"] == before + 2


def test_chunk_states_bwd_refuses_head_dims_it_lacks(dev):
    """K2b's widest key tile is 256: Dk = 272 raises."""
    x = torch.zeros(1, 2, 64, 2 * 272, dtype=torch.bfloat16, device=dev)
    y = torch.zeros(1, 2, 64, 2 * 128, dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError):
        mhla_chunk.chunk_states_bwd(x, y, torch.zeros(1, 2, 2 * 272, 128, dtype=torch.bfloat16,
                                                     device=dev), x, y, 2)


# (batch rows, chunks, Dk, Dv, chunk size) of K2's card cases: one 781-token
# row (13 chunks), (a)'s 4 x 1984 (31) and (c)'s 8 x 2048 (32), each at
# every key head dim of the set, Dv and C taken in turn; then chunks longer
# than a slab of 64 rows (the kernel it replaced took any C % 16)
_K2_CASES = [(b, n, dk, (128, 256, 512)[i % 3], (16, 32, 64)[(i + j) % 3])
             for j, (b, n) in enumerate([(1, 13), (4, 31), (8, 32)])
             for i, dk in enumerate((16, 96, 128, 272, 384))] + \
            [(2, 3, 128, 256, 80), (2, 3, 128, 256, 128)]


@pytest.mark.parametrize("b,n,dk,dv,c", _K2_CASES)
def test_chunk_states_kernel_forms_match_plain(dev, b, n, dk, dv, c):
    """K2 at key head dims below, between and above its 128-row items (16,
    96, 128, 272, 384: zero-filled boxes and rows not stored), Dv of one to
    four 128-column panels and chunks of 16 to 128 rows (zero-filled slab
    rows; two slabs summed), at the main path's batch rows and chunk counts;
    the same bits twice."""
    h = 2
    k4 = _randn(dev, b, n, c, h * dk, seed=1).to(_BF16)
    v4 = _randn(dev, b, n, c, h * dv, seed=2).to(_BF16)
    before = mhla_chunk.launches["chunk_states"]
    got = mhla_chunk.chunk_states(k4, v4, h)
    assert got.shape == (b, n, h * dk, dv)
    assert_close(f"chunk_states Dk={dk} Dv={dv} C={c}", mhla_chunk.chunk_states_plain(k4, v4, h),
                 got, KERNEL_TOL)
    assert torch.equal(got, mhla_chunk.chunk_states(k4, v4, h))
    assert mhla_chunk.launches["chunk_states"] == before + 2


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
    big = torch.zeros(1, 900, 16, 128, dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError):  # beyond the 832 slots the strip form stages
        mhla_chunk.mix_states_bwd(torch.zeros(900, 900, device=dev), big, big)
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
    tol = K6_F32_TOL if dtype == _F32 else KERNEL_TOL
    assert_close("mix_states_dense", mixed_ref, mixed, tol)
    assert_close("block_readout", mhla_block.block_readout_plain(q4, mixed_ref, h), out, tol)


@pytest.mark.parametrize("dtype", [_F32, _BF16])
@pytest.mark.parametrize("n,c", [(150, 210), (8, 24), (33, 1)])
@pytest.mark.parametrize("dk,dv", [(128, 128), (256, 128), (128, 256), (256, 256)])
def test_block_readout_kernel_on_tf32_tensor_cores(dev, dtype, n, c, dk, dv):
    """K7 at both head dims it takes (Dk = 256: items of 64 columns of Dv in
    float32) and at two item column groups (Dv = 256): float32 within
    K6_F32_TOL of its plain version (three TF32 products), bf16 within
    KERNEL_TOL, the same bits over two runs, one launch a call."""
    b, h = 2, 2
    q4 = torch.relu(_randn(dev, b, n, c, h * dk, seed=4)).to(dtype)
    mixed = _randn(dev, b, n, h * dk, dv, seed=3).to(dtype)
    before = mhla_block.launches["block_readout"]
    first = mhla_block.block_readout(q4, mixed, h)
    assert mhla_block.launches["block_readout"] == before + 1
    assert first.dtype == dtype and first.shape == (b, n, c, h * dv)
    assert torch.equal(first, mhla_block.block_readout(q4, mixed, h))
    assert_close(f"block_readout Dk={dk} Dv={dv}", mhla_block.block_readout_plain(q4, mixed, h),
                 first, K6_F32_TOL if dtype == _F32 else KERNEL_TOL)


# K6's float32 form against its plain version (float32 einsum, TF32 off):
# three TF32 products carry float32 accuracy (2.2e-7 in relative RMS against
# float64 at N = 150); one TF32 product alone would be about 3e-4 off.
K6_F32_TOL = 1e-5


@pytest.mark.parametrize("dtype", [_F32, _BF16])
@pytest.mark.parametrize("n", [8, 150, 224])
@pytest.mark.parametrize("transposed", [False, True])
def test_dense_mix_kernel_on_tf32_tensor_cores(dev, dtype, n, transposed):
    """K6 at N = 8 (the second block of each cluster of two holding no row
    of M), 150 (the video model's) and 224 (clusters of four) on M and, as the
    backward takes it, on M^T: float32 within K6_F32_TOL of its plain
    version, bf16 within KERNEL_TOL, the same bits over two runs, one launch
    a call."""
    from mhla_tpu_torch.ops import block_mixing_matrix

    m = torch.rand(n, n, generator=torch.Generator(dev).manual_seed(n), device=dev)
    if n == 150:
        m = torch.from_numpy(block_mixing_matrix((3, 5, 10))).to(dev)
    if transposed:
        m = m.T.contiguous()
    states = _randn(dev, 2, n, 4 * 128, 96, seed=n + 1).to(dtype)
    before = mhla_block.launches["mix_states_dense"]
    first = mhla_block.mix_states_dense(m, states)
    assert mhla_block.launches["mix_states_dense"] == before + 1
    assert first.dtype == dtype and first.shape == states.shape
    assert torch.equal(first, mhla_block.mix_states_dense(m, states))
    tol = K6_F32_TOL if dtype == _F32 else KERNEL_TOL
    assert_close(f"mix_states_dense N={n}", mhla_block.mix_states_dense_plain(m, states), first,
                 tol)


def test_dense_mix_kernel_takes_ragged_state_sizes(dev):
    """K6 at a state size that ends mid-item (R = 2,080: 8 items of 256
    columns and one of 32) and at one batch row."""
    m = torch.rand(33, 33, generator=torch.Generator(dev).manual_seed(4), device=dev)
    states = _randn(dev, 1, 33, 65, 32, seed=5)
    got = mhla_block.mix_states_dense(m, states)
    assert_close("mix_states_dense R=2080", mhla_block.mix_states_dense_plain(m, states), got,
                 K6_F32_TOL)


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


# frames x tokens per frame: below the 128-key tile (each column's frame in
# turn) and above it (two windows a row); T a multiple of the tile and not;
# enough frames for windows of 1/2, 1/4, 1/8, 1/16
@pytest.mark.parametrize("frames,hw", [(6, 7), (5, 100), (3, 64), (4, 640), (8, 568), (21, 150),
                                       (40, 3)])
def test_radial_flash_kernel_matches_plain(dev, frames, hw):
    """K10: full tiles (no mask work), masked tiles, tiles that are wholly
    masked for some rows, rows past T and keys past T; the tiles walked
    (``visits``) are the lists' and two runs give the same bits."""
    import chip_smoke

    t = frames * hw
    q, k, v = (_randn(dev, 2, t, 3, 128, seed=s).to(_BF16) for s in (1, 2, 3))
    before = sparse.launches["radial_flash_attention"]
    out = sparse.sparse_flash_attention(q, k, v, frames)
    assert sparse.launches["radial_flash_attention"] == before + 1
    visits = torch.zeros(1, dtype=torch.int32, device=dev)
    again = sparse.radial_flash_attention(q, k, v, frames, visits=visits)
    assert torch.equal(again, out)
    assert visits.item() == sparse.radial_fwd_visits(t, frames, 3, 2)
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
    qb = q.to(_BF16)
    with pytest.raises(ValueError):  # the radial route's own demand: whole frames
        sparse.sparse_flash_attention(qb, qb, qb, 5, impl="radial")
    with pytest.raises(ValueError):  # more frames than tokens
        sparse.radial_flash_attention(qb, qb, qb, 129)
    with pytest.raises(TypeError):  # float32 gradient streams
        sparse.radial_flash_attention_bwd(qb, qb, qb, qb, torch.zeros(1, 2, 128, device=dev), q, 4)
    with pytest.raises(ValueError):  # lse of another shape
        sparse.radial_flash_attention_bwd(qb, qb, qb, qb, torch.zeros(1, 128, 2, device=dev), qb, 4)


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
    with pytest.raises(ValueError):  # head dim 384: K7 takes Dk = 128 or 256
        x = torch.zeros(1, 2, 8, 768, device=dev)
        mhla_block.block_readout(x, torch.zeros(1, 2, 768, 128, device=dev), 2)
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


# ---------------------------------------------------------------------------
# video training: K5b, K8b, K7b, K9b
# ---------------------------------------------------------------------------


# odd partitions (7, 6, 5); even ones; 3 and 33 blocks (N * N no multiple of 4);
# Wan2.1-1.3B's token grid at its width (12 heads of 128, runs of 5 tokens)
_WAN_PERMUTE = ((21, 30, 50), (3, 5, 10))


@pytest.mark.parametrize("grid,layout", [((21, 12, 10), (3, 2, 2)), ((4, 4, 8), (2, 2, 2)),
                                         ((3, 4, 4), (3, 1, 1)), ((3, 11, 2), (3, 11, 1)),
                                         _WAN_PERMUTE])
@pytest.mark.parametrize("form", ["rope_bf16_to_f32", "plain_f32", "neg_sin_add", "strided"])
def test_blockify_and_unblockify_kernels_match_plain(dev, grid, layout, form):
    """K8b and K5b: the permutation in both directions, with and without
    RoPE, reading bf16 or float32 and writing float32, K5b also with the
    second tensor summed in; K8b on a column range of a wider tensor. Both
    bit-equal over two runs."""
    h, dh = (12 if (grid, layout) == _WAN_PERMUTE else 2), 128
    b = 1 if (grid, layout) == _WAN_PERMUTE else 2
    n, t = layout[0] * layout[1] * layout[2], grid[0] * grid[1] * grid[2]
    tables = None if form == "plain_f32" else rope_tables_flat(grid, dh, device=dev)
    in_dt = _F32 if form == "plain_f32" else _BF16
    sign = -1.0 if form == "neg_sin_add" else 1.0
    x = _randn(dev, b, t, 3 * h * dh).to(in_dt)
    x = x[..., h * dh: 2 * h * dh] if form == "strided" else x[..., : h * dh].contiguous()
    xb = _randn(dev, b, n, t // n, h * dh, seed=1).to(in_dt)
    add = _randn(dev, b, n, t // n, h * dh, seed=2).to(in_dt) if form == "neg_sin_add" else None
    before = dict(mhla_block.launches)
    got_b = mhla_block.blockify(x, tables, grid, layout, h, sign, _F32)
    got_u = mhla_block.unblockify(xb, tables, grid, layout, h, sign, _F32, add)
    assert mhla_block.launches["blockify"] == before["blockify"] + 1
    assert mhla_block.launches["unblockify"] == before["unblockify"] + 1
    assert got_b.dtype == _F32 and got_u.dtype == _F32
    assert_close(f"blockify {form}",
                 mhla_block.blockify_plain(x, tables, grid, layout, h, sign, _F32), got_b, 1e-6)
    assert_close(f"unblockify {form}",
                 mhla_block.unblockify_plain(xb, tables, grid, layout, h, sign, _F32, add),
                 got_u, 1e-6)
    assert torch.equal(got_b, mhla_block.blockify(x, tables, grid, layout, h, sign, _F32))
    assert torch.equal(got_u, mhla_block.unblockify(xb, tables, grid, layout, h, sign, _F32, add))


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("form", ["odd_bf16_column", "rows_of_24_bytes", "fp16_head_dim_8"])
def test_permute_kernel_moves_unaligned_rows_itself(dev, form, inverse):
    """K8b / K5b where a bulk copy cannot take a row: a flat side at an odd
    2-byte column offset in bf16 (K8b's x; K5b's out from a blocked tensor
    read the same way is contiguous, so K5b runs aligned there), rows of
    24 bytes (head dim 2: the one-element path too) and fp16 rows of head
    dim 8, each against the plain version, with RoPE."""
    grid, layout = (3, 11, 2), (3, 11, 1)
    n, t = 33, 66
    h, dh, dt = {"odd_bf16_column": (2, 128, _BF16), "rows_of_24_bytes": (3, 2, _F32),
                 "fp16_head_dim_8": (3, 8, torch.float16)}[form]
    f = h * dh
    tables = rope_tables_flat(grid, dh, device=dev)
    if inverse:
        x = _randn(dev, 2, n, t // n, f).to(dt)
        add = _randn(dev, 2, n, t // n, f, seed=3).to(dt)
        got = mhla_block.unblockify(x, tables, grid, layout, h, -1.0, _F32, add)
        ref = mhla_block.unblockify_plain(x, tables, grid, layout, h, -1.0, _F32, add)
    else:
        x = _randn(dev, 2, t, f + 1).to(dt)[..., 1:]
        if form == "odd_bf16_column":
            assert x.data_ptr() % 16 == 2
            assert not mhla_block._permute_flags(x, None, tables, x, False) & mhla_block._BULK_X
        got = mhla_block.blockify(x, tables, grid, layout, h, 1.0, dt)
        ref = mhla_block.blockify_plain(x, tables, grid, layout, h, 1.0, dt)
    torch.cuda.synchronize()
    assert_close(f"permute {form}", ref.float(), got.float(), 1e-6)


def test_permute_kernel_runs_on_bulk_copies_and_no_triton(dev, monkeypatch):
    """K5b / K8b's kernels (``permute_kernel``, both instantiations) hold the
    bulk copy (UBLKCP, ``cp.async.bulk``) and no tensor-core product; the
    wrappers launch no Triton kernel (Triton cannot even load)."""
    found = 0
    for fn, text in _sass_bodies().items():
        if "permute_kernel" in fn:
            assert "UBLKCP" in text, fn
            assert "HGMMA" not in text and " HMMA" not in text, fn
            found += 1
    assert found == 2
    monkeypatch.setattr(mhla_block, "_load_triton", lambda: pytest.fail("Triton loaded"))
    grid, layout = (3, 11, 2), (3, 11, 1)
    tables = rope_tables_flat(grid, 128, device=dev)
    xb = _randn(dev, 1, 33, 2, 256)
    out = mhla_block.unblockify(xb, tables, grid, layout, 2, -1.0, _F32, xb)
    back = mhla_block.blockify(out, None, grid, layout, 2)
    torch.cuda.synchronize()
    assert back.shape == xb.shape


@pytest.mark.parametrize("dtype", [_F32, _BF16])
@pytest.mark.parametrize("n,c,dk", [(150, 210, 128), (8, 24, 128), (33, 1, 128), (3, 40, 256),
                                    (150, 210, 256), (8, 24, 256), (33, 1, 256)])
def test_block_readout_bwd_kernel_matches_plain(dev, dtype, n, c, dk):
    """K7b at the video model's 150 blocks of 210 tokens (neither a multiple
    of a tile), at small sizes and at Dk = 256 (four 64-row items of Dk a
    block and head): float32 within K6_F32_TOL of its plain version (three
    TF32 products each), bf16 within KERNEL_TOL, the same bits over two
    runs."""
    b, h, dv = 2, 2, 128
    q4 = torch.relu(_randn(dev, b, n, c, h * dk, seed=4)).to(dtype)
    mixed = _randn(dev, b, n, h * dk, dv, seed=3).to(dtype)
    do4 = _randn(dev, b, n, c, h * dv, seed=5).to(dtype)
    before = mhla_block.launches["block_readout_bwd"]
    dq, dmixed = mhla_block.block_readout_bwd(q4, mixed, do4, h)
    assert mhla_block.launches["block_readout_bwd"] == before + 1
    ref_dq, ref_dm = mhla_block.block_readout_bwd_plain(q4, mixed, do4, h)
    assert dq.dtype == dtype and dmixed.dtype == dtype
    again = mhla_block.block_readout_bwd(q4, mixed, do4, h)
    assert torch.equal(dq, again[0]) and torch.equal(dmixed, again[1])
    tol = K6_F32_TOL if dtype == _F32 else KERNEL_TOL
    assert_close("block_readout_bwd dq", ref_dq, dq, tol)
    assert_close("block_readout_bwd dmixed", ref_dm, dmixed, tol)


@pytest.mark.parametrize("tq,tk", [(3000, 512), (1000, 1000), (70, 33), (1, 5), (64, 129),
                                   (200, 1)])
def test_flash_attention_bwd_kernel_matches_plain(dev, tq, tk):
    """K9b for Tq != Tk and Tq == Tk, multiples of no tile, and one key:
    against the plain backward on the kernel forward's own output and
    log-sum-exp, against float32 autograd of softmax attention, and equal
    across two runs (no atomics)."""
    import chip_smoke

    q, k, v = (_randn(dev, 2, t, 3, 128, seed=s).to(_BF16) for s, t in ((1, tq), (2, tk), (3, tk)))
    do = _randn(dev, 2, tq, 3, 128, seed=4).to(_BF16)
    out, lse = flash._flash_fwd(q, k, v, None, want_lse=True)
    assert torch.equal(out, flash.flash_attention(q, k, v))  # the serving form, without lse
    _, lse_ref = flash.flash_attention_plain(q, k, v, return_lse=True)
    assert_close("lse", lse_ref, lse, 1e-5)
    before = flash.launches["flash_attention_bwd"]
    got = flash.flash_attention_bwd(q, k, v, out, lse, do)
    assert flash.launches["flash_attention_bwd"] == before + 1
    ref = flash.flash_attention_bwd_plain(q, k, v, out, lse, do)
    for name, r, g in zip(("dq", "dk", "dv"), ref, got):
        assert g.dtype == _BF16 and g.shape == r.shape
        if name != "dv" and tk == 1:  # one key: P = 1, dS = 0, so dq and dk are rounding noise
            assert g.abs().max() < 1e-5 and r.abs().max() < 1e-5
            continue
        assert_close(f"flash bwd {name} {tq}x{tk}", r, g, chip_smoke.FLASH_BWD_TOL)
    again = flash.flash_attention_bwd(q, k, v, out, lse, do)
    assert all(torch.equal(a, g) for a, g in zip(again, got))
    # through the autograd Function, against float32 autograd of softmax attention
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    (flash.flash_attention(*leaves).float() * do.float()).sum().backward()
    f32 = [x.float().requires_grad_() for x in (q, k, v)]
    (flash.flash_attention_plain(*f32) * do.float()).sum().backward()
    for name, r, g in zip(("dq", "dk", "dv"), f32, leaves):
        if name == "dv" or tk > 1:
            assert_close(f"flash grad {name} {tq}x{tk} vs float32", r.grad, g.grad, 2e-2)


# (tokens, frames): T a multiple of the 64-token tile and not; one frame; frames
# of one token; ragged frames whose tail is shorter than a tile, longer than a
# frame (24 tokens in "5" frames are 6 frames of 4) and spread over many
# frames; the video model's frame count; tiles wholly masked for some rows
_RADIAL_TRAIN_SHAPES = [(256, 4), (437, 4), (500, 5), (100, 1), (40, 40), (24, 5), (29, 10),
                        (323, 5), (1983, 21), (4544, 8)]


@pytest.mark.parametrize("t,frames", _RADIAL_TRAIN_SHAPES)
@pytest.mark.parametrize("b,h", [(2, 3), (1, 1)])
def test_radial_flash_training_kernels_match_plain(dev, t, frames, b, h):
    """K10 in its training form (the serving form's output bit for bit, plus
    the masked log-sum-exp; the tiles walked are its lists') and K10b on the kernel forward's own output,
    against their plain versions, at even and ragged frames; K10b equal across
    two runs; the gradients through ``sparse_flash_attention`` against float32
    autograd of the masked softmax, in the inputs' dtype."""
    import chip_smoke

    q, k, v, do = (_randn(dev, b, t, h, 128, seed=s).to(_BF16) for s in (1, 2, 3, 4))
    before = dict(sparse.launches)
    visits = torch.zeros(1, dtype=torch.int32, device=dev)
    out, lse = sparse.radial_flash_attention(q, k, v, frames, return_lse=True, visits=visits)
    assert visits.item() == sparse.radial_fwd_visits(t, frames, h, b)
    assert torch.equal(out, sparse.radial_flash_attention(q, k, v, frames))
    ref_out, ref_lse = sparse.radial_flash_attention_plain(q, k, v, frames, return_lse=True)
    assert_close(f"radial {t}/{frames}", ref_out, out, chip_smoke.FLASH_TOL)
    assert lse.shape == (b, h, t) and torch.isfinite(lse).all()
    assert_close("masked lse", ref_lse, lse, 1e-5)
    got = sparse.radial_flash_attention_bwd(q, k, v, out, lse, do, frames)
    assert sparse.launches == {"radial_flash_attention": before["radial_flash_attention"] + 2,
                               "radial_flash_attention_bwd":
                                   before["radial_flash_attention_bwd"] + 1}
    ref = sparse.radial_flash_attention_bwd_plain(q, k, v, out, lse, do, frames)
    for name, r, g in zip(("dq", "dk", "dv"), ref, got):
        assert g.dtype == _BF16 and g.shape == r.shape and torch.isfinite(g.float()).all()
        assert_close(f"radial bwd {name} {t}/{frames}", r, g, chip_smoke.FLASH_BWD_TOL)
    again = sparse.radial_flash_attention_bwd(q, k, v, out, lse, do, frames)
    assert all(torch.equal(a, g) for a, g in zip(again, got))
    # through the autograd Function from float32 leaves (bf16 streams inside),
    # against float32 autograd of the masked softmax
    leaves = [x.float().requires_grad_() for x in (q, k, v)]
    (sparse.sparse_flash_attention(*leaves, frames) * do.float()).sum().backward()
    f32 = [x.float().requires_grad_() for x in (q, k, v)]
    (sparse.radial_flash_attention_plain(*f32, frames) * do.float()).sum().backward()
    for name, r, g in zip(("dq", "dk", "dv"), f32, leaves):
        assert g.grad.dtype == _F32
        assert_close(f"radial grad {name} {t}/{frames} vs float32", r.grad, g.grad, 2e-2)


@pytest.mark.parametrize("t,frames", [(1536, 6), (437, 4)])
def test_radial_backward_walks_its_lists_on_the_hopper_kernels(dev, t, frames):
    """K10b, the radial form of K9b's kernels, at an even geometry (6 frames
    of 256) and a ragged one (4 frames of 109 and a last of 1): within
    FLASH_BWD_TOL of its plain version, the same bits over two runs, one
    launch a call, and its two kernels walk exactly the tiles of their
    lists (``radial_bwd_visits``)."""
    import chip_smoke

    b, h = 2, 3
    q, k, v, do = (_randn(dev, b, t, h, 128, seed=s).to(_BF16) for s in (1, 2, 3, 4))
    out, lse = sparse.radial_flash_attention(q, k, v, frames, return_lse=True)
    visits = torch.zeros(2, dtype=torch.int32, device=dev)
    before = sparse.launches["radial_flash_attention_bwd"]
    got = sparse.radial_flash_attention_bwd(q, k, v, out, lse, do, frames, visits=visits)
    assert sparse.launches["radial_flash_attention_bwd"] == before + 1
    assert visits.tolist() == sparse.radial_bwd_visits(t, frames, h, b)
    again = sparse.radial_flash_attention_bwd(q, k, v, out, lse, do, frames)
    assert all(torch.equal(x, y) for x, y in zip(got, again))
    ref = sparse.radial_flash_attention_bwd_plain(q, k, v, out, lse, do, frames)
    for name, r, g in zip(("dq", "dk", "dv"), ref, got):
        assert_close(f"radial bwd {name} {t}/{frames}", r, g, chip_smoke.FLASH_BWD_TOL)


def test_video_backward_wrappers_raise_instead_of_falling_back(dev):
    q = torch.zeros(1, 2, 8, 512, device=dev)  # head dim 256 = Dv: K7b takes Dv = 128
    with pytest.raises(ValueError):
        mhla_block.block_readout_bwd(q, torch.zeros(1, 2, 512, 256, device=dev), q, 2)
    with pytest.raises(TypeError):
        h16 = torch.zeros(1, 2, 8, 256, dtype=torch.float16, device=dev)
        mhla_block.block_readout_bwd(
            h16, torch.zeros(1, 2, 256, 128, dtype=torch.float16, device=dev), h16, 2)
    with pytest.raises(ValueError):  # blocked shape and geometry disagree
        mhla_block.unblockify(torch.zeros(1, 8, 9, 256, device=dev), None, (4, 4, 4), (2, 2, 2), 2)
    with pytest.raises(ValueError):  # head dim 96
        mhla_block.blockify(torch.zeros(1, 64, 192, device=dev), None, (4, 4, 4), (2, 2, 2), 2)
    z = torch.zeros(1, 8, 2, 128, device=dev)
    with pytest.raises(TypeError):  # float32: the kernel takes bf16
        flash.flash_attention_bwd(z, z, z, z, torch.zeros(1, 2, 8, device=dev), z)
    with pytest.raises(ValueError):  # lse of another shape
        zb = z.to(_BF16)
        flash.flash_attention_bwd(zb, zb, zb, zb, torch.zeros(1, 8, 2, device=dev), zb)


@pytest.mark.parametrize("norm_output", [False, True])
def test_tiny_wan_trains_through_the_kernels(dev, norm_output):
    """One step of the video trainer on a 3-layer hybrid model (softmax,
    MHLA, MHLA), bf16 compute over float32 parameters, 2,048 tokens (the
    flash route) in 8 blocks, per-block remat: every kernel launches the
    reckoned number of times, and the parameter gradients through the
    kernels agree with those through the plain versions. ``norm_output``
    adds the pre-RoPE copies, whose gradients K5b sums in."""
    import chip_smoke
    from mhla_tpu_torch.train import wan_train

    cfg = wan_train.parse_cli(wan_train.WanTrainConfig, [
        "--model.dim=256", "--model.ffn_dim=512", "--model.num_heads=2", "--model.num_layers=3",
        "--model.linear_attn_idx=(1,2)", "--model.block_layout=(2,2,2)",
        f"--model.norm_output={norm_output}", "--data.latent_frames=8",
        "--data.latent_height=32", "--data.latent_width=32", "--data.text_len=128",
        "--data.text_dim=64", "--optimizer.warmup_steps=1"])
    model, state, step, data = wan_train.build_training(cfg)
    z, c = next(data)
    batch = (torch.from_numpy(z).to(dev), torch.from_numpy(c).to(dev))
    kernels.reset_launch_counts()
    state, metrics = step(state, batch)
    counts = kernels.launch_counts()
    assert torch.isfinite(metrics["loss"]) and float(metrics["grad_norm"]) > 0
    want = chip_smoke.video_train_launches(mhla_layers=2, softmax_layers=1, steps=1)
    assert want["flash_attention"] == 2 * (3 + 1) and want["unblockify"] == 6
    assert {name: counts[name] for name in want} == want

    loss_fn = wan_train.make_loss_fn(cfg)

    def grads():
        for p in model.parameters():
            p.grad = None
        loss, _ = loss_fn(model, batch, torch.Generator(dev).manual_seed(5))
        loss.backward()
        return torch.cat([p.grad.flatten() for p in model.parameters()])

    got = grads()
    before = kernels.launch_counts()
    with chip_smoke.plain_kernels():
        ref = grads()
    assert kernels.launch_counts() == before
    # two bf16 runs of three layers, rounding at the same points: see VIDEO_TOL
    assert_close("tiny Wan gradients, kernels vs plain", ref, got, chip_smoke.VIDEO_TOL)


@pytest.mark.parametrize("lora", [False, True])
def test_tiny_sparse_wan_trains_through_the_kernels(dev, lora):
    """One step of the video trainer on a 3-layer model (radial-sparse
    softmax, MHLA, MHLA; 2,048 tokens in 8 frames), with and without LoRA:
    K10 launches twice under remat and K10b once, K9 and K9b only in the
    cross-attentions, and the gradients of what is trained agree with those
    through the plain versions; with LoRA nothing but the adapters moves."""
    import chip_smoke
    from mhla_tpu_torch.train import wan_train

    cfg = wan_train.parse_cli(wan_train.WanTrainConfig, [
        "--model.dim=256", "--model.ffn_dim=512", "--model.num_heads=2", "--model.num_layers=3",
        "--model.linear_attn_idx=(1,2)", "--model.sparse_attn_idx=(0,)",
        "--model.block_layout=(2,2,2)", "--data.latent_frames=8", "--data.latent_height=32",
        "--data.latent_width=32", "--data.text_len=128", "--data.text_dim=64",
        "--optimizer.warmup_steps=0", f"--lora.enable={lora}", "--lora.rank=4"])
    model, state, step, data = wan_train.build_training(cfg)
    assert [b.attn_type for b in model.blocks] == ["sparse", "mhla_uni", "mhla_uni"]
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    z, c = next(data)
    batch = (torch.from_numpy(z).to(dev), torch.from_numpy(c).to(dev))
    kernels.reset_launch_counts()
    state, metrics = step(state, batch)
    counts = kernels.launch_counts()
    assert torch.isfinite(metrics["loss"]) and float(metrics["grad_norm"]) > 0
    want = chip_smoke.video_train_launches(mhla_layers=2, softmax_layers=0, steps=1,
                                           sparse_layers=1)
    assert want["radial_flash_attention"] == 2 and want["radial_flash_attention_bwd"] == 1
    assert want["flash_attention"] == 2 * 3 and want["flash_attention_bwd"] == 3
    assert {name: counts[name] for name in want} == want
    for name, p in model.named_parameters():
        if lora and not p.requires_grad:
            assert torch.equal(p, before[name]), name

    loss_fn = wan_train.make_loss_fn(cfg)
    trained = [p for p in model.parameters() if p.requires_grad]
    assert len(trained) == (2 * 8 * 3 if lora else len(before))

    def grads():
        for p in trained:
            p.grad = None
        loss, _ = loss_fn(model, batch, torch.Generator(dev).manual_seed(5))
        loss.backward()
        return torch.cat([p.grad.flatten() for p in trained])

    got = grads()
    launched = kernels.launch_counts()
    with chip_smoke.plain_kernels():
        ref = grads()
    assert kernels.launch_counts() == launched
    assert_close("tiny sparse Wan gradients, kernels vs plain", ref, got, chip_smoke.VIDEO_TOL)


# ---------------------------------------------------------------------------
# LM on packed documents and the hybrid LM: per-row K1-K4b, masked K9 / K9b
# ---------------------------------------------------------------------------


def _doc_ids(lengths, t):
    """[t] int32 ids of documents of the given lengths back to back (the
    rest one more document)."""
    ids = torch.full((t,), len(lengths), dtype=torch.int32)
    pos = 0
    for i, n in enumerate(lengths):
        ids[pos:pos + n] = i
        pos += n
    return ids


def _seg_geometry(name):
    """(segment ids [B, T] on the CPU, heads) of one masked-flash geometry."""
    t = {"packed": 2048, "unaligned": 1000, "one_token": 130, "decreasing": 777,
         "repeated": 300, "bh1": 777, "one_tile": 64, "one": 1}[name]
    if name == "packed":  # the varlen packer's rows: chunk-aligned documents and pad runs
        return torch.stack([_doc_ids([448, 64, 640, 192, 576], t),
                            _doc_ids([1024, 960], t)]), 3
    if name == "unaligned":  # boundaries inside tiles, a last tile of 40
        return torch.stack([_doc_ids([10, 300, 1, 333], t), _doc_ids([999], t)]), 3
    if name == "one_token":  # every token its own segment
        return torch.arange(t, dtype=torch.int32).expand(2, t).contiguous(), 3
    if name == "decreasing":
        return ((t - torch.arange(t)) // 37).to(torch.int32).expand(2, t).contiguous(), 2
    if name == "repeated":  # ids that recur out of order: every tile's range meets every other's
        return (torch.arange(t) % 5).to(torch.int32).expand(2, t).contiguous(), 2
    if name == "bh1":
        return _doc_ids([100, 200, 65], t)[None], 1
    return _doc_ids([40], t)[None].expand(2, t).contiguous(), 2


@pytest.mark.parametrize("form", ["causal", "segment", "causal_segment"])
@pytest.mark.parametrize("geometry", ["packed", "unaligned", "one_token", "decreasing",
                                      "repeated", "bh1", "one_tile", "one"])
def test_masked_flash_kernels_match_plain(dev, geometry, form):
    """K9 (serving and training forms) and K9b in their causal, segment-id
    and combined forms against the plain versions; the lse; two K9b runs
    bit for bit; and the tiles each kernel walked against the rule's count
    at its own geometry (``kernel_visits``), which is below the full count
    where a tile can be skipped."""
    import chip_smoke

    seg_cpu, h = _seg_geometry(geometry)
    b, t = seg_cpu.shape
    causal = form.startswith("causal")
    seg = seg_cpu.to(dev) if "segment" in form else None
    q, k, v, do = (_randn(dev, b, t, h, 128, seed=s).to(_BF16) for s in range(4))
    visits = torch.zeros(3, dtype=torch.int32, device=dev)
    before = dict(flash.launches)
    out, lse = flash._flash_fwd(q, k, v, None, True, causal, seg, visits[:1])
    assert torch.equal(out, flash.flash_attention(q, k, v, causal=causal, segment_ids=seg))
    ref, lse_ref = flash.flash_attention_plain(q, k, v, return_lse=True, causal=causal,
                                               segment_ids=seg)
    assert_close(f"K9 {form} {geometry}", ref, out, chip_smoke.FLASH_TOL)
    assert_close(f"K9 lse {form} {geometry}", lse_ref, lse, 1e-5)
    got = flash.flash_attention_bwd(q, k, v, out, lse, do, None, causal, seg, visits[1:])
    want = flash.flash_attention_bwd_plain(q, k, v, out, lse, do, causal=causal, segment_ids=seg)
    one_key = t == 1 or (geometry == "one_token" and seg is not None)
    for name, r, g in zip(("dq", "dk", "dv"), want, got):
        if one_key and name != "dv":  # every row keeps one key: P = 1, dS = 0
            assert g.abs().max() < 1e-5 and r.abs().max() < 1e-5
            continue
        assert_close(f"K9b {name} {form} {geometry}", r, g, chip_smoke.FLASH_BWD_TOL)
    again = flash.flash_attention_bwd(q, k, v, out, lse, do, None, causal, seg)
    assert all(torch.equal(a, g) for a, g in zip(again, got))
    assert flash.launches["flash_attention_masked"] == before["flash_attention_masked"] + 2
    assert flash.launches["flash_attention_masked_bwd"] == before["flash_attention_masked_bwd"] + 2
    assert flash.launches["flash_attention"] == before["flash_attention"]
    n = -(-t // 64)
    want_tiles = flash.kernel_visits(causal, seg_cpu if seg is not None else None, t, 128, h, b)
    assert visits.tolist() == want_tiles
    assert all(w <= b * h * n * n for w in want_tiles)


def test_masked_flash_refuses_unequal_lengths(dev):
    q = torch.zeros(1, 128, 1, 128, dtype=_BF16, device=dev)
    with pytest.raises(ValueError):
        flash.flash_attention(q, q[:, :64], q[:, :64], causal=True)


def _per_row_mixing(dev, b, t, seed=5):
    """Segment ids of packed rows and the [B, N, N] / [B, N] per-row matrices
    the fused op builds from them."""
    from mhla_tpu_torch.ops import build_segment_mixing

    seg = torch.stack([_doc_ids([256, 64, 448], t), _doc_ids([128] * (t // 128), t)]).to(dev)[:b]
    m = torch.rand(32, 32, generator=torch.Generator(dev).manual_seed(seed), device=dev)
    n = -(-t // 64)
    mv = torch.tril(build_segment_mixing(m, seg, n, 64) * 128**-0.5)
    return seg, m, torch.tril(mv, -1).to(_BF16).float().contiguous(), \
        torch.diagonal(mv, dim1=-2, dim2=-1).contiguous()


@pytest.mark.parametrize("b,t", [(2, 2048), (1, 781)])
def test_per_row_chunk_kernels_match_plain(dev, b, t):
    """K3, K4, K4b and K3b with one mixing matrix per batch row (d md [B, N]
    and dMs [B, N, N] per row), K1/K1b with per-token positions, and the
    fused op on packed rows against its plain version."""
    h, dk, dv, c = 4, 128, 256, 64
    n = -(-t // c)
    seg, m, m_strict, m_diag = _per_row_mixing(dev, b, t)

    def tokens(d, relu, seed):
        y = _randn(dev, b, n * c, h * d, seed=seed)
        y[:, t:] = 0
        y = torch.relu(y) if relu else y
        return y.to(_BF16).reshape(b, n, c, h * d).contiguous()

    q4, k4, v4, do4 = tokens(dk, True, 1), tokens(dk, True, 2), tokens(dv, False, 3), tokens(dv, False, 4)
    states4 = mhla_chunk.chunk_states_plain(k4, v4, h)
    assert_close("K3 per row", mhla_chunk.mix_states_plain(m_strict, states4),
                 mhla_chunk.mix_states(m_strict, states4), KERNEL_TOL)
    mixed4 = mhla_chunk.mix_states_plain(m_strict, states4)
    assert_close("K4 per row", mhla_chunk.chunk_output_plain(q4, k4, v4, mixed4, m_diag, h),
                 mhla_chunk.chunk_output(q4, k4, v4, mixed4, m_diag, h), KERNEL_TOL)
    ref = mhla_chunk.chunk_output_bwd_plain(q4, k4, v4, mixed4, m_diag, do4, h)
    got = mhla_chunk.chunk_output_bwd(q4, k4, v4, mixed4, m_diag, do4, h)
    assert got[4].shape == (b, n)
    for name, r, g in zip(("dq", "dk_intra", "dv_intra", "dmixed", "dmd"), ref, got):
        assert_close(f"K4b per row {name}", r, g, KERNEL_TOL)
    ref = mhla_chunk.mix_states_bwd_plain(m_strict, ref[3], states4)
    got = mhla_chunk.mix_states_bwd(m_strict, got[3], states4)
    assert got[1].shape == (b, n, n)
    for name, r, g in zip(("dstates", "dMs"), ref, got):
        assert_close(f"K3b per row {name}", r, g, KERNEL_TOL)

    from mhla_tpu_torch.ops import segment_positions

    pos = segment_positions(seg)
    cos, sin = rotary_cos_sin(2048, 128, device=dev)
    x, dy = (_randn(dev, b, t, h * 128, seed=s).to(_BF16) for s in (6, 7))
    assert_close("K1 positions", fmap_rope.fmap_rope_plain(x, cos, sin, h, "relu", positions=pos),
                 fmap_rope.fused_fmap_rope_flat(x, cos, sin, h, "relu", positions=pos),
                 KERNEL_TOL)
    assert_close("K1b positions",
                 fmap_rope.fmap_rope_bwd_plain(dy, x, cos, sin, h, "relu", positions=pos),
                 fmap_rope.fmap_rope_bwd(dy, x, cos, sin, h, "relu", positions=pos), KERNEL_TOL)

    qf, kf = (torch.relu(_randn(dev, b, t, h * dk, seed=s)).to(_BF16) for s in (8, 9))
    vf = _randn(dev, b, t, h * dv, seed=10).to(_BF16)
    o, _ = mhla_chunk.mhla_chunk_fused_flat(qf, kf, vf, m, h, segment_ids=seg)
    o_cpu, _ = mhla_chunk.mhla_chunk_fused_flat(qf.cpu(), kf.cpu(), vf.cpu(), m.cpu(), h,
                                                segment_ids=seg.cpu())
    assert_close("fused op on packed rows", o_cpu, o, KERNEL_TOL)


def test_per_row_kernels_equal_shared_ones_for_equal_rows(dev):
    """A per-row matrix whose rows are all the shared one gives the shared
    kernels' results bit for bit (K3, K4, K4b but its summed d md, K3b's dS),
    and the shared kernels' own results are those of the plain versions."""
    b, t, h, dk, dv, c = 2, 1024, 4, 128, 256, 64
    n = t // c
    m = torch.tril(torch.rand(n, n, generator=torch.Generator(dev).manual_seed(3), device=dev))
    ms, md = torch.tril(m, -1).to(_BF16).float().contiguous(), torch.diagonal(m).contiguous()
    ms_b, md_b = ms.expand(b, n, n).contiguous(), md.expand(b, n).contiguous()
    q4, k4 = (torch.relu(_randn(dev, b, n, c, h * dk, seed=s)).to(_BF16) for s in (1, 2))
    v4, do4 = (_randn(dev, b, n, c, h * dv, seed=s).to(_BF16) for s in (3, 4))
    states4 = mhla_chunk.chunk_states(k4, v4, h)
    mixed4 = mhla_chunk.mix_states(ms, states4)
    assert torch.equal(mixed4, mhla_chunk.mix_states(ms_b, states4))
    assert_close("K3 shared", mhla_chunk.mix_states_plain(ms, states4), mixed4, KERNEL_TOL)
    o4 = mhla_chunk.chunk_output(q4, k4, v4, mixed4, md, h)
    assert torch.equal(o4, mhla_chunk.chunk_output(q4, k4, v4, mixed4, md_b, h))
    shared = mhla_chunk.chunk_output_bwd(q4, k4, v4, mixed4, md, do4, h)
    per_row = mhla_chunk.chunk_output_bwd(q4, k4, v4, mixed4, md_b, do4, h)
    assert all(torch.equal(x, y) for x, y in zip(shared[:4], per_row[:4]))
    assert_close("K4b d md summed over rows", shared[4], per_row[4].sum(0), 1e-6)
    ds_shared, dm_shared = mhla_chunk.mix_states_bwd(ms, shared[3], states4)
    ds_row, dm_row = mhla_chunk.mix_states_bwd(ms_b, shared[3], states4)
    assert torch.equal(ds_shared, ds_row)
    assert_close("K3b dMs summed over rows", dm_shared, dm_row.sum(0), 1e-5)


def _tiny_hybrid(dev, dtype=torch.bfloat16):
    """Three layers (softmax, MHLA, softmax), the softmax ones 4 heads of 128."""
    cfg = MHLALMConfig(hidden_size=512, num_hidden_layers=3, num_heads=2, vocab_size=100,
                       attn={"layers": [0, 2], "num_heads": 4}, dtype=dtype)
    return init_lm_params(MHLAForCausalLM(cfg, device=dev), torch.Generator(dev).manual_seed(0))


def test_tiny_hybrid_lm_serves_through_the_kernels(dev):
    """A 2,040-token prompt takes the plain causal product in the softmax
    layers (Tq < 2048) and 8 decode steps their KV caches; one forward over
    the 2,048 tokens runs K9's causal form there."""
    model = _tiny_hybrid(dev).to(_BF16).eval()
    ids = torch.randint(0, 100, (2, 2040), generator=torch.Generator(dev).manual_seed(1),
                        device=dev)
    kernels.reset_launch_counts()
    out, scores = generate(model, ids, max_new_tokens=8, output_scores=True)
    assert kernels.launch_counts()["flash_attention_masked"] == 0
    with torch.no_grad():
        full, _ = model(out)
    assert kernels.launch_counts()["flash_attention_masked"] == 2
    assert_close("tiny hybrid LM decode vs full forward", full[:, 2039:-1], scores, 5e-2)


def test_tiny_hybrid_lm_trains_on_packed_rows_through_the_kernels(dev):
    """Two steps on packed rows of 2,048 tokens: every per-row kernel and
    K9 / K9b's causal segment-id form launch as the schedule says, and the
    loss is finite."""
    from mhla_tpu_torch.data import make_lm_dataloader
    from mhla_tpu_torch.train.lm_train import lm_loss, to_device

    model = _tiny_hybrid(dev)
    state = init_train_state(model, OptimizerConfig(warmup_steps=1, learning_rate=1e-3))
    step = make_train_step(lm_loss)
    data = make_lm_dataloader(2048, 2, 100, varlen=True)
    kernels.reset_launch_counts()
    losses = []
    for _ in range(2):
        state, metrics = step(state, to_device(next(data), dev))
        losses.append(float(metrics["loss"]))
    counts = kernels.launch_counts()
    want = {"fmap_rope": 4, "fmap_rope_bwd": 4, "flash_attention_masked": 4,
            "flash_attention_masked_bwd": 4, "flash_attention": 0, "flash_attention_bwd": 0,
            **{n: 2 for n in _FWD_CHUNK + tuple(f"{n}_bwd" for n in _FWD_CHUNK)}}
    assert {n: counts[n] for n in want} == want, counts
    assert all(torch.isfinite(torch.tensor(losses))), losses
    assert torch.count_nonzero(model.model.layers[1].attn.mixing_matrix.grad) > 0


def _delta_inputs(dev, b, t, h, dv, c, seed=0):
    """K11 / K11b's padded inputs: normed bf16 q, k, bf16 v, the within-chunk
    cumsum G of a layer-like decay and beta (zero on the ragged tail), a
    nonzero initial state and the cotangents."""
    import math

    from mhla_tpu_torch.ops.delta_rule import l2norm
    from mhla_tpu_torch.ops.mhla_chunk import _pad_to_chunks

    gen = torch.Generator(dev).manual_seed(seed)
    rn = lambda *s: torch.randn(*s, generator=gen, device=dev)  # noqa: E731
    q, k, v = (_pad_to_chunks(x, c) for x in (rn(b, t, h, 128), rn(b, t, h, 128),
                                               rn(b, t, h, dv)))
    a = torch.rand(h, generator=gen, device=dev) * 16
    g = -a * torch.nn.functional.softplus(rn(b, t, h) + math.log(math.expm1(0.01)))
    g, beta = _pad_to_chunks(g, c), _pad_to_chunks(torch.sigmoid(rn(b, t, h)), c)
    n = g.shape[1] // c
    g_cum = torch.cumsum(g.reshape(b, n, c, h), 2).reshape(b, n * c, h)
    do = _pad_to_chunks(rn(b, t, h, dv), c).to(_BF16)
    return (l2norm(q).to(_BF16), l2norm(k).to(_BF16), v.to(_BF16), g_cum, beta,
            0.1 * rn(b, h, 128, dv), do, rn(b, h, 128, dv))


@pytest.mark.parametrize("b,t,h,dv,c", [(2, 2048, 4, 256, 64), (1, 781, 4, 256, 64),
                                        (1, 200, 2, 128, 32), (3, 64, 1, 64, 16)])
def test_delta_chunk_kernels_match_plain(dev, b, t, h, dv, c):
    """K11 (o, the final state and the entry states) and K11b (dq, dk, dv,
    dG, dbeta, ds0) against their plain versions; K11b twice, bit for bit;
    one launch each per call."""
    from mhla_tpu_torch.kernels import delta_chunk as dc

    q, k, v, g_cum, beta, s0, do, ds = _delta_inputs(dev, b, t, h, dv, c)
    before = dict(dc.launches)
    out = dc.delta_chunk_fwd(q, k, v, g_cum, beta, s0, c, True)
    ref = dc.delta_chunk_fwd_plain(q, k, v, g_cum, beta, s0, c, True)
    for name, r, x in zip(("o", "state", "entry states"), ref, out):
        assert_close(f"K11 {name}", r, x, KERNEL_TOL)
    serving = dc.delta_chunk_fwd(q, k, v, g_cum, beta, s0, c)
    assert serving[2] is None and torch.equal(serving[0], out[0])
    got = dc.delta_chunk_bwd(q, k, v, g_cum, beta, ref[2], do, ds, c)
    again = dc.delta_chunk_bwd(q, k, v, g_cum, beta, ref[2], do, ds, c)
    want = dc.delta_chunk_bwd_plain(q, k, v, g_cum, beta, ref[2], do, ds, c)
    for name, r, x, y in zip(("dq", "dk", "dv", "dG", "dbeta", "ds0"), want, got, again):
        assert_close(f"K11b {name}", r, x, KERNEL_TOL)
        assert torch.equal(x, y), name
    assert dc.launches == {"delta_chunk_fwd": before["delta_chunk_fwd"] + 2,
                           "delta_chunk_bwd": before["delta_chunk_bwd"] + 2}


@pytest.mark.parametrize("b,t,h,dv,c", [(2, 2048, 4, 256, 64), (1, 781, 4, 256, 64),
                                        (1, 200, 2, 128, 32), (3, 64, 1, 64, 16)])
def test_delta_chunk_forward_is_bit_equal_over_runs(dev, b, t, h, dv, c):
    """K11's o, final state and entry states, two runs, bit for bit."""
    from mhla_tpu_torch.kernels import delta_chunk as dc

    q, k, v, g_cum, beta, s0, _, _ = _delta_inputs(dev, b, t, h, dv, c)
    first = dc.delta_chunk_fwd(q, k, v, g_cum, beta, s0, c, True)
    second = dc.delta_chunk_fwd(q, k, v, g_cum, beta, s0, c, True)
    for name, x, y in zip(("o", "state", "entry states"), first, second):
        assert torch.equal(x, y), name


@pytest.mark.parametrize("b,t,h,dv", [(1, 256, 2, 128), (2, 2048, 4, 256)])
def test_delta_chunk_kernels_at_strong_decay(dev, b, t, h, dv):
    """Gates whose log-decay summed over a chunk falls below -88.7, where
    e^{-G} overflows float32: K11 and K11b, which form their decays from
    differences of G, are finite and match their plain versions."""
    from mhla_tpu_torch.kernels import delta_chunk as dc

    c = 64
    q, k, v, _, beta, s0, do, ds = _delta_inputs(dev, b, t, h, dv, c)
    gen = torch.Generator(dev).manual_seed(7)
    g = -(1.5 + 1.5 * torch.rand(b, t, h, generator=gen, device=dev))
    g_cum = torch.cumsum(g.reshape(b, t // c, c, h), 2).reshape(b, t, h)
    assert g_cum[:, c - 1::c].max() < -88.7
    out = dc.delta_chunk_fwd(q, k, v, g_cum, beta, s0, c, True)
    ref = dc.delta_chunk_fwd_plain(q, k, v, g_cum, beta, s0, c, True)
    for name, r, x in zip(("o", "state", "entry states"), ref, out):
        assert torch.isfinite(x.float()).all(), name
        assert_close(f"K11 {name}", r, x, KERNEL_TOL)
    got = dc.delta_chunk_bwd(q, k, v, g_cum, beta, ref[2], do, ds, c)
    want = dc.delta_chunk_bwd_plain(q, k, v, g_cum, beta, ref[2], do, ds, c)
    for name, r, x in zip(("dq", "dk", "dv", "dG", "dbeta", "ds0"), want, got):
        assert torch.isfinite(x.float()).all(), name
        assert_close(f"K11b {name}", r, x, KERNEL_TOL)


def test_delta_kernels_run_on_wgmma_and_tma(dev):
    """The built library's K11 / K11b kernels (the prep, the chain both ways,
    the gradients) hold HGMMA (wgmma) and UTMALDG (TMA loads) and no HMMA
    (mma.sync or WMMA)."""
    kinds = ("delta_prep_kernel", "delta_fwd_chain_kernel", "delta_bwd_chain_kernel",
             "delta_bwd_grads_kernel")
    found = dict.fromkeys(kinds, 0)
    for fn, text in _sass_bodies().items():
        kind = next((k for k in kinds if k in fn), None)
        if kind is None:
            continue
        assert "HGMMA" in text and "UTMALDG" in text, fn
        assert " HMMA" not in text, fn
        found[kind] += 1
    assert found == dict.fromkeys(kinds, 1)


def test_delta_op_gradients_through_the_kernels(dev):
    """gated_delta_chunk_fused's gradients (through K11 / K11b and the
    autograd around them) against autograd of the plain op, bf16 inputs,
    within the bf16 floor (chip_smoke.DELTA_GRAD_TOL)."""
    from mhla_tpu_torch.kernels.delta_chunk import gated_delta_chunk_fused
    from mhla_tpu_torch.ops.delta_rule import gated_delta_chunk

    gen = torch.Generator(dev).manual_seed(3)
    rn = lambda *s: torch.randn(*s, generator=gen, device=dev)  # noqa: E731
    raw = [rn(1, 300, 2, 128).to(_BF16), rn(1, 300, 2, 128).to(_BF16),
           rn(1, 300, 2, 256).to(_BF16), -torch.rand(1, 300, 2, generator=gen, device=dev),
           torch.rand(1, 300, 2, generator=gen, device=dev), 0.1 * rn(1, 2, 128, 256)]
    w = rn(1, 300, 2, 256)
    grads = []
    for fn in (gated_delta_chunk_fused, gated_delta_chunk):
        xs = [x.clone().requires_grad_() for x in raw]
        o, s = fn(*xs[:5], initial_state=xs[5], output_final_state=True)
        ((o.float() * w).sum() + s.sum()).backward()
        grads.append([x.grad for x in xs])
    for name, x, r in zip(("q", "k", "v", "g", "beta", "s0"), *grads):
        assert_close(f"d{name}", r, x, 1e-2)


def test_delta_wrappers_raise_instead_of_falling_back(dev):
    from mhla_tpu_torch.kernels import delta_chunk as dc

    q, k, v, g_cum, beta, s0, do, ds = _delta_inputs(dev, 1, 128, 1, 128, 64)
    with pytest.raises(TypeError):  # the kernels take bf16 q, k, v
        dc.delta_chunk_fwd(q.float(), k.float(), v.float(), g_cum, beta, s0, 64)
    with pytest.raises(ValueError):  # Dk != 128
        dc.delta_chunk_fwd(q[..., :64].contiguous(), k[..., :64].contiguous(), v, g_cum,
                           beta, s0[:, :, :64].contiguous(), 64)
    with pytest.raises(ValueError):  # not whole chunks
        dc.delta_chunk_fwd(q[:, :100], k[:, :100], v[:, :100], g_cum[:, :100],
                           beta[:, :100], s0, 64)


@pytest.mark.parametrize("dk,c", [(256, 64), (128, 8), (128, 128)])
def test_delta_routed_shapes_the_kernels_lack_raise(dev, dk, c):
    """Shapes JAX's rule sends to its Pallas kernel but K11 does not hold yet
    (Dk = 256, a chunk not a multiple of 16 or above 64): the fused path
    raises on the card instead of running the plain op."""
    from mhla_tpu_torch.kernels.delta_chunk import gated_delta_chunk_fused, kernel_route

    gen = torch.Generator(dev).manual_seed(4)
    rn = lambda *s: torch.randn(*s, generator=gen, device=dev)  # noqa: E731
    q, k, v = rn(1, 128, 1, dk).to(_BF16), rn(1, 128, 1, dk).to(_BF16), rn(1, 128, 1, 128)
    g, beta = -torch.rand(1, 128, 1, device=dev), torch.rand(1, 128, 1, device=dev)
    assert kernel_route(128, c, dk, 128)
    with pytest.raises(ValueError):
        gated_delta_chunk_fused(q, k, v.to(_BF16), g, beta, chunk_size=c)


def test_tiny_gdn_lm_serves_and_trains_through_the_kernels(dev):
    """A 2-layer Gated DeltaNet LM at Dk = 128: a 130-token prefill on K11,
    decode on the recurrence, decode-step logits against one forward, and a
    training step through K11 / K11b."""
    from mhla_tpu_torch.train.lm_train import lm_loss

    cfg = MHLALMConfig(hidden_size=512, num_hidden_layers=2, num_heads=2, vocab_size=100,
                       attn_extends="gated_deltanet", dtype=_BF16)
    model = init_lm_params(MHLAForCausalLM(cfg, device=dev), torch.Generator(dev).manual_seed(0))
    serving = MHLAForCausalLM(cfg, device=dev).to(_BF16).eval()
    serving.load_state_dict(model.state_dict())
    ids = torch.randint(0, 100, (2, 130), generator=torch.Generator(dev).manual_seed(1),
                        device=dev)
    kernels.reset_launch_counts()
    out, scores = generate(serving, ids, max_new_tokens=6, output_scores=True)
    assert kernels.launch_counts()["delta_chunk_fwd"] == 2
    with torch.no_grad():
        full, _ = serving(out[:, :-1])
    assert_close("tiny GDN LM decode vs full forward", full[:, 129:], scores, 5e-2)
    state = init_train_state(model, OptimizerConfig(warmup_steps=1, learning_rate=1e-3))
    kernels.reset_launch_counts()
    state, metrics = make_train_step(lm_loss)(state, ids)
    counts = kernels.launch_counts()
    assert counts["delta_chunk_fwd"] == counts["delta_chunk_bwd"] == 2, counts
    assert torch.isfinite(metrics["loss"])
    assert all(p.grad is not None and torch.isfinite(p.grad).all() for p in model.parameters())


def _gla_inputs(dev, b, t, h, dv, dtype, c=64, seed=0):
    """K12 / K12b's padded inputs as ``gla_chunk_fused`` makes them: relu q,
    k and v in ``dtype``, a layer-like decay logsigmoid(x) / 16, then qd, kd,
    v in the compute dtype and e^{G_last}; a nonzero initial state and the
    cotangents (dO zero on the ragged tail)."""
    from mhla_tpu_torch.kernels import gla_chunk as gc

    gen = torch.Generator(dev).manual_seed(seed)
    rn = lambda *s: torch.randn(*s, generator=gen, device=dev)  # noqa: E731
    q, k, v = torch.relu(rn(b, t, h, 128)), torch.relu(rn(b, t, h, 128)), rn(b, t, h, dv)
    gk = torch.nn.functional.logsigmoid(2 * rn(b, t, h, 128) + 1) / 16
    qd, kd, v4, egl, _ = gc._prep(q.to(dtype), k.to(dtype), v.to(dtype), gk, c)
    do = rn(*v4.shape)
    do[:, t:] = 0
    return (qd.contiguous(), kd.contiguous(), v4, egl, 0.1 * rn(b, h, 128, dv),
            do.to(v4.dtype), rn(b, h, 128, dv))


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (_BF16, KERNEL_TOL)])
@pytest.mark.parametrize("b,t,h,dv,c", [(2, 2048, 4, 256, 64), (1, 781, 4, 256, 64),
                                        (1, 200, 2, 128, 32), (3, 64, 1, 64, 16),
                                        (1, 200, 2, 128, 48)]
                         + [(2, 300, 2, dv, c) for c in (16, 32, 64) for dv in (64, 128, 256)])
def test_gla_chunk_kernels_match_plain(dev, b, t, h, dv, c, dtype, tol):
    """K12 (o, the final state and the entry states) and K12b (dqd, dkd, dv,
    degl, ds0) against their plain versions in the layer's float32 form
    (JAX's bound between its fused kernel and its op) and in bf16, at chunks
    of 16 to 64 (the TF32 wgmma products at M = 64 with rows past C zero, and
    N = C), Dv of one to four
    64-column panels, ragged last chunks and a nonzero initial state; K12b
    twice, bit for bit; one launch each per call."""
    from mhla_tpu_torch.kernels import gla_chunk as gc

    qd, kd, v, egl, s0, do, ds = _gla_inputs(dev, b, t, h, dv, dtype, c)
    before = dict(gc.launches)
    out = gc.gla_chunk_fwd(qd, kd, v, egl, s0, c, True)
    ref = gc.gla_chunk_fwd_plain(qd, kd, v, egl, s0, c, True)
    for name, r, x in zip(("o", "state", "entry states"), ref, out):
        assert_close(f"K12 {name}", r.float(), x.float(), tol)
    serving = gc.gla_chunk_fwd(qd, kd, v, egl, s0, c)
    assert serving[2] is None and torch.equal(serving[0], out[0])
    got = gc.gla_chunk_bwd(qd, kd, v, egl, ref[2], do, ds, c)
    again = gc.gla_chunk_bwd(qd, kd, v, egl, ref[2], do, ds, c)
    want = gc.gla_chunk_bwd_plain(qd, kd, v, egl, ref[2], do, ds, c)
    for name, r, x, y in zip(("dqd", "dkd", "dv", "degl", "ds0"), want, got, again):
        assert_close(f"K12b {name}", r, x, tol)
        assert torch.equal(x, y), name
    assert gc.launches == {**before, "gla_chunk_fwd": before["gla_chunk_fwd"] + 2,
                           "gla_chunk_bwd": before["gla_chunk_bwd"] + 2}


def _gla_scalar_inputs(dev, b, t, h, dv, dtype, c=64, seed=0, strong=False):
    """The scalar form's padded inputs as ``gla_chunk_fused`` makes them
    from a Mamba2-like call: q, k, v in ``dtype``, one log-decay per head
    gk = -A softplus(x + dt_bias) with A ~ U(0, 16) and dt log-uniform in
    [1e-3, 0.1] (the layer's init), or with ``strong`` gk ~ -U(1.5, 3) (every
    chunk of 64 sums below -96); G the within-chunk cumsum; a nonzero
    initial state and the cotangents (dO zero on the ragged tail)."""
    import math

    from mhla_tpu_torch.kernels import gla_chunk as gc

    gen = torch.Generator(dev).manual_seed(seed)
    rn = lambda *s: torch.randn(*s, generator=gen, device=dev)  # noqa: E731
    q, k, v = rn(b, t, h, 128), rn(b, t, h, 128), rn(b, t, h, dv)
    a = 16 * torch.rand(h, generator=gen, device=dev)
    dt = torch.exp(torch.rand(h, generator=gen, device=dev) * math.log(100.0) + math.log(1e-3))
    gk = -a * torch.nn.functional.softplus(rn(b, t, h) + torch.log(torch.expm1(dt)))
    if strong:
        gk = -1.5 - 1.5 * torch.rand(b, t, h, generator=gen, device=dev)
    q4, k4, v4, g4 = gc._prep_scalar(q.to(dtype), k.to(dtype), v.to(dtype), gk, c)
    do = rn(*v4.shape)
    do[:, t:] = 0
    return q4, k4, v4, g4, 0.1 * rn(b, h, 128, dv), do.to(v4.dtype), rn(b, h, 128, dv)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (_BF16, KERNEL_TOL)])
@pytest.mark.parametrize("b,t,h,dv,c", [(8, 2048, 8, 256, 64), (1, 781, 8, 256, 64),
                                        (3, 64, 1, 64, 16), (1, 200, 2, 128, 48)]
                         + [(2, 300, 2, dv, c) for c in (16, 32, 64) for dv in (64, 128, 256)])
def test_gla_scalar_kernels_match_plain(dev, b, t, h, dv, c, dtype, tol):
    """K12's and K12b's scalar-decay forms (one log-decay per head, the
    difference form) against their plain versions at Mamba2's shape [8,
    2048, 8, 128|256], a ragged 1 x 781, chunks of 16 to 64 and Dv of one to
    four panels, in float32 and bf16, with Mamba2's decay at init (A up to
    16): every output finite, K12b twice bit for bit, one launch each per call."""
    from mhla_tpu_torch.kernels import gla_chunk as gc

    q, k, v, g, s0, do, ds = _gla_scalar_inputs(dev, b, t, h, dv, dtype, c)
    before = dict(gc.launches)
    out = gc.gla_chunk_fwd_scalar(q, k, v, g, s0, c, True)
    ref = gc.gla_chunk_fwd_scalar_plain(q, k, v, g, s0, c, True)
    for name, r, x in zip(("o", "state", "entry states"), ref, out):
        assert torch.isfinite(x).all(), name
        assert_close(f"K12 scalar {name}", r.float(), x.float(), tol)
    got = gc.gla_chunk_bwd_scalar(q, k, v, g, ref[2], do, ds, c)
    again = gc.gla_chunk_bwd_scalar(q, k, v, g, ref[2], do, ds, c)
    want = gc.gla_chunk_bwd_scalar_plain(q, k, v, g, ref[2], do, ds, c)
    for name, r, x, y in zip(("dq", "dk", "dv", "dG", "ds0"), want, got, again):
        assert torch.isfinite(x).all(), name
        assert_close(f"K12b scalar {name}", r, x, tol)
        assert torch.equal(x, y), name
    assert gc.launches == {**before, "gla_chunk_fwd_scalar": before["gla_chunk_fwd_scalar"] + 1,
                           "gla_chunk_bwd_scalar": before["gla_chunk_bwd_scalar"] + 2}


def test_gla_scalar_kernels_at_strong_decay(dev):
    """A per-head decay whose chunks sum below -88.7: the factored form's
    e^{-G} would overflow; the scalar form's kernels are finite, match their
    plain versions, and the op through them matches the token recurrence."""
    from mhla_tpu_torch.kernels import gla_chunk as gc
    from mhla_tpu_torch.kernels.gla_chunk import gla_chunk_fused
    from mhla_tpu_torch.ops.gla_chunk import gla_recurrent

    q, k, v, g, s0, do, ds = _gla_scalar_inputs(dev, 2, 512, 4, 256, torch.float32, strong=True)
    assert g.view(2, 8, 64, 4)[:, :, -1].min() < -88.7
    out = gc.gla_chunk_fwd_scalar(q, k, v, g, s0, 64, True)
    ref = gc.gla_chunk_fwd_scalar_plain(q, k, v, g, s0, 64, True)
    got = gc.gla_chunk_bwd_scalar(q, k, v, g, ref[2], do, ds, 64)
    want = gc.gla_chunk_bwd_scalar_plain(q, k, v, g, ref[2], do, ds, 64)
    for name, r, x in zip(("o", "state", "entry states", "dq", "dk", "dv", "dG", "ds0"),
                          (*ref, *want), (*out, *got)):
        assert torch.isfinite(x).all(), name
        assert_close(f"strong decay {name}", r.float(), x.float(), 1e-4)
    gen = torch.Generator(dev).manual_seed(9)
    q, k, v = (torch.randn(1, 300, 2, d, generator=gen, device=dev) for d in (128, 128, 256))
    gk = -12.0 * torch.rand(1, 300, 2, generator=gen, device=dev) - 1.5
    o, s = gla_chunk_fused(q, k, v, gk, output_final_state=True)
    o_rec, s_rec = gla_recurrent(q, k, v, gk, output_final_state=True)
    assert torch.isfinite(o).all() and torch.isfinite(s).all()
    assert_close("strong decay op vs recurrence", o_rec, o, 1e-4)
    assert_close("strong decay state vs recurrence", s_rec, s, 1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, _BF16])
def test_gla_op_gradients_through_the_kernels(dev, dtype):
    """gla_chunk_fused's gradients (through K12 / K12b and the decay chains
    around them) against autograd of the plain op on the same inputs: the
    float32 op (JAX's bound, 1e-4) and, for bf16 inputs, within the bf16
    floor (chip_smoke.OP_GRAD_TOL)."""
    from mhla_tpu_torch.kernels.gla_chunk import gla_chunk_fused
    from mhla_tpu_torch.ops.gla_chunk import gla_chunk

    gen = torch.Generator(dev).manual_seed(3)
    rn = lambda *s: torch.randn(*s, generator=gen, device=dev)  # noqa: E731
    raw = [torch.relu(rn(1, 300, 2, 128)).to(dtype), torch.relu(rn(1, 300, 2, 128)).to(dtype),
           rn(1, 300, 2, 256).to(dtype), torch.nn.functional.logsigmoid(rn(1, 300, 2, 128)) / 16,
           0.1 * rn(1, 2, 128, 256)]
    w = rn(1, 300, 2, 256)
    grads = []
    for fn in (gla_chunk_fused, gla_chunk):
        xs = [x.clone().requires_grad_() for x in raw]
        o, s = fn(*xs[:4], initial_state=xs[4], output_final_state=True)
        ((o.float() * w).sum() + s.sum()).backward()
        grads.append([x.grad for x in xs])
    for name, x, r in zip(("q", "k", "v", "gk", "s0"), *grads):
        assert_close(f"d{name}", r.float(), x.float(), 1e-4 if dtype == torch.float32 else 1e-2)


def test_gla_wrappers_raise_instead_of_falling_back(dev):
    from mhla_tpu_torch.kernels import gla_chunk as gc

    qd, kd, v, egl, s0, do, ds = _gla_inputs(dev, 1, 128, 1, 128, torch.float32)
    with pytest.raises(TypeError):  # mixed dtypes
        gc.gla_chunk_fwd(qd.to(_BF16), kd, v, egl, s0, 64)
    with pytest.raises(TypeError):  # neither bf16 nor float32
        gc.gla_chunk_fwd(qd.half(), kd.half(), v.half(), egl, s0, 64)
    with pytest.raises(ValueError):  # Dk != 128
        gc.gla_chunk_fwd(qd[..., :64].contiguous(), kd[..., :64].contiguous(), v,
                         egl[..., :64].contiguous(), s0[:, :, :64].contiguous(), 64)
    with pytest.raises(ValueError):  # not whole chunks
        gc.gla_chunk_fwd(qd[:, :100], kd[:, :100], v[:, :100], egl, s0, 64)


@pytest.mark.parametrize("dk,dv,c", [(256, 128, 64), (128, 128, 8), (128, 128, 128)])
def test_gla_routed_shapes_the_kernels_lack_raise(dev, dk, dv, c):
    """Shapes JAX's rule sends to its Pallas kernel but K12 does not hold yet
    (Dk = 256, a chunk not a multiple of 16 or above 64): the fused path
    raises on the card instead of running the plain op."""
    from mhla_tpu_torch.kernels.gla_chunk import gla_chunk_fused, kernel_route

    gen = torch.Generator(dev).manual_seed(4)
    rn = lambda *s: torch.randn(*s, generator=gen, device=dev)  # noqa: E731
    q, k, v = rn(1, 128, 1, dk), rn(1, 128, 1, dk), rn(1, 128, 1, dv)
    gk = -torch.rand(1, 128, 1, dk, generator=gen, device=dev) / 16
    assert kernel_route(128, c, dk, dv)
    with pytest.raises(ValueError):
        gla_chunk_fused(q, k, v, gk, chunk_size=c)


def test_gla_kernels_run_on_tf32_wgmma_and_tma(dev):
    """The built library's K12 / K12b kernels (the state pass both ways, the
    readout and the gradients, at every chunk and in both forms) hold HGMMA
    (wgmma) and UTMALDG (TMA loads) and no HMMA (mma.sync or WMMA)."""
    found = {kind: 0 for kind in ("gla_state_kernel", "gla_readout_kernel", "gla_grads_kernel")}
    for fn, text in _sass_bodies().items():
        kind = next((k for k in found if k in fn), None)
        if kind is None:
            continue
        assert "HGMMA" in text and "UTMALDG" in text, fn
        assert " HMMA" not in text, fn
        found[kind] += 1
    # four chunk sizes x two dtypes x the per-channel and scalar-decay forms;
    # the state pass forward and in reverse
    assert found == {"gla_state_kernel": 32, "gla_readout_kernel": 16, "gla_grads_kernel": 16}


@pytest.mark.parametrize("extends", ["gla", "simple_gla"])
def test_tiny_gla_lm_serves_and_trains_through_the_kernels(dev, extends):
    """A 2-layer GLA LM at Dk = 128: a 130-token prefill on K12, decode on
    the recurrence, decode-step logits against one forward, and a training
    step through K12 / K12b (their scalar-decay form for simple GLA)."""
    from mhla_tpu_torch.train.lm_train import lm_loss

    fwd, bwd = (("gla_chunk_fwd_scalar", "gla_chunk_bwd_scalar") if extends == "simple_gla"
                else ("gla_chunk_fwd", "gla_chunk_bwd"))

    cfg = MHLALMConfig(hidden_size=512, num_hidden_layers=2, num_heads=2, vocab_size=100,
                       attn_extends=extends, dtype=_BF16)
    model = init_lm_params(MHLAForCausalLM(cfg, device=dev), torch.Generator(dev).manual_seed(0))
    serving = MHLAForCausalLM(cfg, device=dev).to(_BF16).eval()
    serving.load_state_dict(model.state_dict())
    ids = torch.randint(0, 100, (2, 130), generator=torch.Generator(dev).manual_seed(1),
                        device=dev)
    kernels.reset_launch_counts()
    out, scores = generate(serving, ids, max_new_tokens=6, output_scores=True)
    assert kernels.launch_counts()[fwd] == 2
    with torch.no_grad():
        full, _ = serving(out[:, :-1])
    assert_close("tiny GLA LM decode vs full forward", full[:, 129:], scores, 5e-2)
    state = init_train_state(model, OptimizerConfig(warmup_steps=1, learning_rate=1e-3))
    kernels.reset_launch_counts()
    state, metrics = make_train_step(lm_loss)(state, ids)
    counts = kernels.launch_counts()
    assert counts[fwd] == counts[bwd] == 2, counts
    assert torch.isfinite(metrics["loss"])
    assert all(p.grad is not None and torch.isfinite(p.grad).all() for p in model.parameters())


def test_tiny_mamba2_lm_serves_and_trains_through_the_scalar_kernels(dev):
    """A 2-layer Mamba2 LM at hidden 256 and 2 heads (head dim 128, d_state
    128: the kernels' shape rule): a 130-token prefill on K12's scalar form
    in every layer, decode on the recurrence, decode-step logits against one
    forward, and a training step through K12 / K12b's scalar form in every
    layer, all finite."""
    from mhla_tpu_torch.train.lm_train import lm_loss

    cfg = MHLALMConfig(hidden_size=256, num_hidden_layers=2, num_heads=2, vocab_size=100,
                       attn_extends="mamba2", dtype=_BF16)
    model = init_lm_params(MHLAForCausalLM(cfg, device=dev), torch.Generator(dev).manual_seed(0))
    serving = MHLAForCausalLM(cfg, device=dev).to(_BF16).eval()
    serving.load_state_dict(model.state_dict())
    ids = torch.randint(0, 100, (2, 130), generator=torch.Generator(dev).manual_seed(1),
                        device=dev)
    kernels.reset_launch_counts()
    out, scores = generate(serving, ids, max_new_tokens=6, output_scores=True)
    counts = kernels.launch_counts()
    assert counts["gla_chunk_fwd_scalar"] == 2 and counts["gla_chunk_fwd"] == 0, counts
    with torch.no_grad():
        full, _ = serving(out[:, :-1])
    assert torch.isfinite(scores).all() and torch.isfinite(full).all()
    assert_close("tiny Mamba2 LM decode vs full forward", full[:, 129:], scores, 5e-2)
    state = init_train_state(model, OptimizerConfig(warmup_steps=1, learning_rate=1e-3))
    kernels.reset_launch_counts()
    state, metrics = make_train_step(lm_loss)(state, ids)
    counts = kernels.launch_counts()
    assert counts["gla_chunk_fwd_scalar"] == counts["gla_chunk_bwd_scalar"] == 2, counts
    assert torch.isfinite(metrics["loss"])
    assert all(p.grad is not None and torch.isfinite(p.grad).all() for p in model.parameters())


# --- the long-context path: head dim 256 (K9 / K9b) and wide mixing (K3 / K3b)


@pytest.mark.parametrize("tq,tk", [(3000, 512), (1000, 1000), (70, 33), (64, 129), (2048, 2048)])
def test_flash_kernels_at_head_dim_256(dev, tq, tk):
    """K9 (serving and training forms) and K9b at head dim 256, the softmax
    layers of a hybrid LM with the LM's 4 heads, against their plain
    versions; K9b equal across two runs."""
    import chip_smoke

    q, k, v = (_randn(dev, 2, t, 2, 256, seed=s).to(_BF16) for s, t in ((1, tq), (2, tk), (3, tk)))
    do = _randn(dev, 2, tq, 2, 256, seed=4).to(_BF16)
    before = dict(flash.launches)
    out, lse = flash._flash_fwd(q, k, v, None, want_lse=True)
    assert torch.equal(out, flash.flash_attention(q, k, v))
    ref, lse_ref = flash.flash_attention_plain(q, k, v, return_lse=True)
    assert_close(f"K9 d256 {tq}x{tk}", ref, out, chip_smoke.FLASH_TOL)
    assert_close(f"K9 d256 lse {tq}x{tk}", lse_ref, lse, 1e-5)
    got = flash.flash_attention_bwd(q, k, v, out, lse, do)
    want = flash.flash_attention_bwd_plain(q, k, v, out, lse, do)
    for name, r, g in zip(("dq", "dk", "dv"), want, got):
        assert_close(f"K9b d256 {name} {tq}x{tk}", r, g, chip_smoke.FLASH_BWD_TOL)
    again = flash.flash_attention_bwd(q, k, v, out, lse, do)
    assert all(torch.equal(a, g) for a, g in zip(again, got))
    assert flash.launches["flash_attention"] == before["flash_attention"] + 2
    assert flash.launches["flash_attention_bwd"] == before["flash_attention_bwd"] + 2


@pytest.mark.parametrize("form", ["causal", "segment", "causal_segment"])
@pytest.mark.parametrize("geometry", ["packed", "unaligned", "one_token", "one"])
def test_masked_flash_kernels_at_head_dim_256(dev, geometry, form):
    """The causal and segment-id forms of K9 / K9b at head dim 256 against
    the plain versions, two K9b runs bit for bit, and the tiles walked
    against the rule's count at each kernel's geometry."""
    import chip_smoke

    seg_cpu, h = _seg_geometry(geometry)
    b, t = seg_cpu.shape
    causal = form.startswith("causal")
    seg = seg_cpu.to(dev) if "segment" in form else None
    q, k, v, do = (_randn(dev, b, t, h, 256, seed=s).to(_BF16) for s in range(4))
    visits = torch.zeros(3, dtype=torch.int32, device=dev)
    out, lse = flash._flash_fwd(q, k, v, None, True, causal, seg, visits[:1])
    assert torch.equal(out, flash.flash_attention(q, k, v, causal=causal, segment_ids=seg))
    ref, lse_ref = flash.flash_attention_plain(q, k, v, return_lse=True, causal=causal,
                                               segment_ids=seg)
    assert_close(f"K9 d256 {form} {geometry}", ref, out, chip_smoke.FLASH_TOL)
    assert_close(f"K9 d256 lse {form} {geometry}", lse_ref, lse, 1e-5)
    got = flash.flash_attention_bwd(q, k, v, out, lse, do, None, causal, seg, visits[1:])
    want = flash.flash_attention_bwd_plain(q, k, v, out, lse, do, causal=causal, segment_ids=seg)
    one_key = t == 1 or (geometry == "one_token" and seg is not None)
    for name, r, g in zip(("dq", "dk", "dv"), want, got):
        if one_key and name != "dv":  # every row keeps one key: P = 1, dS = 0
            assert g.abs().max() < 1e-5 and r.abs().max() < 1e-5
            continue
        assert_close(f"K9b d256 {name} {form} {geometry}", r, g, chip_smoke.FLASH_BWD_TOL)
    again = flash.flash_attention_bwd(q, k, v, out, lse, do, None, causal, seg)
    assert all(torch.equal(a, g) for a, g in zip(again, got))
    want_tiles = flash.kernel_visits(causal, seg_cpu if seg is not None else None, t, 256, h, b)
    assert visits.tolist() == want_tiles


def _wide_mixing(dev, b, n, per_row, seed=7):
    """A scaled strict lower mixing matrix rounded to bf16, [N, N] or one per
    batch row [B, N, N], as the chunked op hands it to K3 / K3b."""
    shape = (b, n, n) if per_row else (n, n)
    m = torch.rand(*shape, generator=torch.Generator(dev).manual_seed(seed), device=dev)
    return torch.tril(m * 128**-0.5, -1).to(_BF16).float().contiguous()


@pytest.mark.parametrize("b,n,per_row", [(1, 33, False), (1, 64, False), (2, 100, False),
                                         (1, 448, False), (1, 512, False), (2, 96, True),
                                         (1, 256, False), (1, 832, False), (2, 256, True),
                                         (3, 200, True), (1, 320, False), (2, 33, True),
                                         (2, 64, True), (2, 448, True), (2, 512, True),
                                         (2, 832, True)])
def test_wide_mix_kernels_match_plain(dev, b, n, per_row):
    """K3 and K3b beyond 32 chunks against their plain versions, shared and
    per-row M (reloaded as the batch row changes), ragged N included: the
    small form (N <= 64), streamed at 2-4 row tiles (N <= 256), then strips
    with M through a ring and one or two buffers of rows; dS and dMs bit for
    bit over two runs (fixed slices, no atomics)."""
    states4 = _randn(dev, b, n, 512, 256, seed=1).to(_BF16)
    dmixed4 = _randn(dev, b, n, 512, 256, seed=2).to(_BF16)
    m = _wide_mixing(dev, b, n, per_row)
    before = dict(mhla_chunk.launches)
    out = mhla_chunk.mix_states(m, states4)
    assert_close(f"K3 wide N={n}", mhla_chunk.mix_states_plain(m, states4), out, KERNEL_TOL)
    ds, dm = mhla_chunk.mix_states_bwd(m, dmixed4, states4)
    ds_ref, dm_ref = mhla_chunk.mix_states_bwd_plain(m, dmixed4, states4)
    assert_close(f"K3b wide dS N={n}", ds_ref, ds, KERNEL_TOL)
    assert_close(f"K3b wide dM N={n}", dm_ref, dm, KERNEL_TOL)
    assert dm.shape == m.shape and not torch.count_nonzero(torch.triu(dm))
    ds2, dm2 = mhla_chunk.mix_states_bwd(m, dmixed4, states4)
    assert torch.equal(ds, ds2) and torch.equal(dm, dm2)
    after = mhla_chunk.launches
    assert after["mix_states"] == before["mix_states"] + 1
    assert after["mix_states_bwd"] == before["mix_states_bwd"] + 2


def test_wide_mix_kernels_hold_at_a_size_met_before(dev):
    """The strip kernel's shared memory grows with N (N = 512 asks more
    than 448): K3 and K3b at N = 512, then 448, then 512 again in one
    process each launch and match plain, so a smaller size asked in between
    does not leave a larger one it met before unlaunchable."""
    for n in (512, 448, 512):
        states4 = _randn(dev, 1, n, 128, 128, seed=1).to(_BF16)
        dmixed4 = _randn(dev, 1, n, 128, 128, seed=2).to(_BF16)
        m = _wide_mixing(dev, 1, n, False)
        out = mhla_chunk.mix_states(m, states4)
        assert_close(f"K3 wide N={n}", mhla_chunk.mix_states_plain(m, states4), out, KERNEL_TOL)
        ds, dm = mhla_chunk.mix_states_bwd(m, dmixed4, states4)
        ds_ref, dm_ref = mhla_chunk.mix_states_bwd_plain(m, dmixed4, states4)
        assert_close(f"K3b wide dS N={n}", ds_ref, ds, KERNEL_TOL)
        assert_close(f"K3b wide dM N={n}", dm_ref, dm, KERNEL_TOL)


@pytest.mark.parametrize("n", [32, 33])
def test_mix_kernels_take_m_at_bf16(dev, n):
    """K3 and K3b at N = 32 (the small form, M's tile built in registers)
    and N = 33 take an unrounded M at bf16: the same bits as M rounded
    first, and the plain versions' result."""
    states4 = _randn(dev, 2, n, 512, 256, seed=3).to(_BF16)
    dmixed4 = _randn(dev, 2, n, 512, 256, seed=4).to(_BF16)
    m = torch.tril(torch.rand(n, n, generator=torch.Generator(dev).manual_seed(6),
                              device=dev) * 128**-0.5, -1)
    m_bf = m.to(_BF16).float()
    out = mhla_chunk.mix_states(m, states4)
    assert torch.equal(out, mhla_chunk.mix_states(m_bf, states4))
    assert_close(f"K3 N={n}", mhla_chunk.mix_states_plain(m, states4), out, KERNEL_TOL)
    ds = mhla_chunk.mix_states_bwd(m, dmixed4, states4)[0]
    assert torch.equal(ds, mhla_chunk.mix_states_bwd(m_bf, dmixed4, states4)[0])
    assert_close(f"K3b dS N={n}", mhla_chunk.mix_states_bwd_plain(m, dmixed4, states4)[0], ds,
                 KERNEL_TOL)


@pytest.mark.parametrize("n", [1, 2, 13, 31, 32, 33, 64])
@pytest.mark.parametrize("hdk,dv", [(512, 256), (5, 128)])
def test_small_mix_kernels_match_plain(dev, n, hdk, dv):
    """K3 and K3b's dS at the chunk counts of the small form and its edges
    (one chunk, a 781-token row's 13, (a)'s 31, (c)'s 32, 33, 64), at the
    340M's states and at a state size that ends half way through an item of
    256 columns (R = 640), with a shared M and one per batch row: each
    against its plain version, the same bits twice, and per-row rows that
    repeat the shared M give the shared result bit for bit."""
    b = 3
    states4 = _randn(dev, b, n, hdk, dv, seed=1).to(_BF16)
    dmixed4 = _randn(dev, b, n, hdk, dv, seed=2).to(_BF16)
    m = _wide_mixing(dev, b, n, False)
    m_rows = _wide_mixing(dev, b, n, True)
    for tag, mm in (("shared", m), ("per-row", m_rows)):
        out = mhla_chunk.mix_states(mm, states4)
        assert_close(f"K3 {tag} N={n} R={hdk * dv}", mhla_chunk.mix_states_plain(mm, states4),
                     out, KERNEL_TOL)
        assert torch.equal(out, mhla_chunk.mix_states(mm, states4))
        ds, dm = mhla_chunk.mix_states_bwd(mm, dmixed4, states4)
        ds_ref, dm_ref = mhla_chunk.mix_states_bwd_plain(mm, dmixed4, states4)
        assert_close(f"K3b dS {tag} N={n}", ds_ref, ds, KERNEL_TOL)
        assert_close(f"K3b dM {tag} N={n}", dm_ref, dm, KERNEL_TOL)
        ds2, dm2 = mhla_chunk.mix_states_bwd(mm, dmixed4, states4)
        assert torch.equal(ds, ds2) and torch.equal(dm, dm2)
    repeated = m.expand(b, n, n).contiguous()
    assert torch.equal(mhla_chunk.mix_states(m, states4),
                       mhla_chunk.mix_states(repeated, states4))
    assert torch.equal(mhla_chunk.mix_states_bwd(m, dmixed4, states4)[0],
                       mhla_chunk.mix_states_bwd(repeated, dmixed4, states4)[0])


def test_long_context_shapes_the_kernels_lack_raise(dev):
    """Head dim 384 (a multiple of 128 that the JAX rule sends to flash)
    and a sequence longer than the mixing matrix's slots raise."""
    from mhla_tpu_torch.kernels import mhla_chunk_fused_flat

    q = torch.zeros(1, 2048, 1, 384, dtype=_BF16, device=dev)
    with pytest.raises(ValueError):
        flash.flash_attention(q, q, q, causal=True)
    x = torch.zeros(1, 65 * 64, 2 * 128, dtype=_BF16, device=dev)
    with pytest.raises(ValueError):  # 65 chunks, 64 slots
        mhla_chunk_fused_flat(x, x, x, torch.ones(64, 64, device=dev), num_heads=2)


def test_tiny_long_context_hybrid_lm_through_the_kernels(dev):
    """A 2-layer hybrid with one softmax layer of 2 heads of 256 and 64
    mixing slots serves a 2,112-token prompt (33 chunks: K3 wide; K9 causal
    at head dim 256) and trains one step at that length (K9b, K3b wide)."""
    cfg = MHLALMConfig(hidden_size=512, num_hidden_layers=2, num_heads=2, vocab_size=128,
                       max_position_embeddings=4096, attn={"layers": [0]},
                       dtype=torch.bfloat16)
    model = MHLAForCausalLM(cfg, device=dev)
    init_lm_params(model, torch.Generator(dev).manual_seed(0))
    ids = torch.randint(0, 128, (1, 2112), generator=torch.Generator(dev).manual_seed(1),
                        device=dev)
    kernels.reset_launch_counts()
    toks = generate(model, ids, max_new_tokens=4)
    counts = kernels.launch_counts()
    assert toks.shape == (1, 2116)
    assert counts["flash_attention_masked"] == 1 and counts["mix_states"] == 1
    state = init_train_state(model, OptimizerConfig(warmup_steps=1))
    step = make_train_step(lambda mdl, batch: (cross_entropy_loss(mdl(batch)[0], batch), {}))
    kernels.reset_launch_counts()
    _, metrics = step(state, ids)
    counts = kernels.launch_counts()
    assert torch.isfinite(torch.as_tensor(float(metrics["loss"])))
    assert counts["flash_attention_masked_bwd"] == 1 and counts["mix_states_bwd"] == 1


# (rows of a, N, K, a read MN-major, b read MN-major) of mhla_wgmma_check's
# layouts (csrc/hopper_check.cu): the products K9 and K9b run (0-7; a from
# registers where b is MN-major; 6 also the small K3 / dS), then K2b's and
# the larger K3 / K3b forms' (8-13), then K2's second 64 rows of Dk (14: A
# the last 64 columns of a [64][128] tile read MN-major)
_WGMMA_LAYOUTS = [(128, 128, 128, False, False), (128, 64, 256, False, False),
                  (128, 64, 128, False, False), (64, 128, 128, False, False),
                  (64, 64, 256, False, False), (64, 128, 128, False, True),
                  (64, 256, 64, False, True), (64, 128, 64, False, True),
                  (64, 128, 128, False, True), (64, 128, 256, False, True),
                  (64, 256, 128, False, False), (64, 64, 64, True, True),
                  (64, 128, 64, True, True), (64, 64, 64, False, True),
                  (128, 128, 64, True, True)]


@pytest.mark.parametrize("layout", range(len(_WGMMA_LAYOUTS)))
def test_wgmma_over_tma_tiles_matches_matmul(dev, layout):
    """One wgmma product over TMA-loaded, 128-byte-swizzled tiles for each
    operand layout of K9 / K9b, K2, K2b and K3 / K3b (K-major a and b;
    register a with b read MN-major; a and b from shared memory, either
    read MN-major) against torch.matmul of the same bf16 values in float32."""
    import ctypes

    from mhla_tpu_torch.kernels import _build

    rows, n, k, a_mn, b_mn = _WGMMA_LAYOUTS[layout]
    lib = _build.load()
    lib.mhla_wgmma_check.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 4
    lib.mhla_wgmma_check.restype = ctypes.c_int
    a = _randn(dev, k, rows, seed=layout).to(_BF16) if a_mn else \
        _randn(dev, rows, k, seed=layout).to(_BF16)
    b = _randn(dev, k, n, seed=layout + 10).to(_BF16) if b_mn else \
        _randn(dev, n, k, seed=layout + 10).to(_BF16)
    c = torch.full((64, n), float("nan"), device=dev)
    err = lib.mhla_wgmma_check(layout, a.data_ptr(), b.data_ptr(), c.data_ptr(),
                               torch.cuda.current_stream(dev).cuda_stream)
    torch.cuda.synchronize()
    assert err == 0
    a64 = (a.float().T if a_mn else a.float())[rows - 64:]
    ref = a64 @ (b.float() if b_mn else b.float().T)
    assert torch.allclose(c, ref, rtol=1e-4, atol=1e-3), (c - ref).abs().max().item()


@pytest.mark.parametrize("layout", [15, 16])
def test_tf32_wgmma_over_a_tma_tile_matches_float64(dev, layout):
    """K6's TF32 product on one tile (mhla_wgmma_check layouts 15 and 16):
    A = S^T from a [32][64] float32 tile loaded by TMA a k-step at a time and
    read transposed into registers, B = M^T from M's [40][32] rows split by
    the threads into a swizzled K-major panel, as K6 reads its stages and M. Three products
    (hi hi + hi lo + lo hi) hold the float64 product within 1e-6 in relative
    RMS; one (hi hi) within 2e-3, so the layouts are right, but not within
    1e-5, so it is the split that carries float32 accuracy."""
    import ctypes

    from mhla_tpu_torch.kernels import _build
    from mhla_tpu_torch.utils import get_err_ratio

    lib = _build.load()
    lib.mhla_wgmma_check.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 4
    lib.mhla_wgmma_check.restype = ctypes.c_int
    a, b = _randn(dev, 32, 64, seed=layout), _randn(dev, 40, 32, seed=layout + 10)
    c = torch.full((64, 40), float("nan"), device=dev)
    err = lib.mhla_wgmma_check(layout, a.data_ptr(), b.data_ptr(), c.data_ptr(),
                               torch.cuda.current_stream(dev).cuda_stream)
    torch.cuda.synchronize()
    assert err == 0
    rel = get_err_ratio(a.double().T @ b.double().T, c)
    assert (rel < 1e-6) if layout == 15 else (1e-5 < rel < 2e-3), rel


@pytest.mark.parametrize("d", [128, 256])
@pytest.mark.parametrize("form", ["square", "cross", "ragged", "causal", "segment",
                                  "causal_segment"])
def test_flash_bwd_is_bit_equal_over_two_runs(dev, d, form):
    """K9b gives the same bits twice in every form at both head dims (three
    launches, no atomics)."""
    tq, tk = {"square": (512, 512), "cross": (1000, 512), "ragged": (781, 33),
              "causal": (781, 781), "segment": (1000, 1000), "causal_segment": (2048, 2048)}[form]
    seg = None
    if "segment" in form:
        seg = torch.stack([_doc_ids([10, 300, 1, 333], tq), _doc_ids([tq - 1], tq)]).to(dev)
    causal = form.startswith("causal")
    q, do = (_randn(dev, 2, tq, 2, d, seed=s).to(_BF16) for s in (1, 4))
    k, v = (_randn(dev, 2, tk, 2, d, seed=s).to(_BF16) for s in (2, 3))
    out, lse = flash._flash_fwd(q, k, v, None, True, causal, seg)
    first = flash.flash_attention_bwd(q, k, v, out, lse, do, None, causal, seg)
    again = flash.flash_attention_bwd(q, k, v, out, lse, do, None, causal, seg)
    assert all(torch.equal(a, g) for a, g in zip(first, again))
    assert all(torch.isfinite(g.float()).all() for g in first)


def _sass_bodies() -> dict:
    """The built library's SASS (``cuobjdump -sass``) by kernel name."""
    import os
    import shutil
    import subprocess

    from mhla_tpu_torch.kernels import _build

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    assert os.path.exists(tool), "cuobjdump not found"
    sass = subprocess.run([tool, "-sass", str(_build.build())], capture_output=True, text=True,
                          check=True).stdout
    bodies, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :", 1)[1].strip()
            bodies[name] = []
        elif name is not None:
            bodies[name].append(line)
    return {fn: "\n".join(body) for fn, body in bodies.items()}


def test_flash_kernels_run_on_wgmma_and_tma(dev):
    """The built library's K9, K9b, K10 and K10b kernels hold HGMMA (wgmma)
    and UTMALDG (TMA loads) and no HMMA (mma.sync), in every instantiation,
    K10's two (``radial_fwd_kernel``, serving and training: the radial form
    of K9's body) and K10b's two (``radial_bwd_*``: of K9b's bodies), under
    names of their own, included."""
    found = {kind: 0 for kind in ("flash_fwd_kernel", "flash_bwd_dkv_kernel",
                                  "flash_bwd_dq_kernel", "radial_fwd_kernel",
                                  "radial_bwd_dkv_kernel", "radial_bwd_dq_kernel")}
    for fn, text in _sass_bodies().items():
        kind = next((k for k in found if k in fn), None)
        if kind is None:
            continue
        assert "HGMMA" in text and "UTMALDG" in text, fn
        assert " HMMA" not in text, fn
        found[kind] += 1
    # the backward's four mask forms at both head dims, and the radial form at 128
    assert found == {"flash_fwd_kernel": 16, "flash_bwd_dkv_kernel": 8, "flash_bwd_dq_kernel": 8,
                     "radial_fwd_kernel": 2, "radial_bwd_dkv_kernel": 1,
                     "radial_bwd_dq_kernel": 1}


def test_dense_mix_kernels_run_on_tf32_wgmma_and_tma(dev):
    """The built library's K6 kernels (float32 and bf16, 16 to 80 rows of M
    a block on clusters of two, 48 and 56 on clusters of four) hold HGMMA (wgmma),
    UTMALDG (TMA loads) and UTMASTG (TMA stores) and no FFMA: the product
    runs on the tensor cores, not on float32 FMAs."""
    found = 0
    for fn, text in _sass_bodies().items():
        if "mix_dense_kernel" not in fn:
            continue
        assert "HGMMA" in text and "UTMALDG" in text and "UTMASTG" in text, fn
        assert "FFMA" not in text, fn
        found += 1
    assert found == 14


def test_block_readout_kernels_run_on_tf32_wgmma_and_tma(dev):
    """The built library's K7 kernels (float32 and bf16 at Dk = 128 and 256)
    hold HGMMA (wgmma), UTMALDG (TMA loads) and UTMASTG (TMA stores), its K7b
    kernels (float32 and bf16) HGMMA and UTMALDG, and none of them FFMA:
    the products run on the tensor cores, not on float32 FMAs."""
    found = {"readout_kernel": 0, "readout_bwd_kernel": 0}
    for fn, text in _sass_bodies().items():
        if "gla_" in fn:  # K12's gla_readout_kernel
            continue
        kind = next((k for k in found if k + "I" in fn), None)
        if kind is None:
            continue
        assert "HGMMA" in text and "UTMALDG" in text, fn
        assert kind != "readout_kernel" or "UTMASTG" in text, fn
        assert "FFMA" not in text, fn
        found[kind] += 1
    assert found == {"readout_kernel": 4, "readout_bwd_kernel": 2}


def test_k2b_and_wide_mix_kernels_run_on_wgmma_and_tma(dev):
    """The built library's K2 kernel, its K2b kernels (key tiles 64, 128,
    256), the K3 / K3b kernels (the small form at 1-4 products a stage, the
    streamed form at 2-4 row tiles and the strip form, both walks) and the
    dMs Gram kernel hold HGMMA (wgmma) and UTMALDG (TMA loads) and no HMMA
    (mma.sync or WMMA)."""
    found = {kind: 0 for kind in ("chunk_states_kernel", "chunk_states_bwd_kernel",
                                  "mix_small_kernel", "mix_stream_kernel",
                                  "mix_strip_kernel", "gram_partial_kernel")}
    for fn, text in _sass_bodies().items():
        kind = next((k for k in found if k in fn), None)
        if kind is None:
            continue
        assert "HGMMA" in text and "UTMALDG" in text, fn
        assert " HMMA" not in text, fn
        found[kind] += 1
    assert found == {"chunk_states_kernel": 1, "chunk_states_bwd_kernel": 3,
                     "mix_small_kernel": 8, "mix_stream_kernel": 6, "mix_strip_kernel": 2,
                     "gram_partial_kernel": 1}


def test_chunk_output_kernels_run_on_wgmma_and_tma(dev):
    """The built library's K4 kernel and its K4b kernels (key tiles 64, 128,
    256) hold HGMMA (wgmma), UTMALDG (TMA loads) and UTMASTG (TMA stores)
    and no HMMA (mma.sync or WMMA)."""
    found = {kind: 0 for kind in ("chunk_output_kernel", "chunk_output_bwd_kernel")}
    for fn, text in _sass_bodies().items():
        kind = next((k for k in found if k in fn), None)
        if kind is None:
            continue
        assert "HGMMA" in text and "UTMALDG" in text and "UTMASTG" in text, fn
        assert " HMMA" not in text, fn
        found[kind] += 1
    assert found == {"chunk_output_kernel": 1, "chunk_output_bwd_kernel": 3}


def _chunk_output_inputs(dev, b, t, h, dk, dv, c, per_row, seed=0):
    """K4 / K4b's inputs at a ragged last chunk (tokens past t zero): relu q
    and k, v, dO, K2 -> K3's mixed states (plain) and md, shared [N] or one
    per batch row [B, N]."""
    n = -(-t // c)
    gen = torch.Generator(dev).manual_seed(seed)

    def tokens(d, relu):
        y = torch.randn(b, n * c, h * d, generator=gen, device=dev)
        y[:, t:] = 0
        y = torch.relu(y) if relu else y
        return y.to(_BF16).reshape(b, n, c, h * d).contiguous()

    q4, k4, v4, do4 = tokens(dk, True), tokens(dk, True), tokens(dv, False), tokens(dv, False)
    m = torch.tril(torch.rand(*((b, n, n) if per_row else (n, n)), generator=gen, device=dev)
                   * dk**-0.5)
    m_strict = torch.tril(m, -1).to(_BF16).float().contiguous()
    m_diag = torch.diagonal(m, dim1=-2, dim2=-1).contiguous()
    mixed4 = mhla_chunk.mix_states_plain(m_strict, mhla_chunk.chunk_states_plain(k4, v4, h))
    return q4, k4, v4, mixed4, m_diag, do4


@pytest.mark.parametrize("dv", [128, 256])
@pytest.mark.parametrize("dk", [64, 96, 128, 256, 384])
@pytest.mark.parametrize("c", [16, 32, 48, 64])
def test_chunk_output_kernels_match_plain(dev, c, dk, dv):
    """K4 and K4b against their plain versions at chunks of 16 to 64 rows
    (zero-filled tile rows, not stored), key head dims on each of K4b's key
    tiles (64, 128, 256) and between them (96), Dv of one and two 128-column
    panels, a ragged last chunk, per-row md at C = 64; K4 also at Dk = 384
    (Dk walked in panels; K4b raises there, as K2b)."""
    h, t = 2, 5 * c - 7
    q4, k4, v4, mixed4, m_diag, do4 = _chunk_output_inputs(dev, 2, t, h, dk, dv, c, c == 64)
    before = dict(mhla_chunk.launches)
    got = mhla_chunk.chunk_output(q4, k4, v4, mixed4, m_diag, h)
    assert_close(f"K4 C={c} Dk={dk} Dv={dv}",
                 mhla_chunk.chunk_output_plain(q4, k4, v4, mixed4, m_diag, h), got, KERNEL_TOL)
    if dk > 256:
        with pytest.raises(ValueError):
            mhla_chunk.chunk_output_bwd(q4, k4, v4, mixed4, m_diag, do4, h)
        return
    got = mhla_chunk.chunk_output_bwd(q4, k4, v4, mixed4, m_diag, do4, h)
    ref = mhla_chunk.chunk_output_bwd_plain(q4, k4, v4, mixed4, m_diag, do4, h)
    for name, r, g in zip(("dq", "dk_intra", "dv_intra", "dmixed", "dmd"), ref, got):
        assert g.shape == r.shape and g.dtype == r.dtype
        assert_close(f"K4b {name} C={c} Dk={dk} Dv={dv}", r, g, KERNEL_TOL)
    assert mhla_chunk.launches["chunk_output"] == before["chunk_output"] + 1
    assert mhla_chunk.launches["chunk_output_bwd"] == before["chunk_output_bwd"] + 1


@pytest.mark.parametrize("per_row", [False, True])
def test_chunk_output_bwd_is_bit_equal_over_two_runs(dev, per_row):
    """K4b gives the same bits twice in all five outputs at the 340M's
    training shape (d md from one partial per chunk and head, summed in a
    fixed order: no atomics), shared and per-row md; so does K4."""
    args = _chunk_output_inputs(dev, 8, 2048, 4, 128, 256, 64, per_row)
    first = mhla_chunk.chunk_output_bwd(*args, 4)
    again = mhla_chunk.chunk_output_bwd(*args, 4)
    assert all(torch.equal(a, g) for a, g in zip(first, again))
    assert all(torch.isfinite(g.float()).all() for g in first)
    o = mhla_chunk.chunk_output(*args[:5], 4)
    assert torch.equal(o, mhla_chunk.chunk_output(*args[:5], 4))


def _layer_pair(dev, **kw):
    """An MHLA layer (float32, seeded) on the card and its copy on the CPU,
    where the chunk op runs its plain versions."""
    from mhla_tpu_torch.layers import MHLACausal

    torch.manual_seed(0)
    cpu = MHLACausal(**kw)
    with torch.no_grad():  # a mixing matrix off its init, as after training
        cpu.mixing_matrix.copy_(torch.tril(torch.rand_like(cpu.mixing_matrix)))
    card = MHLACausal(**kw, device=dev)
    card.load_state_dict(cpu.state_dict())
    return card, cpu


def _layer_grads(layer, x):
    x = x.clone().requires_grad_()
    o, _ = layer(x)
    (o * torch.linspace(-1, 1, o.shape[-1], device=o.device)).sum().backward()
    return [o, x.grad] + [p.grad for p in layer.parameters()]


@pytest.mark.parametrize("kw,t", [
    # hidden 1024, 4 heads, expand_v 0.75: Dk 128, Dv 192, which JAX runs on XLA
    (dict(hidden_size=1024, expand_v=0.75, num_heads=4), 200),
    # chunk 12 (not % 8) at the tiny LM's Dk 128, Dv 256
    (dict(hidden_size=512, num_heads=2, chunk_size=12, num_slots=20), 200),
])
def test_layers_off_the_kernel_route_run_as_jax(dev, kw, t):
    """An MHLA layer at a shape JAX sends to its XLA route runs the chunk op's
    plain versions on the card, launching no chunk kernel: its output and
    the gradients of its input and parameters match its copy on the CPU
    (float32 on both; the sums run in other orders)."""
    card, cpu = _layer_pair(dev, **kw)
    assert not mhla_chunk.kernel_route(card.chunk_size, card.head_k_dim, card.head_v_dim)
    x = torch.randn(2, t, kw["hidden_size"], generator=torch.Generator().manual_seed(1))
    before = dict(mhla_chunk.launches)
    got = _layer_grads(card, x.to(dev))
    assert mhla_chunk.launches == before
    for i, (r, g) in enumerate(zip(_layer_grads(cpu, x), got)):
        assert_close(f"layer {kw} tensor {i}", r, g, 1e-5)


def test_off_route_head_dim_layer_runs_k1_plain_as_jax(dev):
    """An MHLA layer at Dk = 96 (hidden 768, 4 heads, expand_k 0.5), where
    JAX runs jnp for fmap + RoPE and XLA for the chunk op: on the card it
    trains and serves with no K1 / K1b or chunk-kernel launch, and its
    output and gradients match its copy on the CPU (float32 on both). The
    feature map is elu + 1, whose derivative is continuous: under relu one
    projected k of 153,600 lies 1.5e-8 from the kink at this seed, float32
    noise puts it on either side, and that one gradient entry alone moves
    the relative RMS of dx by 3.6e-4 (as for any relu input that close)."""
    kw = dict(hidden_size=768, num_heads=4, feature_map="elu")
    card, cpu = _layer_pair(dev, **kw)
    assert card.head_k_dim == 96 and not fmap_rope.kernel_route(card.head_k_dim)
    x = torch.randn(2, 200, 768, generator=torch.Generator().manual_seed(1))
    before = dict(fmap_rope.launches), dict(mhla_chunk.launches)
    got = _layer_grads(card, x.to(dev))
    for i, (r, g) in enumerate(zip(_layer_grads(cpu, x), got)):
        assert_close(f"Dk 96 layer tensor {i}", r, g, 1e-5)
    with torch.no_grad():  # serving: a prefill without autograd
        assert_close("Dk 96 layer serving", cpu(x)[0], card(x.to(dev))[0], 1e-5)
    assert (dict(fmap_rope.launches), dict(mhla_chunk.launches)) == before


def test_fmap_rope_kernels_at_head_dim_384(dev):
    """Dh = 384 (Dh % 128 == 0, Dh / 2 = 192 not a power of two), which JAX
    sends to its Pallas kernel: K1 and K1b launch once each (an arange over
    the next power of two, masked) and match their plain versions."""
    assert fmap_rope.kernel_route(384)
    cos, sin = rotary_cos_sin(2048, 384, device=dev)
    x = _randn(dev, 2, 100, 2 * 384, seed=2).to(torch.bfloat16).requires_grad_()
    dy = _randn(dev, 2, 100, 2 * 384, seed=3).to(torch.bfloat16)
    before = dict(fmap_rope.launches)
    out = fmap_rope.fused_fmap_rope_flat(x, cos, sin, 2, "relu", offset=9)
    out.backward(dy)
    assert fmap_rope.launches == {n: before[n] + 1 for n in before}
    xd = x.detach()
    assert_close("K1 Dh=384", fmap_rope.fmap_rope_plain(xd, cos, sin, 2, "relu", offset=9), out,
                 KERNEL_TOL)
    assert_close("K1b Dh=384",
                 fmap_rope.fmap_rope_bwd_plain(dy, xd, cos, sin, 2, "relu", offset=9), x.grad,
                 KERNEL_TOL)


def test_kernel_route_shapes_the_kernels_lack_raise(dev):
    """Chunk 8 at Dk 128, Dv 256 is on JAX's Pallas route, which the port's
    kernels lack (chunk % 16): it raises, as chunk 80 does (K4 takes at most
    64 rows)."""
    x = torch.zeros(1, 160, 2 * 128, dtype=_BF16, device=dev)
    y = torch.zeros(1, 160, 2 * 256, dtype=_BF16, device=dev)
    m = torch.tril(torch.ones(20, 20, device=dev))
    for c in (8, 80):
        assert mhla_chunk.kernel_route(c, 128, 256)
        with pytest.raises(ValueError):
            mhla_chunk.mhla_chunk_fused_flat(x, x, y, m, num_heads=2, chunk_size=c)


def test_340m_width_layer_runs_every_chunk_kernel(dev):
    """The 340M's MHLA layer (hidden 1024, 4 heads: Dk 128, Dv 256) in bf16
    takes the kernels' route: one forward and backward launch K2-K4 and
    K4b-K2b once each."""
    from mhla_tpu_torch.layers import MHLACausal

    layer = MHLACausal(device=dev).to(_BF16)
    x = torch.randn(2, 256, 1024, device=dev, dtype=_BF16, requires_grad=True)
    before = dict(mhla_chunk.launches)
    o, _ = layer(x)
    o.float().sum().backward()
    assert {n: mhla_chunk.launches[n] - before[n] for n in before} == {n: 1 for n in before}
    assert torch.isfinite(x.grad.float()).all()


def test_mhla3d_lepe_layer_on_the_kernels_matches_plain(dev):
    """An ``MHLA3D(is_lepe=True)`` layer at a small Wan shape (head dim 128,
    2,048 tokens in 8 blocks), bf16 activations over float32 parameters:
    output and gradients through K5-K8b against the plain versions, and the
    LePE convolution adds no launch of theirs (the same counts as the layer
    without it)."""
    import chip_smoke
    from mhla_tpu_torch.layers import MHLA3D

    grid, layout = (8, 16, 16), (2, 2, 2)
    x = _randn(dev, 1, 2048, 256, seed=1).to(_BF16)
    w = _randn(dev, 1, 2048, 256, seed=2)
    tables = rope_tables_flat(grid, 128, device=dev)
    counts = {}
    for lepe in (False, True):
        layer = MHLA3D(256, 2, layout, normalize_out=False, is_lepe=lepe, device=dev)
        init_wan_params(layer, torch.Generator(dev).manual_seed(3))
        kernels.reset_launch_counts()
        got = chip_smoke.layer_grads(layer, x, w, grid, tables)
        counts[lepe] = kernels.launch_counts()
        with chip_smoke.plain_kernels():
            ref = chip_smoke.layer_grads(layer, x, w, grid, tables)
        assert kernels.launch_counts() == counts[lepe]
        for name in ref:
            assert torch.isfinite(got[name]).all(), name
            assert_close(f"LePE={lepe} d {name}", ref[name], got[name], chip_smoke.LAYER_GRAD_TOL)
    assert counts[True] == counts[False] and counts[True]["block_readout_bwd"] == 1
    assert counts[True]["blockify_island"] == 3 and counts[True]["unblockify"] == 3


def _entry_point_defaults_to_cuda(main, argv):
    """``main(argv)`` with no ``--device``: the model's parameters are on
    the card."""
    out = main(argv)
    assert next(out["model"].parameters()).device.type == "cuda"
    return out


def test_tiny_dit_and_vit_train_on_the_card(dev, tmp_path):
    """One ``dit_train`` and one ``vit_train`` step on the card at tiny widths,
    no ``--device`` (the default is cuda): finite losses, the trainable
    mixing clamped to [0, 1], no kernel launched (MHLA2D runs the plain
    blockwise op, as JAX runs its einsums); the FID CLI samples from the
    DiT run's checkpoint on the card."""
    from mhla_tpu_torch.eval import fid_cli
    from mhla_tpu_torch.train import dit_train, vit_train

    kernels.reset_launch_counts()
    dit = _entry_point_defaults_to_cuda(dit_train.main, [
        "--depth=2", "--hidden_size=64", "--num_heads=2", "--input_size=8", "--block_size=4",
        "--num_classes=10", "--train.batch_size=4", "--train.max_steps=2",
        "--optimizer.learning_rate=0.5", f"--work_dir={tmp_path}/dit"])
    assert all(map(torch.isfinite, map(torch.tensor, dit["losses"])))
    mix = [p.detach() for n, p in dit["model"].named_parameters()
           if n.endswith("piece_attn.weight")]
    assert mix and all(float(p.min()) >= 0.0 and float(p.max()) <= 1.0 for p in mix)
    vit = _entry_point_defaults_to_cuda(vit_train.main, [
        "--model_name=deit_tiny_mhla", "--img_size=32", "--piece_size=2", "--num_classes=10",
        "--train.batch_size=8", "--train.max_steps=2", "--train.eval_interval=2",
        "--train.eval_batches=1", "--optimizer.warmup_steps=1", f"--work_dir={tmp_path}/vit"])
    assert all(map(torch.isfinite, map(torch.tensor, vit["losses"])))
    assert 0.0 <= vit["val_acc"] <= 1.0
    res = fid_cli.main([f"--ckpt={tmp_path}/dit", "--depth=2", "--hidden_size=64",
                        "--num_heads=2", "--input_size=8", "--block_size=4", "--num_classes=10",
                        "--num_samples=4", "--batch_size=4", "--num_sampling_steps=3",
                        f"--out={tmp_path}/fid/s.npz"])
    import numpy as np

    assert np.load(res["npz"])["arr_0"].shape == (4, 8, 8, 4)
    assert not any(kernels.launch_counts().values())
