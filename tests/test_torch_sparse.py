"""Port of the radial sparse attention (the mask, the tile schedule, the
plain versions of K10 and K10b, ``sparse_flash_attention`` and its
gradients) held against ``mhla_tpu.kernels.sparse_attention`` on the CPU: the
JAX side takes its masked-softmax CPU route or runs its Pallas kernel body or
the splash kernel in interpret mode, the port its plain versions. Inputs come
from numpy with fixed seeds."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mhla_tpu.kernels import sparse_attention as jax_sparse
from mhla_tpu_torch.kernels import flash_attention as flash
from mhla_tpu_torch.kernels import sparse_attention as sparse
from mhla_tpu_torch.utils import assert_close

# (frames, tokens per frame): tokens per frame below, at and above the 64-token
# tile, multiples of it and not; T a multiple of the tile and not
GEOMETRIES = [(8, 32), (4, 50), (6, 7), (5, 100), (3, 64), (21, 12), (4, 130)]
_IDS = [f"{f}x{hw}" for f, hw in GEOMETRIES]
# (tokens, frames) that do not split evenly: a tail shorter than a frame and
# than a tile, a tail that holds whole further frames (24 tokens in "5" frames
# are 6 frames of 4), many further frames (29 in "10": 15 frames), tails past
# a tile boundary, the video model's frame count
RAGGED = [(437, 4), (24, 5), (29, 10), (100, 7), (323, 5), (1983, 21), (135, 2)]
_RAGGED_IDS = [f"{t}in{f}" for t, f in RAGGED]


def _qkv(b, t, h, d, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=(b, t, h, d)).astype(np.float32) for _ in range(3))


@pytest.mark.parametrize("hw", [1, 7, 64, 1500])
def test_radial_window_matches_jax(hw):
    dist = np.arange(0, 70)
    assert np.array_equal(sparse.radial_window(dist, hw), jax_sparse.radial_window(dist, hw))
    assert sparse.radial_window(np.array(0), hw) == hw == sparse.radial_window(np.array(1), hw)


@pytest.mark.parametrize("frames,hw", GEOMETRIES, ids=_IDS)
@pytest.mark.parametrize("pad", [None, 13])
def test_radial_mask_dense_matches_jax(frames, hw, pad):
    t = frames * hw
    pad_to = None if pad is None else t + pad
    ours = sparse.radial_mask_dense(t, frames, pad_to)
    assert ours.dtype == np.bool_
    assert np.array_equal(ours, jax_sparse.radial_mask_dense(t, frames, pad_to))
    if pad is None:
        # the on-device form of the mask's rows and the exact pair count
        assert np.array_equal(sparse.radial_block_mask(0, t, t, frames).numpy(), ours)
        assert np.array_equal(sparse.radial_block_mask(3, t - 2, t, frames).numpy(), ours[3:t - 2])
        assert sparse.radial_allowed_pairs(t, frames) == int(ours.sum())


@pytest.mark.parametrize("t,frames", RAGGED, ids=_RAGGED_IDS)
@pytest.mark.parametrize("pad", [None, 13])
def test_ragged_radial_mask_matches_jax(t, frames, pad):
    """Tokens past ``hw * frames`` fall into further frames by ``i // hw``,
    as in the JAX package's ``_radial_block``: the dense mask, its on-device
    rows and the pair count."""
    pad_to = None if pad is None else t + pad
    ours = sparse.radial_mask_dense(t, frames, pad_to)
    assert np.array_equal(ours, jax_sparse.radial_mask_dense(t, frames, pad_to))
    idx = np.arange(ours.shape[0])
    assert np.array_equal(ours, jax_sparse._radial_block(idx, idx, t, frames))
    if pad is None:
        assert np.array_equal(ours, ours.T)
        assert np.array_equal(sparse.radial_block_mask(0, t, t, frames).numpy(), ours)
        assert np.array_equal(sparse.radial_block_mask(5, t - 3, t, frames).numpy(), ours[5:t - 3])
        assert sparse.radial_allowed_pairs(t, frames) == int(ours.sum())


@pytest.mark.parametrize("frames,hw", GEOMETRIES, ids=_IDS)
@pytest.mark.parametrize("bq,bk", [(64, 64), (16, 32), (32, 8)])
def test_radial_schedule_matches_jax_and_is_conservative(frames, hw, bq, bk):
    _check_schedule(frames * hw, frames, bq, bk)


@pytest.mark.parametrize("t,frames", RAGGED, ids=_RAGGED_IDS)
@pytest.mark.parametrize("bq,bk", [(64, 64), (16, 32), (32, 8)])
def test_ragged_radial_schedule_matches_jax_and_is_conservative(t, frames, bq, bk):
    _check_schedule(t, frames, bq, bk)


@pytest.mark.parametrize(
    "t,frames", [(f * hw, f) for f, hw in GEOMETRIES] + RAGGED, ids=_IDS + _RAGGED_IDS)
@pytest.mark.parametrize("tile", [64, 16])
def test_radial_schedule_reads_the_same_from_the_key_side(t, frames, tile):
    """The dK/dV kernel walks, for key tile j, the list of query tile j: at
    square tiles the lists are those of the transposed mask, and an entry's
    ``full`` says that every pair of the key tile's real keys with the listed
    query tile is allowed and that no query of that tile lies past T."""
    offsets, tiles, full = sparse.radial_schedule(t, frames, tile, tile)
    mask_t = sparse.radial_mask_dense(t, frames).T  # [key, query]
    n = -(-t // tile)
    for j in range(n):
        mine = tiles[offsets[j]:offsets[j + 1]]
        hit = [i for i in range(n)
               if mask_t[j * tile:(j + 1) * tile, i * tile:(i + 1) * tile].any()]
        assert mine.tolist() == hit, j
        for i, is_full in zip(mine, full[offsets[j]:offsets[j + 1]]):
            blk = mask_t[j * tile:(j + 1) * tile, i * tile:(i + 1) * tile]
            assert bool(is_full) == (blk.all() and (i + 1) * tile <= t), (j, i)


def _check_schedule(t, frames, bq, bk):
    offsets, tiles, full = sparse.radial_schedule(t, frames, bq, bk)
    sched, n_steps, jax_full = jax_sparse._radial_schedule(t, frames, bq, bk)
    nq, nk = -(-t // bq), -(-t // bk)
    assert offsets.dtype == tiles.dtype == full.dtype == np.int32
    assert offsets.shape == (nq + 1,) and offsets[0] == 0 and offsets[-1] == len(tiles) == len(full)
    mask = sparse.radial_mask_dense(t, frames)
    for i in range(nq):
        mine = tiles[offsets[i]:offsets[i + 1]]
        assert np.array_equal(mine, sched[i, :n_steps[i]]), i  # same tiles, same order
        assert np.array_equal(full[offsets[i]:offsets[i + 1]], jax_full[i, :n_steps[i]]), i
        listed = np.zeros(nk, bool)
        listed[mine] = True
        for j in range(nk):
            blk = mask[i * bq:(i + 1) * bq, j * bk:(j + 1) * bk]
            if blk.any():  # every allowed pair lies inside a scheduled tile
                assert listed[j], (i, j)
        for j, is_full in zip(mine, full[offsets[i]:offsets[i + 1]]):
            if is_full:  # no disallowed real pair and no column past T under `full`
                assert mask[i * bq:(i + 1) * bq, j * bk:(j + 1) * bk].all(), (i, j)
                assert (j + 1) * bk <= t


def test_radial_schedule_at_the_video_geometry():
    """21 frames of 1,500 tokens in 64 x 64 tiles: the schedule keeps what
    the mask needs and little more."""
    t, frames = 31500, 21
    offsets, tiles, full = sparse.radial_schedule(t, frames)
    nq = -(-t // 64)
    density = len(tiles) / nq**2
    pairs = sparse.radial_allowed_pairs(t, frames) / t**2
    assert 0.47 < pairs < 0.48 and pairs < density < 0.56
    assert np.all(np.diff(offsets) > 0) and 0.7 < full.mean() < 0.8
    with pytest.raises(ValueError):  # more frames than tokens: no token per frame
        sparse.radial_schedule(6, 7)


@pytest.mark.parametrize("frames,hw", [(8, 32), (4, 50), (6, 7), (5, 100)],
                         ids=["8x32", "4x50", "6x7", "5x100"])
def test_radial_plain_matches_jax_cpu_route(frames, hw):
    """float32 on both sides, the same arithmetic in another summation
    order; the row blocking changes nothing."""
    t = frames * hw
    q, k, v = _qkv(2, t, 2, 64, seed=t)
    ref = jax_sparse.sparse_flash_attention(*(jnp.asarray(a) for a in (q, k, v)),
                                            num_frames=frames)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    out = sparse.radial_flash_attention_plain(tq, tk, tv, frames)
    assert out.shape == (2, t, 2, 64) and out.dtype == torch.float32
    assert_close(f"radial plain {frames}x{hw}", np.asarray(ref), out, 2e-5)
    blocked = sparse.radial_flash_attention_plain(tq, tk, tv, frames, block_rows=37)
    assert_close("radial plain, 37-row blocks", out, blocked, 1e-6)
    before = dict(sparse.launches)
    routed = sparse.sparse_flash_attention(tq, tk, tv, frames)  # CPU tensors: the plain version
    assert sparse.launches == before and torch.equal(routed, out)
    scaled = jax_sparse.sparse_flash_attention(
        *(jnp.asarray(a) for a in (q, k, v)), num_frames=frames, scale=0.3)
    assert_close("scale", np.asarray(scaled),
                 sparse.sparse_flash_attention(tq, tk, tv, frames, scale=0.3), 2e-5)


@pytest.mark.parametrize("frames,hw", [(4, 320), (3, 100)], ids=["4x320", "3x100"])
def test_radial_plain_bf16_matches_the_pallas_body(frames, hw):
    """bf16 streams through the JAX package's kernel body in interpret mode
    (which pads T to its 256 x 1024 tiles) against the plain version with
    bf16 streams; they round at different points (the Pallas wrapper folds
    the scale into q before the cast)."""
    t = frames * hw
    q, k, v = _qkv(1, t, 2, 128, seed=frames)
    ref = jax_sparse.radial_flash_attention(
        *(jnp.asarray(a) for a in (q, k, v)), frames, interpret=True)
    assert ref.dtype == jnp.float32
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    out = sparse.sparse_flash_attention(tq, tk, tv, frames, compute_dtype=torch.bfloat16)
    assert out.dtype == torch.float32  # q's dtype, whatever the streams'
    assert_close(f"radial bf16 {frames}x{hw}", np.asarray(ref), out, 2e-2)
    exact = sparse.radial_flash_attention_plain(tq, tk, tv, frames)
    assert_close("bf16 streams vs float32", exact, out, 2e-2)
    bf = sparse.sparse_flash_attention(*(a.to(torch.bfloat16) for a in (tq, tk, tv)), frames)
    assert bf.dtype == torch.bfloat16 and torch.equal(bf.float(), out)


def test_sparse_flash_attention_refusals():
    """What the JAX package's dispatch runs, runs: ``impl="splash"`` and
    ragged frames; ``impl="radial"`` with ragged frames fails there (an
    assert) and raises here."""
    q = torch.zeros(1, 24, 2, 64)
    even = sparse.sparse_flash_attention(q, q, q, 4)
    assert torch.equal(sparse.sparse_flash_attention(q, q, q, 4, impl="splash"), even)
    assert torch.equal(sparse.sparse_flash_attention(q, q, q, 4, impl="radial"), even)
    ragged = sparse.sparse_flash_attention(q, q, q, 5)  # 24 tokens in 5 frames
    assert torch.equal(sparse.sparse_flash_attention(q, q, q, 5, impl="splash"), ragged)
    with pytest.raises(ValueError):
        sparse.sparse_flash_attention(q, q, q, 5, impl="radial")
    with pytest.raises(ValueError):
        sparse.sparse_flash_attention(q, q, q, 4, impl="dense")
    with pytest.raises(ValueError):
        sparse.radial_flash_attention(q, q, q[:, :12], 4)
    with pytest.raises(ValueError):  # more frames than tokens
        sparse.radial_flash_attention(q, q, q, 25)
    with pytest.raises(ValueError):  # lse of another shape
        sparse.radial_flash_attention_bwd(q, q, q, q, torch.zeros(1, 24, 2), q, 4)


def _jax_masked_attention(q, k, v, frames, scale=None):
    """The JAX package's CPU route (masked softmax attention, float32)."""
    return jax_sparse.sparse_flash_attention(q, k, v, num_frames=frames, scale=scale)


@pytest.mark.parametrize("t,frames", [(256, 8), (200, 4), (42, 6), (437, 4), (24, 5), (29, 10),
                                      (135, 2)],
                         ids=["256in8", "200in4", "42in6", "437in4", "24in5", "29in10", "135in2"])
def test_radial_forward_lse_and_backward_match_jax_grad(t, frames):
    """Even and ragged frames, float32: the plain forward with its row
    log-sum-exp, the plain backward on them, and the same gradients through
    ``sparse_flash_attention`` under autograd (the ``autograd.Function`` of
    the CPU route), against ``jax.vjp`` of the JAX CPU route."""
    q, k, v = _qkv(2, t, 2, 32, seed=t)
    do = np.random.default_rng(t + 1).normal(size=q.shape).astype(np.float32)
    ref, vjp = jax.vjp(lambda a, b, c: _jax_masked_attention(a, b, c, frames),
                       *(jnp.asarray(a) for a in (q, k, v)))
    ref_grads = vjp(jnp.asarray(do))
    mask = jnp.asarray(jax_sparse.radial_mask_dense(t, frames))
    logits = jnp.einsum("bqhd,bkhd->bhqk", jnp.asarray(q) * 32**-0.5, jnp.asarray(k))
    ref_lse = jax.nn.logsumexp(jnp.where(mask[None, None], logits, -jnp.inf), axis=-1)

    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    out, lse = sparse.radial_flash_attention_plain(tq, tk, tv, frames, return_lse=True)
    assert lse.shape == (2, 2, t) and lse.dtype == torch.float32
    assert_close("out", np.asarray(ref), out, 2e-5)
    assert_close("lse", np.asarray(ref_lse), lse, 2e-5)
    assert torch.equal(out, sparse.radial_flash_attention_plain(tq, tk, tv, frames))
    routed = sparse.radial_flash_attention(tq, tk, tv, frames, return_lse=True)
    assert torch.equal(routed[0], out) and torch.equal(routed[1], lse)
    grads = sparse.radial_flash_attention_bwd_plain(tq, tk, tv, out, lse, tdo, frames)
    blocked = sparse.radial_flash_attention_bwd_plain(tq, tk, tv, out, lse, tdo, frames,
                                                      block_rows=37)
    before = dict(sparse.launches)
    assert all(torch.equal(a, b) for a, b in zip(
        grads, sparse.radial_flash_attention_bwd(tq, tk, tv, out, lse, tdo, frames)))
    leaves = [x.clone().requires_grad_() for x in (tq, tk, tv)]
    (sparse.sparse_flash_attention(*leaves, frames) * tdo).sum().backward()
    assert sparse.launches == before  # CPU tensors: the plain versions
    for name, r, g, b, leaf in zip("qkv", ref_grads, grads, blocked, leaves):
        assert g.dtype == torch.float32 and leaf.grad.dtype == torch.float32
        assert_close(f"d{name}", np.asarray(r), g, 2e-5)
        assert_close(f"d{name}, 37-row blocks", g, b, 1e-6)
        assert_close(f"d{name} under autograd", np.asarray(r), leaf.grad, 2e-5)


def test_radial_gradients_keep_the_inputs_dtype_and_scale():
    """bf16 leaves get bf16 gradients, float32 leaves with bf16 streams get
    float32 ones (the casts lie outside the autograd Function), and ``scale``
    reaches the backward."""
    t, frames = 100, 4
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, t, 2, 32, seed=3))
    do = torch.from_numpy(np.random.default_rng(4).normal(size=q.shape).astype(np.float32))
    ref, vjp = jax.vjp(lambda a, b, c: _jax_masked_attention(a, b, c, frames, scale=0.3),
                       *(jnp.asarray(a.numpy()) for a in (q, k, v)))
    ref_grads = vjp(jnp.asarray(do.numpy()))
    for leaf_dtype, cdt, tol in ((torch.float32, None, 2e-5), (torch.float32, torch.bfloat16, 2e-2),
                                 (torch.bfloat16, None, 2e-2)):
        leaves = [x.clone().to(leaf_dtype).requires_grad_() for x in (q, k, v)]
        out = sparse.sparse_flash_attention(*leaves, frames, scale=0.3, compute_dtype=cdt)
        assert out.dtype == leaf_dtype
        (out.float() * do).sum().backward()
        for name, r, leaf in zip("qkv", ref_grads, leaves):
            assert leaf.grad.dtype == leaf_dtype
            assert_close(f"d{name} {leaf_dtype} streams {cdt}", np.asarray(r), leaf.grad, tol)


def test_radial_gradients_match_the_splash_kernel_in_interpret_mode():
    """The JAX package's differentiable path: ``jax.grad`` through its splash
    kernel (interpret mode, float32 streams), at ragged frames (837 tokens in
    4 frames, padded there to 1,024 with rows that attend to themselves; the
    port pads nothing), forward and gradients."""
    t, frames, d = 837, 4, 128
    q, k, v = _qkv(1, t, 2, d, seed=5)
    do = np.random.default_rng(6).normal(size=q.shape).astype(np.float32)
    ref, vjp = jax.vjp(
        lambda a, b, c: jax_sparse._splash_attention(a, b, c, frames, d**-0.5, jnp.float32,
                                                     interpret=True),
        *(jnp.asarray(a) for a in (q, k, v)))
    ref_grads = vjp(jnp.asarray(do))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = sparse.sparse_flash_attention(*leaves, frames, impl="splash")
    assert_close("splash forward, ragged", np.asarray(ref), out, 2e-5)
    (out * torch.from_numpy(do)).sum().backward()
    for name, r, leaf in zip("qkv", ref_grads, leaves):
        assert_close(f"splash d{name}", np.asarray(r), leaf.grad, 2e-5)


@pytest.mark.parametrize("t,frames", [(437, 4), (24, 5), (100, 7)], ids=["437in4", "24in5", "100in7"])
@pytest.mark.parametrize("impl", [None, "splash"])
def test_sparse_flash_attention_ragged_and_splash_match_jax(t, frames, impl):
    """Ragged frames and ``impl="splash"`` compute the radial route's
    function: equal to the JAX CPU route at ragged T, and at an even T all
    three ``impl`` values give one result."""
    q, k, v = _qkv(2, t, 2, 64, seed=t + 7)
    ref = _jax_masked_attention(*(jnp.asarray(a) for a in (q, k, v)), frames)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    out = sparse.sparse_flash_attention(tq, tk, tv, frames, impl=impl)
    assert_close(f"{t} in {frames}, impl {impl}", np.asarray(ref), out, 2e-5)
    assert torch.equal(out, sparse.radial_flash_attention_plain(tq, tk, tv, frames))


@pytest.mark.parametrize("tq,tk,rows", [(130, 130, 17), (70, 33, 64), (257, 64, 100), (5, 9, 1)])
def test_blocked_flash_plain_equals_unblocked(tq, tk, rows):
    """K9's plain version walks the query rows in blocks at long lengths:
    the result is the one of a single block."""
    rng = np.random.default_rng(tq)
    q, k, v = (torch.from_numpy(rng.normal(size=(2, n, 2, 128)).astype(np.float32))
               for n in (tq, tk, tk))
    whole = flash.flash_attention_plain(q, k, v, block_rows=tq)
    assert_close("blocked vs whole", whole, flash.flash_attention_plain(q, k, v, block_rows=rows),
                 1e-6)
    assert torch.equal(whole, flash.flash_attention_plain(q, k, v))  # short: one block
    keep = torch.from_numpy(rng.random((tq, tk)) < 0.5)
    keep[:, 0] = True
    masked = flash.flash_attention_plain(q, k, v, block_rows=rows,
                                         row_mask=lambda r0, r1: keep[r0:r1])
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * 128**-0.5
    ref = torch.einsum("bhqk,bkhd->bqhd",
                       torch.softmax(s.masked_fill(~keep, float("-inf")), -1), v)
    assert_close("row_mask", ref, masked, 1e-5)
