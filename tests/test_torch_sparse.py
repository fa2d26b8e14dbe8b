"""Port of the radial sparse attention (the mask, the tile schedule, the
plain version of K10, ``sparse_flash_attention``) held against
``mhla_tpu.kernels.sparse_attention`` on the CPU: the JAX side takes its
masked-softmax CPU route or runs its Pallas kernel body in interpret mode,
the port its plain version. Inputs come from numpy with fixed seeds."""

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


@pytest.mark.parametrize("frames,hw", GEOMETRIES, ids=_IDS)
@pytest.mark.parametrize("bq,bk", [(64, 64), (16, 32), (32, 8)])
def test_radial_schedule_matches_jax_and_is_conservative(frames, hw, bq, bk):
    t = frames * hw
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
    with pytest.raises(ValueError):
        sparse.radial_schedule(100, 7)


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
    q = torch.zeros(1, 24, 2, 64)
    with pytest.raises(NotImplementedError):
        sparse.sparse_flash_attention(q, q, q, 4, impl="splash")
    with pytest.raises(NotImplementedError):  # 24 tokens in 5 frames: the splash route's case
        sparse.sparse_flash_attention(q, q, q, 5)
    with pytest.raises(ValueError):
        sparse.sparse_flash_attention(q, q, q, 4, impl="dense")
    with pytest.raises(ValueError):
        sparse.radial_flash_attention(q, q, q[:, :12], 4)
    with pytest.raises(ValueError):
        sparse.radial_flash_attention(q, q, q, 5)
    assert sparse.sparse_flash_attention(q, q, q, 4, impl="radial").shape == q.shape


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
