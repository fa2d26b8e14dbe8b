"""K10's and K10b's tile lists and walks (``radial_fwd_lists`` and
``radial_bwd_lists`` in ``mhla_tpu_torch/kernels/sparse_attention.py``,
walked by the radial forms of ``csrc/flash_fwd.cu`` and ``csrc/flash_bwd.cu``)
against the dense radial mask, at even and ragged frames.

The forward's blocks of 128 queries walk the 128-key tiles of
``radial_schedule(t, f, 128, 128)``; the dQ kernel's blocks of 128 queries
walk the 64-key tiles of ``radial_schedule(t, f, 128, 64)``; the dK/dV
kernel's blocks of 64 keys walk the 128-query tiles of
``radial_schedule(t, f, 64, 128)``, read from the key side. A list is exact
when every allowed pair lies in a listed tile, every listed tile holds one,
and ``full`` marks exactly the tiles in which every pair of real tokens is
allowed and no token of the step tile lies past T. Plain mirrors of the
walks (the forward and the backward over the listed tiles only, the mask
applied on the tiles not marked full, by the kernels' rule) then equal
``radial_flash_attention_plain`` and ``radial_flash_attention_bwd_plain``,
which ``test_torch_sparse.py`` holds against JAX; the walked forward is held
against JAX's ``radial_flash_attention`` here too. The card tests compare the
kernels' ``visits`` counters with the lists' lengths.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mhla_tpu.kernels import sparse_attention as jax_sparse
from mhla_tpu_torch.kernels import sparse_attention as sparse
from mhla_tpu_torch.utils import assert_close
from torch_threads import _two_torch_threads  # noqa: F401  (autouse)

# (tokens, frames): 6 frames of 96 (tiles straddle frames); 437 in 4 frames
# of 109 and a last of 1; 24 in "5" frames (6 frames of 4); 6 frames of 256
_GEOMETRIES = [(576, 6), (437, 4), (24, 5), (1536, 6)]
_IDS = ["576in6", "437in4", "24in5", "1536in6"]


def _lists(t, frames, kernel):
    """((own block, step tile), (offsets, tiles, full, order)) of the
    forward ("fwd") or of one of K10b's kernels."""
    if kernel == "fwd":
        return sparse.FWD_WALK_TILES, sparse.radial_fwd_lists(t, frames)
    return sparse.BWD_WALK_TILES[kernel], sparse.radial_bwd_lists(t, frames)[kernel]


def _lists_against_the_mask(t, frames, kernel):
    """(allowed pairs by (own block, step tile) with the key side's
    transpose taken, listed, full flags by the same) for one kernel."""
    (own, step), (offsets, tiles, full, order) = _lists(t, frames, kernel)
    mask = sparse.radial_mask_dense(t, frames)
    if kernel == "dkv":  # the lists of key blocks, read from the key side
        mask = mask.T  # [key, query]
    n_own, n_step = -(-t // own), -(-t // step)
    return mask, own, step, n_own, n_step, offsets, tiles, full, order


def _assert_lists_exact(t, frames, kernel):
    mask, own, step, n_own, n_step, offsets, tiles, full, order = _lists_against_the_mask(
        t, frames, kernel)
    assert offsets.shape == (n_own + 1,) and offsets[-1] == len(tiles) == len(full)
    for i in range(n_own):
        rows = mask[i * own:(i + 1) * own]
        hit = [j for j in range(n_step) if rows[:, j * step:(j + 1) * step].any()]
        mine = tiles[offsets[i]:offsets[i + 1]]
        assert mine.tolist() == hit, (i, mine, hit)  # rising, every tile with a pair, no other
        for j, is_full in zip(mine, full[offsets[i]:offsets[i + 1]]):
            blk = rows[:, j * step:(j + 1) * step]
            assert bool(is_full) == bool(blk.all() and (j + 1) * step <= t), (i, j)


def _assert_order_longest_first(t, frames, kernel):
    offsets, _, _, order = _lists(t, frames, kernel)[1]
    lengths = np.diff(offsets)
    assert order.dtype == np.int32 and sorted(order.tolist()) == list(range(len(lengths)))
    assert np.all(np.diff(lengths[order]) <= 0)


@pytest.mark.parametrize("kernel", ["dq", "dkv"])
@pytest.mark.parametrize("t,frames", _GEOMETRIES, ids=_IDS)
def test_bwd_lists_hold_exactly_the_allowed_tiles(t, frames, kernel):
    _assert_lists_exact(t, frames, kernel)


@pytest.mark.parametrize("kernel", ["dq", "dkv"])
@pytest.mark.parametrize("t,frames", _GEOMETRIES + [(31500, 21)], ids=_IDS + ["video"])
def test_bwd_order_takes_every_block_once_longest_list_first(t, frames, kernel):
    _assert_order_longest_first(t, frames, kernel)


# the forward's geometries add 437 tokens in 3 frames of 145 and a last of 2:
# ragged frames wider than its 128-key tiles (the two-window keep bits)
_FWD_GEOMETRIES = _GEOMETRIES + [(437, 3)]
_FWD_IDS = _IDS + ["437in3"]


@pytest.mark.parametrize("t,frames", _FWD_GEOMETRIES, ids=_FWD_IDS)
def test_fwd_lists_hold_exactly_the_allowed_tiles(t, frames):
    _assert_lists_exact(t, frames, "fwd")


@pytest.mark.parametrize("t,frames", _FWD_GEOMETRIES + [(31500, 21)], ids=_FWD_IDS + ["video"])
def test_fwd_order_takes_every_block_once_longest_list_first(t, frames):
    _assert_order_longest_first(t, frames, "fwd")


def test_fwd_lists_at_the_video_geometry():
    """31,500 tokens in 21 frames: the forward's 128 x 128 tiles list 37,501
    of 247 x 247 (61.5%) per (batch row, head), 84 to 177 a block, and the
    visits K10's counter must read follow for the serving shape (batch 2)
    and the training shape (batch 1) at 12 heads."""
    offsets, tiles, full, order = sparse.radial_fwd_lists(31500, 21)
    lengths = np.diff(offsets)
    assert len(lengths) == 247 and len(tiles) == 37501
    assert lengths.min() == 84 and lengths.max() == 177 and lengths[order[0]] == 177
    assert 0.5 < full.mean() < 0.6
    assert sparse.radial_fwd_visits(31500, 21, 12, 2) == 900024
    assert sparse.radial_fwd_visits(31500, 21, 12, 1) == 450012


def test_bwd_lists_at_the_video_geometry():
    """31,500 tokens in 21 frames: both kernels list the same 70,827 tiles
    (58.5% of 493 x 247), and the visits K10b's counters must read follow."""
    lists = sparse.radial_bwd_lists(31500, 21)
    assert [len(lists[k][1]) for k in ("dkv", "dq")] == [70827, 70827]
    assert sparse.radial_bwd_visits(31500, 21, 12, 1) == [12 * 70827] * 2


def _walk_bwd(q, k, v, o, lse, do, frames, scale):
    """The backward as the two kernels walk it, in float64: the dQ blocks
    over their listed key tiles and the dK/dV blocks over their listed query
    tiles, the mask applied only on tiles not marked full."""
    t = q.shape[1]
    mask = torch.from_numpy(sparse.radial_mask_dense(t, frames))
    qf, kf, vf, of, dof = (x.double().permute(0, 2, 1, 3) for x in (q, k, v, o, do))
    delta = (dof * of).sum(-1)
    lse64 = lse.double()

    def p_ds(qr, kr, full):
        p = torch.exp(scale * qf[:, :, qr] @ kf[:, :, kr].transpose(-1, -2) - lse64[:, :, qr, None])
        if not full:
            p = p * mask[qr, kr]
        ds = p * (dof[:, :, qr] @ vf[:, :, kr].transpose(-1, -2) - delta[:, :, qr, None])
        return p, ds

    lists = sparse.radial_bwd_lists(t, frames)
    dq, dk, dv = (torch.zeros_like(x) for x in (qf, kf, vf))
    for kernel in ("dq", "dkv"):
        own, step = sparse.BWD_WALK_TILES[kernel]
        offsets, tiles, full, _ = lists[kernel]
        for i in range(len(offsets) - 1):
            mine = slice(i * own, min((i + 1) * own, t))
            for j, is_full in zip(tiles[offsets[i]:offsets[i + 1]], full[offsets[i]:offsets[i + 1]]):
                other = slice(j * step, min((j + 1) * step, t))
                if kernel == "dq":
                    _, ds = p_ds(mine, other, bool(is_full))
                    dq[:, :, mine] += scale * ds @ kf[:, :, other]
                else:
                    p, ds = p_ds(other, mine, bool(is_full))
                    dv[:, :, mine] += p.transpose(-1, -2) @ dof[:, :, other]
                    dk[:, :, mine] += scale * ds.transpose(-1, -2) @ qf[:, :, other]
    return tuple(x.permute(0, 2, 1, 3).float() for x in (dq, dk, dv))


@pytest.mark.parametrize("t,frames", _GEOMETRIES[:3], ids=_IDS[:3])
def test_backward_over_the_listed_tiles_equals_the_plain_backward(t, frames):
    rng = np.random.default_rng(t)
    q, k, v, do = (torch.from_numpy(rng.normal(size=(2, t, 2, 32)).astype(np.float32))
                   for _ in range(4))
    o, lse = sparse.radial_flash_attention_plain(q, k, v, frames, return_lse=True)
    ref = sparse.radial_flash_attention_bwd_plain(q, k, v, o, lse, do, frames)
    got = _walk_bwd(q, k, v, o, lse, do, frames, 32**-0.5)
    for name, r, g in zip(("dq", "dk", "dv"), ref, got):
        assert_close(f"walked {name} {t}/{frames}", r, g, 1e-5)


def _keep_bits(rows, c0, step, t, hw):
    """The forward kernel's rule on one tile not marked full: [rows, step]
    bools for key columns c0 .. c0 + step - 1. Where hw is at least the
    tile's width its columns lie in at most two frames, and a row keeps of
    each the run of columns within its window of its spatial index, two
    ranges of column offsets from two windows a row (radial_keep_bits);
    smaller frames take each column's frame. Keys past T are dropped."""
    fr, sr = rows // hw, rows % hw
    win = lambda d: sparse.radial_window(np.abs(d), hw)  # noqa: E731
    cols = c0 + np.arange(step)
    if hw >= step:
        f0 = c0 // hw
        split = hw - (c0 - f0 * hw)  # offsets below lie in frame f0, the others in f0 + 1
        wa, wb = win(fr - f0)[:, None], win(fr - f0 - 1)[:, None]
        # the row's spatial index as an offset into frame f0 and into frame f0 + 1
        a, b = (sr - (c0 - f0 * hw))[:, None], (sr + split)[:, None]
        off = np.arange(step)[None, :]
        keep = ((off > a - wa) & (off < np.minimum(a + wa, split))
                | (off >= np.maximum(b - wb + 1, split)) & (off < b + wb))
    else:
        keep = np.abs(sr[:, None] - cols % hw) < win(fr[:, None] - (cols // hw)[None, :])
    return keep & (cols < t)[None, :]


def _walk_fwd(q, k, v, frames, scale):
    """The forward as the kernel walks it, in float64: each block of 128
    query rows, in the lists' order, over its listed key tiles, the keep
    bits applied only on tiles not marked full, an online softmax per tile
    (exponentials against 0 while a row has kept nothing). Keys past T are
    zeros, as TMA fills them, and only the rule drops them. Returns (out,
    lse)."""
    b, t, h, _ = q.shape
    hw = t // frames
    own, step = sparse.FWD_WALK_TILES
    offsets, tiles, full, order = sparse.radial_fwd_lists(t, frames)
    pad = (0, 0, 0, -t % step)
    qf = q.double().permute(0, 2, 1, 3)
    kf, vf = (torch.nn.functional.pad(x.double().permute(0, 2, 1, 3), pad) for x in (k, v))
    out = torch.zeros_like(qf)
    lse = torch.zeros(b, h, t, dtype=torch.float64)
    for i in order:
        mine = slice(i * own, min((i + 1) * own, t))
        rows = np.arange(mine.start, mine.stop)
        m = torch.full((b, h, len(rows), 1), -torch.inf, dtype=torch.float64)
        l = torch.zeros_like(m)
        acc = torch.zeros(b, h, len(rows), qf.shape[-1], dtype=torch.float64)
        for j, is_full in zip(tiles[offsets[i]:offsets[i + 1]], full[offsets[i]:offsets[i + 1]]):
            keys = slice(j * step, (j + 1) * step)
            s = scale * qf[:, :, mine] @ kf[:, :, keys].transpose(-1, -2)
            if not is_full:
                s = s.masked_fill(~torch.from_numpy(_keep_bits(rows, j * step, step, t, hw)),
                                  -torch.inf)
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            ref = torch.where(m_new == -torch.inf, torch.zeros_like(m_new), m_new)
            alpha, p = torch.exp(m - ref), torch.exp(s - ref)
            l = l * alpha + p.sum(-1, keepdim=True)
            acc = acc * alpha + p @ vf[:, :, keys]
            m = m_new
        out[:, :, mine] = acc / l
        lse[:, :, mine] = (m + torch.log(l))[..., 0]
    return out.permute(0, 2, 1, 3).float(), lse.float()


@pytest.mark.parametrize("t,frames", _FWD_GEOMETRIES, ids=_FWD_IDS)
def test_forward_over_the_listed_tiles_equals_the_plain_forward(t, frames):
    """The walked forward against ``radial_flash_attention_plain`` (out and
    lse) and against JAX: at even frames its analytic-mask Pallas kernel
    ``radial_flash_attention`` in interpret mode with float32 streams, and
    the masked log-sum-exp of the scores; at ragged frames (which that
    kernel refuses) its CPU route ``sparse_flash_attention``."""
    rng = np.random.default_rng(t + frames)
    q, k, v = (rng.normal(size=(2, t, 2, 32)).astype(np.float32) for _ in range(3))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    ref_out, ref_lse = sparse.radial_flash_attention_plain(tq, tk, tv, frames, return_lse=True)
    out, lse = _walk_fwd(tq, tk, tv, frames, 32**-0.5)
    assert_close(f"walked out {t}/{frames}", ref_out, out, 1e-5)
    assert_close(f"walked lse {t}/{frames}", ref_lse, lse, 1e-5)

    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    if t % frames == 0:
        jax_out = jax_sparse.radial_flash_attention(jq, jk, jv, frames,
                                                    compute_dtype=jnp.float32, interpret=True)
    else:
        jax_out = jax_sparse.sparse_flash_attention(jq, jk, jv, num_frames=frames)
    mask = jnp.asarray(jax_sparse.radial_mask_dense(t, frames))
    logits = jnp.einsum("bqhd,bkhd->bhqk", jq * 32**-0.5, jk)
    jax_lse = jax.nn.logsumexp(jnp.where(mask[None, None], logits, -jnp.inf), axis=-1)
    assert_close(f"walked out {t}/{frames} vs JAX", np.asarray(jax_out), out, 1e-5)
    assert_close(f"walked lse {t}/{frames} vs JAX", np.asarray(jax_lse), lse, 1e-5)
