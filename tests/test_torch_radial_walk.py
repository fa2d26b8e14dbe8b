"""K10b's tile lists and walk (``radial_bwd_lists`` in
``mhla_tpu_torch/kernels/sparse_attention.py``, walked by the radial form of
``csrc/flash_bwd.cu``) against the dense radial mask, at even and ragged
frames.

The dQ kernel's blocks of 128 queries walk the 64-key tiles of
``radial_schedule(t, f, 128, 64)``; the dK/dV kernel's blocks of 64 keys walk
the 128-query tiles of ``radial_schedule(t, f, 64, 128)``, read from the key
side. A list is exact when every allowed pair lies in a listed tile, every
listed tile holds one, and ``full`` marks exactly the tiles in which every
pair of real tokens is allowed and no token of the step tile lies past T.
A plain mirror of the walk (the backward over the listed tiles only, the
mask applied on the tiles not marked full) then equals
``radial_flash_attention_bwd_plain``, which ``test_torch_sparse.py`` holds
against ``jax.grad``. The card tests compare the kernels' ``visits``
counters with the lists' lengths.
"""

import numpy as np
import pytest
import torch

from mhla_tpu_torch.kernels import sparse_attention as sparse
from mhla_tpu_torch.utils import assert_close

# (tokens, frames): 6 frames of 96 (tiles straddle frames); 437 in 4 frames
# of 109 and a last of 1; 24 in "5" frames (6 frames of 4); 6 frames of 256
_GEOMETRIES = [(576, 6), (437, 4), (24, 5), (1536, 6)]
_IDS = ["576in6", "437in4", "24in5", "1536in6"]


def _lists_against_the_mask(t, frames, kernel):
    """(allowed pairs by (own block, step tile) with the key side's
    transpose taken, listed, full flags by the same) for one kernel."""
    own, step = sparse.BWD_WALK_TILES[kernel]
    offsets, tiles, full, order = sparse.radial_bwd_lists(t, frames)[kernel]
    mask = sparse.radial_mask_dense(t, frames)
    if kernel == "dkv":  # the lists of key blocks, read from the key side
        mask = mask.T  # [key, query]
    n_own, n_step = -(-t // own), -(-t // step)
    return mask, own, step, n_own, n_step, offsets, tiles, full, order


@pytest.mark.parametrize("kernel", ["dq", "dkv"])
@pytest.mark.parametrize("t,frames", _GEOMETRIES, ids=_IDS)
def test_bwd_lists_hold_exactly_the_allowed_tiles(t, frames, kernel):
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


@pytest.mark.parametrize("kernel", ["dq", "dkv"])
@pytest.mark.parametrize("t,frames", _GEOMETRIES + [(31500, 21)], ids=_IDS + ["video"])
def test_bwd_order_takes_every_block_once_longest_list_first(t, frames, kernel):
    offsets, _, _, order = sparse.radial_bwd_lists(t, frames)[kernel]
    lengths = np.diff(offsets)
    assert order.dtype == np.int32 and sorted(order.tolist()) == list(range(len(lengths)))
    assert np.all(np.diff(lengths[order]) <= 0)


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
