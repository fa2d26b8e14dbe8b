"""The masked flash kernels' tile walk (``walk_tiles`` / ``visited_tiles`` in
``mhla_tpu_torch/kernels/flash_attention.py``, the host mirror of
``csrc/flash_mask.cuh``) against a brute-force count from the keep mask, at
every (query block, key tile) geometry the kernels use.

A walk is exact when it visits every pair of spans that holds a kept pair,
and applies the per-element rule on exactly the walked pairs that also hold
a dropped one. For ids that never recur after another id (packed documents,
one document, one id per token) the range test walks nothing more; ids
that recur out of order make ranges meet that share no id, and those extra
pairs hold only dropped pairs. The card tests compare the kernels'
``visits`` counters with the same count.
"""

import pytest
import torch

from mhla_tpu_torch.kernels import flash_attention as flash

_GEOMETRIES = sorted({g for tiles in flash.WALK_TILES.values() for g in tiles.values()})


def _ids(kind: str, t: int) -> torch.Tensor:
    """[2, t] segment ids: one document; packed documents (lengths that cut
    tiles); ids that recur out of order."""
    if kind == "one_document":
        return torch.zeros(2, t, dtype=torch.int32)
    if kind == "documents":
        rows = []
        for lengths in ((5, 300, 1, 64, 700), (t // 3, t // 3)):
            ids, pos = torch.full((t,), len(lengths), dtype=torch.int32), 0
            for i, n in enumerate(lengths):
                ids[pos:pos + n] = i
                pos += n
            rows.append(ids)
        return torch.stack(rows)
    return torch.stack([torch.arange(t) % 5, (torch.arange(t) // 50) % 3]).to(torch.int32)


def _brute(causal: bool, seg, t: int, bq: int, bk: int):
    """(holds a kept pair, holds a dropped pair) per (query block, key tile)."""
    keep = flash.keep_mask(causal, seg, t, "cpu")(0, t)[:, 0]  # [B or 1, t, t]
    nq, nk = -(-t // bq), -(-t // bk)
    padded = torch.zeros(keep.shape[0], nq * bq, nk * bk, dtype=torch.bool)
    dropped = torch.zeros_like(padded)
    padded[:, :t, :t] = keep
    dropped[:, :t, :t] = ~keep
    tiles = lambda x: x.reshape(-1, nq, bq, nk, bk).any(dim=4).any(dim=2)  # noqa: E731
    return tiles(padded), tiles(dropped)


_CASES = [(t, "causal", None) for t in (33, 781, 2048, 2100)] + [
    (t, form, kind) for t in (33, 781, 2048, 2100) for form in ("segment", "causal+segment")
    for kind in ("one_document", "documents", "recurring")]


@pytest.mark.parametrize("bq,bk", _GEOMETRIES)
@pytest.mark.parametrize("t,form,kind", _CASES)
def test_walk_matches_brute_force(t, form, kind, bq, bk):
    causal = form.startswith("causal")
    seg = _ids(kind, t) if kind is not None else None
    walked, rule = flash.walk_tiles(causal, seg, t, bq, bk)
    kept, dropped = _brute(causal, seg, t, bq, bk)
    assert walked.shape == kept.shape
    # exact: every pair holding a kept pair is walked ...
    assert not (kept & ~walked).any()
    if kind != "recurring":
        assert torch.equal(walked, kept)
    else:  # ... and what the ranges add holds dropped pairs only
        assert not (walked & ~kept & ~dropped).any()
    # the per-element rule on exactly the walked pairs that drop something
    assert torch.equal(rule, walked & dropped)
    assert flash.visited_tiles(causal, seg, t, bq, bk) == int(walked.sum())
    # the counters K9 / K9b read back, per kernel geometry
    for d, tiles in flash.WALK_TILES.items():
        counts = flash.kernel_visits(causal, seg, t, d, heads=3, batch=2)
        rows = 1 if seg is not None else 2
        assert counts == [3 * rows * flash.visited_tiles(causal, seg, t, *tiles[k])
                          for k in ("fwd", "dkv", "dq")]
