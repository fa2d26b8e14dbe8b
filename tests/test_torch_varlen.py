"""Packed varlen rows in the port (segment ids), held against the JAX
package on the CPU: the segment bookkeeping (exact), the chunked op's
segment path, the per-row plain forms of K1-K4b against the JAX fused
kernels in interpret mode (outputs and ``jax.vjp`` gradients), packed rows
against separate documents, the MHLA layer's ``segment_ids`` and
``attention_mask``, and ``PackedVarlenIterator``. Inputs come from numpy
with a fixed seed.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mhla_tpu.data.lm_data import PackedVarlenIterator as JaxPackedVarlenIterator
from mhla_tpu.kernels.fmap_rope_pallas import fused_fmap_rope_flat as jax_fmap_rope_flat
from mhla_tpu.kernels.mhla_chunk_pallas import mhla_chunk_fused_flat as jax_fused_flat
from mhla_tpu.layers import MHLACausal as JaxMHLACausal
from mhla_tpu_torch.data import PackedVarlenIterator, make_lm_dataloader
from mhla_tpu_torch.kernels import fmap_rope
from mhla_tpu_torch.kernels import mhla_chunk as port_kernels
from mhla_tpu_torch.layers import MHLACausal
from mhla_tpu_torch.ops import rotary_cos_sin
from mhla_tpu_torch.utils import assert_close

jax_ops = importlib.import_module("mhla_tpu.ops.mhla_chunk")
port_ops = importlib.import_module("mhla_tpu_torch.ops.mhla_chunk")

# float32 on both sides, sums in other orders: a few float32 ulp of the
# largest partial sum (tests/test_torch_mhla_chunk.py's bound)
TOL = 1e-5


@pytest.fixture
def interpret():
    from mhla_tpu.kernels import mhla_chunk_pallas as mod

    mod.FORCE_INTERPRET = True
    yield
    mod.FORCE_INTERPRET = False


def seg_ids(rows, t):
    """[B, T] int32 ids of documents of the given lengths back to back per
    row (the rest of a row one more segment)."""
    out = np.zeros((len(rows), t), np.int32)
    for bi, lengths in enumerate(rows):
        pos = 0
        for sid, n in enumerate(lengths):
            out[bi, pos:pos + n] = sid
            pos += n
        out[bi, pos:] = len(lengths)
    return out


def _qkv(b, t, h, dk, dv, seed=0):
    rng = np.random.default_rng(seed)
    q = np.maximum(rng.standard_normal((b, t, h, dk)), 0).astype(np.float32)
    k = np.maximum(rng.standard_normal((b, t, h, dk)), 0).astype(np.float32)
    v = rng.standard_normal((b, t, h, dv)).astype(np.float32)
    return q, k, v


def _t(x):
    return torch.from_numpy(np.array(x))


# rows of documents: chunk-aligned documents; a trailing pad; unsorted-looking
# but non-decreasing ids within one chunk are not made by the packer
_ROWS = [[[128, 64, 192], [384]], [[64] * 5, [320, 64]]]


@pytest.mark.parametrize("rows", _ROWS)
def test_segment_bookkeeping_equals_jax(rows):
    """chunk_segments (with a padded last chunk), segment_positions and
    build_segment_mixing, exactly."""
    t, c, n = 400, 64, 7  # 400 tokens: the last chunk is padded to 448
    ids = seg_ids(rows, t)
    cs_ref, rel_ref = jax_ops.chunk_segments(jnp.asarray(ids), n, c)
    cs, rel = port_ops.chunk_segments(_t(ids), n, c)
    np.testing.assert_array_equal(np.asarray(cs_ref), cs.numpy())
    np.testing.assert_array_equal(np.asarray(rel_ref), rel.numpy())
    np.testing.assert_array_equal(np.asarray(jax_ops.segment_positions(jnp.asarray(ids))),
                                  port_ops.segment_positions(_t(ids)).numpy())
    m = np.random.default_rng(1).uniform(0, 1, (8, 8)).astype(np.float32)
    ref = jax_ops.build_segment_mixing(jnp.asarray(m), jnp.asarray(ids), n, c)
    got = port_ops.build_segment_mixing(_t(m), _t(ids), n, c)
    np.testing.assert_array_equal(np.asarray(ref), got.numpy())


def test_over_long_document_reads_the_last_slot_as_jax():
    """A document of 6 chunks against a matrix of 4 slots: JAX's gather
    clamps the out-of-range indices to the last slot, and so does the port
    (the packer never makes such a document; torch indexing would raise)."""
    ids = seg_ids([[6 * 64, 64]], 7 * 64)
    m = np.random.default_rng(2).uniform(0, 1, (4, 4)).astype(np.float32)
    ref = jax_ops.build_segment_mixing(jnp.asarray(m), jnp.asarray(ids), 7, 64)
    got = port_ops.build_segment_mixing(_t(m), _t(ids), 7, 64)
    np.testing.assert_array_equal(np.asarray(ref), got.numpy())
    assert got[0, 5, 5] == float(np.tril(m)[3, 3])


def test_segment_op_matches_jax_and_the_loop_oracle():
    """ops.mhla_chunk with segment ids against the JAX op; without them
    the loop oracle ``mhla_chunk_ref`` against JAX's."""
    b, t, h, dk, dv, c = 2, 448, 2, 16, 24, 64
    q, k, v = _qkv(b, t, h, dk, dv)
    m = np.tril(np.random.default_rng(3).uniform(0, 1, (8, 8))).astype(np.float32)
    ids = seg_ids(_ROWS[0], t)
    ref, _ = jax_ops.mhla_chunk(*map(jnp.asarray, (q, k, v, m)), chunk_size=c,
                                segment_ids=jnp.asarray(ids))
    got, _ = port_ops.mhla_chunk(*map(_t, (q, k, v, m)), chunk_size=c, segment_ids=_t(ids))
    assert_close("segment op", np.asarray(ref), got, TOL)
    ref, s_ref = jax_ops.mhla_chunk_ref(*map(jnp.asarray, (q, k, v, m)), chunk_size=c,
                                        output_final_state=True)
    got, s = port_ops.mhla_chunk_ref(*map(_t, (q, k, v, m)), chunk_size=c,
                                     output_final_state=True)
    assert_close("loop oracle", np.asarray(ref), got, TOL)
    assert_close("loop oracle states", np.asarray(s_ref), s, TOL)


def test_per_row_kernel_path_matches_jax_interpret(interpret):
    """The fused op on packed rows (per-row K3/K4 and, under autograd,
    K4b/K3b/K2b in their plain versions) against the JAX fused op's Pallas
    bodies in interpret mode with the batched mixing matrix: the output and
    the ``jax.vjp`` gradients of q, k, v and the mixing matrix."""
    b, t, h, d, c = 2, 512, 2, 128, 64
    q, k, v = _qkv(b, t, h, d, d, seed=4)
    m = np.tril(np.random.default_rng(5).uniform(0, 1, (8, 8))).astype(np.float32)
    ids = seg_ids([[192, 320], [64, 64, 128]], t)
    flat = lambda x: x.reshape(b, t, h * d)  # noqa: E731
    w = np.random.default_rng(6).standard_normal((b, t, h * d)).astype(np.float32)

    def jax_fn(q_, k_, v_, m_):
        return jax_fused_flat(q_, k_, v_, m_, num_heads=h, chunk_size=c,
                              segment_ids=jnp.asarray(ids))[0]

    o_ref, vjp = jax.vjp(jax_fn, *map(jnp.asarray, (flat(q), flat(k), flat(v), m)))
    g_ref = vjp(jnp.asarray(w))
    leaves = [_t(x).requires_grad_() for x in (flat(q), flat(k), flat(v), m)]
    o, _ = port_kernels.mhla_chunk_fused_flat(*leaves, num_heads=h, chunk_size=c,
                                              segment_ids=_t(ids))
    (o * _t(w)).sum().backward()
    assert_close("packed fused o", np.asarray(o_ref), o.detach(), TOL)
    for name, r, x in zip("qkvm", g_ref, leaves):
        # the mixing matrix's gradient sums over every token of the batch
        assert_close(f"packed fused grad {name}", np.asarray(r), x.grad, 1e-4)


def test_packed_rows_equal_separate_documents():
    """In the port: each document of a packed row (fused op, chunk-aligned
    boundaries) equals the document run as its own sequence."""
    b, t, h, d, c = 2, 512, 2, 128, 64
    q, k, v = _qkv(b, t, h, d, d, seed=7)
    m = _t(np.tril(np.random.default_rng(8).uniform(0, 1, (8, 8))).astype(np.float32))
    rows = [[192, 320], [64, 64, 128, 256]]
    ids = _t(seg_ids(rows, t))
    flat = lambda x: _t(x).reshape(x.shape[0], x.shape[1], -1)  # noqa: E731
    o, _ = port_kernels.mhla_chunk_fused_flat(flat(q), flat(k), flat(v), m, h, c,
                                              segment_ids=ids)
    for bi, lengths in enumerate(rows):
        pos = 0
        for n in lengths:
            sl = slice(pos, pos + n)
            part = lambda x: flat(x[bi:bi + 1, sl])  # noqa: E731
            o_doc, _ = port_kernels.mhla_chunk_fused_flat(part(q), part(k), part(v), m, h, c)
            assert_close(f"row {bi} document at {pos}", o_doc, o[bi:bi + 1, sl], TOL)
            pos += n


def test_rotary_positions_match_jax_fused_kernel_interpret(interpret):
    """K1's plain version with per-token positions (the gathered [B, T, Dh]
    tables of the JAX kernel) and K1b's against ``jax.vjp`` of the JAX
    Pallas kernel in interpret mode."""
    b, t, h, dh = 2, 256, 2, 128
    ids = seg_ids([[64, 192], [128]], t)
    pos = np.asarray(jax_ops.segment_positions(jnp.asarray(ids)))
    rng = np.random.default_rng(9)
    x = rng.standard_normal((b, t, h * dh)).astype(np.float32)
    dy = rng.standard_normal((b, t, h * dh)).astype(np.float32)
    cos, sin = rotary_cos_sin(2048, dh)
    jcos, jsin = jnp.asarray(cos.numpy()), jnp.asarray(sin.numpy())
    ref, vjp = jax.vjp(lambda x_: jax_fmap_rope_flat(x_, jcos, jsin, h, "relu",
                                                     positions=jnp.asarray(pos)), jnp.asarray(x))
    xt = _t(x).requires_grad_()
    got = fmap_rope.fused_fmap_rope_flat(xt, cos, sin, h, "relu", positions=_t(pos))
    got.backward(_t(dy))
    assert_close("K1 positions", np.asarray(ref), got.detach(), TOL)
    assert_close("K1b positions", np.asarray(vjp(jnp.asarray(dy))[0]), xt.grad, TOL)


def _layer_pair(seed=10, **kw):
    """The JAX MHLACausal and the port's with one set of numpy weights."""
    jl = JaxMHLACausal(hidden_size=512, num_heads=2, **kw)
    shapes = jax.eval_shape(jl.init, jax.random.PRNGKey(0), jnp.zeros((1, 64, 512)))
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(
        lambda s: rng.normal(0, 0.05, s.shape).astype(np.float32), shapes)
    attn = params["params"]
    attn["mixing_matrix"] = rng.uniform(0, 1, attn["mixing_matrix"].shape).astype(np.float32)
    pl = MHLACausal(hidden_size=512, num_heads=2, **kw)
    sd = {f"{n}.weight": _t(attn[n]["kernel"]).T for n in ("q_proj", "k_proj", "v_proj",
                                                            "g_proj", "o_proj")}
    sd["mixing_matrix"] = _t(attn["mixing_matrix"])
    sd["g_norm_swish_gate.weight"] = _t(attn["g_norm_swish_gate"]["weight"])
    pl.load_state_dict(sd)
    return jl, jax.tree_util.tree_map(jnp.asarray, params), pl


def test_mhla_layer_segment_ids_and_attention_mask_match_jax():
    """The MHLA layer with packed segment ids and with a right-pad
    attention mask against the JAX layer; decode with segment ids raises
    ``ValueError`` in both packages."""
    jl, params, pl = _layer_pair()
    b, t = 2, 320
    x = np.random.default_rng(11).standard_normal((b, t, 512)).astype(np.float32)
    ids = seg_ids([[128, 64], [256]], t)
    ref, _ = jl.apply(params, jnp.asarray(x), segment_ids=jnp.asarray(ids))
    got, _ = pl(_t(x), segment_ids=_t(ids))
    assert_close("layer segment_ids", np.asarray(ref), got.detach(), TOL)
    mask = (np.arange(t)[None, :] < np.array([[300], [200]])).astype(np.int32)
    ref, _ = jl.apply(params, jnp.asarray(x), attention_mask=jnp.asarray(mask))
    got, _ = pl(_t(x), attention_mask=_t(mask))
    assert_close("layer attention_mask", np.asarray(ref), got.detach(), TOL)
    _, state = pl(_t(x[:, :64]), use_cache=True)
    with pytest.raises(ValueError):
        pl(_t(x[:, 64:65]), state, use_cache=True, segment_ids=_t(ids[:, 64:65]))


def test_packed_varlen_iterator_rows_equal_jax():
    """The same documents give the same dict rows as the JAX packer, past a
    document split at the row end and one longer than the slots; the
    dataloader's varlen batches and its resume state follow."""
    rng = np.random.default_rng(12)
    docs = [rng.integers(1, 100, int(n)).tolist() for n in (70, 300, 5, 700, 64, 129, 1000, 33)]
    source = lambda epoch: docs  # noqa: E731
    ref_it = iter(JaxPackedVarlenIterator(source, 512, chunk_size=64, num_slots=4))
    it = iter(PackedVarlenIterator(source, 512, chunk_size=64, num_slots=4))
    for _ in range(7):
        r, g = next(ref_it), next(it)
        assert set(r) == set(g) == {"input_ids", "segment_ids", "targets"}
        for key in r:
            np.testing.assert_array_equal(r[key], g[key])
    batch = next(make_lm_dataloader(256, 3, 100, varlen=True, docs=docs))
    assert {k: v.shape for k, v in batch.items()} == {k: (3, 256) for k in batch}
