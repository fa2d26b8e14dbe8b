"""Port of the non-causal blockwise MHLA island (K5-K8 and the op around
them), held against ``mhla_tpu.kernels.mhla_block_pallas`` on the CPU. The
JAX side runs its Pallas bodies in interpret mode; the port runs its plain
versions. Inputs come from numpy with fixed seeds.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mhla_tpu.kernels import mhla_block_pallas as jax_block
from mhla_tpu.kernels import mhla_chunk_pallas
from mhla_tpu.ops import block_mixing_matrix as jax_block_mixing_matrix
from mhla_tpu.ops import rope_angles_3d as jax_rope_angles_3d
from mhla_tpu.ops.mhla_blockwise import mhla_blockwise_mh as jax_blockwise_mh
from mhla_tpu_torch.kernels import mhla_block
from mhla_tpu_torch.ops import (
    block_mixing_matrix,
    mhla_blockwise_mh,
    rope_angles_3d,
    rope_tables_flat,
)
from mhla_tpu_torch.utils import assert_close

# float32 on both sides, the same arithmetic in another summation order
TOL = 1e-5
# bf16 rounding between the steps on both sides: a half ulp is 2^-9
TOL_BF16 = 2e-3
_TORCH_DT = {None: None, "bfloat16": torch.bfloat16, "float32": torch.float32}
_JAX_DT = {None: None, "bfloat16": jnp.bfloat16, "float32": jnp.float32}


@pytest.fixture(autouse=True)
def _force_interpret():
    mhla_chunk_pallas.FORCE_INTERPRET = True
    yield
    mhla_chunk_pallas.FORCE_INTERPRET = False


def _rng(seed):
    return np.random.default_rng(seed)


def _f32(a):
    return np.array(jnp.asarray(a, jnp.float32))  # a writable copy


@pytest.mark.parametrize("layout", [(4, 4), (3, 5, 10), (2, 2, 2)])
@pytest.mark.parametrize("transform", ["linear", "cos", "exp", "gaussian", "local"])
def test_block_mixing_matrix_equals_jax(layout, transform):
    np.testing.assert_array_equal(
        block_mixing_matrix(layout, transform), jax_block_mixing_matrix(layout, transform)
    )


@pytest.mark.parametrize("grid,dh", [((21, 30, 50), 128), ((3, 10, 20), 128), ((2, 4, 4), 64)])
def test_rope_angles_and_tables_equal_jax(grid, dh):
    np.testing.assert_array_equal(rope_angles_3d(grid, dh), jax_rope_angles_3d(grid, dh))
    cos, sin = rope_tables_flat(grid, dh)
    ref_cos, ref_sin = jax_block.rope_tables_flat(grid, dh, 1)
    # cos and sin of the same float32 angles: correctly rounded here, float32 routines there
    np.testing.assert_allclose(cos.numpy(), np.asarray(ref_cos), atol=1e-6)
    np.testing.assert_allclose(sin.numpy(), np.asarray(ref_sin), atol=1e-6)


# (grid, layout, heads, in dtype, rope, norm, relu, mid, out dtype, emit_nope, tol)
_ISLAND_CASES = {
    "rope": ((4, 4, 8), (2, 2, 2), 2, "float32", True, True, True, None, "float32", False, TOL),
    "no_rope": ((4, 4, 8), (2, 2, 2), 2, "float32", False, True, True, None, "float32", False,
                TOL),
    "v_stream_bf16_in": ((4, 4, 8), (2, 2, 2), 2, "bfloat16", False, False, False, None,
                         "float32", False, TOL),
    "emit_nope": ((4, 4, 8), (2, 2, 2), 2, "bfloat16", True, True, True, None, "float32", True,
                  TOL),
    "mid_bf16": ((4, 4, 8), (2, 2, 2), 2, "bfloat16", True, True, True, "bfloat16", "bfloat16",
                 True, TOL_BF16),
    "wan_odd_geometry": ((3, 10, 20), (3, 5, 10), 1, "float32", True, True, True, None,
                         "float32", False, TOL),
    "odd_partitions": ((6, 10, 9), (2, 2, 3), 1, "bfloat16", True, True, True, None, "float32",
                       True, TOL),
}


@pytest.mark.parametrize("case", sorted(_ISLAND_CASES))
def test_blockify_island_matches_jax(case):
    grid, layout, h, in_dt, rope, norm, relu, mid, out_dt, nope, tol = _ISLAND_CASES[case]
    dh = 128
    t, f = int(np.prod(grid)), h * dh
    rng = _rng(sorted(_ISLAND_CASES).index(case))
    x = rng.normal(size=(2, t, f)).astype(np.float32)
    gamma = (1.0 + 0.1 * rng.normal(size=(f,))).astype(np.float32) if norm else None
    eps = 1e-6

    xj = jnp.asarray(x, _JAX_DT[in_dt])
    tables_j = jax_block.rope_tables_flat(grid, dh, h) if rope else None
    ref, ref_nope = jax_block.blockify_island(
        xj, tables_j, None if gamma is None else jnp.asarray(gamma), grid, layout, h,
        eps, eps if relu else None, _JAX_DT[mid], _JAX_DT[out_dt], nope,
    )
    xt = torch.from_numpy(_f32(xj)).to(_TORCH_DT[in_dt])
    tables_t = rope_tables_flat(grid, dh) if rope else None
    out, out_nope = mhla_block.blockify_island(
        xt, tables_t, None if gamma is None else torch.from_numpy(gamma), grid, layout, h,
        eps, eps if relu else None, _TORCH_DT[mid], _TORCH_DT[out_dt], nope,
    )
    assert out.shape == ref.shape and out.dtype == _TORCH_DT[out_dt]
    assert_close(f"blockify_island {case}", _f32(ref), out, tol)
    assert (out_nope is None) == (ref_nope is None)
    if nope:
        assert_close(f"blockify_island {case} nope", _f32(ref_nope), out_nope, tol)


@pytest.mark.parametrize(
    "grid,layout,in_dt,mid,out_dt,tol",
    [
        ((4, 4, 8), (2, 2, 2), "float32", None, "float32", TOL),
        ((3, 10, 20), (3, 5, 10), "float32", None, "float32", TOL),
        ((6, 10, 9), (2, 2, 3), "float32", "bfloat16", "bfloat16", TOL_BF16),
        ((4, 4, 8), (2, 2, 2), "bfloat16", None, "bfloat16", TOL_BF16),
    ],
)
def test_unblockify_island_matches_jax(grid, layout, in_dt, mid, out_dt, tol):
    h, dh = 2, 128
    n, t = int(np.prod(layout)), int(np.prod(grid))
    rng = _rng(7)
    xb = rng.normal(size=(2, n, t // n, h * dh)).astype(np.float32)
    g = (1.0 + 0.1 * rng.normal(size=(dh,))).astype(np.float32)
    xj = jnp.asarray(xb, _JAX_DT[in_dt])
    ref = jax_block.unblockify_island(
        xj, jnp.asarray(g), grid, layout, h, 1e-6, _JAX_DT[mid], _JAX_DT[out_dt]
    )
    out = mhla_block.unblockify_island(
        torch.from_numpy(_f32(xj)).to(_TORCH_DT[in_dt]), torch.from_numpy(g), grid, layout, h,
        1e-6, _TORCH_DT[mid], _TORCH_DT[out_dt],
    )
    assert out.shape == (2, t, h * dh) and out.dtype == _TORCH_DT[out_dt]
    assert_close("unblockify_island", _f32(ref), out, tol)


def test_blockify_then_unblockify_is_the_identity_permutation():
    """With every option off K5 and the permutation of K8 invert each other
    (K8's norm is undone by hand), for the odd partitions (7, 6, 5) of the
    video model's block."""
    grid, layout, h, dh = (21, 12, 10), (3, 2, 2), 1, 128
    t = int(np.prod(grid))
    x = torch.from_numpy(_rng(3).normal(size=(1, t, dh)).astype(np.float32))
    xb, _ = mhla_block.blockify_island(x, None, None, grid, layout, h)
    assert xb.shape == (1, 12, 7 * 6 * 5, dh)
    back = mhla_block.unblockify_island(xb, torch.ones(dh), grid, layout, h, norm_eps=0.0)
    rms = x.square().mean(dim=-1, keepdim=True).sqrt()
    assert_close("permutation round trip", x, back * rms, TOL)


@pytest.mark.parametrize("n,dtype,tol", [(8, "float32", TOL), (150, "float32", TOL),
                                         (12, "bfloat16", TOL_BF16)])
def test_mix_states_dense_matches_jax(n, dtype, tol):
    rng = _rng(11)
    m = rng.uniform(0.0, 1.0, size=(n, n)).astype(np.float32)
    s = rng.normal(size=(2, n, 16, 128)).astype(np.float32)
    sj = jnp.asarray(s, _JAX_DT[dtype])
    ref = jax_block.mix_states_dense(jnp.asarray(m, _JAX_DT[dtype]), sj)
    out = mhla_block.mix_states_dense(
        torch.from_numpy(_f32(jnp.asarray(m, _JAX_DT[dtype]))),
        torch.from_numpy(_f32(sj)).to(_TORCH_DT[dtype]),
    )
    assert out.dtype == _TORCH_DT[dtype]
    assert_close(f"mix_states_dense n={n}", _f32(ref), out, tol)


@pytest.mark.parametrize("c,dtype,tol", [(24, "float32", TOL), (210, "float32", TOL),
                                         (24, "bfloat16", TOL_BF16)])
def test_block_readout_matches_jax(c, dtype, tol):
    b, n, h, dk, dv = 2, 4, 2, 128, 128
    rng = _rng(13)
    q = np.maximum(rng.normal(size=(b, n, c, h * dk)), 0).astype(np.float32)
    mixed = rng.normal(size=(b, n, h * dk, dv)).astype(np.float32)
    qj, mj = jnp.asarray(q, _JAX_DT[dtype]), jnp.asarray(mixed, _JAX_DT[dtype])
    g = 2  # two blocks per supertile: the row masks of the TPU kernel are exercised
    ref = jax_block._readout(qj.reshape(b, n // g, g * c, h * dk), mj, g, c, h)
    out = mhla_block.block_readout(
        torch.from_numpy(_f32(qj)).to(_TORCH_DT[dtype]),
        torch.from_numpy(_f32(mj)).to(_TORCH_DT[dtype]), h,
    )
    assert out.dtype == _TORCH_DT[dtype]
    assert_close(f"block_readout c={c}", _f32(ref).reshape(b, n, c, h * dv), out, tol)


def _blockwise_inputs(b, n, c, h, dk, dv, seed):
    rng = _rng(seed)
    q = (np.maximum(rng.normal(size=(b, n, c, h * dk)), 0) + 1e-6).astype(np.float32)
    k = (np.maximum(rng.normal(size=(b, n, c, h * dk)), 0) + 1e-6).astype(np.float32)
    qn = (np.maximum(rng.normal(size=(b, n, c, h * dk)), 0) + 1e-6).astype(np.float32)
    kn = (np.maximum(rng.normal(size=(b, n, c, h * dk)), 0) + 1e-6).astype(np.float32)
    v = rng.normal(size=(b, n, c, h * dv)).astype(np.float32)
    return q, k, v, qn, kn


@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("nope", [False, True])
def test_mhla_blockwise_fused_matches_jax(normalize, nope):
    b, n, c, h, dk, dv = 2, 8, 24, 2, 128, 128
    q, k, v, qn, kn = _blockwise_inputs(b, n, c, h, dk, dv, 17)
    m = block_mixing_matrix((2, 2, 2))
    ref = jax_block.mhla_blockwise_fused(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(m), h,
        q_nope4=jnp.asarray(qn) if nope else None, k_nope4=jnp.asarray(kn) if nope else None,
        normalize=normalize,
    )
    t = torch.from_numpy
    out = mhla_block.mhla_blockwise_fused(
        t(q), t(k), t(v), t(m), h, q_nope4=t(qn) if nope else None,
        k_nope4=t(kn) if nope else None, normalize=normalize,
    )
    assert_close("mhla_blockwise_fused", np.asarray(ref), out, TOL)


def test_mhla_blockwise_fused_bf16_island_matches_jax():
    b, n, c, h, dk, dv = 1, 8, 24, 2, 128, 128
    q, k, v, _, _ = _blockwise_inputs(b, n, c, h, dk, dv, 19)
    m = block_mixing_matrix((2, 2, 2))
    bf = lambda a: jnp.asarray(a, jnp.bfloat16)  # noqa: E731
    ref = jax_block.mhla_blockwise_fused(
        bf(q), bf(k), bf(v), jnp.asarray(m), h, normalize=True, compute_dtype=jnp.bfloat16
    )
    t = lambda a: torch.from_numpy(_f32(bf(a))).to(torch.bfloat16)  # noqa: E731
    out = mhla_block.mhla_blockwise_fused(
        t(q), t(k), t(v), torch.from_numpy(m), h, normalize=True,
        compute_dtype=torch.bfloat16,
    )
    assert out.dtype == torch.bfloat16
    # the output is rounded to bf16 on both sides: single roundings may differ
    assert_close("mhla_blockwise_fused bf16", _f32(ref), out, 2 * TOL_BF16)


@pytest.mark.parametrize("normalize", [False, True])
def test_mhla_blockwise_mh_and_small_head_dims_match_jax(normalize):
    """Head dim 64: the fused op falls back to the einsum op on both sides."""
    b, n, c, h, d = 2, 8, 6, 2, 64
    q, k, v, qn, kn = _blockwise_inputs(b, n, c, h, d, d, 23)
    m = block_mixing_matrix((2, 2, 2))
    five = lambda a: a.reshape(b, n, c, h, d)  # noqa: E731
    ref = jax_blockwise_mh(
        *(jnp.asarray(five(a)) for a in (q, k, v)), jnp.asarray(m),
        q_nope=jnp.asarray(five(qn)), k_nope=jnp.asarray(five(kn)), normalize=normalize,
    )
    t = torch.from_numpy
    out = mhla_blockwise_mh(
        *(t(five(a)) for a in (q, k, v)), t(m), q_nope=t(five(qn)), k_nope=t(five(kn)),
        normalize=normalize,
    )
    assert_close("mhla_blockwise_mh", np.asarray(ref), out, TOL)
    fused = mhla_block.mhla_blockwise_fused(
        t(q), t(k), t(v), t(m), h, q_nope4=t(qn), k_nope4=t(kn), normalize=normalize
    )
    assert_close("fused op, Dh=64", np.asarray(ref).reshape(b, n, c, h * d), fused, TOL)


def test_rms_norm_heads_flat_matches_jax():
    rng = _rng(29)
    x = rng.normal(size=(2, 50, 256)).astype(np.float32)
    w = (1.0 + 0.1 * rng.normal(size=(128,))).astype(np.float32)
    ref = jax_block.rms_norm_heads_flat(jnp.asarray(x), jnp.asarray(w), 2)
    out = mhla_block.rms_norm_heads_flat(torch.from_numpy(x), torch.from_numpy(w), 2)
    assert_close("rms_norm_heads_flat", np.asarray(ref), out, TOL)


def test_wrappers_reject_what_does_not_fit():
    x = torch.zeros(1, 64, 256)
    with pytest.raises(ValueError):  # grid not divisible by the layout
        mhla_block.blockify_island(x, None, None, (4, 4, 4), (3, 2, 2), 2)
    with pytest.raises(ValueError):  # grid and tokens disagree
        mhla_block.blockify_island(x, None, None, (4, 4, 8), (2, 2, 2), 2)
    with pytest.raises(ValueError):  # tables of another length
        bad = (torch.zeros(10, 128), torch.zeros(10, 128))
        mhla_block.blockify_island(x, bad, None, (4, 4, 4), (2, 2, 2), 2)
    with pytest.raises(TypeError):
        mhla_block.blockify_island(x, None, None, (4, 4, 4), (2, 2, 2), 2,
                                   mid_dtype=torch.float64)
    with pytest.raises(ValueError):  # blocked shape and geometry disagree
        mhla_block.unblockify_island(torch.zeros(1, 8, 9, 256), torch.ones(128), (4, 4, 4),
                                     (2, 2, 2), 2)
    with pytest.raises(ValueError):  # tensors on several devices
        mhla_block.mix_states_dense(torch.zeros(2, 2), torch.zeros(1, 2, 4, 128, device="meta"))
