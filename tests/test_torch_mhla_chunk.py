"""Port of the chunked MHLA op (K2-K4 and their plain versions) and of the
recurrent decode op, held against the JAX package on the CPU.

On the CPU the port's kernel wrappers run their plain versions; the JAX
fused op runs its Pallas bodies in interpret mode. Inputs come from numpy
with a fixed seed and go to both packages.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mhla_tpu.kernels.mhla_chunk_pallas import mhla_chunk_fused_flat as jax_fused_flat
from mhla_tpu_torch.kernels import mhla_chunk as port_kernels
from mhla_tpu_torch.utils import assert_close
from torch_threads import _two_torch_threads  # noqa: F401  (autouse)

# the ops packages re-export functions under their modules' names
jax_chunk_ops = importlib.import_module("mhla_tpu.ops.mhla_chunk")
jax_rec = importlib.import_module("mhla_tpu.ops.mhla_recurrent")
port_ops = importlib.import_module("mhla_tpu_torch.ops.mhla_chunk")
port_rec = importlib.import_module("mhla_tpu_torch.ops.mhla_recurrent")

# float32 on both sides; the sums run in other orders (XLA vs ATen
# einsums, or per-token recurrence vs chunk matmuls), a few float32 ulp
# of the largest partial sum: 1e-5 relative RMS, as tests/test_kernels.py
TOL = 1e-5
# bf16 in the port against JAX in float32 on the same bf16 values (JAX's
# CPU backend has no bf16 x bf16 -> f32 dot): a few bf16 roundings of
# 2^-9 relative each, as test_bf16_entry_within_bf16_error_of_jax allows
BF16_TOL = 1e-2


@pytest.fixture(autouse=True)
def _force_interpret():
    from mhla_tpu.kernels import mhla_chunk_pallas as mod

    mod.FORCE_INTERPRET = True
    yield
    mod.FORCE_INTERPRET = False


def _qkv(b, t, h, dk, dv, seed=0):
    rng = np.random.default_rng(seed)
    q = np.maximum(rng.standard_normal((b, t, h, dk)), 0).astype(np.float32)
    k = np.maximum(rng.standard_normal((b, t, h, dk)), 0).astype(np.float32)
    v = rng.standard_normal((b, t, h, dv)).astype(np.float32)
    return q, k, v


def _mixing(n, seed=1):
    """A clamped random causal mixing matrix [n, n] (float32 numpy)."""
    m = np.random.default_rng(seed).uniform(0.0, 1.0, (n, n)).astype(np.float32)
    return np.tril(np.clip(m, 1e-5, 1.0))


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))  # a writable copy


# t = 781 spans 13 chunks: the JAX fused op pads them to 16 (4 supertiles
# of 4 chunks), so its far, near and padding paths all run.
def test_fused_flat_matches_jax_interpret():
    b, t, h, d = 2, 781, 2, 128
    q, k, v = _qkv(b, t, h, d, d)
    m = _mixing(13)
    flat = lambda x: x.reshape(b, t, h * d)  # noqa: E731
    o_ref, s_ref = jax_fused_flat(
        jnp.asarray(flat(q)), jnp.asarray(flat(k)), jnp.asarray(flat(v)), jnp.asarray(m),
        num_heads=h, output_final_state=True,
    )
    o, s = port_kernels.mhla_chunk_fused_flat(
        _t(flat(q)), _t(flat(k)), _t(flat(v)), _t(m), num_heads=h, output_final_state=True
    )
    assert o.shape == (b, t, h * d) and s.shape == (b, h, 13, d, d)
    assert_close("fused flat o", np.asarray(o_ref), o, TOL)
    assert_close("fused flat states", np.asarray(s_ref), s, TOL)


@pytest.mark.parametrize("t", [64, 200])
def test_ops_chunk_matches_jax(t):
    b, h, dk, dv = 2, 3, 16, 24
    q, k, v = _qkv(b, t, h, dk, dv)
    m = _mixing(8)
    o_ref, s_ref = jax_chunk_ops.mhla_chunk(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(m), output_final_state=True
    )
    o, s = port_ops.mhla_chunk(_t(q), _t(k), _t(v), _t(m), output_final_state=True)
    assert_close("ops chunk o", np.asarray(o_ref), o, TOL)
    assert_close("ops chunk states", np.asarray(s_ref), s, TOL)


def test_kernel_entry_matches_ops_chunk():
    """The K2-K4 decomposition (scale folded into M) equals the op's
    definition (scale on q) in float32."""
    b, t, h, dk, dv = 2, 200, 3, 16, 24
    q, k, v = _qkv(b, t, h, dk, dv)
    m = _mixing(8)
    o_ref, s_ref = port_ops.mhla_chunk(_t(q), _t(k), _t(v), _t(m), output_final_state=True)
    flat = lambda x: _t(x.reshape(b, t, -1))  # noqa: E731
    o, s = port_kernels.mhla_chunk_fused_flat(
        flat(q), flat(k), flat(v), _t(m), num_heads=h, output_final_state=True
    )
    assert_close("entry vs op o", o_ref.reshape(b, t, -1), o, TOL)
    assert_close("entry vs op states", s_ref, s, TOL)


def test_bf16_entry_within_bf16_error_of_jax():
    """bf16 in: the port's kernel entry (plain path on the CPU) against the
    JAX fused entry in float32 on the same values. The JAX CPU backend has
    no bf16 x bf16 -> f32 dot, so the reference stays float32; the port
    rounds the inputs, states, mixed states, scores and output to bf16
    (2^-9 relative each), a few 1e-3 in all."""
    b, t, h, d = 2, 200, 2, 128
    q, k, v = _qkv(b, t, h, d, d)
    m = _mixing(8)
    tb = lambda x: _t(x.reshape(b, t, -1)).to(torch.bfloat16)  # noqa: E731
    qb, kb, vb = tb(q), tb(k), tb(v)
    o_ref, _ = jax_fused_flat(
        *(jnp.asarray(x.float().numpy()) for x in (qb, kb, vb)), jnp.asarray(m), num_heads=h
    )
    o, _ = port_kernels.mhla_chunk_fused_flat(qb, kb, vb, _t(m), num_heads=h)
    assert o.dtype == torch.bfloat16
    assert_close("bf16 entry vs JAX float32", np.asarray(o_ref), o, 1e-2)


def test_mixing_matrix_helpers_match_jax():
    raw = np.random.default_rng(2).uniform(-0.5, 1.5, (6, 6)).astype(np.float32)
    np.testing.assert_array_equal(
        np.asarray(jax_chunk_ops.clamp_causal_mixing_matrix(jnp.asarray(raw))),
        port_ops.clamp_causal_mixing_matrix(_t(raw)).numpy(),
    )
    np.testing.assert_array_equal(
        np.asarray(jax_chunk_ops.init_causal_mixing_matrix(6)),
        port_ops.init_causal_mixing_matrix(6).numpy(),
    )
    np.testing.assert_array_equal(
        np.asarray(jax_chunk_ops.prepare_mixing_matrix(jnp.asarray(raw), 4)),
        port_ops.prepare_mixing_matrix(_t(raw), 4).numpy(),
    )
    with pytest.raises(ValueError):
        port_ops.prepare_mixing_matrix(_t(raw), 7)


def test_recurrent_matches_jax():
    b, t, h, dk, dv, c = 2, 100, 2, 16, 24, 32
    q, k, v = _qkv(b, t, h, dk, dv)
    m = _mixing(4)
    o_ref, st_ref = jax_rec.mhla_recurrent(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(m), chunk_size=c
    )
    o, st = port_rec.mhla_recurrent(_t(q), _t(k), _t(v), _t(m), chunk_size=c)
    assert st.t == int(st_ref.t) == t
    assert_close("recurrent o", np.asarray(o_ref), o, TOL)
    for name in ("states", "mixed", "s_cur"):
        assert_close(f"recurrent {name}", np.asarray(getattr(st_ref, name)),
                     getattr(st, name), TOL)


@pytest.mark.parametrize("t", [96, 100])
def test_state_from_chunk_matches_jax(t):
    b, h, dk, dv, c = 2, 2, 16, 24, 32
    _, k, v = _qkv(b, t, h, dk, dv)
    m = _mixing(4)
    _, states = jax_chunk_ops.mhla_chunk(
        jnp.asarray(k), jnp.asarray(k), jnp.asarray(v), jnp.asarray(m),
        chunk_size=c, output_final_state=True,
    )
    ref = jax_rec.state_from_chunk(states, t, jnp.asarray(m), chunk_size=c, num_slots=4)
    st = port_rec.state_from_chunk(_t(np.asarray(states)), t, _t(m), chunk_size=c, num_slots=4)
    assert st.t == t
    for name in ("states", "mixed", "s_cur"):
        assert_close(f"state_from_chunk {name}", np.asarray(getattr(ref, name)),
                     getattr(st, name), TOL)


def test_prefill_then_decode_equals_one_chunked_pass():
    """Inside the port: a prefill through the kernel entry, its cache, then
    token-by-token decode across two chunk boundaries equals one pass."""
    b, t_pre, t, h, d, c = 2, 100, 150, 2, 32, 32
    q, k, v = (_t(x) for x in _qkv(b, t, h, d, d))
    m = _t(_mixing(8))
    o_full, _ = port_ops.mhla_chunk(q, k, v, m, chunk_size=c)
    flat = lambda x: x[:, :t_pre].reshape(b, t_pre, -1)  # noqa: E731
    o_pre, states = port_kernels.mhla_chunk_fused_flat(
        flat(q), flat(k), flat(v), m, num_heads=h, chunk_size=c, output_final_state=True
    )
    st = port_rec.state_from_chunk(states, t_pre, m, chunk_size=c)
    outs = [o_pre.reshape(b, t_pre, h, d)]
    for i in range(t_pre, t):
        o_i, st = port_rec.mhla_recurrent(
            q[:, i:i + 1], k[:, i:i + 1], v[:, i:i + 1], m, st, chunk_size=c
        )
        outs.append(o_i)
    assert st.t == t
    assert_close("prefill + decode", o_full, torch.cat(outs, dim=1), TOL)


def test_recurrent_context_bound_raises():
    b, h, d, c = 1, 1, 16, 16
    m = _t(_mixing(2))
    q, k, v = (_t(x) for x in _qkv(b, 2 * c, h, d, d))
    _, st = port_rec.mhla_recurrent(q, k, v, m, chunk_size=c)  # fills both slots
    with pytest.raises(ValueError, match="context bound"):
        port_rec.mhla_recurrent(q[:, :1], k[:, :1], v[:, :1], m, st, chunk_size=c)


def test_wrappers_raise_off_cpu_and_cuda():
    x = torch.empty(1, 1, 64, 256, device="meta")
    with pytest.raises(NotImplementedError):
        port_kernels.chunk_states(x, x, 2)
    with pytest.raises(NotImplementedError):  # the per-row form too
        port_kernels.mix_states(torch.empty(1, 1, 1, device="meta"), x[:, :, 0].unsqueeze(-1))


@pytest.mark.parametrize("b,n", [(2, 4), (1, 5)])
def test_chunk_states_plain_matches_jax_phase_a_kernel(b, n):
    """K2's plain version (what the card kernel is held to), through the
    wrapper, against JAX's ``_phase_a_pallas`` in interpret mode at H = 2,
    Dk = 32, Dv = 128, C = 16 (4 chunks: JAX's kernel takes them in a group;
    5: one at a time): in float32 on bf16-representable values (TOL), and
    with bf16 inputs and output against JAX's float32 result rounded to bf16
    (2e-3, half a bf16 ulp: the sums run in another order, which can flip a
    rounding)."""
    from mhla_tpu.kernels.mhla_chunk_pallas import _phase_a_pallas

    c, h, dk, dv = 16, 2, 32, 128
    rng = np.random.default_rng(11)
    k4, v4 = (
        torch.from_numpy(rng.standard_normal((b, n, c, h * d)).astype(np.float32))
        .to(torch.bfloat16).float()
        for d in (dk, dv))
    ref = _t(_phase_a_pallas(jnp.asarray(k4.numpy()), jnp.asarray(v4.numpy()), h))
    got = port_kernels.chunk_states(k4, v4, h)
    assert got.shape == ref.shape == (b, n, h * dk, dv)
    assert_close("K2 plain vs JAX", ref, got, TOL)
    got16 = port_kernels.chunk_states(k4.to(torch.bfloat16), v4.to(torch.bfloat16), h)
    assert got16.dtype == torch.bfloat16
    assert_close("K2 plain bf16 vs JAX", ref.to(torch.bfloat16).float(), got16.float(), 2e-3)


@pytest.mark.parametrize("per_row", [False, True])
@pytest.mark.parametrize("n", [8, 128])
def test_mix_states_plain_matches_jax_mix_states(n, per_row):
    """K3's plain version (what the card kernels are held to), through the
    wrapper, against JAX's ``mix_states`` at H = 2, Dk = 32, Dv = 128, with
    a shared and a per-row M, in float32 (TOL): at N = 8 JAX runs its XLA
    einsum (``_mix_xla``; the port its small-N kernel), at N = 128 its
    ``_mix_kernel`` in interpret mode."""
    from mhla_tpu.kernels import mhla_chunk_pallas as jax_pallas

    b, h, dk, dv = 2, 2, 32, 128
    rng = np.random.default_rng(12)
    states = rng.standard_normal((b, n, h * dk, dv)).astype(np.float32)
    m = np.tril(rng.uniform(0.0, 1.0, (b, n, n) if per_row else (n, n)).astype(np.float32), -1)
    assert jax_pallas._mix_use_pallas(n, dv) == (n == 128)
    ref = jax_pallas.mix_states(jnp.asarray(m), jnp.asarray(states))
    got = port_kernels.mix_states(_t(m), _t(states))
    assert got.shape == (b, n, h * dk, dv)
    assert_close(f"K3 plain vs JAX N={n} per_row={per_row}", np.asarray(ref), got, TOL)


@pytest.mark.parametrize("dv", [128, 256])
def test_chunk_states_bwd_plain_matches_jax_acc_kernel(dv):
    """K2b's plain version (what the card kernel is held to) with nonzero
    intra terms against JAX's ``_phase_a_bwd_acc_pallas`` in interpret mode
    at C = 64, Dk = 128, N = 2, H = 2: in float32 on bf16-representable
    values (TOL), and with bf16 inputs and outputs against JAX's float32
    result rounded to bf16 (2e-3, half a bf16 ulp: the sums run in another
    order, which can flip a rounding)."""
    from mhla_tpu.kernels.mhla_chunk_pallas import _phase_a_bwd_acc_pallas

    b, n, c, h, dk = 1, 2, 64, 2, 128
    rng = np.random.default_rng(7)
    shapes = [(b, n, c, h * dk), (b, n, c, h * dv), (b, n, h * dk, dv),
              (b, n, c, h * dk), (b, n, c, h * dv)]
    k4, v4, ds4, dki4, dvi4 = (
        torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(torch.bfloat16).float()
        for s in shapes)
    ref = _phase_a_bwd_acc_pallas(*(jnp.asarray(x.numpy()) for x in (k4, v4, ds4, dki4, dvi4)),
                                  h)
    got = port_kernels.chunk_states_bwd(k4, v4, ds4, dki4, dvi4, h)
    got16 = port_kernels.chunk_states_bwd(
        *(x.to(torch.bfloat16) for x in (k4, v4, ds4, dki4, dvi4)), h)
    for name, r, g, g16 in zip(("dk", "dv"), ref, got, got16):
        r = torch.from_numpy(np.asarray(r))
        assert_close(f"K2b plain {name} vs JAX", r, g, TOL)
        assert g16.dtype == torch.bfloat16
        assert_close(f"K2b plain {name} bf16 vs JAX", r.to(torch.bfloat16).float(), g16.float(),
                     2e-3)


@pytest.mark.parametrize("rows", [1, 8])
@pytest.mark.parametrize("r", [3 * 128, 131072, 131072 + 128])
@pytest.mark.parametrize("n", [1, 33, 64, 200, 256, 448, 512, 832])
def test_gram_slices_cover_the_state_columns_exactly(n, r, rows):
    """The wide K3b's dMs slices: consecutive, none empty, each a multiple
    of 64 columns, together exactly the R state columns, and the same for
    the same shape (the second pass sums them in this fixed order)."""
    splits, width = port_kernels._gram_slices(n, r, rows)
    bounds = [(s * width, min((s + 1) * width, r)) for s in range(splits)]
    assert width % 64 == 0 and 1 <= splits <= -(-r // 64)
    assert bounds[0][0] == 0 and bounds[-1][1] == r
    assert all(lo < hi and (hi - lo) % 64 == 0 for lo, hi in bounds)
    assert all(x[1] == y[0] for x, y in zip(bounds, bounds[1:]))
    assert port_kernels._gram_slices(n, r, rows) == (splits, width)



@pytest.mark.parametrize("c", [4, 8, 12, 16, 64, 80])
@pytest.mark.parametrize("dk,dv", [(96, 192), (128, 256), (128, 192), (256, 128), (16, 128)])
def test_kernel_route_is_jax_pallas_rule(c, dk, dv):
    """The port's routing predicate is JAX's ``_pallas_compatible`` over a
    grid of chunk sizes and head dims (chunk % 8, Dk % 128, Dv % 128)."""
    from mhla_tpu.kernels.mhla_chunk_pallas import _pallas_compatible

    assert port_kernels.kernel_route(c, dk, dv) == _pallas_compatible(c, dk, dv)


def _fused_grads_jax(q, k, v, m, w, h, c):
    """o and the gradients of sum(o * w) in q, k, v and the mixing matrix
    through JAX's ``mhla_chunk_fused_flat`` (its XLA route at these shapes)."""
    import jax

    def f(q_, k_, v_, m_):
        return jax_fused_flat(q_, k_, v_, m_, num_heads=h, chunk_size=c)[0]

    o, vjp = jax.vjp(f, *(jnp.asarray(x) for x in (q, k, v, m)))
    return (o, *vjp(jnp.asarray(w).astype(o.dtype)))


def _fused_grads_port(q, k, v, m, w, h, c):
    q, k, v, m = (x.clone().requires_grad_() for x in (q, k, v, m))
    o, _ = port_kernels.mhla_chunk_fused_flat(q, k, v, m, num_heads=h, chunk_size=c)
    (o.float() * w.float()).sum().backward()
    return (o, q.grad, k.grad, v.grad, m.grad)


@pytest.mark.parametrize("dk,dv,c,t", [(96, 192, 64, 200), (128, 128, 12, 100)])
def test_fused_flat_off_the_kernel_route_matches_jax(dk, dv, c, t):
    """Shapes JAX sends to its XLA route (Dv = 192 at Dk = 96; chunk 12, not
    % 8) run the plain versions under autograd, no kernel launched: o and
    the gradients in q, k, v and the mixing matrix against JAX's
    ``mhla_chunk_fused_flat`` in float32 (TOL), and with bf16 inputs
    against JAX in float32 on the same values (JAX's CPU backend has no bf16
    x bf16 -> f32 dot): the port rounds the states, mixed states, scores,
    output and gradients to bf16 (2^-9 relative each), 1.9e-3 to 4.1e-3
    here, so BF16_TOL."""
    b, h = 2, 2
    assert not port_kernels.kernel_route(c, dk, dv)
    n = -(-t // c)
    q, k, _ = _qkv(b, t, h, dk, dk, seed=3)
    v = np.random.default_rng(4).standard_normal((b, t, h * dv)).astype(np.float32)
    w = np.random.default_rng(5).standard_normal((b, t, h * dv)).astype(np.float32)
    m = _mixing(n)
    q, k = q.reshape(b, t, -1), k.reshape(b, t, -1)
    before = dict(port_kernels.launches)
    for dtype, tol in ((torch.float32, TOL), (torch.bfloat16, BF16_TOL)):
        xs = [_t(x).to(dtype) for x in (q, k, v)]
        ref = _fused_grads_jax(*(x.float().numpy() for x in xs), m, w, h, c)
        got = _fused_grads_port(*xs, _t(m), _t(w), h, c)
        for name, r, g in zip(("o", "dq", "dk", "dv", "dM"), ref, got):
            assert g.dtype == (torch.float32 if name == "dM" else dtype)
            assert_close(f"{name} {dtype} Dk={dk} Dv={dv} C={c}",
                         np.asarray(jnp.asarray(r, jnp.float32)), g.float(), tol)
    assert port_kernels.launches == before


def _core_inputs(per_row, seed=21):
    """K4 / K4b inputs at B = 2, N = 3, C = 16, H = 2, Dk = 32, Dv = 128,
    bf16-representable float32: q, k (relu), v, mixed, md ([N] or [B, N])
    and dO."""
    b, n, c, h, dk, dv = 2, 3, 16, 2, 32, 128
    rng = np.random.default_rng(seed)
    r = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s).astype(np.float32)).to(torch.bfloat16).float()
    q4, k4 = torch.relu(r(b, n, c, h * dk)), torch.relu(r(b, n, c, h * dk))
    v4, do4 = r(b, n, c, h * dv), r(b, n, c, h * dv)
    mixed4 = r(b, n, h * dk, dv)
    md = torch.from_numpy(rng.uniform(0.0, 0.2, (b, n) if per_row else (n,)).astype(np.float32))
    return q4, k4, v4, mixed4, md, do4, h


def _jax_core(q4, k4, v4, mixed4, md, h):
    """JAX's ``_core_xla`` on the port's [B, N, C, H*D] chunks, as a
    function of (q4, k4, v4, mixed4, md) for ``jax.vjp``."""
    from mhla_tpu.kernels.mhla_chunk_pallas import _core_xla

    b, n, c, hdk = q4.shape
    dk, dv = hdk // h, v4.shape[-1] // h

    def f(q_, k_, v_, mx_, md_):
        o = _core_xla(q_.reshape(b, n, c, h, dk), k_.reshape(b, n, c, h, dk),
                      v_.reshape(b, n, c, h, dv), mx_.reshape(b, n, h, dk, dv), md_)
        return o.reshape(b, n, c, h * dv)

    return f, tuple(jnp.asarray(x.numpy()) for x in (q4, k4, v4, mixed4, md))


@pytest.mark.parametrize("per_row", [False, True])
def test_chunk_output_plain_matches_jax_core_xla(per_row):
    """K4's plain version (what the card kernel is held to), through the
    wrapper, against JAX's ``_core_xla`` with a shared and a per-row
    diagonal: in float32 (TOL), and with bf16 inputs and output against
    JAX in float32 on the same values (P and o rounded to bf16 in the port,
    1.7e-3 here: BF16_TOL)."""
    q4, k4, v4, mixed4, md, _, h = _core_inputs(per_row)
    f, args = _jax_core(q4, k4, v4, mixed4, md, h)
    ref = np.asarray(f(*args))
    for tdt, tol in ((torch.float32, TOL), (torch.bfloat16, BF16_TOL)):
        got = port_kernels.chunk_output(*(x.to(tdt) for x in (q4, k4, v4, mixed4)), md, h)
        assert got.dtype == tdt and got.shape == ref.shape
        assert_close(f"K4 plain vs JAX {tdt} per_row={per_row}", ref, got.float(), tol)


@pytest.mark.parametrize("per_row", [False, True])
def test_chunk_output_bwd_plain_matches_jax_vjp(per_row):
    """K4b's plain version, through the wrapper, against ``jax.vjp`` of JAX's
    ``_core_xla`` (dq, dk_intra, dv_intra, dmixed and d md, shared [N] or per
    row [B, N]): in float32 (TOL), and with bf16 inputs against the float32
    vjp on the same values (P, dA and the outputs rounded to bf16 where
    ``chunk_output_bwd_plain`` documents, up to 2.4e-3 here: BF16_TOL)."""
    import jax

    q4, k4, v4, mixed4, md, do4, h = _core_inputs(per_row)
    f, args = _jax_core(q4, k4, v4, mixed4, md, h)
    _, vjp = jax.vjp(f, *args)
    ref = vjp(jnp.asarray(do4.numpy()))
    for tdt, tol in ((torch.float32, TOL), (torch.bfloat16, BF16_TOL)):
        got = port_kernels.chunk_output_bwd(*(x.to(tdt) for x in (q4, k4, v4, mixed4)), md,
                                            do4.to(tdt), h)
        assert got[4].shape == md.shape and got[4].dtype == torch.float32
        for name, r, g in zip(("dq", "dk_intra", "dv_intra", "dmixed", "dmd"), ref, got):
            assert_close(f"K4b plain {name} vs JAX {tdt} per_row={per_row}",
                         np.asarray(r), g.float(), tol)
