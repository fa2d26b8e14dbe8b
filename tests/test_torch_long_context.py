"""The port's long-context path held against the JAX package on the CPU:
flash attention at head dim 256 (the plain K9 / K9b behind it) in every form,
the state mixing beyond 32 chunks (the plain K3 / K3b) against the JAX
Pallas mixing kernels in interpret mode, the ops at 512 mixing slots, and a
2-layer hybrid whose softmax layer keeps heads of 256 at 33 chunks: logits,
parameter gradients and generation. Inputs come from numpy with fixed seeds.
"""

import importlib
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mhla_tpu.kernels import mhla_chunk_pallas as jax_pallas
from mhla_tpu.kernels.flash_attention import flash_attention as jax_flash_attention
from mhla_tpu.layers import sdpa as jax_sdpa
from mhla_tpu.models import MHLAForCausalLM as JaxLM
from mhla_tpu.models import MHLALMConfig as JaxConfig
from mhla_tpu.models import cross_entropy_loss as jax_cross_entropy_loss
from mhla_tpu.models import generate as jax_generate
from mhla_tpu_torch.kernels import flash_attention as flash
from mhla_tpu_torch.kernels import mhla_chunk as port_kernels
from mhla_tpu_torch.layers import attention
from mhla_tpu_torch.models import (
    MHLAForCausalLM,
    MHLALMConfig,
    cross_entropy_loss,
    generate,
    params_from_jax,
)
from mhla_tpu_torch.utils import assert_close

jax_chunk_ops = importlib.import_module("mhla_tpu.ops.mhla_chunk")
jax_rec = importlib.import_module("mhla_tpu.ops.mhla_recurrent")
port_ops = importlib.import_module("mhla_tpu_torch.ops.mhla_chunk")
port_rec = importlib.import_module("mhla_tpu_torch.ops.mhla_recurrent")

# float32 on both sides, the same arithmetic in other summation orders
TOL = 1e-5
# float32 through the layers of a model, forward and backward (as
# tests/test_torch_lm.py and tests/test_torch_attention.py)
MODEL_TOL = 1e-4


def _t(x):
    return torch.from_numpy(np.array(x))


def _qkv(b, tq, tk, h, d, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=(b, t, h, d)).astype(np.float32) for t in (tq, tk, tk))


def _docs(lengths_per_row, t):
    """[B, T] int32 document ids, the rest of a row one more document."""
    out = np.zeros((len(lengths_per_row), t), np.int32)
    for bi, lengths in enumerate(lengths_per_row):
        pos = 0
        for sid, n in enumerate(lengths):
            out[bi, pos:pos + n] = sid
            pos += n
        out[bi, pos:] = len(lengths)
    return out


# (Tq, Tk, causal, segment ids): non-causal with Tq != Tk both ways, causal,
# causal within documents (one-token documents, boundaries inside tiles)
_FORMS = {
    "plain_tq_gt_tk": (300, 170, False, None),
    "plain_tq_lt_tk": (70, 257, False, None),
    "causal": (300, 300, True, None),
    "causal_segment": (300, 300, True, _docs([[1, 1, 150, 7], [299]], 300)),
}


@pytest.mark.parametrize("form", list(_FORMS))
def test_flash_head_dim_256_matches_jax(form):
    """flash_attention (the plain K9 mirror on the CPU) and its gradients
    (the plain K9b) at head dim 256 against the JAX wrapper's CPU route and
    ``jax.vjp`` of it."""
    tq, tk, causal, seg = _FORMS[form]
    q, k, v = _qkv(2, tq, tk, 2, 256, seed=tq + tk)
    w = np.random.default_rng(1).normal(size=q.shape).astype(np.float32)
    jseg = None if seg is None else jnp.asarray(seg)
    ref, vjp = jax.vjp(lambda *x: jax_flash_attention(*x, causal=causal, segment_ids=jseg),
                       *map(jnp.asarray, (q, k, v)))
    leaves = [_t(x).requires_grad_() for x in (q, k, v)]
    before = dict(flash.launches)
    out = flash.flash_attention(*leaves, causal=causal,
                                segment_ids=None if seg is None else _t(seg))
    (out * _t(w)).sum().backward()
    assert flash.launches == before  # CPU tensors: the plain versions, no launch
    assert_close(f"flash d256 {form}", np.asarray(ref), out.detach(), TOL)
    for name, r, x in zip("qkv", vjp(jnp.asarray(w)), leaves):
        assert_close(f"flash d256 grad {name} {form}", np.asarray(r), x.grad, TOL)


@pytest.mark.parametrize("form", ["causal", "causal_segment"])
def test_sdpa_routes_head_dim_256_to_flash_and_matches_jax(form, monkeypatch):
    """At 2,050 tokens (no multiple of the 64-token tile) and head dim 256
    the port's sdpa takes the flash route, as JAX's rule sends it to the
    library kernel on a TPU; output and ``jax.vjp`` gradients agree with
    JAX's sdpa (its CPU route)."""
    t = 2050
    seg = _docs([[1000, 3], [2049]], t) if form == "causal_segment" else None
    q, k, v = _qkv(2, t, t, 1, 256, seed=3)
    w = np.random.default_rng(4).normal(size=q.shape).astype(np.float32)
    routed = []
    monkeypatch.setattr(attention, "flash_attention",
                        lambda *a, **kw: routed.append(kw) or flash.flash_attention(*a, **kw))
    jseg = None if seg is None else jnp.asarray(seg)
    ref, vjp = jax.vjp(lambda *x: jax_sdpa(*x, causal=True, segment_ids=jseg),
                       *map(jnp.asarray, (q, k, v)))
    leaves = [_t(x).requires_grad_() for x in (q, k, v)]
    out = attention.sdpa(*leaves, causal=True, segment_ids=None if seg is None else _t(seg))
    (out * _t(w)).sum().backward()
    assert len(routed) == 1 and routed[0]["causal"]
    assert_close(f"sdpa d256 {form}", np.asarray(ref), out.detach(), TOL)
    for name, r, x in zip("qkv", vjp(jnp.asarray(w)), leaves):
        assert_close(f"sdpa d256 grad {name} {form}", np.asarray(r), x.grad, TOL)


@pytest.fixture
def _force_interpret():
    jax_pallas.FORCE_INTERPRET = True
    yield
    jax_pallas.FORCE_INTERPRET = False


def _mix_inputs(b, n, per_row, seed=2):
    """States and their cotangent [B, N, 16, 128] and a strict lower mixing
    matrix [N, N] or one per batch row [B, N, N], float32 numpy."""
    rng = np.random.default_rng(seed)
    states = rng.normal(size=(b, n, 16, 128)).astype(np.float32)
    dout = rng.normal(size=(b, n, 16, 128)).astype(np.float32)
    m = rng.uniform(0.0, 1.0, (b, n, n) if per_row else (n, n)).astype(np.float32)
    return states, dout, np.tril(m, -1)


@pytest.mark.parametrize("n,b,per_row", [(128, 1, False), (192, 2, False), (128, 2, True)])
def test_wide_mix_matches_jax_pallas_kernels(n, b, per_row, _force_interpret):
    """mix_states / mix_states_bwd (the plain K3 / K3b the wide forms are held
    to on the card) at N >= 128 chunks against JAX's ``_mix_kernel`` (lower:
    the forward; upper: dS), ``_dm_kernel`` and ``_mix_bwd_fused_kernel`` in
    interpret mode, shared and per-row M."""
    states, dout, m = _mix_inputs(b, n, per_row)
    assert jax_pallas._mix_use_pallas(n, 128)
    js, jd, jm = map(jnp.asarray, (states, dout, m))
    ref = jax_pallas._mix_pallas(jm, js, lower=True)
    out = port_kernels.mix_states(_t(m), _t(states))
    assert_close(f"mix N={n}", np.asarray(ref), out, TOL)

    ds, dm = port_kernels.mix_states_bwd(_t(m), _t(dout), _t(states))
    mt = jnp.swapaxes(jm, -1, -2)
    ds_up = jax_pallas._mix_pallas(mt, jd, lower=False)
    dm_k = jax_pallas._dm_pallas(jd, js, jax_pallas._mix_bands(n, True), batched=per_row)
    ds_f, dm_f = jax_pallas._mix_bwd_fused_pallas(mt, jd, js)
    strict = lambda x: np.tril(np.asarray(x), -1)  # noqa: E731  (the op keeps i > j)
    for tag, r_ds, r_dm in (("upper + _dm_kernel", ds_up, dm_k), ("fused", ds_f, dm_f)):
        assert_close(f"dS {tag} N={n}", np.asarray(r_ds), ds, TOL)
        assert_close(f"dM {tag} N={n}", strict(r_dm), dm, TOL)
    # and through the custom VJP the JAX op runs
    _, vjp = jax.vjp(jax_pallas.mix_states, jm, js)
    r_dm, r_ds = vjp(jd)
    assert_close(f"dS vjp N={n}", np.asarray(r_ds), ds, TOL)
    assert_close(f"dM vjp N={n}", strict(r_dm), dm, TOL)


@pytest.mark.parametrize("n", [32, 40])
def test_mix_takes_m_at_the_states_dtype(n):
    """At the 340M's 32 chunks and past them, mix_states and mix_states_bwd
    (the plain K3 / K3b, as the card's kernels) take an unrounded M at the
    bf16 of the states: the same bits as M rounded first, and JAX's mixing
    einsum with M in bf16, the dtype JAX's op hands it in."""
    states, dout, m = _mix_inputs(2, n, False, seed=5)
    bf16 = torch.bfloat16
    s, d = _t(states).to(bf16), _t(dout).to(bf16)
    m_bf = _t(m).to(bf16).float()
    out = port_kernels.mix_states(_t(m), s)
    assert torch.equal(out, port_kernels.mix_states(m_bf, s))
    ref = jax_pallas._mix_xla(jnp.asarray(m, jnp.bfloat16), jnp.asarray(states, jnp.bfloat16))
    assert_close(f"mix bf16 N={n}", np.asarray(ref.astype(jnp.float32)), out.float(), TOL)
    ds, dm = port_kernels.mix_states_bwd(_t(m), d, s)
    ds_r, dm_r = port_kernels.mix_states_bwd(m_bf, d, s)
    assert torch.equal(ds, ds_r) and torch.equal(dm, dm_r)


def test_ops_at_512_slots_match_jax():
    """The chunked op, its decode cache and the recurrence past 32 chunks with
    a 512-slot mixing matrix (a 32,768-token context): 2,112 tokens (33
    chunks) through the chunked op, ``state_from_chunk``, then 70 decode
    steps across a chunk boundary."""
    b, t, h, dk, dv, c, slots = 1, 2112, 1, 16, 16, 64, 512
    rng = np.random.default_rng(5)
    q, k = (np.maximum(rng.normal(size=(b, t + 70, h, dk)), 0).astype(np.float32)
            for _ in range(2))
    v = rng.normal(size=(b, t + 70, h, dv)).astype(np.float32)
    m = np.tril(np.clip(rng.uniform(0.0, 1.0, (slots, slots)), 1e-5, 1.0)).astype(np.float32)
    np.testing.assert_array_equal(np.asarray(jax_chunk_ops.prepare_mixing_matrix(
        jnp.asarray(m), 33)), port_ops.prepare_mixing_matrix(_t(m), 33).numpy())
    pre = lambda x: x[:, :t]  # noqa: E731
    o_ref, s_ref = jax_chunk_ops.mhla_chunk(*(jnp.asarray(pre(x)) for x in (q, k, v)),
                                            jnp.asarray(m), chunk_size=c,
                                            output_final_state=True)
    o, s = port_ops.mhla_chunk(*(_t(pre(x)) for x in (q, k, v)), _t(m), chunk_size=c,
                               output_final_state=True)
    assert_close("mhla_chunk 33 chunks", np.asarray(o_ref), o, TOL)
    st_ref = jax_rec.state_from_chunk(s_ref, t, jnp.asarray(m), chunk_size=c, num_slots=slots)
    st = port_rec.state_from_chunk(s, t, _t(m), chunk_size=c, num_slots=slots)
    assert st.states.shape[2] == slots
    for name in ("states", "mixed", "s_cur"):
        assert_close(f"state_from_chunk {name}", np.asarray(getattr(st_ref, name)),
                     getattr(st, name), TOL)
    post = lambda x: x[:, t:]  # noqa: E731
    o_ref, st_ref = jax_rec.mhla_recurrent(*(jnp.asarray(post(x)) for x in (q, k, v)),
                                           jnp.asarray(m), st_ref, chunk_size=c)
    o, st = port_rec.mhla_recurrent(*(_t(post(x)) for x in (q, k, v)), _t(m), st, chunk_size=c)
    assert st.t == int(st_ref.t) == t + 70
    assert_close("decode past chunk 33", np.asarray(o_ref), o, TOL)
    assert_close("decode mixed", np.asarray(st_ref.mixed), st.mixed, TOL)


def test_long_context_config_from_json(tmp_path):
    """The long-context json: 32,768 positions give 512 mixing slots, and an
    ``attn`` dict without ``num_heads`` gives the softmax layers the LM's 4
    heads of 256; the parameter count matches the JAX model's (counted on
    the meta device and from shapes, no weights made)."""
    raw = {"model_type": "mhla", "hidden_size": 1024, "num_hidden_layers": 24, "num_heads": 4,
           "vocab_size": 32000, "max_position_embeddings": 32768,
           "attn": {"layers": list(range(0, 24, 3))}}
    path = tmp_path / "long.json"
    path.write_text(json.dumps(raw))
    cfg = MHLALMConfig.from_json(str(path))
    assert cfg.num_slots == 512 and cfg.max_context == 32768
    model = MHLAForCausalLM(cfg, device="meta")
    attn = model.model.layers[0].attn
    assert (attn.num_heads, attn.head_dim) == (4, 256)
    assert model.model.layers[1].attn.mixing_matrix.shape == (512, 512)
    n_port = sum(p.numel() for p in model.parameters())
    shapes = jax.eval_shape(JaxLM(JaxConfig(**{k: raw[k] for k in raw if k != "model_type"})).init,
                            jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    n_jax = sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(shapes))
    assert n_port == n_jax
    assert 344e6 < n_port < 346e6


def _random_params(tree, seed=0):
    """Dense kernels N(0, 0.02), the embedding N(0, 0.5), norm weights
    1 + N(0, 0.1), mixing matrices U(0, 1), as tests/test_torch_lm.py."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = jax.tree_util.keystr(path)
        if "mixing_matrix" in name:
            x = rng.uniform(0.0, 1.0, leaf.shape)
        elif "embedding" in name:
            x = rng.normal(0.0, 0.5, leaf.shape)
        elif "kernel" in name:
            x = rng.normal(0.0, 0.02, leaf.shape)
        else:
            x = 1.0 + rng.normal(0.0, 0.1, leaf.shape)
        return x.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, tree)


# softmax layer 0 without num_heads: 2 heads of 256; 64 slots (4,096 positions)
_LONG = dict(hidden_size=512, num_hidden_layers=2, num_heads=2, vocab_size=100,
             max_position_embeddings=4096, attn={"layers": [0]})


@pytest.fixture(scope="module")
def long_pair():
    jax_model = JaxLM(JaxConfig(**_LONG))
    shapes = jax.eval_shape(jax_model.init, jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    params_np = _random_params(shapes)
    cfg = MHLALMConfig(**_LONG)
    port = MHLAForCausalLM(cfg)
    port.load_state_dict(params_from_jax(params_np, cfg))
    return jax_model, params_np, cfg, port


def test_long_context_hybrid_logits_and_gradients_match_jax(long_pair, monkeypatch):
    """2,112 tokens (33 chunks; the softmax layer on the flash route at
    head dim 256): the logits, the loss and every parameter's gradient."""
    jax_model, params_np, cfg, port = long_pair
    t = 2112
    ids = np.random.default_rng(10).integers(0, 100, (1, t)).astype(np.int32)
    routed = []
    monkeypatch.setattr(attention, "flash_attention",
                        lambda *a, **kw: routed.append(a[0].shape) or flash.flash_attention(*a, **kw))

    def loss(p):
        logits, _ = jax_model.apply(p, jnp.asarray(ids))
        return jax_cross_entropy_loss(logits, jnp.asarray(ids)), logits

    (ref_loss, ref_logits), ref_grads = jax.value_and_grad(loss, has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, params_np))
    ref = params_from_jax(jax.tree_util.tree_map(np.asarray, ref_grads), cfg)
    port.zero_grad()
    logits, _ = port(_t(ids).long())
    out = cross_entropy_loss(logits, _t(ids).long())
    out.backward()
    assert routed == [(1, t, 2, 256)]
    assert_close("logits", np.asarray(ref_logits), logits.detach(), MODEL_TOL)
    assert_close("loss", np.asarray(ref_loss), out.detach(), MODEL_TOL)
    grads = dict(port.named_parameters())
    assert set(grads) == set(ref)
    for name, g in ref.items():
        assert_close(f"grad {name}", g, grads[name].grad, MODEL_TOL)


def test_long_context_hybrid_generation_matches_jax(long_pair):
    """6 greedy tokens after a 2,110-token prompt (the prefill mixes 33
    chunks and runs the softmax layer on the flash route; the decode crosses
    into chunk 34)."""
    jax_model, params_np, cfg, port = long_pair
    ids = np.random.default_rng(12).integers(0, 100, (1, 2110)).astype(np.int32)
    ref = jax_generate(jax_model, jax.tree_util.tree_map(jnp.asarray, params_np),
                       jnp.asarray(ids), max_new_tokens=6)
    out = generate(port.eval(), _t(ids).long(), max_new_tokens=6)
    np.testing.assert_array_equal(np.asarray(ref), out.numpy())
