"""The chunked (WY-form) gated delta rule through hand-written CUDA kernels
(counterpart of ``mhla_tpu/kernels/delta_chunk_pallas.py``):

  K11  ``delta_chunk_fwd``  (``csrc/delta_chunk.cu``): o, the final state and,
       for training, every chunk-entry state
  K11b ``delta_chunk_bwd``  (``csrc/delta_chunk_bwd.cu``): dq, dk, dv, dG,
       dbeta and ds0 with respect to the normed q / k and the within-chunk
       cumsum G

Per chunk of C tokens and per head, with G the inclusive cumsum of g over
the chunk (scale = Dk**-0.5):

  A     = beta_i (k_i . k_j) exp(G_i - G_j), j < i      T = (I + A)^-1
  u     = T (beta v);   w = T (beta e^G k)
  v_eff = u - w S
  o     = (q e^G scale) S + ((q k^T) exp(G_i - G_j) scale, j <= i) v_eff
  S     = e^{G_last} S + (k e^{G_last - G})^T v_eff

Both kernels are several launches behind one wrapper (each call adds one to
its count), every product on bf16 wgmma over TMA-fed tiles: a parallel pass
per (chunk, head) forms T by float32 (blocked) forward substitution and the
chunk's w, P (the masked decayed scores), qd = q e^G scale and kc = k
e^{G_last - G}, one record per chunk and head; a sequential pass walks each
(batch, head, 64-column panel of Dv) chain over its chunks, carrying S
(forward) or its cotangent (backward, in reverse) as wgmma accumulators; the
backward then forms the gradients of every chunk in one parallel pass from
its saved entry state and the chain's exit cotangent, every sum over Dv
kept on chip and taken in a fixed order (no atomics: bit-equal from run to
run).

Rounding points, those of the TPU kernel in the compute dtype ``cdt`` (the
inputs' dtype, bf16 or float32): T, w, P, qd, kc, beta v and beta e^G k in
cdt; u and v_eff accumulated in float32 and v_eff rounded before each
product; S carried in float32 and rounded before each product; the saved
entry states and the chain's exit cotangents in cdt. The decays exp(G_i -
G_j) are formed in float32 from differences (never factored: e^{-G}
overflows at delta-rule decay magnitudes), where the TPU kernel streams
them rounded to cdt. The ``*_plain`` versions do the same arithmetic in
plain PyTorch; each wrapper runs its plain version for a CPU tensor and
launches its kernels for a CUDA tensor or raises.

``gated_delta_chunk_fused`` is the op's entry with JAX's dispatch rule;
``_DeltaChunkFn`` is the ``torch.autograd.Function`` with K11 forward and
K11b backward (the JAX custom VJP, ``delta_chunk_pallas.py:624-652``). The
L2 norm of q and k and the cumsum g -> G stay ordinary autograd around it,
as JAX differentiates them outside its kernel (:541-621).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ..ops.delta_rule import gated_delta_chunk, l2norm
from ..ops.mhla_chunk import _pad_to_chunks
from . import _build
from .mhla_chunk import _on_cpu, _raise_on_error, _stream

launches = {"delta_chunk_fwd": 0, "delta_chunk_bwd": 0}

_DK = 128  # the head dim of q and k the kernels hold (csrc: kDk)
_DV_TILE = 64  # Dv columns per chain (csrc: kPanel)
_MAX_CHUNK = 64  # csrc: kMaxC
_REC_BYTES = 66048  # the prep's record of one (chunk, head) (csrc: kRecBytes)

_lib_cache: Optional[ctypes.CDLL] = None


def _lib() -> ctypes.CDLL:
    global _lib_cache
    if _lib_cache is None:
        lib = _build.load()
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.mhla_delta_prep.argtypes = [p] * 5 + [i] * 5 + [p]
        lib.mhla_delta_fwd_chain.argtypes = [p] * 6 + [i] * 5 + [p]
        lib.mhla_delta_bwd_chain.argtypes = [p] * 5 + [i] * 5 + [p]
        lib.mhla_delta_bwd_grads.argtypes = [p] * 14 + [i] * 5 + [p]
        for fn in (lib.mhla_delta_prep, lib.mhla_delta_fwd_chain, lib.mhla_delta_bwd_chain,
                   lib.mhla_delta_bwd_grads):
            fn.restype = ctypes.c_int
        _lib_cache = lib
    return _lib_cache


def _check(name: str, x: torch.Tensor, dtype: torch.dtype, shape: tuple):
    if x.dtype != dtype:
        raise TypeError(f"{name}: kernel takes {dtype}, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(x.shape)}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(f"{name}: kernel takes contiguous 16-byte aligned tensors")


def _check_kernel_args(q4, k4, v4, g_cum, beta, chunk_size: int):
    b, tp, h, dk = q4.shape
    dv, c = v4.shape[-1], chunk_size
    if tp % c:
        raise ValueError(f"{tp} tokens are not whole chunks of {c}")
    n = tp // c
    if c % 16 or c > _MAX_CHUNK or dk != _DK or dv % _DV_TILE:
        raise ValueError(
            f"kernel needs chunk_size % 16 == 0 and <= {_MAX_CHUNK}, Dk == {_DK} and "
            f"Dv % {_DV_TILE} == 0, got C={c}, Dk={dk}, Dv={dv}"
        )
    _check("q4", q4, torch.bfloat16, (b, tp, h, dk))
    _check("k4", k4, torch.bfloat16, (b, tp, h, dk))
    _check("v4", v4, torch.bfloat16, (b, tp, h, dv))
    _check("g_cum", g_cum, torch.float32, (b, tp, h))
    _check("beta", beta, torch.float32, (b, tp, h))
    return b, n, c, h, dk, dv


# ---------------------------------------------------------------------------
# Plain PyTorch versions: the kernels' arithmetic, vectorized over chunks
# ---------------------------------------------------------------------------


def _chunks(x: torch.Tensor, c: int) -> torch.Tensor:
    """[B, T, H(, D)] -> [B, N, H, C(, D)] float32."""
    b, t, h = x.shape[:3]
    if x.ndim == 4:
        return x.float().reshape(b, t // c, c, h, x.shape[-1]).transpose(2, 3)
    return x.float().reshape(b, t // c, c, h).transpose(2, 3)


def _unchunk(x: torch.Tensor) -> torch.Tensor:
    """[B, N, H, C(, D)] -> [B, N*C, H(, D)]."""
    x = x.transpose(2, 3)
    return x.reshape(x.shape[0], -1, *x.shape[3:]).contiguous()


def _decays(g: torch.Tensor, scale: float):
    """exp(G_i - G_j) masked to j < i (strict) and, times ``scale``, to
    j <= i (incl), float32 [..., C, C] from the differences of G [..., C]."""
    c = g.shape[-1]
    idx = torch.arange(c, device=g.device)
    d = g[..., :, None] - g[..., None, :]
    ninf = torch.tensor(float("-inf"), device=g.device)
    strict = torch.exp(torch.where(idx[:, None] > idx[None, :], d, ninf))
    incl = torch.exp(torch.where(idx[:, None] >= idx[None, :], d, ninf)) * scale
    return strict, incl


def _unit_lower_inverse(a: torch.Tensor) -> torch.Tensor:
    """(I + A)^-1 for strictly-lower-triangular float32 A [..., C, C] by
    forward substitution, row by row: T[i, :i] = -A[i, :i] T[:i, :i]."""
    c = a.shape[-1]
    t = torch.eye(c, dtype=a.dtype, device=a.device).expand(a.shape).clone()
    for i in range(1, c):
        t[..., i, :i] = -(a[..., i:i + 1, :i] @ t[..., :i, :i])[..., 0, :]
    return t


def delta_prep_plain(q4, k4, g_cum, beta, chunk_size: int):
    """The per-(chunk, head) pass: T = (I + A)^-1 (float32 substitution),
    w = T (beta e^G k), P = (q k^T) exp(G_i - G_j) scale masked j <= i,
    qd = q e^G scale and kc = k e^{G_last - G}, each [B, N, H, C, C|Dk] in
    q's dtype, from q4, k4 [B, T, H, Dk] and g_cum, beta [B, T, H]."""
    cdt = q4.dtype
    c = chunk_size
    scale = q4.shape[-1] ** -0.5
    q, k = _chunks(q4, c), _chunks(k4, c)
    g, bt = _chunks(g_cum, c), _chunks(beta, c)
    ds, di = _decays(g, scale)
    a = (k @ k.transpose(-1, -2)) * ds * bt[..., :, None]
    tc = _unit_lower_inverse(a).to(cdt)
    eg = torch.exp(g)
    wsrc = (k * (eg * bt)[..., None]).to(cdt)
    w = (tc.float() @ wsrc.float()).to(cdt)
    p = ((q @ k.transpose(-1, -2)) * di).to(cdt)
    qd = (q * (eg * scale)[..., None]).to(cdt)
    kc = (k * torch.exp(g[..., -1:] - g)[..., None]).to(cdt)
    return tc, w, p, qd, kc


def delta_chunk_fwd_plain(q4, k4, v4, g_cum, beta, s0, chunk_size: int = 64,
                          collect_states: bool = False):
    """K11's function. q4, k4 [B, T, H, Dk] (normed) and v4 [B, T, H, Dv]
    in the compute dtype, T whole chunks; g_cum (the within-chunk inclusive
    cumsum of g) and beta [B, T, H] float32; s0 [B, H, Dk, Dv] float32.
    Returns o [B, T, H, Dv] in v's dtype, the final state float32 and, with
    ``collect_states``, the chunk-entry states [B, N, H, Dk, Dv] in the
    compute dtype (else None)."""
    cdt = v4.dtype
    c = chunk_size
    tc, w, p, qd, kc = delta_prep_plain(q4, k4, g_cum, beta, c)
    g, bt = _chunks(g_cum, c), _chunks(beta, c)
    vb = (_chunks(v4, c) * bt[..., None]).to(cdt).float()
    el = torch.exp(g[..., -1])  # [B, N, H]
    s = s0.float().clone()
    outs, states = [], []
    for n in range(tc.shape[1]):
        zc = s.to(cdt)
        if collect_states:
            states.append(zc)
        z = zc.float()
        v_eff = (tc[:, n].float() @ vb[:, n] - w[:, n].float() @ z).to(cdt).float()
        outs.append((qd[:, n].float() @ z + p[:, n].float() @ v_eff).to(cdt))
        s = s * el[:, n, :, None, None] + kc[:, n].float().transpose(-1, -2) @ v_eff
    o = _unchunk(torch.stack(outs, dim=1))
    return o, s, (torch.stack(states, dim=1) if collect_states else None)


def _bwd_chain_plain(p, qd, w, kc, do, el, ds_final, cdt):
    """The reverse chain: the exit cotangent of every chunk [B, N, H, Dk,
    Dv] in cdt and ds0 float32."""
    dz = ds_final.float().clone()
    exits = [None] * p.shape[1]
    for n in reversed(range(p.shape[1])):
        dzc = dz.to(cdt)
        exits[n] = dzc
        dv_eff = (p[:, n].float().transpose(-1, -2) @ do[:, n]
                  + kc[:, n].float() @ dzc.float()).to(cdt).float()
        dz = (dz * el[:, n, :, None, None] + qd[:, n].float().transpose(-1, -2) @ do[:, n]
              - w[:, n].float().transpose(-1, -2) @ dv_eff)
    return torch.stack(exits, dim=1), dz


def delta_chunk_bwd_plain(q4, k4, v4, g_cum, beta, states, do4, ds_final, chunk_size: int = 64):
    """K11b's function: the gradients of :func:`delta_chunk_fwd_plain` for
    the output cotangent do4 [B, T, H, Dv] and the final-state cotangent
    ds_final [B, H, Dk, Dv] float32, given its chunk-entry ``states``.
    Returns dq4, dk4 (w.r.t. the normed q, k), dv4 in the compute dtype and
    dG, dbeta [B, T, H] and ds0 float32."""
    cdt = v4.dtype
    c = chunk_size
    scale = q4.shape[-1] ** -0.5
    tc, w, p, qd, kc = delta_prep_plain(q4, k4, g_cum, beta, c)
    g, bt = _chunks(g_cum, c), _chunks(beta, c)
    eg, el = torch.exp(g), torch.exp(g[..., -1])
    ec = torch.exp(g[..., -1:] - g)
    q, k, v = _chunks(q4, c), _chunks(k4, c), _chunks(v4, c)
    do = _chunks(do4.to(cdt), c)
    dzc, ds0 = _bwd_chain_plain(p, qd, w, kc, do, el, ds_final, cdt)
    s_in, dz = states.float(), dzc.float()
    tcf, wf = tc.float(), w.float()
    t_ = lambda x: x.transpose(-1, -2)  # noqa: E731

    # pass 1, per chunk: everything that sums over Dv
    u = tcf @ (v * bt[..., None]).to(cdt).float()
    v_eff = (u - wf @ s_in).to(cdt).float()
    dv_eff = (t_(p.float()) @ do + kc.float() @ dz).to(cdt).float()
    dmu = t_(tcf) @ dv_eff
    dv = (dmu * bt[..., None]).to(cdt)
    dbeta = (dmu * v).sum(-1)
    dkc = v_eff @ t_(dz)
    dqd = do @ t_(s_in)
    dw = dv_eff @ t_(s_in)
    dp = do @ t_(v_eff)
    da_u = dmu.to(cdt).float() @ t_(u.to(cdt).float())
    dgl = el * (s_in * dz).sum((-1, -2))

    # pass 2, per chunk: the rest
    qd_f, kc_f = q * (eg * scale)[..., None], k * ec[..., None]
    kneg = k * eg[..., None]
    dg = (dqd * qd_f).sum(-1) - (dkc * kc_f).sum(-1)
    dgl = dgl + (dkc * kc_f).sum((-1, -2))
    dq_x = dqd * (eg * scale)[..., None]
    dk_x = dkc * ec[..., None]
    dmw = t_(tcf) @ (-dw).to(cdt).float()
    dk_x = dk_x + dmw * (eg * bt)[..., None]
    dbeta = dbeta + (dmw * kneg).sum(-1)
    dg = dg + (dmw * kneg * bt[..., None]).sum(-1)
    da = -(da_u + dmw.to(cdt).float() @ t_(wf))
    ds, di = _decays(g, scale)
    kkds = (k @ t_(k)) * ds
    dbeta = dbeta + (da * kkds).sum(-1)
    dkk = (da * ds * bt[..., :, None]).to(cdt).float()
    dqk = (dp * di).to(cdt).float()
    m = da * kkds * bt[..., :, None] + dp * ((q @ t_(k)) * di)
    dg = dg + m.sum(-1) - m.sum(-2)
    dg[..., -1] += dgl
    dq = (dq_x + dqk @ k).to(cdt)
    dk = (dk_x + dkk @ k + t_(dkk) @ k + t_(dqk) @ q).to(cdt)
    return (_unchunk(dq), _unchunk(dk), _unchunk(dv), _unchunk(dg), _unchunk(dbeta), ds0)


# ---------------------------------------------------------------------------
# K11 / K11b wrappers
# ---------------------------------------------------------------------------


def _prep(q4, k4, g_cum, beta, b, n, c, h, dk):
    """The per-(chunk, head) records (T, P, w, qd, kc in the kernels' tile
    layout and the gates), [B, N, H, _REC_BYTES] bytes."""
    rec = torch.empty(b, n, h, _REC_BYTES, dtype=torch.uint8, device=q4.device)
    err = _lib().mhla_delta_prep(
        q4.data_ptr(), k4.data_ptr(), g_cum.data_ptr(), beta.data_ptr(), rec.data_ptr(),
        b, n, c, h, dk, _stream(q4),
    )
    _raise_on_error("delta_chunk prep", err)
    return rec


def delta_chunk_fwd(q4, k4, v4, g_cum, beta, s0, chunk_size: int = 64,
                    collect_states: bool = False):
    """K11 (see :func:`delta_chunk_fwd_plain`)."""
    if _on_cpu(q4, k4, v4, g_cum, beta, s0):
        return delta_chunk_fwd_plain(q4, k4, v4, g_cum, beta, s0, chunk_size, collect_states)
    b, n, c, h, dk, dv = _check_kernel_args(q4, k4, v4, g_cum, beta, chunk_size)
    _check("s0", s0, torch.float32, (b, h, dk, dv))
    with torch.cuda.device(q4.device):
        rec = _prep(q4, k4, g_cum, beta, b, n, c, h, dk)
        o = torch.empty_like(v4)
        s_final = torch.empty_like(s0)
        states = (torch.empty(b, n, h, dk, dv, dtype=v4.dtype, device=v4.device)
                  if collect_states else None)
        err = _lib().mhla_delta_fwd_chain(
            rec.data_ptr(), v4.data_ptr(), s0.data_ptr(), o.data_ptr(), s_final.data_ptr(),
            0 if states is None else states.data_ptr(), b, n, c, h, dv, _stream(q4),
        )
        _raise_on_error("delta_chunk_fwd chain", err)
    launches["delta_chunk_fwd"] += 1
    return o, s_final, states


def delta_chunk_bwd(q4, k4, v4, g_cum, beta, states, do4, ds_final, chunk_size: int = 64):
    """K11b (see :func:`delta_chunk_bwd_plain`)."""
    if _on_cpu(q4, k4, v4, g_cum, beta, states, do4, ds_final):
        return delta_chunk_bwd_plain(q4, k4, v4, g_cum, beta, states, do4, ds_final, chunk_size)
    b, n, c, h, dk, dv = _check_kernel_args(q4, k4, v4, g_cum, beta, chunk_size)
    _check("states", states, torch.bfloat16, (b, n, h, dk, dv))
    _check("do4", do4, torch.bfloat16, (b, n * c, h, dv))
    _check("ds_final", ds_final, torch.float32, (b, h, dk, dv))
    with torch.cuda.device(q4.device):
        rec = _prep(q4, k4, g_cum, beta, b, n, c, h, dk)
        exits = torch.empty_like(states)
        ds0 = torch.empty_like(ds_final)
        err = _lib().mhla_delta_bwd_chain(
            rec.data_ptr(), do4.data_ptr(), ds_final.data_ptr(), exits.data_ptr(),
            ds0.data_ptr(), b, n, c, h, dv, _stream(q4),
        )
        _raise_on_error("delta_chunk_bwd chain", err)
        dq, dk_, dv_ = torch.empty_like(q4), torch.empty_like(k4), torch.empty_like(v4)
        dg, dbeta = torch.empty_like(g_cum), torch.empty_like(beta)
        err = _lib().mhla_delta_bwd_grads(
            q4.data_ptr(), k4.data_ptr(), v4.data_ptr(), g_cum.data_ptr(), beta.data_ptr(),
            states.data_ptr(), exits.data_ptr(), do4.data_ptr(), rec.data_ptr(),
            dq.data_ptr(), dk_.data_ptr(), dv_.data_ptr(), dg.data_ptr(), dbeta.data_ptr(),
            b, n, c, h, dv, _stream(q4),
        )
        _raise_on_error("delta_chunk_bwd grads", err)
    launches["delta_chunk_bwd"] += 1
    return dq, dk_, dv_, dg, dbeta, ds0


class _DeltaChunkFn(torch.autograd.Function):
    """K11 forward, K11b backward over padded chunk-major inputs (see
    :func:`gated_delta_chunk_fused`); the entry states are kept for the
    backward only when a gradient is wanted."""

    @staticmethod
    def forward(ctx, q4, k4, v4, g_cum, beta, s0, chunk_size):
        collect = any(ctx.needs_input_grad)
        o, s, states = delta_chunk_fwd(q4, k4, v4, g_cum, beta, s0, chunk_size, collect)
        if collect:
            ctx.save_for_backward(q4, k4, v4, g_cum, beta, states)
        ctx.chunk_size = chunk_size
        return o, s

    @staticmethod
    def backward(ctx, do, ds):
        q4, k4, v4, g_cum, beta, states = ctx.saved_tensors
        do = torch.zeros_like(v4) if do is None else do.to(v4.dtype).contiguous()
        ds = (torch.zeros(states.shape[0], *states.shape[2:], dtype=torch.float32,
                          device=v4.device)
              if ds is None else ds.float().contiguous())
        grads = delta_chunk_bwd(q4, k4, v4, g_cum, beta, states, do, ds, ctx.chunk_size)
        return (*grads, None)


def kernel_route(t: int, chunk_size: int, dk: int, dv: int) -> bool:
    """JAX's rule (``delta_chunk_pallas.py:680-686``): T >= chunk_size and
    the Pallas block rule (chunk % 8, Dk % 128, Dv % 128; ``mhla_chunk_pallas
    ._pallas_compatible``) send a call to the fused kernels."""
    return t >= chunk_size and chunk_size % 8 == 0 and dk % 128 == 0 and dv % 128 == 0


def gated_delta_chunk_fused(
    q: torch.Tensor,  # [B, T, H, Dk]
    k: torch.Tensor,
    v: torch.Tensor,  # [B, T, H, Dv]
    g: torch.Tensor,  # [B, T, H] log decay (<= 0)
    beta: torch.Tensor,  # [B, T, H]
    initial_state: Optional[torch.Tensor] = None,
    chunk_size: int = 64,
    output_final_state: bool = False,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """:func:`ops.delta_rule.gated_delta_chunk` through K11 / K11b.

    Dispatch, JAX's (``delta_chunk_pallas.py:654-690``): a call with
    T >= chunk_size whose chunk size, Dk and Dv pass the Pallas block rule
    (:func:`kernel_route`) takes the fused path, whose wrappers run their
    plain versions on the CPU and launch the kernels on a CUDA tensor or
    raise (they hold chunk % 16 == 0 up to 64, Dk == 128, Dv % 64 == 0,
    bf16); every other call goes to the op ``gated_delta_chunk``, as JAX
    sends it there. The compute dtype is bf16 when v is bf16, else float32;
    o comes back in v's dtype, the final state float32, or None without
    ``output_final_state`` (whose cotangent is then zero)."""
    b, t, h, dk = q.shape
    dv = v.shape[-1]
    if not kernel_route(t, chunk_size, dk, dv):
        return gated_delta_chunk(
            q, k, v, g, beta, initial_state=initial_state, chunk_size=chunk_size,
            output_final_state=output_final_state,
        )
    c = chunk_size
    cdt = torch.bfloat16 if v.dtype == torch.bfloat16 else torch.float32
    q4, k4, v4 = (_pad_to_chunks(x, c).to(cdt)
                  for x in (l2norm(q.float()), l2norm(k.float()), v.float()))
    gp = _pad_to_chunks(g.float(), c)
    n = gp.shape[1] // c
    g_cum = torch.cumsum(gp.reshape(b, n, c, h), dim=2).reshape(b, n * c, h)
    bp = _pad_to_chunks(beta.float(), c)
    s0 = (initial_state.float() if initial_state is not None
          else torch.zeros(b, h, dk, dv, dtype=torch.float32, device=q.device))
    o, s = _DeltaChunkFn.apply(q4, k4, v4, g_cum, bp, s0, c)
    return o[:, :t].to(v.dtype), (s if output_final_state else None)
