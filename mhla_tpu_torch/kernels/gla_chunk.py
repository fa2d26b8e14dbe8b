"""Chunked gated linear attention (GLA) through hand-written CUDA kernels
(counterpart of ``mhla_tpu/kernels/gla_chunk_pallas.py``):

  K12  ``gla_chunk_fwd``  (``csrc/gla_chunk.cu``): o, the final state and,
       for training, every chunk-entry state
  K12b ``gla_chunk_bwd``  (``csrc/gla_chunk_bwd.cu``): the gradients with
       respect to the decayed q and k, v, e^{G_last} and the initial state

The kernels take what the TPU kernel takes: per chunk of C tokens, with G
the inclusive within-chunk cumsum of the log decay gk (float32),
qd = q e^{G} scale and kd = k e^{-G} (scale = Dk**-0.5) and v in the compute
dtype ``cdt`` (the inputs' dtype, bf16 or float32), and e^{G_last} float32
[B, N, H, Dk]. Per chunk and head, with kc = cdt(kd e^{G_last}) and S the
chunk-entry state [Dk, Dv] float32:

  o  = cdt(mask(qd kd^T)) v + qd cdt(S)       mask: j <= i
  S' = e^{G_last} S + kc^T v                  (row d of S decays by e^{G_last, d})

The TPU kernel splits each supertile into three stages so that no product
sits on the chain (``:26-31``): the per-chunk products (kc^T v forward,
qd^T dO backward), the chain over the chunks, and the per-chunk readout
(forward) or gradients (backward). Here each wrapper is one C call of two
launches, every product on the TF32 tensor cores (wgmma, each float32
operand split into TF32 hi and lo for float32 accuracy; one exact product in
the bf16 form), tiles loaded by TMA: (1) a state pass, one block per (batch
row, head, 64-column Dv panel), walks the chunks with its part of the state
in registers, computes each chunk's product there and writes
each chunk-entry state (forward) or exit cotangent (backward, in reverse)
once, so the per-chunk products never reach device memory; (2) the readout
or the gradients, one block per (chunk, head), from those states. Stage 2 of
the backward takes every sum over Dv inside its block, in a fixed order: no
atomics, so K12b is bit-equal from run to run. The kernels take float32
operands: a bf16 call's qd, kd, v and dO go over as float32 copies (exact),
and the kernels round at the bf16 points. Each wrapper adds one to its
count.

The factored decay is JAX's: kd = k e^{-G} overflows float32 once a
chunk's summed log-decay falls below about -88 (about -1.4 a token over 64
tokens; logsigmoid(x) / 16 reaches that only for gate logits below about
-22). The port keeps the form for a per-key-channel gk so that it computes
what JAX computes.

A per-head gk [B, T, H] (Mamba2, simple GLA) takes the scalar-decay form
of both kernels (``gla_chunk_fwd_scalar``, ``gla_chunk_bwd_scalar``), in
difference form, where every exponent is <= 0: with G [B, T', H] the
within-chunk cumsum, e = scale e^{G}, a = e^{G_last - G} and f_ij = scale
e^{G_i - G_j} for j <= i (the exponent taken only there),

  o  = cdt(mask(q k^T * f)) v + cdt(q e) cdt(S)
  S' = e^{G_last} S + cdt(k a)^T v

The scores need the raw product q k^T, so these kernels take q and k
undecayed (in cdt), v and G float32, and form qd = cdt(q e) and kc = cdt(k
a) on the chip. K12b's scalar form returns the gradients of q, k, v, of G
per (token, head) and of s0; the reverse cumsum to gk is done outside.
(JAX's Mamba2 runs its factored op and gives non-finite values once a
chunk's decay passes -88; this form does not copy that fault.)

Rounding points, those of the TPU kernel: qd, kd, v and kc in cdt; every
product summed in float32 from cdt operands; the masked scores and the
entry state rounded to cdt before their products; the state, its
cotangent, the saved entry states and every gradient float32. (K12b's
float32 form sums dv's kc T(dS) as (T(dS) e^{G_last}) kd, the same sum in
another float32 order.) The
``*_plain`` versions do the same arithmetic in plain PyTorch; each wrapper
runs its plain version for a CPU tensor and launches its kernels for a
CUDA tensor or raises.

``gla_chunk_fused`` is the op's entry with JAX's dispatch rule;
``_GLAChunkFn`` is the ``torch.autograd.Function`` with K12 forward and K12b
backward (the JAX custom VJP, ``gla_chunk_pallas.py:464-486``): the
elementwise decay chains around the kernels (qd, kd, e^{G_last} and the
cumsum) are formed and differentiated in plain PyTorch in its forward and
backward, as JAX does outside its kernels (:422-461).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ..ops.gla_chunk import gla_chunk
from ..ops.mhla_chunk import _pad_to_chunks
from . import _build
from .delta_chunk import _check, _chunks, _unchunk, kernel_route
from .mhla_chunk import _on_cpu, _raise_on_error, _stream

launches = {"gla_chunk_fwd": 0, "gla_chunk_bwd": 0,
            "gla_chunk_fwd_scalar": 0, "gla_chunk_bwd_scalar": 0}

_DK = 128  # the head dim of q and k the kernels hold (csrc: kDk)
_DV_TILE = 64  # Dv columns of a panel (csrc: kPanel)
_MAX_CHUNK = 64  # csrc: kMaxC

_lib_cache: Optional[ctypes.CDLL] = None


def _lib() -> ctypes.CDLL:
    global _lib_cache
    if _lib_cache is None:
        lib = _build.load()
        p, i = ctypes.c_void_p, ctypes.c_int
        for fn in (lib.mhla_gla_fwd, lib.mhla_gla_fwd_scalar):
            fn.argtypes = [p] * 8 + [i] * 7 + [p]
        for fn in (lib.mhla_gla_bwd, lib.mhla_gla_bwd_scalar):
            fn.argtypes = [p] * 13 + [i] * 7 + [p]
        for fn in (lib.mhla_gla_fwd, lib.mhla_gla_bwd, lib.mhla_gla_fwd_scalar,
                   lib.mhla_gla_bwd_scalar):
            fn.restype = ctypes.c_int
        _lib_cache = lib
    return _lib_cache


def _check_kernel_args(qd4, kd4, v4, egl, chunk_size: int):
    """The kernels' shape rule; egl is e^{G_last} [B, N, H, Dk] or, for the
    scalar form, G [B, T', H]."""
    b, tp, h, dk = qd4.shape
    dv, c = v4.shape[-1], chunk_size
    if tp % c:
        raise ValueError(f"{tp} tokens are not whole chunks of {c}")
    n = tp // c
    if c % 16 or c > _MAX_CHUNK or dk != _DK or dv % _DV_TILE:
        raise ValueError(
            f"kernel needs chunk_size % 16 == 0 and <= {_MAX_CHUNK}, Dk == {_DK} and "
            f"Dv % {_DV_TILE} == 0, got C={c}, Dk={dk}, Dv={dv}"
        )
    cdt = v4.dtype
    if cdt not in (torch.bfloat16, torch.float32):
        raise TypeError(f"kernel takes bf16 or float32, got {cdt}")
    _check("qd4", qd4, cdt, (b, tp, h, dk))
    _check("kd4", kd4, cdt, (b, tp, h, dk))
    _check("v4", v4, cdt, (b, tp, h, dv))
    _check("egl", egl, torch.float32, (b, tp, h) if egl.ndim == 3 else (b, n, h, dk))
    return b, n, c, h, dk, dv


# ---------------------------------------------------------------------------
# Plain PyTorch versions: the kernels' arithmetic, vectorized over chunks
# ---------------------------------------------------------------------------


def _kc(kd, egl, cdt):
    """kc = cdt(kd e^{G_last}) [B, N, H, C, Dk] float32 from kd [B, N, H, C,
    Dk] and egl [B, N, H, Dk]."""
    return (kd * egl.float()[..., None, :]).to(cdt).float()


def _scores(qd, kd):
    """mask(qd kd^T), j <= i, float32 [B, N, H, C, C]."""
    c = qd.shape[-2]
    mask = torch.ones(c, c, dtype=torch.bool, device=qd.device).tril()
    return torch.where(mask, qd @ kd.transpose(-1, -2), 0.0)


def _chain(x, egl, s_in, reverse: bool = False):
    """The elementwise chain over the chunks: z = s_in, then per chunk n (in
    reverse order when ``reverse``) out[n] = z; z = z e^{G_last}[n] + x[n].
    x [B, N, H, Dk, Dv] float32; returns (out, z)."""
    n_chunks = x.shape[1]
    z = s_in.float().clone()
    out = [None] * n_chunks
    for n in (reversed(range(n_chunks)) if reverse else range(n_chunks)):
        out[n] = z
        z = z * egl[:, n, :, :, None] + x[:, n]
    return torch.stack(out, dim=1), z


def gla_chunk_fwd_plain(qd4, kd4, v4, egl, s0, chunk_size: int = 64,
                        collect_states: bool = False):
    """K12's function. qd4, kd4 [B, T, H, Dk] and v4 [B, T, H, Dv] in the
    compute dtype, T whole chunks; egl = e^{G_last} [B, N, H, Dk] float32; s0
    [B, H, Dk, Dv] float32. Returns o [B, T, H, Dv] in the compute dtype, the
    final state float32 and, with ``collect_states``, the chunk-entry states
    [B, N, H, Dk, Dv] float32 (else None)."""
    cdt = v4.dtype
    c = chunk_size
    qd, kd, v = _chunks(qd4, c), _chunks(kd4, c), _chunks(v4, c)
    u = _kc(kd, egl, cdt).transpose(-1, -2) @ v  # [B, N, H, Dk, Dv]
    states, s = _chain(u, egl, s0)
    o = _scores(qd, kd).to(cdt).float() @ v + qd @ states.to(cdt).float()
    return _unchunk(o).to(cdt), s, (states if collect_states else None)


def gla_chunk_bwd_plain(qd4, kd4, v4, egl, states, do4, ds_final, chunk_size: int = 64):
    """K12b's function: the gradients of :func:`gla_chunk_fwd_plain` for the
    output cotangent do4 [B, T, H, Dv] and the final-state cotangent
    ds_final [B, H, Dk, Dv] float32, given its chunk-entry ``states``.
    Returns d(qd4), d(kd4), d(v4) [B, T, H, D], d(egl) [B, N, H, Dk] and
    ds0, all float32."""
    cdt = v4.dtype
    c = chunk_size
    qd, kd, v = _chunks(qd4, c), _chunks(kd4, c), _chunks(v4, c)
    do = _chunks(do4.to(cdt), c)
    t_ = lambda x: x.transpose(-1, -2)  # noqa: E731
    exits, ds0 = _chain(t_(qd) @ do, egl, ds_final, reverse=True)
    kc = _kc(kd, egl, cdt)
    dp = _scores(do, v).to(cdt).float()
    zc, dzc = states.to(cdt).float(), exits.to(cdt).float()
    dkc = v @ t_(dzc)
    dqd = dp @ kd + do @ t_(zc)
    dkd = t_(dp) @ qd + dkc * egl[..., None, :]
    dv = t_(_scores(qd, kd).to(cdt).float()) @ do + kc @ dzc
    degl = (states * exits).sum(-1) + (dkc * kd).sum(-2)
    return _unchunk(dqd), _unchunk(dkd), _unchunk(dv), degl, ds0


def _scalar_factors(g4, c: int, dk: int):
    """From G [B, T', H] (the within-chunk cumsum): e = scale e^{G} and a =
    e^{G_last - G} [B, N, H, C], e^{G_last} [B, N, H, 1] and f = mask(scale
    e^{G_i - G_j}) [B, N, H, C, C], the exponent taken only for j <= i (every
    exponent <= 0). scale = Dk**-0.5."""
    g = _chunks(g4, c)
    scale = dk**-0.5
    gl = g[..., -1:]
    idx = torch.arange(c, device=g.device)
    d = g[..., :, None] - g[..., None, :]
    f = torch.exp(torch.where(idx[:, None] >= idx[None, :], d, float("-inf"))) * scale
    return torch.exp(g) * scale, torch.exp(gl - g), torch.exp(gl), f


def gla_chunk_fwd_scalar_plain(q4, k4, v4, g4, s0, chunk_size: int = 64,
                               collect_states: bool = False):
    """K12's scalar-decay form (one log-decay per head): q4, k4 [B, T, H, Dk]
    undecayed and v4 [B, T, H, Dv] in the compute dtype, T whole chunks; g4
    = G [B, T, H] float32, the within-chunk cumsum of the log decay; s0 [B,
    H, Dk, Dv] float32. Returns what :func:`gla_chunk_fwd_plain` returns."""
    cdt = v4.dtype
    c = chunk_size
    q, k, v = _chunks(q4, c), _chunks(k4, c), _chunks(v4, c)
    e, a, egl, f = _scalar_factors(g4, c, q4.shape[-1])
    qd = (q * e[..., None]).to(cdt).float()
    kc = (k * a[..., None]).to(cdt).float()
    states, s = _chain(kc.transpose(-1, -2) @ v, egl, s0)
    scores = ((q @ k.transpose(-1, -2)) * f).to(cdt).float()
    o = scores @ v + qd @ states.to(cdt).float()
    return _unchunk(o).to(cdt), s, (states if collect_states else None)


def gla_chunk_bwd_scalar_plain(q4, k4, v4, g4, states, do4, ds_final, chunk_size: int = 64):
    """K12b's scalar-decay form: the gradients of
    :func:`gla_chunk_fwd_scalar_plain` for the cotangents do4 [B, T, H, Dv]
    and ds_final [B, H, Dk, Dv] float32, given its chunk-entry ``states``.
    Returns d(q4), d(k4), d(v4) [B, T, H, D], dG [B, T, H] (the gradient of
    G per token and head) and ds0, all float32. With dp = mask(dO v^T), s the
    rounded scores, P = dp * s, dr = cdt(dp * f), dqd = dO cdt(S)^T and dkc =
    v cdt(dS)^T:

      dq = dr k + dqd e,  dk = dr^T q + dkc a,  dv = s^T dO + kc cdt(dS)
      dG = e sum_d(dqd q) - a sum_d(dkc k) + rowsum(P) - colsum(P), and at
           the last token also sum_t a_t sum_d(dkc k)_t + e^{G_last} sum(S dS)
    """
    cdt = v4.dtype
    c = chunk_size
    q, k, v = _chunks(q4, c), _chunks(k4, c), _chunks(v4, c)
    do = _chunks(do4.to(cdt), c)
    e, a, egl, f = _scalar_factors(g4, c, q4.shape[-1])
    t_ = lambda x: x.transpose(-1, -2)  # noqa: E731
    qd = (q * e[..., None]).to(cdt).float()
    kc = (k * a[..., None]).to(cdt).float()
    exits, ds0 = _chain(t_(qd) @ do, egl, ds_final, reverse=True)
    scores = ((q @ t_(k)) * f).to(cdt).float()
    dp = _scores(do, v)
    dr = (dp * f).to(cdt).float()
    p = dp * scores
    dqd, dkc = do @ t_(states.to(cdt).float()), v @ t_(exits.to(cdt).float())
    dq = dqd * e[..., None] + dr @ k
    dk = t_(dr) @ q + dkc * a[..., None]
    dv = t_(scores) @ do + kc @ exits.to(cdt).float()
    kterm = (dkc * k).sum(-1) * a
    dg = (dqd * q).sum(-1) * e - kterm + p.sum(-1) - p.sum(-2)
    last = kterm.sum(-1) + egl[..., 0] * (states * exits).sum((-1, -2))
    dg = torch.cat([dg[..., :-1], dg[..., -1:] + last[..., None]], dim=-1)
    return _unchunk(dq), _unchunk(dk), _unchunk(dv), _unchunk(dg), ds0


# ---------------------------------------------------------------------------
# K12 / K12b wrappers
# ---------------------------------------------------------------------------


def gla_chunk_fwd(qd4, kd4, v4, egl, s0, chunk_size: int = 64, collect_states: bool = False):
    """K12 (see :func:`gla_chunk_fwd_plain`)."""
    if _on_cpu(qd4, kd4, v4, egl, s0):
        return gla_chunk_fwd_plain(qd4, kd4, v4, egl, s0, chunk_size, collect_states)
    b, n, c, h, dk, dv = _check_kernel_args(qd4, kd4, v4, egl, chunk_size)
    _check("s0", s0, torch.float32, (b, h, dk, dv))
    with torch.cuda.device(qd4.device):
        o = torch.empty_like(v4)
        s_final = torch.empty_like(s0)
        states = torch.empty(b, n, h, dk, dv, dtype=torch.float32, device=v4.device)
        qd4, kd4, v4 = (x.float() for x in (qd4, kd4, v4))  # a bf16 call's values, exact
        err = _lib().mhla_gla_fwd(
            qd4.data_ptr(), kd4.data_ptr(), v4.data_ptr(), egl.data_ptr(), s0.data_ptr(),
            o.data_ptr(), s_final.data_ptr(), states.data_ptr(),
            b, n, c, h, dk, dv, int(o.dtype == torch.bfloat16), _stream(qd4),
        )
        _raise_on_error("gla_chunk_fwd", err)
    launches["gla_chunk_fwd"] += 1
    return o, s_final, (states if collect_states else None)


def gla_chunk_bwd(qd4, kd4, v4, egl, states, do4, ds_final, chunk_size: int = 64):
    """K12b (see :func:`gla_chunk_bwd_plain`)."""
    if _on_cpu(qd4, kd4, v4, egl, states, do4, ds_final):
        return gla_chunk_bwd_plain(qd4, kd4, v4, egl, states, do4, ds_final, chunk_size)
    b, n, c, h, dk, dv = _check_kernel_args(qd4, kd4, v4, egl, chunk_size)
    _check("states", states, torch.float32, (b, n, h, dk, dv))
    _check("do4", do4, v4.dtype, (b, n * c, h, dv))
    _check("ds_final", ds_final, torch.float32, (b, h, dk, dv))
    f32 = dict(dtype=torch.float32, device=qd4.device)
    bf16 = int(v4.dtype == torch.bfloat16)
    with torch.cuda.device(qd4.device):
        exits = torch.empty_like(states)
        qd4, kd4, v4, do4 = (x.float() for x in (qd4, kd4, v4, do4))  # exact
        dqd = torch.empty(qd4.shape, **f32)
        dkd = torch.empty(qd4.shape, **f32)
        dv_ = torch.empty(v4.shape, **f32)
        degl = torch.empty_like(egl)
        ds0 = torch.empty_like(ds_final)
        err = _lib().mhla_gla_bwd(
            qd4.data_ptr(), kd4.data_ptr(), v4.data_ptr(), egl.data_ptr(), states.data_ptr(),
            do4.data_ptr(), ds_final.data_ptr(), exits.data_ptr(),
            dqd.data_ptr(), dkd.data_ptr(), dv_.data_ptr(), degl.data_ptr(), ds0.data_ptr(),
            b, n, c, h, dk, dv, bf16, _stream(qd4),
        )
        _raise_on_error("gla_chunk_bwd", err)
    launches["gla_chunk_bwd"] += 1
    return dqd, dkd, dv_, degl, ds0


def gla_chunk_fwd_scalar(q4, k4, v4, g4, s0, chunk_size: int = 64,
                         collect_states: bool = False):
    """K12's scalar-decay form (see :func:`gla_chunk_fwd_scalar_plain`)."""
    if _on_cpu(q4, k4, v4, g4, s0):
        return gla_chunk_fwd_scalar_plain(q4, k4, v4, g4, s0, chunk_size, collect_states)
    b, n, c, h, dk, dv = _check_kernel_args(q4, k4, v4, g4, chunk_size)
    _check("s0", s0, torch.float32, (b, h, dk, dv))
    with torch.cuda.device(q4.device):
        o = torch.empty_like(v4)
        s_final = torch.empty_like(s0)
        states = torch.empty(b, n, h, dk, dv, dtype=torch.float32, device=v4.device)
        q4, k4, v4 = (x.float() for x in (q4, k4, v4))  # a bf16 call's values, exact
        err = _lib().mhla_gla_fwd_scalar(
            q4.data_ptr(), k4.data_ptr(), v4.data_ptr(), g4.data_ptr(), s0.data_ptr(),
            o.data_ptr(), s_final.data_ptr(), states.data_ptr(),
            b, n, c, h, dk, dv, int(o.dtype == torch.bfloat16), _stream(q4),
        )
        _raise_on_error("gla_chunk_fwd_scalar", err)
    launches["gla_chunk_fwd_scalar"] += 1
    return o, s_final, (states if collect_states else None)


def gla_chunk_bwd_scalar(q4, k4, v4, g4, states, do4, ds_final, chunk_size: int = 64):
    """K12b's scalar-decay form (see :func:`gla_chunk_bwd_scalar_plain`)."""
    if _on_cpu(q4, k4, v4, g4, states, do4, ds_final):
        return gla_chunk_bwd_scalar_plain(q4, k4, v4, g4, states, do4, ds_final, chunk_size)
    b, n, c, h, dk, dv = _check_kernel_args(q4, k4, v4, g4, chunk_size)
    _check("states", states, torch.float32, (b, n, h, dk, dv))
    _check("do4", do4, v4.dtype, (b, n * c, h, dv))
    _check("ds_final", ds_final, torch.float32, (b, h, dk, dv))
    f32 = dict(dtype=torch.float32, device=q4.device)
    bf16 = int(v4.dtype == torch.bfloat16)
    with torch.cuda.device(q4.device):
        exits = torch.empty_like(states)
        q4, k4, v4, do4 = (x.float() for x in (q4, k4, v4, do4))  # exact
        dq = torch.empty(q4.shape, **f32)
        dk_ = torch.empty(q4.shape, **f32)
        dv_ = torch.empty(v4.shape, **f32)
        dg = torch.empty_like(g4)
        ds0 = torch.empty_like(ds_final)
        err = _lib().mhla_gla_bwd_scalar(
            q4.data_ptr(), k4.data_ptr(), v4.data_ptr(), g4.data_ptr(), states.data_ptr(),
            do4.data_ptr(), ds_final.data_ptr(), exits.data_ptr(),
            dq.data_ptr(), dk_.data_ptr(), dv_.data_ptr(), dg.data_ptr(), ds0.data_ptr(),
            b, n, c, h, dk, dv, bf16, _stream(q4),
        )
        _raise_on_error("gla_chunk_bwd_scalar", err)
    launches["gla_chunk_bwd_scalar"] += 1
    return dq, dk_, dv_, dg, ds0


def _prep(q, k, v, gk, chunk_size: int):
    """JAX's ``_prep`` (``gla_chunk_pallas.py:272-322``) without the
    supertiles: pad to whole chunks (pad tokens: zero q, k, v and g = 0),
    G = the within-chunk cumsum, and the kernels' inputs qd4, kd4, v4 in the
    compute dtype and egl = e^{G_last}. Returns those and G [B, T', H, Dk]."""
    b, _, h, dk = q.shape
    c = chunk_size
    cdt = torch.bfloat16 if q.dtype == torch.bfloat16 else torch.float32
    scale = dk**-0.5
    q4, k4 = _pad_to_chunks(q.float(), c), _pad_to_chunks(k.float(), c)
    v4 = _pad_to_chunks(v, c).to(cdt).contiguous()
    g4 = _pad_to_chunks(gk.float(), c)
    n = g4.shape[1] // c
    gcum = torch.cumsum(g4.reshape(b, n, c, h, dk), dim=2)
    egl = torch.exp(gcum[:, :, -1]).contiguous()  # [B, N, H, Dk]
    gcum = gcum.reshape(b, n * c, h, dk)
    qd4 = (q4 * torch.exp(gcum) * scale).to(cdt)
    kd4 = (k4 * torch.exp(-gcum)).to(cdt)
    return qd4, kd4, v4, egl, gcum


class _GLAChunkFn(torch.autograd.Function):
    """K12 forward, K12b backward (see :func:`gla_chunk_fused`): saves q, k,
    v, gk, s0 and the chunk-entry states, as JAX does (its supertile-entry
    states at G chunks a supertile; here every chunk's, float32: at [8,
    2048, 4, 128|256] 134 MB a layer), and recomputes the rest."""

    @staticmethod
    def forward(ctx, q, k, v, gk, s0, chunk_size, output_final_state):
        t = q.shape[1]
        qd4, kd4, v4, egl, _ = _prep(q, k, v, gk, chunk_size)
        collect = any(ctx.needs_input_grad)
        o, s, states = gla_chunk_fwd(qd4, kd4, v4, egl, s0.float().contiguous(), chunk_size,
                                     collect)
        if collect:
            ctx.save_for_backward(q, k, v, gk, s0, states)
        ctx.chunk_size, ctx.output_final_state = chunk_size, output_final_state
        return o[:, :t].to(q.dtype), s

    @staticmethod
    def backward(ctx, do, ds):
        q, k, v, gk, s0, states = ctx.saved_tensors
        c = ctx.chunk_size
        b, t, h, dk = q.shape
        dv_ = v.shape[-1]
        qd4, kd4, v4, egl, gcum = _prep(q, k, v, gk, c)
        do4 = (torch.zeros_like(v4) if do is None
               else _pad_to_chunks(do.to(v4.dtype), c).contiguous())
        if ds is None or not ctx.output_final_state:
            ds = torch.zeros(b, h, dk, dv_, dtype=torch.float32, device=q.device)
        dqd, dkd, dv4, degl, ds0 = gla_chunk_bwd(qd4, kd4, v4, egl, states, do4,
                                                 ds.float().contiguous(), c)
        # the elementwise decay chains (JAX differentiates them outside its kernel):
        #   qd = q e^{G} scale -> dq = dqd e^{G} scale ; dG += dqd * q e^{G} scale
        #   kd = k e^{-G}      -> dk = dkd e^{-G}      ; dG -= dkd * k e^{-G}
        #   egl = e^{G_last}   -> dG_last += degl * egl
        #   G = cumsum(g)      -> dg = reverse cumsum(dG)
        scale = dk**-0.5
        n = egl.shape[1]
        egc, emc = torch.exp(gcum), torch.exp(-gcum)
        q4, k4 = _pad_to_chunks(q.float(), c), _pad_to_chunks(k.float(), c)
        dq4 = dqd * egc * scale
        dk4 = dkd * emc
        dgcum = (dqd * (q4 * egc * scale) - dkd * (k4 * emc)).reshape(b, n, c, h, dk)
        dgcum[:, :, -1] += degl * egl
        dg4 = torch.flip(torch.cumsum(torch.flip(dgcum, [2]), dim=2), [2]).reshape(b, n * c, h, dk)
        return (dq4[:, :t].to(q.dtype), dk4[:, :t].to(k.dtype), dv4[:, :t].to(v.dtype),
                dg4[:, :t].to(gk.dtype), ds0.to(s0.dtype), None, None)


def _prep_scalar(q, k, v, gk, chunk_size: int):
    """The scalar form's inputs: q, k, v padded to whole chunks (pad tokens
    zero, g = 0) in the compute dtype and G [B, T', H] float32, the
    within-chunk cumsum of gk [B, T, H]."""
    b, _, h, _ = q.shape
    c = chunk_size
    cdt = torch.bfloat16 if q.dtype == torch.bfloat16 else torch.float32
    q4, k4, v4 = (_pad_to_chunks(x, c).to(cdt).contiguous() for x in (q, k, v))
    g4 = _pad_to_chunks(gk.float(), c)
    n = g4.shape[1] // c
    g4 = torch.cumsum(g4.reshape(b, n, c, h), dim=2).reshape(b, n * c, h).contiguous()
    return q4, k4, v4, g4


class _GLAChunkScalarFn(torch.autograd.Function):
    """K12's scalar form forward, K12b's backward (see
    :func:`gla_chunk_fused`): saves q, k, v, gk, s0 and the chunk-entry
    states; the backward's dG [B, T', H] goes back to gk by the reverse
    within-chunk cumsum."""

    @staticmethod
    def forward(ctx, q, k, v, gk, s0, chunk_size, output_final_state):
        t = q.shape[1]
        q4, k4, v4, g4 = _prep_scalar(q, k, v, gk, chunk_size)
        collect = any(ctx.needs_input_grad)
        o, s, states = gla_chunk_fwd_scalar(q4, k4, v4, g4, s0.float().contiguous(),
                                            chunk_size, collect)
        if collect:
            ctx.save_for_backward(q, k, v, gk, s0, states)
        ctx.chunk_size, ctx.output_final_state = chunk_size, output_final_state
        return o[:, :t].to(q.dtype), s

    @staticmethod
    def backward(ctx, do, ds):
        q, k, v, gk, s0, states = ctx.saved_tensors
        c = ctx.chunk_size
        b, t, h, dk = q.shape
        q4, k4, v4, g4 = _prep_scalar(q, k, v, gk, c)
        do4 = (torch.zeros_like(v4) if do is None
               else _pad_to_chunks(do.to(v4.dtype), c).contiguous())
        if ds is None or not ctx.output_final_state:
            ds = torch.zeros(b, h, dk, v.shape[-1], dtype=torch.float32, device=q.device)
        dq4, dk4, dv4, dg4, ds0 = gla_chunk_bwd_scalar(q4, k4, v4, g4, states, do4,
                                                       ds.float().contiguous(), c)
        n = g4.shape[1] // c
        dg4 = torch.flip(torch.cumsum(torch.flip(dg4.reshape(b, n, c, h), [2]), dim=2), [2])
        dg4 = dg4.reshape(b, n * c, h)
        return (dq4[:, :t].to(q.dtype), dk4[:, :t].to(k.dtype), dv4[:, :t].to(v.dtype),
                dg4[:, :t].to(gk.dtype), ds0.to(s0.dtype), None, None)


def gla_chunk_fused(
    q: torch.Tensor,  # [B, T, H, Dk]
    k: torch.Tensor,
    v: torch.Tensor,  # [B, T, H, Dv]
    gk: torch.Tensor,  # [B, T, H, Dk] or [B, T, H] log decay (<= 0)
    initial_state: Optional[torch.Tensor] = None,  # [B, H, Dk, Dv]
    chunk_size: int = 64,
    output_final_state: bool = False,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """:func:`ops.gla_chunk.gla_chunk` through K12 / K12b.

    Dispatch, JAX's (``gla_chunk_pallas.py:490-522``): a call with
    T >= chunk_size whose chunk size, Dk and Dv pass the Pallas block rule
    (:func:`kernel_route`) takes the fused path, whose wrappers run their
    plain versions on the CPU and launch the kernels on a CUDA tensor or
    raise (they hold chunk % 16 == 0 up to 64, Dk == 128, Dv % 64 == 0);
    every other call goes to the op ``gla_chunk``, as JAX sends it there. The
    compute dtype is bf16 when q is bf16, else float32. A per-head gk [B, T,
    H] takes the kernels' scalar-decay form (difference form, finite at any
    decay); a per-key-channel one the factored form. o comes back in q's
    dtype, the final state float32, or None without ``output_final_state``
    (whose cotangent is then zero)."""
    b, t, h, dk = q.shape
    dv = v.shape[-1]
    if not kernel_route(t, chunk_size, dk, dv):
        return gla_chunk(q, k, v, gk, initial_state=initial_state, chunk_size=chunk_size,
                         output_final_state=output_final_state)
    s0 = (initial_state if initial_state is not None
          else torch.zeros(b, h, dk, dv, dtype=torch.float32, device=q.device))
    fn = _GLAChunkScalarFn if gk.ndim == 3 else _GLAChunkFn
    o, s = fn.apply(q, k, v, gk, s0, chunk_size, output_final_state)
    return o, (s if output_final_state else None)
