"""Chunked MHLA on head-flat [B, T, H*D] tensors through six hand-written
CUDA kernels (counterpart of ``mhla_tpu/kernels/mhla_chunk_pallas.py``):

  forward (``csrc/mhla_chunk.cu``; K3 ``csrc/mhla_mix_wide.cu``)
  K2  ``chunk_states``      S_j = k_j^T v_j
  K3  ``mix_states``        mixed_i = sum_{j<i} Ms[i, j] S_j
  K4  ``chunk_output``      o_i = q_i @ mixed_i + md_i * (tril(q_i k_i^T) @ v_i)
  backward (``csrc/mhla_chunk_bwd.cu``; K3b ``csrc/mhla_mix_wide.cu``)
  K4b ``chunk_output_bwd``  dq, the intra-chunk dk/dv, dmixed and d md
  K3b ``mix_states_bwd``    dS = Ms^T dmixed and dMs[i, j] = <dmixed_i, S_j>
  K2b ``chunk_states_bwd``  dk = v dS^T + dk_intra, dv = k dS + dv_intra

All six are Hopper kernels built from ``csrc/hopper.cuh`` (TMA, mbarriers,
wgmma), like the flash kernels. K3 and K3b's dS take any N up to
832 chunks (512 slots at 32,768 positions) in one family of kernels chosen
by N: up to 64 chunks (the 340M's 32) M's one tile is built in registers
from the float32 M inside the kernel, beyond that from a bf16 copy of M.
K3b's dMs comes from fixed slices of the state columns
(:func:`_gram_slices`) summed in a second pass, the same bit for bit from
run to run. K4b writes one float32 partial of d md per (chunk, head), which
its wrapper sums over heads (and the batch) in a fixed order: no atomics, so
all six kernels give the same bits from run to run.

The q scale ``Dk**-0.5`` is folded into the mixing matrix once, as the JAX
entry point does (``mhla_chunk_pallas.py:1005-1013``): Ms is the scaled
strict lower triangle rounded to the compute dtype, md the scaled diagonal
in float32. Both are shared by the batch ([N, N] and [N]) or, for packed
varlen rows, one per batch row ([B, N, N] and [B, N], built by
``ops.mhla_chunk.build_segment_mixing``): the kernels then read them with a
batch stride, K4b gives d md per row and K3b dMs per row, as the JAX
kernels do with a batch index on the M block specs
(``mhla_chunk_pallas.py:726``, ``_dm_pallas(batched=True)`` :422). The TPU kernels group 4 chunks into supertiles; here every
kernel works per chunk, so K3 mixes all earlier chunks and K4 adds only the
chunk's own term. ``_ChunkOp`` is the ``torch.autograd.Function`` around
K2 -> K3 -> K4 with K4b -> K3b -> K2b as its backward (the JAX ``_st_path``
custom VJP, ``mhla_chunk_pallas.py:875-950``); the scale fold, the slicing
of M and its rounding stay ordinary autograd around it.
:func:`mhla_chunk_fused_flat` takes that route where JAX's rule sends a
call to its Pallas kernels (:func:`kernel_route`), and the plain versions
under autograd at every other shape, as JAX runs XLA einsums there.

Each wrapper runs its plain PyTorch version (``*_plain``, same function,
same rounding points) for a CPU tensor, and launches its kernel for a CUDA
tensor or raises. ``launches`` counts kernel launches per wrapper.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ..ops.mhla_chunk import _pad_to_chunks, build_segment_mixing, prepare_mixing_matrix
from . import _build

launches = {
    "chunk_states": 0, "mix_states": 0, "chunk_output": 0,
    "chunk_output_bwd": 0, "mix_states_bwd": 0, "chunk_states_bwd": 0,
}

_TILE_N = 128  # Dv columns per item of K2 and per panel of K4
_MAX_SLOTS_WIDE = 832  # slots the strip form stages in shared memory (csrc: kMaxSlotsWide)
_SMALL_SLOTS = 64  # up to here K3 / K3b's dS build M's tile in the kernel (csrc: kSmallSlots)
_WIDE_COLS = 128  # state columns per strip of the larger forms (csrc: kCols)
_GRAM_COLS = 64  # state columns per stage of the wide dMs
_GRAM_ROWS = 128  # rows (and columns) of a dMs tile of the wide dMs
_GRAM_BLOCKS = 264  # wide dMs: two blocks on each of the H100's 132 SMs
_BWD_MAX_HEAD_DIM = 256  # K4b and K2b pad Dk to a tile of 64, 128 or 256 (csrc: *BwdGeom)
_MAX_CHUNK = 64  # K4 and K4b take a chunk as one 64-row wgmma tile

_lib_cache: Optional[ctypes.CDLL] = None


def _lib() -> ctypes.CDLL:
    global _lib_cache
    if _lib_cache is None:
        lib = _build.load()
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.mhla_chunk_states.argtypes = [p, p, p, i, i, i, i, i, p]
        ll = ctypes.c_longlong
        lib.mhla_chunk_output.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, i, p]
        lib.mhla_chunk_output_bwd.argtypes = [p] * 11 + [i] * 7 + [p]
        lib.mhla_chunk_states_bwd.argtypes = [p] * 7 + [i] * 5 + [p]
        lib.mhla_mix_states_fwd.argtypes = [p, p, p, p, i, i, ll, ll, p]
        lib.mhla_mix_states_bwd.argtypes = [p] * 7 + [i, i, ll, ll, i, ll, p]
        for fn in (lib.mhla_chunk_states, lib.mhla_chunk_output, lib.mhla_chunk_output_bwd,
                   lib.mhla_chunk_states_bwd, lib.mhla_mix_states_fwd,
                   lib.mhla_mix_states_bwd):
            fn.restype = ctypes.c_int
        _lib_cache = lib
    return _lib_cache


def _on_cpu(*tensors: torch.Tensor) -> bool:
    """True for CPU tensors (plain path); None of them may be elsewhere
    than on one CUDA device otherwise."""
    dev = tensors[0].device
    if any(t.device != dev for t in tensors[1:]):
        raise ValueError(f"tensors on several devices: {sorted({str(t.device) for t in tensors})}")
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise NotImplementedError(f"no kernel for device {dev}")
    return False


def _check(name: str, x: torch.Tensor, dtype: torch.dtype, ndim: int):
    if x.dtype != dtype:
        raise TypeError(f"{name}: kernel takes {dtype}, got {x.dtype}")
    if x.ndim != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got shape {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: kernel takes contiguous tensors")


def _raise_on_error(fn: str, err: int):
    if err != 0:
        raise RuntimeError(f"{fn}: CUDA launch failed with cudaError_t {err}")


def _check_heads(num_heads: int, hdk: int, hdv: int) -> Tuple[int, int]:
    if hdk % num_heads or hdv % num_heads:
        raise ValueError(f"head-flat widths {hdk}, {hdv} not divisible by {num_heads} heads")
    dk, dv = hdk // num_heads, hdv // num_heads
    if dk % 16 or dv % _TILE_N:
        raise ValueError(
            f"kernel needs Dk % 16 == 0 and Dv % {_TILE_N} == 0, got Dk={dk}, Dv={dv}"
        )
    return dk, dv


def _stream(x: torch.Tensor) -> int:
    """The raw handle of the current stream of x's CUDA device: torch's
    cheap form of ``torch.cuda.current_stream(x.device).cuda_stream`` (a
    small kernel's host cost a call is part of its time where calls follow
    each other)."""
    return torch._C._cuda_getCurrentRawStream(x.device.index)


def _launch(name: str, entry, x: torch.Tensor, *args) -> None:
    """Call the C entry ``entry`` of wrapper ``name`` with ``args`` and the
    current stream of x's device, that device current around the call (as
    ``torch.cuda.device(x.device)`` makes it, in fewer steps); raise on a
    launch error and count the launch."""
    prev = torch.cuda._exchange_device(x.device.index)
    try:
        err = entry(*args, _stream(x))
    finally:
        torch.cuda._maybe_exchange_device(prev)
    _raise_on_error(name, err)
    launches[name] += 1


# ---------------------------------------------------------------------------
# K2: per-chunk states
# ---------------------------------------------------------------------------


def chunk_states_plain(k4: torch.Tensor, v4: torch.Tensor, num_heads: int) -> torch.Tensor:
    """[B,N,C,H*Dk] x [B,N,C,H*Dv] -> states [B,N,H*Dk,Dv] in k's dtype,
    accumulated in float32."""
    b, n, c, hdk = k4.shape
    h = num_heads
    dk, dv = hdk // h, v4.shape[-1] // h
    s = torch.einsum(
        "bnchk,bnchv->bnhkv",
        k4.reshape(b, n, c, h, dk).float(),
        v4.reshape(b, n, c, h, dv).float(),
    )
    return s.to(k4.dtype).reshape(b, n, h * dk, dv).contiguous()


def chunk_states(k4: torch.Tensor, v4: torch.Tensor, num_heads: int) -> torch.Tensor:
    """K2 (see :func:`chunk_states_plain`)."""
    if _on_cpu(k4, v4):
        return chunk_states_plain(k4, v4, num_heads)
    _check("k4", k4, torch.bfloat16, 4)
    _check("v4", v4, torch.bfloat16, 4)
    b, n, c, hdk = k4.shape
    if v4.shape[:3] != k4.shape[:3]:
        raise ValueError(f"k4 {tuple(k4.shape)} and v4 {tuple(v4.shape)} disagree")
    if c % 16:
        raise ValueError(f"kernel needs chunk_size % 16 == 0, got {c}")
    dk, dv = _check_heads(num_heads, hdk, v4.shape[-1])
    if k4.data_ptr() % 16 or v4.data_ptr() % 16:
        raise ValueError("kernel loads tiles by TMA: its inputs must be 16-byte aligned")
    out = torch.empty(b, n, hdk, dv, dtype=k4.dtype, device=k4.device)
    _launch("chunk_states", _lib().mhla_chunk_states, k4,
            k4.data_ptr(), v4.data_ptr(), out.data_ptr(),
            b * n, c, num_heads, dk, dv)
    return out


# ---------------------------------------------------------------------------
# K3: strictly-lower state mixing
# ---------------------------------------------------------------------------


def _batch_stride(m: torch.Tensor, per_row_ndim: int, name: str, b: int, n: int) -> int:
    """Elements between two batch rows' matrices in ``m``: 0 for a shared
    one ([N, N] or [N]), its size for one per row ([B, N, N] or [B, N])."""
    shared = (n,) * (per_row_ndim - 1)
    if tuple(m.shape) == shared:
        return 0
    if tuple(m.shape) == (b, *shared):
        return n ** (per_row_ndim - 1)
    raise ValueError(f"{name} {tuple(m.shape)} is neither {shared} nor {(b, *shared)}")


def mix_states_plain(m_strict: torch.Tensor, states4: torch.Tensor) -> torch.Tensor:
    """mixed[b, i] = sum_j m_strict[(b,) i, j] states[b, j], float32
    accumulation, result in the states' dtype. m_strict: [N, N] or, one per
    batch row, [B, N, N] float32; its values are taken rounded to the
    states' dtype, as JAX's kernel takes M in the compute dtype (the op
    rounds its M before, so nothing is lost there)."""
    eq = "ij,bjrd->bird" if m_strict.ndim == 2 else "bij,bjrd->bird"
    out = torch.einsum(eq, m_strict.to(states4.dtype).float(), states4.float())
    return out.to(states4.dtype).contiguous()


def _mix_args(m_strict: torch.Tensor, states4: torch.Tensor, *others: torch.Tensor):
    """Checks shared by K3 and K3b, which load the states (and ``others``)
    by TMA; (M's batch stride, R, the bf16 scratch for M's padded copy, or
    None up to _SMALL_SLOTS chunks, where the kernels make none)."""
    _check("m_strict", m_strict, torch.float32, m_strict.ndim)
    for name, x in (("states4", states4), *(("dmixed4", y) for y in others)):
        _check(name, x, torch.bfloat16, 4)
        if x.shape != states4.shape:
            raise ValueError("dmixed4 and states4 disagree in shape")
    b, n, hdk, dv = states4.shape
    m_bstride = _batch_stride(m_strict, 3, "m_strict", b, n)
    if n > _MAX_SLOTS_WIDE:
        raise ValueError(f"kernel mixes at most {_MAX_SLOTS_WIDE} chunks, got {n}")
    r = hdk * dv
    if r % _WIDE_COLS:
        raise ValueError(f"kernel needs a state size divisible by {_WIDE_COLS}, got {r}")
    if any(x.data_ptr() % 16 for x in (states4, *others)):
        raise ValueError("kernel loads tiles by TMA: its inputs must be 16-byte aligned")
    scratch = None
    if n > _SMALL_SLOTS:
        np_ = -(-n // 64) * 64
        scratch = torch.empty(b if m_bstride else 1, np_, np_, dtype=torch.bfloat16,
                              device=states4.device)
    return m_bstride, r, scratch


def _ptr(x: Optional[torch.Tensor]) -> Optional[int]:
    return None if x is None else x.data_ptr()


def mix_states(m_strict: torch.Tensor, states4: torch.Tensor) -> torch.Tensor:
    """K3 (see :func:`mix_states_plain`) at any N up to 832. The kernels
    read only the strict lower triangle of ``m_strict``, take its values at
    bf16 and run bf16 products on the tensor cores."""
    if _on_cpu(m_strict, states4):
        return mix_states_plain(m_strict, states4)
    m_bstride, r, scratch = _mix_args(m_strict, states4)
    b, n = states4.shape[:2]
    out = torch.empty_like(states4)
    _launch("mix_states", _lib().mhla_mix_states_fwd, states4,
            m_strict.data_ptr(), states4.data_ptr(), out.data_ptr(), _ptr(scratch),
            b, n, r, m_bstride)
    return out


# ---------------------------------------------------------------------------
# K4: chunk output
# ---------------------------------------------------------------------------


def chunk_output_plain(
    q4: torch.Tensor,
    k4: torch.Tensor,
    v4: torch.Tensor,
    mixed4: torch.Tensor,
    m_diag: torch.Tensor,
    num_heads: int,
) -> torch.Tensor:
    """o_j = q_j @ mixed_j + m_diag[(b,) j] * (bf16(tril(q_j k_j^T)) @ v_j)
    per chunk, float32 accumulation; [B,N,C,H*Dv] in q's dtype (the JAX
    ``_core_xla``, ``mhla_chunk_pallas.py:819``). m_diag: [N] or [B, N]."""
    b, n, c, hdk = q4.shape
    h = num_heads
    dk, dv = hdk // h, v4.shape[-1] // h
    q5 = q4.reshape(b, n, c, h, dk).float()
    k5 = k4.reshape(b, n, c, h, dk).float()
    v5 = v4.reshape(b, n, c, h, dv).float()
    o_inter = torch.einsum(
        "bnchk,bnhkv->bnchv", q5, mixed4.reshape(b, n, h, dk, dv).float()
    )
    attn = torch.einsum("bnchk,bnmhk->bnhcm", q5, k5)
    tril = torch.tril(torch.ones(c, c, device=q4.device))
    attn = (attn * tril).to(q4.dtype).float()
    o_intra = torch.einsum("bnhcm,bnmhv->bnchv", attn, v5)
    o = o_inter + o_intra * m_diag.float()[..., :, None, None, None]
    return o.to(q4.dtype).reshape(b, n, c, h * dv).contiguous()


def chunk_output(
    q4: torch.Tensor,
    k4: torch.Tensor,
    v4: torch.Tensor,
    mixed4: torch.Tensor,
    m_diag: torch.Tensor,
    num_heads: int,
) -> torch.Tensor:
    """K4 (see :func:`chunk_output_plain`) at any C % 16 up to 64, Dk % 16
    and Dv % 128."""
    if _on_cpu(q4, k4, v4, mixed4, m_diag):
        return chunk_output_plain(q4, k4, v4, mixed4, m_diag, num_heads)
    for name, x in (("q4", q4), ("k4", k4), ("v4", v4), ("mixed4", mixed4)):
        _check(name, x, torch.bfloat16, 4)
    _check("m_diag", m_diag, torch.float32, m_diag.ndim)
    b, n, c, hdk = q4.shape
    dk, dv = _check_heads(num_heads, hdk, v4.shape[-1])
    if k4.shape != q4.shape or v4.shape[:3] != q4.shape[:3]:
        raise ValueError("q4, k4 and v4 disagree in shape")
    if tuple(mixed4.shape) != (b, n, hdk, dv):
        raise ValueError("mixed4 does not match q4")
    md_bstride = _batch_stride(m_diag, 2, "m_diag", b, n)
    if c % 16 or c > _MAX_CHUNK:
        raise ValueError(f"kernel needs chunk_size % 16 == 0 and <= {_MAX_CHUNK}, got {c}")
    if any(x.data_ptr() % 16 for x in (q4, k4, v4, mixed4)):
        raise ValueError("kernel loads tiles by TMA: its inputs must be 16-byte aligned")
    out = torch.empty(b, n, c, num_heads * dv, dtype=q4.dtype, device=q4.device)
    _launch("chunk_output", _lib().mhla_chunk_output, q4,
            q4.data_ptr(), k4.data_ptr(), v4.data_ptr(), mixed4.data_ptr(),
            m_diag.data_ptr(), out.data_ptr(),
            b * n, n, c, num_heads, dk, dv, md_bstride)
    return out


# ---------------------------------------------------------------------------
# K4b: chunk output backward
# ---------------------------------------------------------------------------


def chunk_output_bwd_plain(
    q4: torch.Tensor,
    k4: torch.Tensor,
    v4: torch.Tensor,
    mixed4: torch.Tensor,
    m_diag: torch.Tensor,
    do4: torch.Tensor,
    num_heads: int,
) -> Tuple[torch.Tensor, ...]:
    """Gradient of :func:`chunk_output_plain` for the output gradient do4
    (q's dtype). With A = q k^T, P = bf16(tril A), dP = tril(dO v^T) and
    dA = bf16(md * dP) per chunk and head, float32 accumulation:

      dq = dA k + dO mixed^T,  dk_intra = dA^T q,  dv_intra = md * P^T dO,
      dmixed = q^T dO,  d md[(b,) n] = sum over (b,) h of sum(dP * A).

    Returns (dq4, dk_intra4, dv_intra4, dmixed4) in q's dtype and d md in
    m_diag's shape ([N] shared, [B, N] per row), float32. dA is rounded where the JAX backward rounds it
    (``mhla_chunk_pallas.py:680``)."""
    b, n, c, hdk = q4.shape
    h = num_heads
    dk, dv = hdk // h, v4.shape[-1] // h
    cdt = q4.dtype
    q5 = q4.reshape(b, n, c, h, dk).float()
    k5 = k4.reshape(b, n, c, h, dk).float()
    v5 = v4.reshape(b, n, c, h, dv).float()
    do5 = do4.reshape(b, n, c, h, dv).float()
    tril = torch.tril(torch.ones(c, c, device=q4.device))
    md = m_diag.float()[..., :, None, None, None]
    a = torch.einsum("bnchk,bnmhk->bnhcm", q5, k5) * tril
    p = a.to(cdt).float()
    dp = torch.einsum("bnchv,bnmhv->bnhcm", do5, v5) * tril
    da = (dp * md).to(cdt).float()
    dq = torch.einsum("bnhcm,bnmhk->bnchk", da, k5) + torch.einsum(
        "bnchv,bnhkv->bnchk", do5, mixed4.reshape(b, n, h, dk, dv).float()
    )
    dk_i = torch.einsum("bnhcm,bnchk->bnmhk", da, q5)
    dv_i = torch.einsum("bnhcm,bnchv->bnmhv", p, do5) * md
    dmixed = torch.einsum("bnchk,bnchv->bnhkv", q5, do5)
    dmd = (dp * a).sum(dim=(0, 2, 3, 4) if m_diag.ndim == 1 else (2, 3, 4))
    out = lambda x, d: x.to(cdt).reshape(b, n, c, h * d).contiguous()  # noqa: E731
    return (
        out(dq, dk), out(dk_i, dk), out(dv_i, dv),
        dmixed.to(cdt).reshape(b, n, h * dk, dv).contiguous(), dmd,
    )


def chunk_output_bwd(
    q4: torch.Tensor,
    k4: torch.Tensor,
    v4: torch.Tensor,
    mixed4: torch.Tensor,
    m_diag: torch.Tensor,
    do4: torch.Tensor,
    num_heads: int,
) -> Tuple[torch.Tensor, ...]:
    """K4b (see :func:`chunk_output_bwd_plain`) at any C % 16 up to 64, Dk %
    16 up to 256 (as K2b, which follows it in the backward) and Dv % 128. The
    kernel writes one float32 partial of d md per (chunk, head); their sum
    over heads (and, for a shared m_diag, over the batch) is one
    ``torch.sum`` over fixed dims, so all five outputs are the same bits from
    run to run."""
    if _on_cpu(q4, k4, v4, mixed4, m_diag, do4):
        return chunk_output_bwd_plain(q4, k4, v4, mixed4, m_diag, do4, num_heads)
    for name, x in (("q4", q4), ("k4", k4), ("v4", v4), ("mixed4", mixed4), ("do4", do4)):
        _check(name, x, torch.bfloat16, 4)
    _check("m_diag", m_diag, torch.float32, m_diag.ndim)
    b, n, c, hdk = q4.shape
    dk, dv = _check_heads(num_heads, hdk, v4.shape[-1])
    if k4.shape != q4.shape or v4.shape[:3] != q4.shape[:3] or do4.shape != v4.shape:
        raise ValueError("q4, k4, v4 and do4 disagree in shape")
    if tuple(mixed4.shape) != (b, n, hdk, dv):
        raise ValueError("mixed4 does not match q4")
    md_bstride = _batch_stride(m_diag, 2, "m_diag", b, n)
    if c % 16 or c > _MAX_CHUNK:
        raise ValueError(f"kernel needs chunk_size % 16 == 0 and <= {_MAX_CHUNK}, got {c}")
    if dk > _BWD_MAX_HEAD_DIM:
        raise ValueError(f"kernel needs a key head dim of at most {_BWD_MAX_HEAD_DIM}, got {dk}")
    if any(x.data_ptr() % 16 for x in (q4, k4, v4, mixed4, do4)):
        raise ValueError("kernel loads tiles by TMA: its inputs must be 16-byte aligned")
    dq4, dk_i = torch.empty_like(q4), torch.empty_like(q4)
    dv_i = torch.empty_like(v4)
    dmixed4 = torch.empty_like(mixed4)
    part = torch.empty(b, n, num_heads, dtype=torch.float32, device=q4.device)
    _launch("chunk_output_bwd", _lib().mhla_chunk_output_bwd, q4,
            q4.data_ptr(), k4.data_ptr(), v4.data_ptr(), mixed4.data_ptr(),
            m_diag.data_ptr(), do4.data_ptr(), dq4.data_ptr(), dk_i.data_ptr(),
            dv_i.data_ptr(), dmixed4.data_ptr(), part.data_ptr(),
            b * n, n, c, num_heads, dk, dv, md_bstride)
    dmd = part.sum(dim=(0, 2) if m_diag.ndim == 1 else 2)
    return dq4, dk_i, dv_i, dmixed4, dmd


# ---------------------------------------------------------------------------
# K3b: state mixing backward
# ---------------------------------------------------------------------------


def mix_states_bwd_plain(
    m_strict: torch.Tensor, dmixed4: torch.Tensor, states4: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gradient of :func:`mix_states_plain` for dmixed4: dstates[b, j] =
    sum_{i>j} Ms[(b,) i, j] dmixed[b, i] in the states' dtype, and dMs[i, j]
    = sum over b of <dmixed[b, i], states[b, j]> for i > j (zero elsewhere,
    the strict-part mask of ``mhla_chunk_pallas.py:932-936``), float32; for
    a per-row Ms [B, N, N], dMs[b, i, j] of each row, not summed. Ms's
    values are taken rounded to the states' dtype, as in the forward."""
    ms = torch.tril(m_strict.to(states4.dtype).float(), diagonal=-1)
    per_row = m_strict.ndim == 3
    dstates = torch.einsum("bij,bird->bjrd" if per_row else "ij,bird->bjrd", ms, dmixed4.float())
    dms = torch.einsum("bird,bjrd->bij" if per_row else "bird,bjrd->ij",
                       dmixed4.float(), states4.float())
    return dstates.to(states4.dtype).contiguous(), torch.tril(dms, diagonal=-1)


def _gram_slices(n: int, r: int, rows: int) -> Tuple[int, int]:
    """(splits, slice): the fixed slices [s * slice, min((s + 1) * slice, R))
    of the R state columns, s = 0 .. splits - 1, over which K3b sums
    dMs: each a multiple of 64 columns but the last, none empty, together
    exactly R, as many as give about _GRAM_BLOCKS blocks with the 128 x 128
    tiles on and below dMs's diagonal and the ``rows`` batch rows."""
    tiles = -(-n // _GRAM_ROWS)
    pairs = tiles * (tiles + 1) // 2
    want = max(1, min(-(-r // _GRAM_COLS), -(-_GRAM_BLOCKS // (pairs * rows))))
    slice_ = -(-r // (want * _GRAM_COLS)) * _GRAM_COLS
    return -(-r // slice_), slice_


def mix_states_bwd(
    m_strict: torch.Tensor, dmixed4: torch.Tensor, states4: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3b (see :func:`mix_states_bwd_plain`) at any N up to 832, taking M's
    values at bf16 as K3 does: dS through K3's kernels on M transposed, dMs
    from fixed slices of the state columns summed in a fixed order, so both
    are the same bit for bit from run to run."""
    if _on_cpu(m_strict, dmixed4, states4):
        return mix_states_bwd_plain(m_strict, dmixed4, states4)
    m_bstride, r, scratch = _mix_args(m_strict, states4, dmixed4)
    b, n = states4.shape[:2]
    splits, slice_ = _gram_slices(n, r, b)
    ng = -(-n // _GRAM_ROWS) * _GRAM_ROWS
    part = torch.empty(b, splits, ng, ng, dtype=torch.float32, device=states4.device)
    dstates4 = torch.empty_like(states4)
    dms = torch.empty(m_strict.shape, dtype=torch.float32, device=states4.device)
    _launch("mix_states_bwd", _lib().mhla_mix_states_bwd, states4,
            m_strict.data_ptr(), dmixed4.data_ptr(), states4.data_ptr(),
            dstates4.data_ptr(), dms.data_ptr(), _ptr(scratch), part.data_ptr(),
            b, n, r, m_bstride, splits, slice_)
    return dstates4, dms


# ---------------------------------------------------------------------------
# K2b: chunk states backward
# ---------------------------------------------------------------------------


def chunk_states_bwd_plain(
    k4: torch.Tensor,
    v4: torch.Tensor,
    dstates4: torch.Tensor,
    dk_intra4: torch.Tensor,
    dv_intra4: torch.Tensor,
    num_heads: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """dk = v dS^T + dk_intra and dv = k dS + dv_intra per chunk and head,
    float32 accumulation, rounded once to k's dtype."""
    b, n, c, hdk = k4.shape
    h = num_heads
    dk, dv = hdk // h, v4.shape[-1] // h
    ds5 = dstates4.reshape(b, n, h, dk, dv).float()
    gk = torch.einsum("bnchv,bnhkv->bnchk", v4.reshape(b, n, c, h, dv).float(), ds5)
    gv = torch.einsum("bnchk,bnhkv->bnchv", k4.reshape(b, n, c, h, dk).float(), ds5)
    gk = gk.reshape(b, n, c, hdk) + dk_intra4.float()
    gv = gv.reshape(b, n, c, h * dv) + dv_intra4.float()
    return gk.to(k4.dtype).contiguous(), gv.to(k4.dtype).contiguous()


def chunk_states_bwd(
    k4: torch.Tensor,
    v4: torch.Tensor,
    dstates4: torch.Tensor,
    dk_intra4: torch.Tensor,
    dv_intra4: torch.Tensor,
    num_heads: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2b (see :func:`chunk_states_bwd_plain`) at any Dk % 16 up to 256."""
    if _on_cpu(k4, v4, dstates4, dk_intra4, dv_intra4):
        return chunk_states_bwd_plain(k4, v4, dstates4, dk_intra4, dv_intra4, num_heads)
    for name, x in (("k4", k4), ("v4", v4), ("dstates4", dstates4),
                    ("dk_intra4", dk_intra4), ("dv_intra4", dv_intra4)):
        _check(name, x, torch.bfloat16, 4)
    b, n, c, hdk = k4.shape
    dk, dv = _check_heads(num_heads, hdk, v4.shape[-1])
    if v4.shape[:3] != k4.shape[:3] or dk_intra4.shape != k4.shape or dv_intra4.shape != v4.shape:
        raise ValueError("k4, v4 and the intra gradients disagree in shape")
    if tuple(dstates4.shape) != (b, n, hdk, dv):
        raise ValueError("dstates4 does not match k4")
    if c % 16:
        raise ValueError(f"kernel needs chunk_size % 16 == 0, got {c}")
    if dk > _BWD_MAX_HEAD_DIM:
        raise ValueError(f"kernel needs a key head dim of at most {_BWD_MAX_HEAD_DIM}, got {dk}")
    if any(x.data_ptr() % 16 for x in (k4, v4, dstates4, dk_intra4, dv_intra4)):
        raise ValueError("kernel loads tiles by TMA: its inputs must be 16-byte aligned")
    gk, gv = torch.empty_like(k4), torch.empty_like(v4)
    _launch("chunk_states_bwd", _lib().mhla_chunk_states_bwd, k4,
            k4.data_ptr(), v4.data_ptr(), dstates4.data_ptr(), dk_intra4.data_ptr(),
            dv_intra4.data_ptr(), gk.data_ptr(), gv.data_ptr(),
            b * n, c, num_heads, dk, dv)
    return gk, gv


# ---------------------------------------------------------------------------
# the op as one differentiable unit
# ---------------------------------------------------------------------------


class _ChunkOp(torch.autograd.Function):
    """(q4, k4, v4, m_strict, m_diag) -> (o4, states4) through K2 -> K3 ->
    K4; the backward runs K4b -> K3b -> K2b. states4 is not
    differentiable (the decode cache). m_strict and m_diag are shared
    ([N, N], [N]) or per batch row ([B, N, N], [B, N]), and so are their
    gradients. The gradient for m_strict holds the
    strict lower triangle only, in float32; the cast of m_strict to the
    compute dtype around this Function rounds it there, as JAX returns the
    strict-part dM in the compute dtype (``mhla_chunk_pallas.py:945``)."""

    @staticmethod
    def forward(ctx, q4, k4, v4, m_strict, m_diag, num_heads):
        states4 = chunk_states(k4, v4, num_heads)
        mixed4 = mix_states(m_strict, states4)
        o4 = chunk_output(q4, k4, v4, mixed4, m_diag, num_heads)
        ctx.save_for_backward(q4, k4, v4, m_strict, m_diag, states4, mixed4)
        ctx.num_heads = num_heads
        ctx.mark_non_differentiable(states4)
        return o4, states4

    @staticmethod
    def backward(ctx, do4, _dstates4):
        q4, k4, v4, m_strict, m_diag, states4, mixed4 = ctx.saved_tensors
        h = ctx.num_heads
        do4 = do4.to(q4.dtype).contiguous()
        dq4, dk_i, dv_i, dmixed4, dmd = chunk_output_bwd(q4, k4, v4, mixed4, m_diag, do4, h)
        dstates4, dms = mix_states_bwd(m_strict, dmixed4, states4)
        dk4, dv4 = chunk_states_bwd(k4, v4, dstates4, dk_i, dv_i, h)
        return dq4, dk4, dv4, dms, dmd, None


# ---------------------------------------------------------------------------
# public op
# ---------------------------------------------------------------------------


def kernel_route(chunk_size: int, dk: int, dv: int) -> bool:
    """JAX's rule (``_pallas_compatible``, ``mhla_chunk_pallas.py:838-841``:
    chunk % 8, Dk % 128 and Dv % 128) sends a call to the kernels; every
    other shape runs JAX's XLA route (:1022-1047). Shapes the rule sends to
    the kernels but that they lack (chunk % 8 but not % 16, or above 64)
    raise on the card. JAX's ``gsz * c >= 128`` term (:1016) is left out: it
    sizes the TPU's supertile, not the function."""
    return chunk_size % 8 == 0 and dk % 128 == 0 and dv % 128 == 0


def mhla_chunk_fused_flat(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mixing_matrix: torch.Tensor,
    num_heads: int,
    chunk_size: int = 64,
    output_final_state: bool = False,
    segment_ids: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Chunked MHLA on head-flat q, k [B, T, H*Dk], v [B, T, H*Dv] through
    K2 -> K3 -> K4 where :func:`kernel_route` holds, else through their plain
    versions, as JAX routes the call. Semantics equal
    :func:`mhla_tpu_torch.ops.mhla_chunk`.

    Returns (o [B, T, H*Dv] in q's dtype, states [B, H, N, Dk, Dv] float32
    or None). The states are K2's output, rounded to the compute dtype as
    the JAX entry returns them (``mhla_chunk_pallas.py:1079-1089``).
    o is differentiable in q, k, v and ``mixing_matrix`` (through K4b, K3b
    and K2b on the kernels' route); the states are not.

    ``segment_ids`` [B, T] (packed documents, boundaries on chunk
    boundaries) gives every batch row its own [N, N] matrix from
    :func:`~mhla_tpu_torch.ops.mhla_chunk.build_segment_mixing`; the same
    kernels read it with a batch stride, and its gradient reaches
    ``mixing_matrix`` through that function's gather.
    """
    in_dtype = q.dtype
    b, t, hdk = q.shape
    h = num_heads
    dk, dv = hdk // h, v.shape[-1] // h
    cdt = torch.bfloat16 if in_dtype == torch.bfloat16 else torch.float32

    q, k, v = (_pad_to_chunks(x, chunk_size) for x in (q, k, v))
    n = q.shape[1] // chunk_size
    c = chunk_size

    # fold the q scale into the mixing matrix, exactly once
    if segment_ids is None:
        m = prepare_mixing_matrix(mixing_matrix, n)  # [N, N]
    else:
        m = build_segment_mixing(mixing_matrix, segment_ids, n, c)  # [B, N, N]
    m = torch.tril(m * dk**-0.5)
    m_strict = torch.tril(m, diagonal=-1).to(cdt).float().contiguous()
    m_diag = torch.diagonal(m, dim1=-2, dim2=-1).contiguous()

    q4 = q.reshape(b, n, c, h * dk).to(cdt).contiguous()
    k4 = k.reshape(b, n, c, h * dk).to(cdt).contiguous()
    v4 = v.reshape(b, n, c, h * dv).to(cdt).contiguous()

    if kernel_route(c, dk, dv):
        o4, states4 = _ChunkOp.apply(q4, k4, v4, m_strict, m_diag, h)
    else:  # JAX's XLA route: the plain versions under ordinary autograd
        states4 = chunk_states_plain(k4, v4, h)
        o4 = chunk_output_plain(q4, k4, v4, mix_states_plain(m_strict, states4), m_diag, h)
        states4 = states4.detach()
    o = o4.reshape(b, n * c, h * dv)[:, :t].to(in_dtype)
    states_out = None
    if output_final_state:
        states_out = states4.reshape(b, n, h, dk, dv).permute(0, 2, 1, 3, 4).float()
    return o, states_out
