"""Flash attention, forward and backward (port of ``ops/flash_attention.py``).

``flash_attention_lse(q, k, v, *, causal, scale) -> (out, lse)``
    Attention over ``[B, H, T, D]`` tensors returning ``out`` (the input
    type) and ``lse`` ``[B, H, Tq, 1]`` f32, the log of each row's softmax
    denominator.  Differentiable in q, k and v, through uses of ``lse``
    too.  ``Tq`` and ``Tk`` may differ; the causal mask compares absolute
    positions (key > query is masked), as the JAX kernel does.
``flash_attention(q, k, v, *, causal, scale, layout)``
    The same without ``lse``; ``layout="bthd"`` takes and returns
    ``[B, T, H, D]``.

The three kernels live in ``csrc/flash_attention.cu``: ``flash_fwd``
(online softmax over K/V tiles), ``flash_dq`` (dQ over K/V tiles) and
``flash_dkv`` (dK and dV over Q tiles), each on q^ = q / sqrt(D) rounded
back to the input type, as the TPU kernels take it.  All three run
warpgroup MMA (wgmma) on tiles that TMA brings into a ring of
shared-memory stages under mbarriers; ``flash_dq`` reads each K tile
twice from the ring, K-major for ``q^ . k^T`` and MN-major for ``ds .
k``, with ``ds`` rounded in registers.  Each has its plain
PyTorch version here (``flash_fwd_plain`` and so on): whole-matrix f32
softmax with the TPU kernel's rounding points (the ``-1e30`` mask, the
``den >= 1e-30`` guard, p rounded to v's type before ``p . v``, ds rounded
to k's or q's type before its product, dq scaled once at the end).
:mod:`.kernel_compat`'s rule picks between them by the tensor's device;
on a CUDA tensor the kernels take bf16 or fp16 with head_dim a multiple
of 16 up to 128, and anything else raises ``ValueError``.

``_FlashLse`` wires them as a ``torch.autograd.Function`` (the JAX
package's ``custom_vjp``): the forward saves ``(q^, k, v, out, lse)``;
the backward computes ``delta = rowsum(do * out) - dlse`` in torch (the
lse cotangent folds into delta: d lse / d s is the softmax row) and runs
the two backward kernels.

The CUDA tiles are fixed at compile time (:data:`TILES`).  ``block_q``
and ``block_kv`` are accepted for the JAX signature and not read; a
ragged last tile is masked in the kernel, so T need not divide by
anything.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import kernel_compat as kc

NEG_INF = -1e30  # large-negative instead of -inf: keeps exp/max NaN-free
#: the CUDA tiles, (query rows, keys) for the forward and dQ kernels and
#: (keys, query rows) for dK/dV: a CTA owns the first and loops over the
#: second
TILES = {"flash_fwd": (128, 128), "flash_dq": (128, 128),
         "flash_dkv": (128, 64)}
MAX_HEAD_DIM = 128
#: the kernels' element types, by the code the C entries take
_DTYPES = {torch.bfloat16: 0, torch.float16: 1}


def _prescale(q: torch.Tensor, scale: float) -> torch.Tensor:
    """q^ = q * scale, computed in f32 and rounded back to q's type."""
    return (q.float() * scale).to(q.dtype)


def _scores(qh: torch.Tensor, k: torch.Tensor, causal: bool) -> torch.Tensor:
    """``s = q^ . k^T`` in f32, masked to NEG_INF where key > query."""
    s = torch.matmul(qh.float(), k.float().transpose(-1, -2))
    if causal:
        tq, tk = s.shape[-2:]
        qp = torch.arange(tq, device=s.device)[:, None]
        kp = torch.arange(tk, device=s.device)[None, :]
        s = torch.where(kp <= qp, s, NEG_INF)
    return s


# -- plain versions ------------------------------------------------------------

def flash_fwd_plain(qh: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(out, lse)`` from pre-scaled ``qh``: whole-matrix softmax."""
    s = _scores(qh, k, causal)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    den = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    pv = torch.matmul(p.to(v.dtype).float(), v.float())
    return (pv / den).to(qh.dtype), m + torch.log(den)


def flash_dq_plain(qh: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   do: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
                   causal: bool, scale: float) -> torch.Tensor:
    """``dq = scale * (ds . k)``, ``ds = p * (do . v^T - delta)``."""
    p = torch.exp(_scores(qh, k, causal) - lse)
    dp = torch.matmul(do.float(), v.float().transpose(-1, -2))
    ds = p * (dp - delta)
    dq = torch.matmul(ds.to(k.dtype).float(), k.float())
    return (dq * scale).to(qh.dtype)


def flash_dkv_plain(qh: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    do: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
                    causal: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(dk, dv)``: ``dv = p^T . do``, ``dk = ds^T . q^`` (no scale)."""
    p = torch.exp(_scores(qh, k, causal) - lse)
    dv = torch.matmul(p.to(do.dtype).float().transpose(-1, -2), do.float())
    dp = torch.matmul(do.float(), v.float().transpose(-1, -2))
    ds = p * (dp - delta)
    dk = torch.matmul(ds.to(qh.dtype).float().transpose(-1, -2), qh.float())
    return dk.to(k.dtype), dv.to(v.dtype)


# -- kernels -------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "mr_flash_tiles": (_I, [ctypes.POINTER(_I)]),
    "mr_flash_fwd": (_I, [_P] * 5 + [_I] * 6 + [_P]),
    "mr_flash_dq": (_I, [_P] * 7 + [_I] * 5 + [ctypes.c_float, _I, _P]),
    "mr_flash_dkv": (_I, [_P] * 8 + [_I] * 7 + [_P]),
}


def _lib():
    lib = kc.library("flash_attention", _SIGNATURES)
    buf = (_I * 6)()
    built = tuple(buf[:lib.mr_flash_tiles(buf)])
    want = sum(TILES.values(), ())
    if built != want:
        raise RuntimeError(f"csrc/flash_attention.cu tiles {built}, the "
                           f"wrappers assume {want}")
    return lib


def _check(kernel: str, qh: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           do: Optional[torch.Tensor] = None,
           lse: Optional[torch.Tensor] = None,
           delta: Optional[torch.Tensor] = None) -> Tuple[int, int, int, int]:
    """The kernels' limits, checked before any pointer crosses to C;
    raises ``ValueError`` naming the limit.  Returns ``(B*H, Tq, Tk, D)``."""
    if qh.dim() != 4 or k.dim() != 4 or k.shape != v.shape \
            or qh.shape[:2] != k.shape[:2] or qh.shape[3] != k.shape[3]:
        raise ValueError(f"{kernel}: q [B, H, Tq, D] and k, v [B, H, Tk, D] "
                         f"expected, got {tuple(qh.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, h, tq, d = qh.shape
    tk = k.shape[2]
    if qh.dtype not in _DTYPES:
        raise ValueError(f"{kernel}: the CUDA kernel takes bfloat16 or "
                         f"float16, got {qh.dtype}")
    if d % 16 or not 16 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"{kernel}: head_dim must be a multiple of 16 in "
                         f"[16, {MAX_HEAD_DIM}], got {d}")
    if not 1 <= b * h <= 65535 or tq < 1 or tk < 1:
        raise ValueError(f"{kernel}: needs 1 <= B*H <= 65535 and T >= 1, "
                         f"got B*H={b * h}, Tq={tq}, Tk={tk}")
    dev = qh.device
    if dev.type != "cuda":
        raise ValueError(f"{kernel}: the kernel needs CUDA tensors, got "
                         f"{dev}")
    ops = [("q", qh, qh.shape), ("k", k, k.shape), ("v", v, k.shape)]
    if do is not None:
        ops.append(("do", do, qh.shape))
    for name, t, shape in ops:
        kc.require(t, kernel, name, qh.dtype, dev, shape)
        if t.data_ptr() % 16:
            raise ValueError(f"{kernel}: {name} must start on a 16-byte "
                             f"boundary")
    for name, t in (("lse", lse), ("delta", delta)):
        if t is not None:
            kc.require(t, kernel, name, torch.float32, dev, (b, h, tq, 1))
            if t.data_ptr() % 16:
                raise ValueError(f"{kernel}: {name} must start on a "
                                 f"16-byte boundary")
    return b * h, tq, tk, d


def _flash_fwd_cuda(qh, k, v, causal):
    bh, tq, tk, d = _check("flash_fwd", qh, k, v)
    out = torch.empty_like(qh)
    lse = torch.empty(qh.shape[:3] + (1,), dtype=torch.float32,
                      device=qh.device)
    err = _lib().mr_flash_fwd(kc.ptr(qh), kc.ptr(k), kc.ptr(v), kc.ptr(out),
                              kc.ptr(lse), bh, tq, tk, d, int(causal),
                              _DTYPES[qh.dtype], kc.stream(qh.device))
    kc.check("flash_fwd", err)
    kc.LAUNCHES["flash_fwd"] += 1
    return out, lse


def _flash_dq_cuda(qh, k, v, do, lse, delta, causal, scale):
    bh, tq, tk, d = _check("flash_dq", qh, k, v, do, lse, delta)
    dq = torch.empty_like(qh)
    err = _lib().mr_flash_dq(kc.ptr(qh), kc.ptr(k), kc.ptr(v), kc.ptr(do),
                             kc.ptr(lse), kc.ptr(delta), kc.ptr(dq), bh, tq,
                             tk, d, int(causal), float(scale),
                             _DTYPES[qh.dtype], kc.stream(qh.device))
    kc.check("flash_dq", err)
    kc.LAUNCHES["flash_dq"] += 1
    return dq


def _flash_dkv_cuda(qh, k, v, do, lse, delta, causal):
    bh, tq, tk, d = _check("flash_dkv", qh, k, v, do, lse, delta)
    # the kernel's TMA reads lse and delta rows that start on 16 bytes:
    # rows of a length not a multiple of 4 are padded
    ld = -(-tq // 4) * 4
    if ld != tq:
        lse, delta = (torch.nn.functional.pad(t.view(bh, tq), (0, ld - tq))
                      for t in (lse, delta))
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    err = _lib().mr_flash_dkv(kc.ptr(qh), kc.ptr(k), kc.ptr(v), kc.ptr(do),
                              kc.ptr(lse), kc.ptr(delta), kc.ptr(dk),
                              kc.ptr(dv), bh, tq, tk, d, int(causal), ld,
                              _DTYPES[qh.dtype], kc.stream(qh.device))
    kc.check("flash_dkv", err)
    kc.LAUNCHES["flash_dkv"] += 1
    return dk, dv


# -- the wrappers: the kernel on CUDA, the plain version on the CPU -----------

def flash_fwd(qh: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(out, lse)`` from pre-scaled ``qh`` ``[B, H, Tq, D]``."""
    if kc.use_kernel(qh, "flash_fwd"):
        return _flash_fwd_cuda(qh, k, v, causal)
    return flash_fwd_plain(qh, k, v, causal)


def flash_dq(qh: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             do: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
             causal: bool, scale: float) -> torch.Tensor:
    """dq from pre-scaled ``qh``; ``delta`` already holds ``- dlse``."""
    if kc.use_kernel(qh, "flash_dq"):
        return _flash_dq_cuda(qh, k, v, do, lse, delta, causal, scale)
    return flash_dq_plain(qh, k, v, do, lse, delta, causal, scale)


def flash_dkv(qh: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              do: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
              causal: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(dk, dv)`` from pre-scaled ``qh``."""
    if kc.use_kernel(qh, "flash_dkv"):
        return _flash_dkv_cuda(qh, k, v, do, lse, delta, causal)
    return flash_dkv_plain(qh, k, v, do, lse, delta, causal)


class _FlashLse(torch.autograd.Function):
    """``(out, lse)`` with the flash backward; both outputs differentiable."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        qh = _prescale(q, scale).contiguous()
        k, v = k.contiguous(), v.contiguous()
        out, lse = flash_fwd(qh, k, v, causal)
        ctx.save_for_backward(qh, k, v, out, lse)
        ctx.causal, ctx.scale = causal, scale
        ctx.set_materialize_grads(False)
        return out, lse

    @staticmethod
    def backward(ctx, dout, dlse):
        qh, k, v, out, lse = ctx.saved_tensors
        do = (torch.zeros_like(out) if dout is None
              else dout.to(out.dtype).contiguous())
        # delta[b,h,t] = sum_d dO * O, a small elementwise pass in torch;
        # the lse cotangent adds p * dlse to ds, i.e. delta - dlse
        delta = (do.float() * out.float()).sum(dim=-1, keepdim=True)
        if dlse is not None:
            delta = delta - dlse.float()
        delta = delta.contiguous()
        dq = flash_dq(qh, k, v, do, lse, delta, ctx.causal, ctx.scale)
        dk, dv = flash_dkv(qh, k, v, do, lse, delta, ctx.causal)
        return dq, dk, dv, None, None


def flash_attention_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True,
                        scale: Optional[float] = None,
                        block_q: int = 1024, block_kv: int = 1024):
    """Kernel-layout (``[B, H, T, D]``) attention returning ``(out, lse
    [B, H, Tq, 1] f32)``, differentiable through both.  ``scale=None`` is
    ``D ** -0.5``; ``block_q``/``block_kv`` are not read (the CUDA tiles
    are fixed, :data:`TILES`)."""
    if q.dim() != 4:
        raise ValueError(f"q must be [B, H, T, D], got {tuple(q.shape)}")
    if scale is None:
        scale = q.shape[3] ** -0.5
    return _FlashLse.apply(q, k, v, bool(causal), float(scale))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, scale: Optional[float] = None,
                    block_q: int = 1024, block_kv: int = 1024,
                    layout: str = "bhtd") -> torch.Tensor:
    """Tiled attention, differentiable.  ``layout="bhtd"`` (kernel-native)
    or ``"bthd"`` (transposed in and out)."""
    if layout == "bthd":
        q, k, v = (t.transpose(1, 2) for t in (q, k, v))
    elif layout != "bhtd":
        raise ValueError(f"unknown layout {layout!r}")
    out, _ = flash_attention_lse(q, k, v, causal=causal, scale=scale)
    return out.transpose(1, 2) if layout == "bthd" else out
