"""Ring attention over a sequence split into partitions on one device
(port of ``parallel/ring.py``).

The JAX package shards the sequence over the mesh's ``data`` axis: each
device holds a ``[B, T/P, H, D]`` block of q, k and v, keeps its q and
rotates k/v around the ring with ``lax.ppermute`` for P steps, folding
each step's partial attention into an online-softmax accumulator.  Here
the P sequence partitions are a leading axis of tensors on one device
(as :class:`~.mesh.Partitions` holds the engine's ``data`` axis), so the
rotation is an index shift and every partition's step runs in one call.
Inputs and outputs are the GLOBAL ``[B, T, H, D]`` tensors; partition
``r`` is rows ``r*T/P .. (r+1)*T/P`` of the sequence, as the JAX mesh
concatenates its blocks in axis order.

Two formulations, as in the JAX module:

* ``use_flash`` not False (the default): each step's local attention is
  :func:`..ops.flash_attention.flash_attention_lse` (the CUDA kernels on
  the card, their plain versions on the CPU, by the tensor's device) and
  the steps combine in log-sum-exp form (``logaddexp``; ``out * w_old +
  o_s * w_new`` in f32; ``lse`` starting at ``NEG_INF``), in ascending
  step order.  The JAX ``use_flash=None`` picks this path only on a TPU
  and the jnp path elsewhere; the port picks it everywhere, since the
  kernels (or their plain versions) exist on every device it runs on.
  Step ``s`` pairs the queries of partition ``r`` with the keys of
  partition ``r - s``.  Causal: step 0 is the diagonal (causal within
  the block), a key block before the query block is unmasked, and one
  after it is skipped (the JAX ring combines a zero block there, which
  leaves the accumulator unchanged).  So with q, k and v laid out
  ``[P, B, H, T/P, D]``, step ``s`` is ONE call over the contiguous
  slices ``q[s:P]`` and ``k[0:P-s]`` (partitions folded into the batch),
  causal only at ``s = 0``: P launches of each flash kernel a call, not
  P(P+1)/2.  Non-causal: every step pairs all P partitions, the keys
  rolled by ``s``.
* ``use_flash=False``: the JAX jnp path, as plain torch: masked scores by
  global position, the online softmax in f32 (:func:`_block_attn`,
  :func:`_combine`), ``block_size`` chunking of each step's local
  attention over queries and keys with each tile recomputed in the
  backward pass (``torch.utils.checkpoint``); the P partitions run side
  by side on the leading axis.  ``block_size`` reaches only this path:
  the kernels tile themselves.

Both differentiate by autograd (the flash path through
``flash_attention_lse``'s backward, which folds the lse cotangent into
``delta``).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from ..ops.flash_attention import NEG_INF, flash_attention_lse


def _parts(t: torch.Tensor, n_parts: int) -> torch.Tensor:
    """``[B, T, H, D]`` -> ``[P, B, T/P, H, D]`` (a view)."""
    B, T, H, D = t.shape
    return t.reshape(B, n_parts, T // n_parts, H, D).transpose(0, 1)


def _unparts(t: torch.Tensor) -> torch.Tensor:
    """``[P, B, T/P, H, D]`` -> ``[B, T, H, D]``."""
    P, B, Tl, H, D = t.shape
    return t.transpose(0, 1).reshape(B, P * Tl, H, D)


def _block_attn(q, k, v, mask, scale):
    """One (Q-block, KV-block) partial attention in online-softmax form,
    for every partition at once: ``q`` ``[P, B, Tq, H, D]``, ``k``/``v``
    ``[P, B, Tk, H, D]``, ``mask`` broadcasting to ``[P, B, H, Tq, Tk]``.
    Returns ``(block max [P, B, H, Tq], exp-weight sum [P, B, H, Tq],
    weighted V [P, B, Tq, H, D])``, un-normalised, f32.  The products
    take f32 copies of the operands (the JAX ``preferred_element_type=
    f32``: a product of two bf16 values is exact in f32)."""
    scores = torch.einsum("pbqhd,pbkhd->pbhqk", q.float(), k.float()) * scale
    scores = torch.where(mask, scores, float("-inf"))
    m = scores.amax(dim=-1)
    # a fully masked row (all -inf) would give exp(-inf - -inf) = NaN
    safe_m = torch.where(torch.isfinite(m), m, 0.0)
    p = torch.exp(scores - safe_m[..., None])
    p = torch.where(mask, p, 0.0)
    den = p.sum(dim=-1)
    num = torch.einsum("pbhqk,pbkhd->pbqhd", p.to(v.dtype).float(),
                       v.float())
    return safe_m, den, num


def _combine(m, den, num, bm, bden, bnum):
    """Fold one partial-attention block into the accumulator (associative:
    ring steps and local chunks share it)."""
    new_m = torch.maximum(m, bm)
    corr_old = torch.exp(m - new_m)
    corr_new = torch.exp(bm - new_m)
    den = den * corr_old + bden * corr_new
    # the [P, B, H, T] corrections over the [P, B, T, H, D] accumulator
    num = (num * corr_old.transpose(2, 3)[..., None]
           + bnum * corr_new.transpose(2, 3)[..., None])
    return new_m, den, num


def _ring_flash(q, k, v, n_parts, causal, scale):
    """The flash formulation (module docstring): one ``flash_attention_lse``
    call a step."""
    B, T, H, D = q.shape
    Tl = T // n_parts

    def kernel_layout(t):  # [B, T, H, D] -> [P, B, H, T/P, D], contiguous
        return _parts(t, n_parts).transpose(2, 3).contiguous()

    qp, kp, vp = kernel_layout(q), kernel_layout(k), kernel_layout(v)
    out = torch.zeros(qp.shape, dtype=torch.float32, device=q.device)
    lse = torch.full(qp.shape[:-1] + (1,), NEG_INF, dtype=torch.float32,
                     device=q.device)
    for s in range(n_parts):
        if causal:
            qs, ks, vs = qp[s:], kp[:n_parts - s], vp[:n_parts - s]
        else:
            qs, ks, vs = (qp, torch.roll(kp, s, dims=0),
                          torch.roll(vp, s, dims=0))
        n = qs.shape[0]
        o_s, l_s = flash_attention_lse(
            *(t.reshape(n * B, H, Tl, D) for t in (qs, ks, vs)),
            causal=causal and s == 0, scale=scale)
        o_s = o_s.view(n, B, H, Tl, D).float()
        l_s = l_s.view(n, B, H, Tl, 1)
        lo, ll = out[n_parts - n:], lse[n_parts - n:]
        new_l = torch.logaddexp(ll, l_s)
        new_o = lo * torch.exp(ll - new_l) + o_s * torch.exp(l_s - new_l)
        if n == n_parts:
            out, lse = new_o, new_l
        else:
            out = torch.cat([out[:n_parts - n], new_o])
            lse = torch.cat([lse[:n_parts - n], new_l])
    return _unparts(out.transpose(2, 3)).to(q.dtype)


def _ring_plain(q, k, v, n_parts, causal, scale, block_size):
    """The jnp formulation (module docstring) in torch."""
    B, T, H, D = q.shape
    Tl = T // n_parts
    block = block_size or Tl
    if Tl % block != 0:
        raise ValueError(f"block_size {block} must divide T_local {Tl}")
    C = Tl // block
    dev = q.device
    qp, kp, vp = (_parts(t, n_parts) for t in (q, k, v))
    rank = torch.arange(n_parts, device=dev)
    local = torch.arange(Tl, device=dev)
    q_pos = rank[:, None] * Tl + local            # [P, Tl] global positions

    def tile_step(m, den, num, q_c, qp_c, kb, vb, kp_c):
        """Fold one KV tile into one Q chunk's accumulator."""
        if causal:
            mask = kp_c[:, None, :] <= qp_c[:, :, None]   # [P, Tq, Tk]
        else:
            mask = torch.ones((n_parts, qp_c.shape[1], kp_c.shape[1]),
                              dtype=torch.bool, device=dev)
        bm, bden, bnum = _block_attn(q_c, kb, vb, mask[:, None, None], scale)
        return _combine(m, den, num, bm, bden, bnum)

    m = torch.full((n_parts, B, H, Tl), float("-inf"), device=dev)
    den = torch.zeros((n_parts, B, H, Tl), device=dev)
    num = torch.zeros(qp.shape, dtype=torch.float32, device=dev)
    for s in range(n_parts):
        # the block partition r holds at step s came from partition r - s
        src = (rank - s) % n_parts
        k_blk, v_blk = kp[src], vp[src]
        kv_pos = src[:, None] * Tl + local
        if C == 1:
            m, den, num = tile_step(m, den, num, qp, q_pos, k_blk, v_blk,
                                    kv_pos)
            continue
        # flash tiling: Q chunks outside, KV tiles inside, each tile
        # recomputed in the backward pass
        ms, dens, nums = [], [], []
        for c in range(C):
            qs = slice(c * block, (c + 1) * block)
            mc, dc, nc = m[..., qs], den[..., qs], num[:, :, qs]
            for j in range(C):
                ks = slice(j * block, (j + 1) * block)
                mc, dc, nc = checkpoint(
                    tile_step, mc, dc, nc, qp[:, :, qs], q_pos[:, qs],
                    k_blk[:, :, ks], v_blk[:, :, ks], kv_pos[:, ks],
                    use_reentrant=False)
            ms.append(mc)
            dens.append(dc)
            nums.append(nc)
        m, den, num = (torch.cat(ms, dim=-1), torch.cat(dens, dim=-1),
                       torch.cat(nums, dim=2))
    den = den.transpose(2, 3)[..., None]         # [P, B, Tl, H, 1]
    return _unparts(num / torch.clamp(den, min=1e-20)).to(q.dtype)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   n_parts: int, causal: bool = True,
                   scale: Optional[float] = None,
                   block_size: Optional[int] = None,
                   use_flash: Optional[bool] = None) -> torch.Tensor:
    """Exact multi-head attention over a sequence split into *n_parts*
    partitions, computed as the JAX ring computes it.

    ``q``/``k``/``v``: ``[B, T, H, D]`` global tensors, T a multiple of
    *n_parts*; returns ``[B, T, H, D]`` in q's type.  ``use_flash`` not
    False: each step on the flash kernels (module docstring); False: the
    plain online-softmax path, whose local attention ``block_size``
    chunks (it must divide ``T / n_parts``; None = one chunk)."""
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v must be [B, T, H, D] of one shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if n_parts < 1 or q.shape[1] % n_parts:
        raise ValueError(f"sequence length {q.shape[1]} does not split "
                         f"into {n_parts} partitions")
    if scale is None:
        scale = q.shape[3] ** -0.5
    if use_flash is not False:
        return _ring_flash(q, k, v, n_parts, causal, float(scale))
    return _ring_plain(q, k, v, n_parts, causal, float(scale), block_size)


def full_attention_reference(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, causal: bool = True,
                             scale: Optional[float] = None) -> torch.Tensor:
    """Unsharded oracle: plain softmax attention over the global sequence
    (``[B, T, H, D]``)."""
    T, D = q.shape[1], q.shape[3]
    scale = scale if scale is not None else D ** -0.5
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if causal:
        mask = torch.tril(torch.ones((T, T), dtype=torch.bool,
                                     device=q.device))
        scores = torch.where(mask, scores, float("-inf"))
    w = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", w, v)
