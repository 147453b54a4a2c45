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

Over a process group (``group=``, gloo, world size ``W`` dividing
``n_parts``) the sequence axis spans processes, as the JAX ring's
``data`` axis spans a ``jax.distributed`` mesh: rank ``r`` holds the
``P_L = n_parts / W`` partitions from ``r * P_L`` (its ``[B, T/W, H, D]``
slice of q, k and v; the output is its slice too).  The same loop runs:
step ``s`` reads each key block from the rank's own partitions where it
lies there, and otherwise from the block that crossed the rank boundary
at hop ``s`` or earlier, as ``lax.ppermute`` rotates the blocks.  Only
the boundary block moves (:class:`_Hop`, staged through pinned host
memory, since gloo moves CPU tensors), its cotangent sent back the same
way in the backward pass.  Only the flash formulation runs over a group.
Causal, a block before partition 0 never moves (the sender and the
receiver both skip it), and a rank whose query partitions all lie before
step ``s``'s keys launches nothing at that step.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from ..ops.flash_attention import NEG_INF, flash_attention_lse
from .mesh import group_shape


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


class _Ring:
    """This rank's neighbours on the group's ring and the transfers
    between them (gloo point-to-point, through pinned host memory on the
    card)."""

    def __init__(self, group, world: int, rank: int) -> None:
        import torch.distributed as dist

        self.group = group
        self.next = dist.get_global_rank(group, (rank + 1) % world)
        self.prev = dist.get_global_rank(group, (rank - 1) % world)

    def shift(self, send: Optional[torch.Tensor], like: torch.Tensor,
              receive: bool, forward: bool) -> Optional[torch.Tensor]:
        """Send *send* (None: nothing) one rank on (*forward*: to the
        next rank, else back to the previous) and, with *receive*, return
        the block shaped like *like* that arrives from the other side."""
        import torch.distributed as dist

        from .shuffle import _host_stage

        dst, src = (self.next, self.prev) if forward else (self.prev,
                                                            self.next)
        reqs, got = [], None
        if receive:
            got = torch.empty(like.numel() * like.element_size(),
                              dtype=torch.uint8,
                              pin_memory=like.device.type == "cuda")
            reqs.append(dist.irecv(got, src=src, group=self.group))
        if send is not None:
            # raw bytes: gloo moves any dtype's bytes alike
            out = _host_stage(send.contiguous().view(-1).view(torch.uint8))
            reqs.append(dist.isend(out, dst=dst, group=self.group))
        for req in reqs:
            req.wait()
        if got is None:
            return None
        return got.to(like.device, non_blocking=True).view(
            like.dtype).view(like.shape)


class _Hop(torch.autograd.Function):
    """One ring step's boundary transfer: *block* (a ``[2, ...]`` K/V
    block, or None) goes to the next rank and the previous rank's block
    comes back (zeros when nothing is received, a block no step reads);
    backward sends the received block's cotangent back to the previous
    rank and takes the sent block's from the next.  *token* (the previous
    hop's output) chains a rank's hops, so every rank runs their
    backwards in the same order."""

    @staticmethod
    def forward(ctx, block, token, ring, like, send, receive):
        ctx.ring, ctx.send, ctx.receive = ring, send, receive
        got = ring.shift(block, like, receive, True)
        return torch.zeros_like(like) if got is None else got

    @staticmethod
    def backward(ctx, g):
        back = ctx.ring.shift(g if ctx.receive else None, g, ctx.send,
                              False)
        return back, None, None, None, None, None


class _Sink(torch.autograd.Function):
    """``out`` unchanged, with the last hop's output as a second input
    whose cotangent is zero: it puts every hop of the chain on the
    backward pass's path, so each rank runs all of them (a rank whose
    last received blocks no step reads would otherwise skip those hops'
    backward while its neighbour sends into them)."""

    @staticmethod
    def forward(ctx, out, token):
        ctx.token = (token.shape, token.dtype, token.device)
        return out.view_as(out)

    @staticmethod
    def backward(ctx, g):
        shape, dtype, device = ctx.token
        return g, torch.zeros(shape, dtype=dtype, device=device)


def _window(t, got, j, s, i0):
    """Step *s*'s keys (*j* 0) or values (1) for query partitions *i0*
    on: local partition ``i - s`` of *t* where ``i >= s``, else the
    received ``got[s - i]``.  A view when they all lie in one of the
    two."""
    PL = t.shape[0]
    pieces = [got[s - i][j][None] for i in range(i0, min(s, PL))]
    if s < PL:
        pieces.append(t[max(i0, s) - s:PL - s])
    return pieces[0] if len(pieces) == 1 else torch.cat(pieces)


def _ring_flash(q, k, v, n_parts, causal, scale, group=None):
    """The flash formulation (module docstring): one ``flash_attention_lse``
    call a step.  *q*, *k*, *v* are ``[B, T/W, H, D]`` (W = 1 without a
    *group*); returns ``(out [B, T/W, H, D], lse [P_L, B, H, T/P, 1])``."""
    world, rank = group_shape(group, n_parts, "ring_attention")
    B, Tr, H, D = q.shape
    PL = n_parts // world
    Tl = Tr // PL
    first = rank * PL  # this rank's first partition

    def kernel_layout(t):  # [B, T/W, H, D] -> [P_L, B, H, T/P, D]
        return _parts(t, PL).transpose(2, 3).contiguous()

    qp, kp, vp = kernel_layout(q), kernel_layout(k), kernel_layout(v)
    ring = like = None
    if world > 1:
        ring = _Ring(group, world, rank)
        like = kp.new_empty((2,) + kp.shape[1:])  # one K/V block's shape
    # got[s]: (K, V) of partition first - s (mod P), the block that
    # crosses into this rank at hop s; in one process, its own
    got, token = [None], kp
    out = torch.zeros(qp.shape, dtype=torch.float32, device=q.device)
    lse = torch.full(qp.shape[:-1] + (1,), NEG_INF, dtype=torch.float32,
                     device=q.device)
    for s in range(n_parts):
        if s and ring is None:
            got.append((kp[-s], vp[-s]))
        elif s:
            # hop s sends partition first + PL - s: its own below PL,
            # else the block it received at hop s - PL
            send = not causal or (rank < world - 1 and first + PL - s >= 0)
            block = None
            if send:
                block = (torch.stack([kp[PL - s], vp[PL - s]]) if s <= PL
                         else got[s - PL])
            token = _Hop.apply(block, token, ring, like, send,
                               not causal or first - s >= 0)
            got.append(token)
        # query partition i reads key partition first + i - s, causal
        # only from partition 0 on
        i0 = max(0, s - first) if causal else 0
        if i0 >= PL:
            continue  # nothing to attend at this step
        n = PL - i0
        o_s, l_s = flash_attention_lse(
            *(t.reshape(n * B, H, Tl, D) for t in (
                qp[i0:], _window(kp, got, 0, s, i0),
                _window(vp, got, 1, s, i0))),
            causal=causal and s == 0, scale=scale)
        o_s = o_s.view(n, B, H, Tl, D).float()
        l_s = l_s.view(n, B, H, Tl, 1)
        lo, ll = out[i0:], lse[i0:]
        new_l = torch.logaddexp(ll, l_s)
        new_o = lo * torch.exp(ll - new_l) + o_s * torch.exp(l_s - new_l)
        if n == PL:
            out, lse = new_o, new_l
        else:
            out = torch.cat([out[:i0], new_o])
            lse = torch.cat([lse[:i0], new_l])
    if ring is not None and token.requires_grad:
        out = _Sink.apply(out, token)
    return _unparts(out.transpose(2, 3)).to(q.dtype), lse


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
                   use_flash: Optional[bool] = None,
                   group=None) -> torch.Tensor:
    """Exact multi-head attention over a sequence split into *n_parts*
    partitions, computed as the JAX ring computes it.

    ``q``/``k``/``v``: ``[B, T, H, D]`` global tensors, T a multiple of
    *n_parts*; returns ``[B, T, H, D]`` in q's type.  ``use_flash`` not
    False: each step on the flash kernels (module docstring); False: the
    plain online-softmax path, whose local attention ``block_size``
    chunks (it must divide ``T / n_parts``; None = one chunk).

    With *group* (gloo, world size ``W`` dividing *n_parts*) ``q``/``k``/
    ``v`` and the result are this rank's ``[B, T/W, H, D]`` slice of the
    sequence (module docstring); the plain path raises
    ``NotImplementedError`` there."""
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v must be [B, T, H, D] of one shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    world, rank = group_shape(group, n_parts, f"ring_attention(n_parts="
                              f"{n_parts})")
    if n_parts < 1 or (q.shape[1] * world) % n_parts:
        raise ValueError(f"sequence length {q.shape[1] * world} does not "
                         f"split into {n_parts} partitions")
    if scale is None:
        scale = q.shape[3] ** -0.5
    if world > 1 and use_flash is False:
        raise NotImplementedError(
            "ring_attention(use_flash=False) over a process group: only "
            "the flash formulation runs across ranks")
    if use_flash is not False:
        return _ring_flash(q, k, v, n_parts, causal, float(scale),
                           group)[0]
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
