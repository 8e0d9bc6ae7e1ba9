"""Flash attention — the training path's attention (twin of
kubeml_tpu/ops/pallas/flash_attention.py).

``flash_attention(q, k, v, pad_mask, causal)`` attends [B, T, H, D]
tensors under a [B, T] keep-mask over the keys and an optional causal
mask, and is differentiable in q, k and v (its gradient w.r.t. the mask
is zero). It keeps the reference's internal contract, which ring
attention reuses:

  _fa_forward(q, k, v, pad_mask, causal) -> (out, m_rows, l_rows)
  _fa_backward(q, k, v, pad_mask, out, m_rows, l_rows, g, causal)
      -> (dq, dk, dv)

with the row statistics m (running max) and l (normalizer) as f32
[B*H, 1, T], kept apart — never lse = m + log l, which loses log l at
NEG_INF scale and would inflate a fully masked row's gradients.

The device decides: CUDA tensors launch the hand-written Hopper kernels
(ops/csrc/flash_attention.cu: the forward, dK/dV and dQ) or raise; CPU
tensors run each kernel's plain version, the same op chain over the full
[B, H, T, T] score matrix. There is no fallback from a kernel to its plain
version. ``delta = rowsum(dO * O)`` is a plain PyTorch expression outside
the kernels, as it is outside the reference's Pallas kernels.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from kubeml_tpu_torch.ops.attention import NEG_INF

# the most shared memory one thread block may use on Hopper (bytes)
MAX_SMEM_BYTES = 232448
MAX_HEAD_DIM = 128      # the kernels' head_dim limit (two 64-wide chunks)


def _scale(D: int) -> float:
    """The reference's ``1.0 / float(D) ** 0.5`` (a Python double, applied
    to f32 scores as f32)."""
    return 1.0 / float(D) ** 0.5


def _rows(x: torch.Tensor) -> torch.Tensor:
    """[B, T, H] -> [B*H, 1, T], the layout of the row statistics."""
    B, T, H = x.shape
    return x.permute(0, 2, 1).reshape(B * H, 1, T).contiguous()


def _delta(g: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """rowsum(dO * O) in f32, [B*H, 1, T]."""
    return _rows((g.float() * out.float()).sum(-1))


# ------------------------------------------------------------ plain versions
def _scores_plain(q, k, pad_mask, causal: bool) -> torch.Tensor:
    """The full masked f32 score matrix [B, H, T, T]: the reference's
    _block_scores for every block at once (scaled product, then the pad
    term, then the causal term, as separate f32 additions)."""
    T, D = q.shape[1], q.shape[3]
    # products of bf16 values are exact in f32, so upcasting first gives
    # the reference's f32-accumulated scores
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * _scale(D)
    s = s + ((1.0 - pad_mask.float()) * NEG_INF)[:, None, None, :]
    if causal:
        idx = torch.arange(T, device=q.device)
        tri = torch.zeros((T, T), device=q.device).masked_fill(
            idx[:, None] < idx[None, :], NEG_INF)
        s = s + tri
    return s


def _probs_plain(q, k, pad_mask, m_rows, l_rows, causal) -> torch.Tensor:
    """The backward's recomputed probabilities p = exp(s - m) / l."""
    B, T, H, _ = q.shape
    s = _scores_plain(q, k, pad_mask, causal)
    return torch.exp(s - m_rows.reshape(B, H, T, 1)) \
        / l_rows.reshape(B, H, T, 1)


def _fa_forward_plain(q, k, v, pad_mask, causal: bool):
    """Plain version of the forward kernel: (out, m_rows, l_rows)."""
    B, T, H, _ = q.shape
    s = _scores_plain(q, k, pad_mask, causal)
    # the kernel's running max starts at NEG_INF
    m = s.amax(-1, keepdim=True).clamp_min(NEG_INF)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True).clamp_min(1e-30)
    acc = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    out = (acc / l.permute(0, 2, 1, 3)).to(q.dtype)
    return out, m.reshape(B * H, 1, T), l.reshape(B * H, 1, T)


def _ds_plain(p, g, v, delta, D):
    """ds = p * (dO . v^T - delta) * scale, f32 [B, H, T, T]."""
    B, T, H, _ = g.shape
    dp = torch.einsum("bqhd,bkhd->bhqk", g.float(), v.float())
    return p * (dp - delta.reshape(B, H, T, 1)) * _scale(D)


def _fa_bwd_dkv_plain(q, k, v, pad_mask, g, m_rows, l_rows, delta,
                      causal: bool):
    """Plain version of the dK/dV kernel: (dk, dv)."""
    p = _probs_plain(q, k, pad_mask, m_rows, l_rows, causal)
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(g.dtype).float(), g.float())
    ds = _ds_plain(p, g, v, delta, q.shape[3])
    dk = torch.einsum("bhqk,bqhd->bkhd", ds.to(q.dtype).float(), q.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def _fa_bwd_dq_plain(q, k, v, pad_mask, g, m_rows, l_rows, delta,
                     causal: bool):
    """Plain version of the dQ kernel: dq."""
    p = _probs_plain(q, k, pad_mask, m_rows, l_rows, causal)
    ds = _ds_plain(p, g, v, delta, q.shape[3])
    dq = torch.einsum("bhqk,bkhd->bqhd", ds.to(k.dtype).float(), k.float())
    return dq.to(q.dtype)


# ------------------------------------------------------------------- kernels
def _check_kernel_args(q, k, v, pad_mask, g=None, rows=()) -> None:
    """What the kernels take: [B, T, H, D] q/k/v (and g) of one f32 or
    bf16 dtype, a [B, T] f32 keep-mask, f32 [B*H, 1, T] row statistics,
    all contiguous on one device, D * itemsize a multiple of 16 bytes and
    D at most MAX_HEAD_DIM."""
    if q.dim() != 4:
        raise ValueError(f"flash attention wants [B, T, H, D] tensors, got "
                         f"q {tuple(q.shape)}")
    B, T, H, D = q.shape
    if min(B, T, H, D) < 1:
        raise ValueError(f"empty flash attention operand {tuple(q.shape)}")
    seq = (k, v) if g is None else (k, v, g)
    if any(t.shape != q.shape for t in seq):
        raise ValueError(f"q/k/v{'' if g is None else '/g'} shapes differ: "
                         f"{[tuple(t.shape) for t in (q, *seq)]}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the kernels take f32 or bf16, not {q.dtype}")
    if any(t.dtype != q.dtype for t in seq):
        raise TypeError("q/k/v (and g) must share one dtype")
    if tuple(pad_mask.shape) != (B, T) or pad_mask.dtype != torch.float32:
        raise ValueError(f"pad_mask must be f32 [B, T] = {(B, T)}, got "
                         f"{pad_mask.dtype} {tuple(pad_mask.shape)}")
    for r in rows:
        if tuple(r.shape) != (B * H, 1, T) or r.dtype != torch.float32:
            raise ValueError(f"row statistics must be f32 [B*H, 1, T] = "
                             f"{(B * H, 1, T)}, got {r.dtype} "
                             f"{tuple(r.shape)}")
    tensors = (q, *seq, pad_mask, *rows)
    if any(t.device != q.device for t in tensors):
        raise ValueError("flash attention operands span devices")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("flash attention operands must be contiguous")
    if (D * q.element_size()) % 16:
        raise ValueError(f"the kernels stage rows in 16-byte vectors: "
                         f"head_dim {D} x {q.element_size()} bytes is not a "
                         f"multiple of 16")
    if D > MAX_HEAD_DIM:
        raise ValueError(f"head_dim {D} exceeds the kernels' "
                         f"{MAX_HEAD_DIM}")


@functools.lru_cache(maxsize=None)
def _entries():
    """The library's C entries, typed once (layouts live in
    csrc/flash_attention.cu)."""
    from kubeml_tpu_torch.ops import _build

    lib = _build.load("flash_attention")
    tail = [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_int,
                                 ctypes.c_void_p]
    fwd = lib.kubeml_flash_fwd
    fwd.argtypes = [ctypes.c_void_p] * 7 + tail
    dkv = lib.kubeml_flash_bwd_dkv
    dkv.argtypes = [ctypes.c_void_p] * 10 + tail
    dq = lib.kubeml_flash_bwd_dq
    dq.argtypes = [ctypes.c_void_p] * 9 + tail
    for f in (fwd, dkv, dq):
        f.restype = ctypes.c_int
    smem = lib.kubeml_flash_smem_bytes
    smem.argtypes = [ctypes.c_int] * 3
    smem.restype = ctypes.c_size_t
    return {"fwd": fwd, "dkv": dkv, "dq": dq, "smem": smem}


def _launch(name: str, kernel_id: int, q, causal: bool, ptrs) -> None:
    """Launch one kernel on the current stream; raises on a refused
    launch (the kernels allocate nothing: outputs are made by the
    caller)."""
    B, T, H, D = q.shape
    bf16 = int(q.dtype == torch.bfloat16)
    entries = _entries()
    smem = entries["smem"](kernel_id, D, bf16)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"flash attention {name} needs {smem} bytes of "
                         f"shared memory per block (D={D}); a Hopper block "
                         f"has {MAX_SMEM_BYTES}")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = entries[name](*(t.data_ptr() for t in ptrs), B, T, H, D,
                           int(causal), _scale(D), bf16, stream)
    if rc != 0:
        raise RuntimeError(f"flash attention {name} kernel launch failed: "
                           f"CUDA error {rc}")


def fa_fwd_kernel(q, k, v, pad_mask, causal: bool):
    """The forward kernel (replaces _fa_kernel): (out, m_rows, l_rows)."""
    _check_kernel_args(q, k, v, pad_mask)
    B, T, H, _ = q.shape
    out = torch.empty_like(q)
    m_rows = torch.empty((B * H, 1, T), device=q.device)
    l_rows = torch.empty_like(m_rows)
    _launch("fwd", 0, q, causal, (q, k, v, pad_mask, out, m_rows, l_rows))
    fa_fwd_kernel.launches += 1
    return out, m_rows, l_rows


def fa_bwd_dkv_kernel(q, k, v, pad_mask, g, m_rows, l_rows, delta,
                      causal: bool):
    """The dK/dV kernel (replaces _fa_bwd_dkv_kernel): (dk, dv)."""
    _check_kernel_args(q, k, v, pad_mask, g, (m_rows, l_rows, delta))
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch("dkv", 1, q, causal,
            (q, k, v, pad_mask, g, m_rows, l_rows, delta, dk, dv))
    fa_bwd_dkv_kernel.launches += 1
    return dk, dv


def fa_bwd_dq_kernel(q, k, v, pad_mask, g, m_rows, l_rows, delta,
                     causal: bool):
    """The dQ kernel (replaces _fa_bwd_dq_kernel): dq."""
    _check_kernel_args(q, k, v, pad_mask, g, (m_rows, l_rows, delta))
    dq = torch.empty_like(q)
    _launch("dq", 2, q, causal,
            (q, k, v, pad_mask, g, m_rows, l_rows, delta, dq))
    fa_bwd_dq_kernel.launches += 1
    return dq


fa_fwd_kernel.launches = 0
fa_bwd_dkv_kernel.launches = 0
fa_bwd_dq_kernel.launches = 0


# --------------------------------------------------------- routed contract
def _on_cuda(q: torch.Tensor) -> bool:
    if q.device.type not in ("cuda", "cpu"):
        raise ValueError(f"the flash-attention kernels run on CUDA tensors "
                         f"only, got a {q.device.type} tensor")
    return q.device.type == "cuda"


def _fa_forward(q, k, v, pad_mask, causal: bool):
    """(out, m_rows, l_rows): the kernel on CUDA tensors, its plain
    version on CPU tensors."""
    if _on_cuda(q):
        return fa_fwd_kernel(q, k, v, pad_mask, causal)
    return _fa_forward_plain(q, k, v, pad_mask, causal)


def _fa_backward(q, k, v, pad_mask, out, m_rows, l_rows, g, causal: bool):
    """(dq, dk, dv) from the forward's out and row statistics: the dK/dV
    and dQ kernels on CUDA tensors, their plain versions on CPU tensors."""
    delta = _delta(g, out)
    if _on_cuda(q):
        dk, dv = fa_bwd_dkv_kernel(q, k, v, pad_mask, g, m_rows, l_rows,
                                   delta, causal)
        dq = fa_bwd_dq_kernel(q, k, v, pad_mask, g, m_rows, l_rows, delta,
                              causal)
        return dq, dk, dv
    dk, dv = _fa_bwd_dkv_plain(q, k, v, pad_mask, g, m_rows, l_rows, delta,
                               causal)
    dq = _fa_bwd_dq_plain(q, k, v, pad_mask, g, m_rows, l_rows, delta,
                          causal)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """The reference's custom_vjp: the forward saves (out, m, l), the
    backward recomputes probabilities from them."""

    @staticmethod
    def forward(ctx, q, k, v, pad_mask, causal):
        out, m_rows, l_rows = _fa_forward(q, k, v, pad_mask, causal)
        ctx.save_for_backward(q, k, v, pad_mask, out, m_rows, l_rows)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, pad_mask, out, m_rows, l_rows = ctx.saved_tensors
        dq, dk, dv = _fa_backward(q, k, v, pad_mask, out, m_rows, l_rows,
                                  g.contiguous(), ctx.causal)
        dmask = torch.zeros_like(pad_mask) if ctx.needs_input_grad[3] \
            else None
        return dq, dk, dv, dmask, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    pad_mask: torch.Tensor, causal: bool = False
                    ) -> torch.Tensor:
    """Fused attention over [B, T, H, D] with a [B, T] keep-mask over the
    keys (1 = attend); equals multi_head_attention with the composed pad
    (+ causal) bias to f32 accuracy. Differentiable in q, k, v.

    The device decides: CUDA tensors launch the kernels (or raise), CPU
    tensors run the plain versions, any other device raises. The kernels'
    launches are counted on ``fa_fwd_kernel.launches``,
    ``fa_bwd_dkv_kernel.launches`` and ``fa_bwd_dq_kernel.launches``.
    """
    return _FlashAttention.apply(q, k, v, pad_mask.float().contiguous(),
                                 causal)
