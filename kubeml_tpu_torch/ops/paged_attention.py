"""Paged attention — the serving programs' context read (twin of
kubeml_tpu/ops/pallas/paged_attention.py).

``paged_attention`` attends [S, T, H, D] queries over KV pages held in
the slab as [P, G, H, D], walked through a [S, Pmax] page table. On a
CUDA tensor it launches the hand-written Hopper kernel
(ops/csrc/paged_attention.cu) or raises; on a CPU tensor it runs the
plain version ``_pa_plain`` — the reference's gather path, which is also
what the kernel is held against on the card. There is no fallback from
the kernel to the plain version.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from kubeml_tpu_torch.ops.attention import multi_head_attention

# the most shared memory one thread block may use on Hopper (bytes)
MAX_SMEM_BYTES = 232448


def _dequant(pages: torch.Tensor, scale: torch.Tensor,
             dtype: torch.dtype) -> torch.Tensor:
    """Per-page symmetric int8 -> compute dtype: the reference's dequant
    expression (cast to f32, multiply by the page's scale, cast)."""
    shape = scale.shape + (1,) * (pages.ndim - scale.ndim)
    return (pages.float() * scale.reshape(shape)).to(dtype)


def _pa_plain(q, k_pages, v_pages, k_scale, v_scale, page_tables, bias,
              quantized: bool, compute_dtype: torch.dtype) -> torch.Tensor:
    """The plain version: dequantize, gather each slot's whole context
    through its page table, then the shared attention chain."""
    S, T, H, D = q.shape
    G = k_pages.shape[1]
    C = page_tables.shape[1] * G
    if quantized:
        k_pages = _dequant(k_pages, k_scale, compute_dtype)
        v_pages = _dequant(v_pages, v_scale, compute_dtype)
    ck = k_pages[page_tables].reshape(S, C, H, D)
    cv = v_pages[page_tables].reshape(S, C, H, D)
    return multi_head_attention(q, ck, cv, bias)


def _check_kernel_args(q, k_pages, v_pages, k_scale, v_scale, page_tables,
                       bias, quantized: bool, compute_dtype) -> None:
    if q.dim() != 4 or k_pages.dim() != 4:
        raise ValueError("paged_attention wants q [S, T, H, D] and pages "
                         "[P, G, H, D]")
    S, T, H, D = q.shape
    P, G, Hk, Dk = k_pages.shape
    if min(S, T, H, D, P, G) < 1:
        raise ValueError(f"empty paged_attention operand: q {tuple(q.shape)}"
                         f", pages {tuple(k_pages.shape)}")
    if (Hk, Dk) != (H, D) or v_pages.shape != k_pages.shape:
        raise ValueError(f"page shape {tuple(k_pages.shape)} / "
                         f"{tuple(v_pages.shape)} does not match q "
                         f"{tuple(q.shape)}")
    if page_tables.dim() != 2 or page_tables.shape[0] != S:
        raise ValueError(f"page_tables must be [S={S}, Pmax], got "
                         f"{tuple(page_tables.shape)}")
    C = page_tables.shape[1] * G
    if tuple(bias.shape) != (S, 1, T, C):
        raise ValueError(f"bias must be [S, 1, T, C] = {(S, 1, T, C)}, got "
                         f"{tuple(bias.shape)}")
    if tuple(k_scale.shape) != (P,) or tuple(v_scale.shape) != (P,):
        raise ValueError(f"page scales must be [P={P}]")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the kernel takes f32 or bf16 queries, not "
                        f"{q.dtype}")
    if compute_dtype != q.dtype:
        raise TypeError(f"the kernel computes in q's dtype {q.dtype}, not "
                        f"{compute_dtype}")
    page_dtype = torch.int8 if quantized else q.dtype
    if k_pages.dtype != page_dtype or v_pages.dtype != page_dtype:
        raise TypeError(f"pages must be {page_dtype} (quantized="
                        f"{quantized}), got {k_pages.dtype}")
    for name, t, dt in (("scales", k_scale, torch.float32),
                        ("scales", v_scale, torch.float32),
                        ("page_tables", page_tables, torch.int32),
                        ("bias", bias, torch.float32)):
        if t.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {t.dtype}")
    tensors = (q, k_pages, v_pages, k_scale, v_scale, page_tables, bias)
    if any(t.device != q.device for t in tensors):
        raise ValueError("paged_attention operands span devices")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("paged_attention operands must be contiguous")
    why = kernel_geometry_refusal(T, D, G, page_tables.shape[1], q.dtype,
                                  quantized, smem=False)
    if why is not None:
        raise ValueError(why)


def kernel_geometry_refusal(T: int, D: int, G: int, Pmax: int,
                            compute_dtype: torch.dtype, quantized: bool,
                            smem: bool = True) -> Optional[str]:
    """Why the kernel cannot take T query tokens of head_dim D over Pmax
    pages of G tokens in ``compute_dtype`` (int8 pages when quantized), or
    None when it can. The one home of the kernel's geometry rules: the
    launch checks them, and a CUDA DecodeEngine checks them when it is
    built. The page-size and row-width rules are pure; with ``smem`` the
    shared memory the launch would need is asked of the built library,
    which needs the CUDA toolkit (the card's machine)."""
    itemsize = 1 if quantized else torch.finfo(compute_dtype).bits // 8
    if (D * itemsize) % 16:
        return (f"the kernel stages page rows in 16-byte vectors: head_dim "
                f"{D} x {itemsize} bytes is not a multiple of 16")
    if compute_dtype == torch.bfloat16 and G % 8:
        return (f"the bf16 kernel walks the context in 8-token slices: page "
                f"size {G} is not a multiple of 8")
    if smem:
        need = kernel_smem_bytes(T, D, G, Pmax, compute_dtype, quantized)
        if need > MAX_SMEM_BYTES:
            return (f"paged_attention needs {need} bytes of shared memory "
                    f"per block (T={T}, C={Pmax * G}, D={D}, G={G}); a "
                    f"Hopper block has {MAX_SMEM_BYTES}")
    return None


def kernel_smem_bytes(T: int, D: int, G: int, Pmax: int,
                      compute_dtype: torch.dtype, quantized: bool) -> int:
    """Shared memory per block of a launch at this geometry, from the
    built library (the layout lives in csrc/paged_attention.cu)."""
    _, smem_bytes = _entries()
    return int(smem_bytes(T, D, G, Pmax,
                          int(compute_dtype == torch.bfloat16),
                          int(quantized)))


@functools.lru_cache(maxsize=None)
def _entries():
    """The library's two C entries, typed once: the launch (a cluster of
    up to 8 blocks per (head, slot) for bf16 queries) and its
    shared-memory query (the layout lives in csrc/paged_attention.cu)."""
    from kubeml_tpu_torch.ops import _build

    lib = _build.load("paged_attention")
    launch = lib.kubeml_paged_attention
    launch.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 9 \
        + [ctypes.c_void_p]
    launch.restype = ctypes.c_int
    smem = lib.kubeml_paged_attention_smem_bytes
    smem.argtypes = [ctypes.c_int] * 6
    smem.restype = ctypes.c_size_t
    return launch, smem


def _pa_kernel(q, k_pages, v_pages, k_scale, v_scale, page_tables, bias,
               quantized: bool, compute_dtype) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream; raises on a refused
    launch (the kernel allocates nothing: the output is made here)."""
    _check_kernel_args(q, k_pages, v_pages, k_scale, v_scale, page_tables,
                       bias, quantized, compute_dtype)
    S, T, H, D = q.shape
    P, G = k_pages.shape[:2]
    Pmax = page_tables.shape[1]
    why = kernel_geometry_refusal(T, D, G, Pmax, q.dtype, quantized)
    if why is not None:      # the shared-memory rule, asked of the library
        raise ValueError(why)
    launch, _ = _entries()
    bf16 = int(q.dtype == torch.bfloat16)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = launch(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                    k_scale.data_ptr(), v_scale.data_ptr(),
                    page_tables.data_ptr(), bias.data_ptr(), out.data_ptr(),
                    S, T, H, D, G, Pmax, P, bf16, int(quantized), stream)
    if rc != 0:
        raise RuntimeError(f"paged_attention kernel launch failed: CUDA "
                           f"error {rc}")
    paged_attention.launches += 1
    return out


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                    v_pages: torch.Tensor, k_scale: torch.Tensor,
                    v_scale: torch.Tensor, page_tables: torch.Tensor,
                    bias: torch.Tensor, *, quantized: bool = False,
                    compute_dtype: Optional[torch.dtype] = None
                    ) -> torch.Tensor:
    """Attention of [S, T, H, D] queries over paged KV, through the page
    table — one layer's context read of the serving programs.

    k_pages/v_pages: [P, G, H, D] slab planes (compute dtype, or int8
    with quantized=True); k_scale/v_scale: [P] f32 per-page symmetric
    scales (ignored unless quantized); page_tables: [S, Pmax] int32
    (tails point at the reserved null page 0); bias: additive f32 mask
    [S, 1, T, C], C = Pmax*G — validity and causality are entirely the
    caller's bias.

    The device decides: a CUDA tensor launches the kernel (or raises), a
    CPU tensor runs the plain version, any other device raises.
    ``paged_attention.launches`` counts kernel launches.
    """
    if compute_dtype is None:
        compute_dtype = q.dtype
    if q.device.type == "cuda":
        return _pa_kernel(q, k_pages, v_pages, k_scale, v_scale,
                          page_tables, bias, quantized, compute_dtype)
    if q.device.type != "cpu":
        raise ValueError(f"the paged-attention kernel runs on CUDA tensors "
                         f"only, got a {q.device.type} tensor")
    return _pa_plain(q, k_pages, v_pages, k_scale, v_scale, page_tables,
                     bias, quantized, compute_dtype)


paged_attention.launches = 0
