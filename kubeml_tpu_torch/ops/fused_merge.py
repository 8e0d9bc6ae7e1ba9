"""Fused merge-apply over one flat f32 merge bucket (twin of
kubeml_tpu/ops/pallas/fused_merge.py).

After a bucket's lane sum the K-avg merge still owes three elementwise
steps: divide the summed contributions by the contributor count, select
the round-start values instead when every contributor dropped, and (for a
gradient bucket driving plain SGD) apply the learning-rate step:

    avg mode:  out = raw_count > 0 ? s / count            : ref
    sgd mode:  out = raw_count > 0 ? ref - lr * s / count : ref

The device decides: CUDA tensors launch the hand-written Hopper kernel
(ops/csrc/fused_merge.cu) or raise; CPU tensors run the plain version, the
reference's ``_lax_apply`` chain as three separate ops (never ``addcdiv``,
``lerp`` or ``sub(alpha=)``, which may contract or reorder the rounding).
The kernel rounds each step to nearest as well, so the two agree bit for
bit. ``count`` and ``raw_count`` are 0-d f32 tensors on the bucket's device:
the kernel reads them from device memory, so no host sync happens per
bucket. The output is always a fresh tensor: a one-leaf bucket's ``ref`` is
a view of the round-start weights.

The reference's ``fused=``/``interpret=`` knobs (and the engine's
``merge_fused``) gate Pallas to TPU backends; here the tensor's device is
the only gate, so they are not ported.
"""

from __future__ import annotations

import ctypes
import functools

import torch

_MODES = {"avg": 0, "sgd": 1}


def _apply_plain(mode: str, s, ref, count, raw_count, lr):
    """The plain version: the reference's IEEE op chain."""
    avg = s / count
    val = ref - lr * avg if mode == "sgd" else avg
    return torch.where(raw_count > 0, val, ref)


@functools.lru_cache(maxsize=None)
def _entry():
    """The library's C entry, typed once (csrc/fused_merge.cu)."""
    from kubeml_tpu_torch.ops import _build

    fn = _build.load("fused_merge").kubeml_fused_merge
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_float, ctypes.c_void_p,
                                           ctypes.c_longlong, ctypes.c_int,
                                           ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check_kernel_args(s, ref, count, raw_count) -> None:
    """What the kernel takes: flat contiguous f32 s and ref of one length
    and 0-d f32 count / raw_count, all on one device."""
    if s.dim() != 1 or ref.shape != s.shape:
        raise ValueError(f"the fused merge takes two flat buckets of one "
                         f"length, got {tuple(s.shape)} and "
                         f"{tuple(ref.shape)}")
    for name, t in (("s", s), ("ref", ref), ("count", count),
                    ("raw_count", raw_count)):
        if t.dtype != torch.float32:
            raise TypeError(f"fused merge {name} must be f32, not {t.dtype}")
        if t.device != s.device:
            raise ValueError(f"fused merge {name} lives on {t.device}, the "
                             f"bucket on {s.device}")
    if count.dim() != 0 or raw_count.dim() != 0:
        raise ValueError("count and raw_count must be 0-d device tensors")
    if not (s.is_contiguous() and ref.is_contiguous()):
        raise ValueError("fused merge buckets must be contiguous")


def fused_merge_kernel(mode: str, s, ref, count, raw_count,
                       lr: float = 0.0) -> torch.Tensor:
    """The kernel (replaces _kernel): one launch over the bucket, into a
    fresh output. Raises on a refused launch."""
    _check_kernel_args(s, ref, count, raw_count)
    out = torch.empty_like(s)
    if s.numel() == 0:
        return out
    with torch.cuda.device(s.device):
        stream = torch.cuda.current_stream(s.device).cuda_stream
        rc = _entry()(s.data_ptr(), ref.data_ptr(), count.data_ptr(),
                      raw_count.data_ptr(), float(lr), out.data_ptr(),
                      s.numel(), _MODES[mode], stream)
    if rc != 0:
        raise RuntimeError(f"fused merge kernel launch failed: CUDA error "
                           f"{rc}")
    fused_merge_kernel.launches += 1
    return out


fused_merge_kernel.launches = 0


def _bucket_apply(mode: str, s, ref, count, raw_count, lr):
    s, ref = s.float(), ref.float()
    if s.device.type == "cuda":
        return fused_merge_kernel(mode, s, ref, count, raw_count, lr)
    if s.device.type != "cpu":
        raise ValueError(f"the fused merge runs on CUDA or CPU tensors, got "
                         f"a {s.device.type} tensor")
    return _apply_plain(mode, s, ref, count, raw_count, lr)


def fused_avg_select(s, ref, count, raw_count) -> torch.Tensor:
    """avg + all-dropped guard-select over one flat f32 bucket:
    ``where(raw_count > 0, s / count, ref)``. The bucketed merges' apply
    step; launches are counted on ``fused_merge_kernel.launches``."""
    return _bucket_apply("avg", s, ref, count, raw_count, 0.0)


def fused_sgd_select(gsum, params, count, raw_count, lr: float
                     ) -> torch.Tensor:
    """avg + guard-select + SGD step over one flat gradient bucket:
    ``where(raw_count > 0, params - lr * gsum / count, params)``."""
    return _bucket_apply("sgd", gsum, params, count, raw_count, lr)
