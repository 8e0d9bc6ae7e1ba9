"""Fused merge-apply over a round's flat f32 merge buckets (twin of
kubeml_tpu/ops/pallas/fused_merge.py).

After a bucket's lane sum the K-avg merge still owes three elementwise
steps: divide the summed contributions by the contributor count, select
the round-start values instead when every contributor dropped, and (for a
gradient bucket driving plain SGD) apply the learning-rate step:

    avg mode:  out = raw_count > 0 ? s / count            : ref
    sgd mode:  out = raw_count > 0 ? ref - lr * s / count : ref

``fused_merge_apply`` takes every bucket of a round at once, as
``(s, ref)`` pairs. The device decides: CUDA tensors launch the
hand-written Hopper kernel (ops/csrc/fused_merge.cu) once for up to
MAX_SEGMENTS buckets, or raise; CPU tensors run the plain version pair by
pair, the reference's ``_lax_apply`` chain as three separate ops (never
``addcdiv``, ``lerp`` or ``sub(alpha=)``, which may contract or reorder
the rounding). The kernel rounds each step to nearest as well, so the two
agree bit for bit. ``count`` and ``raw_count`` are 0-d f32 tensors on the
buckets' device: the kernel reads them from device memory, so no host
sync happens per merge. Every output is fresh: a one-leaf bucket's
``ref`` is a view of the round-start weights. ``fused_avg_select``,
``fused_sgd_select`` and ``fused_merge_kernel`` are the one-bucket calls.

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


# Segments one launch takes (csrc/fused_merge.cu kMaxSegments): a longer
# list of buckets is cut into ceil(n / MAX_SEGMENTS) launches.
MAX_SEGMENTS = 64


class _Segment(ctypes.Structure):
    """One record of the kernel's segment table (csrc Segment)."""
    _fields_ = [("s", ctypes.c_void_p), ("ref", ctypes.c_void_p),
                ("out", ctypes.c_void_p), ("n", ctypes.c_longlong)]


@functools.lru_cache(maxsize=None)
def _entry():
    """The library's C entry, typed once (csrc/fused_merge.cu)."""
    from kubeml_tpu_torch.ops import _build

    lib = _build.load("fused_merge")
    if lib.kubeml_fused_merge_max_segments() != MAX_SEGMENTS:
        raise RuntimeError("csrc/fused_merge.cu's kMaxSegments is not "
                           f"{MAX_SEGMENTS}")
    fn = lib.kubeml_fused_merge
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_float, ctypes.c_int,
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


def _check_pairs(pairs, count, raw_count) -> torch.device:
    """Every pair checked as the kernel takes it, all on one CUDA or CPU
    device; returns that device."""
    if not pairs:
        raise ValueError("the fused merge takes at least one bucket")
    device = pairs[0][0].device
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"the fused merge runs on CUDA or CPU tensors, got "
                         f"a {device.type} tensor")
    for s, ref in pairs:
        _check_kernel_args(s, ref, count, raw_count)
        if s.device != device:
            raise ValueError(f"fused merge buckets live on {s.device} and "
                             f"{device}: one launch takes one device")
    return device


def _launch(mode: str, pairs, count, raw_count, lr: float) -> list:
    """The kernel (replaces _kernel) over checked CUDA pairs: one output
    buffer, each bucket's view at a 16-byte-aligned offset, and one
    launch per MAX_SEGMENTS non-empty buckets. Raises on a refused
    launch."""
    device = pairs[0][0].device
    offsets, total = [], 0
    for s, _ in pairs:
        offsets.append(total)
        total += -(-s.numel() // 4) * 4          # 16 bytes of f32
    buf = torch.empty(total, dtype=torch.float32, device=device)
    outs = [buf[o:o + s.numel()] for o, (s, _) in zip(offsets, pairs)]
    table = [_Segment(s.data_ptr(), ref.data_ptr(), out.data_ptr(),
                      s.numel())
             for (s, ref), out in zip(pairs, outs) if s.numel()]
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        for i in range(0, len(table), MAX_SEGMENTS):
            part = table[i:i + MAX_SEGMENTS]
            rc = _entry()((_Segment * len(part))(*part), len(part),
                          count.data_ptr(), raw_count.data_ptr(), float(lr),
                          _MODES[mode], stream)
            if rc != 0:
                raise RuntimeError(f"fused merge kernel launch failed: CUDA "
                                   f"error {rc}")
            fused_merge_kernel.launches += 1
            fused_merge_kernel.segments += len(part)
    return outs


def fused_merge_kernel(mode: str, s, ref, count, raw_count,
                       lr: float = 0.0) -> torch.Tensor:
    """The kernel over one bucket: a one-segment launch, into a fresh
    output."""
    _check_kernel_args(s, ref, count, raw_count)
    return _launch(mode, [(s, ref)], count, raw_count, lr)[0]


fused_merge_kernel.launches = 0    # kernel launches
fused_merge_kernel.segments = 0    # buckets those launches merged


def fused_merge_apply(mode: str, pairs, count, raw_count,
                      lr: float = 0.0) -> list:
    """The merge-apply of a round's buckets: ``pairs`` is a list of flat
    contiguous f32 ``(s, ref)`` on one device, and the result is one
    fresh f32 output per pair, in order. CUDA tensors take one kernel
    launch per MAX_SEGMENTS buckets (counted on
    ``fused_merge_kernel.launches`` and ``.segments``); CPU tensors run
    the plain version pair by pair."""
    pairs = list(pairs)
    device = _check_pairs(pairs, count, raw_count)
    if device.type == "cuda":
        return _launch(mode, pairs, count, raw_count, lr)
    return [_apply_plain(mode, s, ref, count, raw_count, lr)
            for s, ref in pairs]


def _bucket_apply(mode: str, s, ref, count, raw_count, lr):
    return fused_merge_apply(mode, [(s.float(), ref.float())], count,
                             raw_count, lr)[0]


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
