"""Decoder-only transformer (GPT) for serving — twin of
kubeml_tpu/models/gpt.py.

The math follows the flax module exactly:
  - pre-LN blocks; LayerNorm in f32 with epsilon 1e-6 and flax's
    variance (E[x^2] - E[x]^2, clipped at 0);
  - every Dense/Embed keeps f32 parameters and casts operands to the
    compute dtype (bf16 by default) at use;
  - GELU is the tanh approximation;
  - learned positional embeddings and a weight-tied LM head
    (logits = h @ tok_embed^T in the compute dtype, returned as f32).

Parameters are held by an ``nn.Module`` (``GPTModule``); the serving
programs take them as a dict of compute-dtype tensors made once by
``compute_params`` (casting once gives the same values as flax's cast at
use). ``GPTModule.forward`` is the dense inference forward over plain
``multi_head_attention``; the paged decode and prefill steps
(``build_paged_decode_step``/``build_paged_prefill_step``) read the KV
slab through the paged-attention kernel. The multi-step decode program
(``build_paged_multi_step_decode``) runs K decode steps per call, and the
speculative verify program (``build_paged_spec_verify_step``) lets a
draft GPT propose K tokens, through the flash forward, that the decode
step verifies and replays.

Training: ``GPTModule.logits`` is the differentiable forward (f32 master
weights cast to the compute dtype at use, dropout from an explicit
generator, attention through ``masked_attention(causal=True)`` — the flash
kernels on the card), and ``GPTMini``/``GPTNano`` carry the model
contract (per-sequence LM loss, metrics, AdamW).

``GPTMoEMini`` (``gpt-moe-mini``) replaces every block's FFN by a mixture
of experts (``MoEFFN``'s parameters, ``parallel/ep.moe_apply``'s math):
the router and the experts run in f32 on the f32 LayerNorm output, as
the reference's do, and each block's load-balance aux joins the loss.
With ``ep_axis`` (the rank grid's ``"expert"``) each rank of the expert
group routes the same tokens and runs its share of the experts
(``parallel/manual.ep_partial_ffn``), or, under ``ep_impl="alltoall"``,
routes its own 1/n of the tokens and exchanges the slots with the
experts' ranks (``parallel/manual.ep_alltoall_ffn``); under a seq axis
each rank routes its own block of the sequence (per-shard capacity). The
serving programs refuse an MoE module, as the reference's do.

``tp_axis`` (the rank grid's ``"model"``) runs every block's two Megatron
pairs over the model axis (``parallel/manual.py``): q/k/v on this rank's
heads / n heads, attention on those local heads (the flash kernels, or
the flash ring under a seq axis), the out-projection's partial product
summed over the axis; the FFN's first Dense on this rank's columns, its
second on the matching rows, summed. ``tp_plan`` (the GSPMD route's
``parallel/tp.shard_plan``) says per block which pair splits and which
runs whole; without one every pair splits and heads or an FFN width that
does not divide is refused (the manual route). The serving programs
refuse a tensor-parallel module.

Pipeline parallelism (``GPTMini.enable_pipeline_parallel``, the
reference's ``_pp_forward_loss``; ``forward_pipelined``) runs the blocks
as ``pp_trunk``: M microbatches through stages of L/P consecutive blocks
over the rank grid's stage axis (``parallel/pp.py``), the embedding, the
final LayerNorm and the head on every stage, the parameters whole.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from kubeml_tpu_torch._device import DeviceLike, resolve_device
from kubeml_tpu_torch.convert import params_from_flax, params_to_flax
from kubeml_tpu_torch.models.base import (PAD_ID, InferenceInputError,
                                          KubeModel, register_model)
from kubeml_tpu_torch.models.layers import RowDraw, _dropout
from kubeml_tpu_torch.ops.attention import (NEG_INF, composed_bias,
                                            masked_attention,
                                            multi_head_attention,
                                            ring_flash_eligible)
from kubeml_tpu_torch.ops.paged_attention import paged_attention
from kubeml_tpu_torch.parallel import distributed as dist_lib
from kubeml_tpu_torch.parallel.distributed import (EXPERT_AXIS, SEQ_AXIS,
                                                   STAGE_AXIS)
from kubeml_tpu_torch.parallel.ep import moe_apply, route_tokens
from kubeml_tpu_torch.parallel.manual import (all_gather, ep_alltoall_ffn,
                                              ep_partial_ffn,
                                              tp_column_dense, tp_heads_dense,
                                              tp_out_dense, tp_row_dense,
                                              validate_tp_geometry)
from kubeml_tpu_torch.parallel.pp import (pipeline_lane, sequential_apply,
                                          stack_stage_params)
from kubeml_tpu_torch.parallel.ring_attention import (_seq_block,
                                                      gather_seq,
                                                      ring_attention)
from kubeml_tpu_torch.parallel.tp import TRANSFORMER_TP_RULES
from kubeml_tpu_torch.parallel.ulysses import ulysses_attention

LN_EPS = 1e-6  # flax LayerNorm's default, not torch's 1e-5
# an MoE block's routing: top-2 GShard choices, each expert taking
# ceil(tokens / experts x 1.25) (the reference's moe_k, capacity_factor)
MOE_K = 2
CAPACITY_FACTOR = 1.25

# published widths of the built-in GPT family (kubeml_tpu/models/gpt.py
# GPTModule defaults and GPTNano.build)
GPT_CONFIGS = {
    "gpt-mini": dict(vocab_size=8192, max_len=512, hidden=256, layers=4,
                     heads=4, ffn=1024),
    "gpt-nano": dict(vocab_size=512, max_len=64, hidden=32, layers=2,
                     heads=2, ffn=64),
}
# their dropout rates (GPTModule's default 0.1; GPTNano builds with 0.0)
GPT_DROPOUT = {"gpt-mini": 0.1, "gpt-nano": 0.0}
# gpt-moe-mini: gpt-mini's widths with 8 experts of a 512-wide FFN
# (GPTMoEMini.build); the serving programs refuse it, so it is not a
# serving built-in
GPT_MOE_CONFIG = dict(GPT_CONFIGS["gpt-mini"], ffn=512, n_experts=8)

# serving KV storage modes (mirrors serve/pager.py KV_DTYPES)
_KV_DTYPES = ("f32", "int8")


class DecoderBlock(nn.Module):
    """Parameters of one pre-LN block; the math is ``_block`` below.
    With ``n_experts`` > 0 the FFN is the mixture of experts ``moe`` in
    place of ``fc0``/``fc1``."""

    def __init__(self, hidden: int, heads: int, ffn: int,
                 device: torch.device, n_experts: int = 0):
        super().__init__()
        self.ln0 = nn.LayerNorm(hidden, eps=LN_EPS, device=device)
        self.q = nn.Linear(hidden, hidden, device=device)
        self.k = nn.Linear(hidden, hidden, device=device)
        self.v = nn.Linear(hidden, hidden, device=device)
        self.out = nn.Linear(hidden, hidden, device=device)
        self.ln1 = nn.LayerNorm(hidden, eps=LN_EPS, device=device)
        if n_experts > 0:
            self.moe = MoEFFN(hidden, ffn, n_experts, device)
        else:
            self.fc0 = nn.Linear(hidden, ffn, device=device)
            self.fc1 = nn.Linear(ffn, hidden, device=device)


class MoEFFN(nn.Module):
    """The mixture-of-experts FFN's parameters (the reference's
    ``MoEFFN``), in the flax layouts with the expert axis leading: router
    [D, E], wi [E, D, F], bi [E, F], wo [E, F, D], bo [E, D]. The math is
    ``parallel/ep.moe_apply``."""

    def __init__(self, d_model: int, d_ff: int, n_experts: int,
                 device: torch.device):
        super().__init__()
        e = n_experts

        def param(*shape):
            return nn.Parameter(torch.zeros(shape, device=device))

        self.router = param(d_model, e)
        self.wi, self.bi = param(e, d_model, d_ff), param(e, d_ff)
        self.wo, self.bo = param(e, d_ff, d_model), param(e, d_model)

    def flax_init_(self, generator: torch.Generator) -> None:
        """The reference's initializers: router and wi normal with
        standard deviation 1/sqrt(D), wo 1/sqrt(F), the biases zero."""
        d, f = self.wi.shape[1:]
        with torch.no_grad():
            for w, std in ((self.router, d ** -0.5), (self.wi, d ** -0.5),
                           (self.wo, f ** -0.5)):
                w.copy_(torch.randn(w.shape, generator=generator) * std)
            self.bi.zero_()
            self.bo.zero_()


class GPTModule(nn.Module):
    """GPT parameters (f32, like flax's) plus the dense inference forward.

    device=None means CUDA and raises where no CUDA device exists; pass
    device="cpu" to run on the CPU. ``dtype`` is the compute dtype;
    ``dropout`` applies in the training forward only. ``n_experts`` > 0
    makes every block's FFN a mixture of experts (top-``MOE_K`` routing at
    ``CAPACITY_FACTOR``), which the serving programs refuse.

    ``seq_axis`` (the rank grid's ``"seq"``) makes the training forward
    (``logits``) sequence-parallel: x is this rank's [B, T/n] block,
    positions are offset by the seq index, attention is the causal flash
    ring (``seq_impl="ring"``) or Ulysses, and the logits are the block's;
    an MoE block routes the block's tokens. The dense inference forward
    and the serving programs stay dense.

    ``ep_axis`` (the rank grid's ``"expert"``) runs every MoE block's
    experts split over the expert axis: ``ep_impl="replicated"`` routes
    the same tokens on every rank of the axis and sums the ranks' partial
    outputs (``ep_partial_ffn``); ``"alltoall"`` routes each rank's 1/n
    of the tokens and exchanges slot payloads with the experts' ranks
    (``ep_alltoall_ffn``; the reference's forward paths' route). The
    experts must divide over the axis. An unknown ``ep_impl`` raises on
    every path of an MoE module, as the reference's does.

    ``tp_axis`` (the rank grid's ``"model"``) makes the training forward
    tensor-parallel over the model axis (module docstring), with the
    GSPMD route's per-block ``tp_plan`` or, without one, every pair
    split; the parameters stay whole on every rank, and the dense
    inference forward and the serving programs stay dense.
    """

    def __init__(self, vocab_size: int = 8192, max_len: int = 512,
                 hidden: int = 256, layers: int = 4, heads: int = 4,
                 ffn: int = 1024, dropout: float = 0.1,
                 dtype: torch.dtype = torch.bfloat16,
                 device: DeviceLike = None, n_experts: int = 0,
                 seq_axis: Optional[str] = None, seq_impl: str = "ring",
                 ep_axis: Optional[str] = None,
                 ep_impl: str = "replicated", tp_axis: Optional[str] = None,
                 tp_plan: Optional[dict] = None):
        super().__init__()
        if hidden % heads:
            raise ValueError(f"hidden {hidden} does not split over "
                             f"{heads} heads")
        if seq_impl not in ("ring", "ulysses"):
            raise ValueError(f"unknown seq_impl {seq_impl!r}; expected "
                             "'ring' or 'ulysses'")
        self.seq_axis, self.seq_impl = seq_axis, seq_impl
        self.ep_axis, self.ep_impl = ep_axis, ep_impl
        self.tp_axis, self.tp_plan = tp_axis, tp_plan
        self.vocab_size, self.max_len = vocab_size, max_len
        self.hidden, self.layers, self.heads = hidden, layers, heads
        self.ffn, self.dtype, self.dropout = ffn, dtype, float(dropout)
        self.n_experts = n_experts
        self.head_dim = hidden // heads
        dev = resolve_device(device)
        self.tok_embed = nn.Embedding(vocab_size, hidden, device=dev)
        self.pos_embed = nn.Embedding(max_len, hidden, device=dev)
        self.blocks = nn.ModuleList(
            DecoderBlock(hidden, heads, ffn, dev, n_experts)
            for _ in range(layers))
        self.ln_f = nn.LayerNorm(hidden, eps=LN_EPS, device=dev)

    @property
    def device(self) -> torch.device:
        return self.tok_embed.weight.device

    @torch.no_grad()
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Dense causal forward (inference): int token ids [B, T], pad id
        0 -> [B, T, vocab] f32 logits."""
        B, T = x.shape
        if T > self.max_len:
            raise InferenceInputError(
                f"sequence length {T} exceeds max_len {self.max_len}")
        p = compute_params(self)
        x = x.to(self.device)
        pad_mask = (x != PAD_ID).float()
        h = p["tok_embed"][x] \
            + p["pos_embed"][torch.arange(T, device=x.device)][None]
        bias = composed_bias(pad_mask, causal=True, T=T)
        for lp in p["layers"]:
            h = _block(lp, h, lambda q, k, v: multi_head_attention(
                q, k, v, bias), pad_mask=pad_mask, aux=[])
        return _lm_head(p, h)

    def logits(self, x: torch.Tensor, train: bool = False,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Differentiable dense causal forward — the reference module's
        ``__call__(x, train)``: int ids [B, T] (pad id 0) -> [B, T, vocab]
        f32 logits. The f32 parameters are cast to the compute dtype at
        use, so they get f32 gradients; attention is
        ``masked_attention(causal=True)`` (the flash kernels on the card);
        with ``train`` dropout follows the embeddings, the attention
        out-projection and the FFN, drawn from ``generator``."""
        return self.logits_and_aux(x, train, generator)[0]

    def logits_and_aux(self, x: torch.Tensor, train: bool = False,
                       generator: Optional[torch.Generator] = None):
        """``logits`` and the list of the MoE blocks' load-balance aux
        losses, one a layer (empty for a dense module) — what the
        reference's blocks sow into 'intermediates'."""
        B, T = x.shape
        n = 1 if self.seq_axis is None else dist_lib.axis_size(self.seq_axis)
        if T * n > self.max_len:
            raise InferenceInputError(
                f"sequence length {T * n} exceeds max_len {self.max_len}")
        check_tp(self)
        x = x.to(self.device)
        named = dict(self.named_parameters())
        p = _param_tree(self, lambda name, dtype: named[name].to(dtype),
                        tp=True)
        rate = self.dropout if train else 0.0
        seq = None
        if self.seq_axis is not None:
            seq = (self.seq_axis, self.seq_impl)
            generator = seq_draw(generator, self.seq_axis, T)
        h, aux = _causal_trunk(p, x, lambda t: _dropout(t, rate, generator),
                               seq)
        return _lm_head(p, h), aux


def check_tp(module) -> None:
    """The reference's refusals of a tensor-parallel module (a GPT or
    BERT module with ``tp_axis``), in its order: heads or an FFN width
    that does not divide over the model axis (the manual route: no
    ``tp_plan``); Ulysses, which re-shards the head axis the split owns;
    a mixture of experts."""
    if module.tp_axis is None:
        return
    if module.tp_plan is None:
        validate_tp_geometry(module.heads, module.ffn,
                             dist_lib.axis_size(module.tp_axis))
    if module.seq_axis is not None and module.seq_impl == "ulysses":
        raise ValueError(
            "tensor parallelism composes with seq_impl='ring' only "
            "(ulysses re-shards the head axis the TP split owns)")
    if getattr(module, "n_experts", 0):
        raise ValueError("manual TP does not apply to MoE blocks "
                         "(experts shard over the expert axis instead — "
                         "ep_axis)")


def tp_layer(module, i: int, out_bias: torch.Tensor,
             fc1_bias: torch.Tensor) -> Optional[dict]:
    """Block i's tensor-parallel entry of its parameter dict (None for a
    module without ``tp_axis``): the model axis, which of its pairs split
    ("heads", "ffn": the plan's, or both without one) and the row
    layers' f32 biases, which the reference adds after the sum."""
    if module.tp_axis is None:
        return None
    split = {"heads": True, "ffn": True} if module.tp_plan is None \
        else module.tp_plan[f"layer_{i}"]
    return {"axis": module.tp_axis, "heads": bool(split["heads"]),
            "ffn": bool(split["ffn"]), "out_bias": out_bias,
            "fc1_bias": fc1_bias}


def seq_draw(generator, axis_name: str, T: int):
    """The dropout generator of a seq rank holding a [B, T] block: the
    uniforms of the whole sequence drawn and this rank's block kept, so
    sequence-parallel training drops what the dense forward drops."""
    n = dist_lib.axis_size(axis_name)
    if n == 1 or not isinstance(generator, torch.Generator):
        return generator
    i = dist_lib.axis_index(axis_name)
    return RowDraw(generator, slice(i * T, (i + 1) * T), n * T, axis=1)


def seq_attention(axis_name: str, impl: str, pos: torch.Tensor,
                  pad_mask: torch.Tensor, causal: bool):
    """The sequence-parallel attention of a block over [B, T/n, H, D]
    projections: the flash ring (positions ``pos``) or Ulysses."""
    if impl == "ulysses":
        return lambda q, k, v: ulysses_attention(
            q, k, v, pad_mask, causal=causal, axis_name=axis_name)
    use_flash = ring_flash_eligible(pos.shape[0])
    return lambda q, k, v: ring_attention(
        q, k, v, q_pos=pos, kv_pos=pos, kv_mask=pad_mask, causal=causal,
        axis_name=axis_name, use_flash=use_flash)


def _causal_trunk(p: dict, x: torch.Tensor,
                  drop: Callable[[torch.Tensor], torch.Tensor] = lambda t: t,
                  seq: Optional[tuple] = None) -> tuple:
    """The reference module's ``__call__`` up to the final LayerNorm:
    embeddings of [B, T] ids (pad id 0) and the blocks, attention through
    ``masked_attention(causal=True)`` (the flash kernels on the card) with
    the pads masked as keys -> ([B, T, hidden], the MoE blocks' aux
    losses, one a layer). ``drop`` is the training forward's dropout.
    With ``seq`` = (axis name, impl), x is this rank's block of the
    sequence: positions start at seq index x T and attention is
    ``seq_attention``'s."""
    pad_mask = (x != PAD_ID).float()
    T = x.shape[1]
    if seq is None:
        pos_embed = p["pos_embed"][:T]
        attend = lambda q, k, v: masked_attention(  # noqa: E731
            q, k, v, pad_mask, causal=True)
    else:
        pos = dist_lib.axis_index(seq[0]) * T \
            + torch.arange(T, device=x.device)
        pos_embed = p["pos_embed"][pos]
        attend = seq_attention(*seq, pos, pad_mask, causal=True)
    h = drop(p["tok_embed"][x] + pos_embed[None])
    aux: list = []
    for lp in p["layers"]:
        h = _block(lp, h, attend, drop, pad_mask, aux)
    return h, aux


def compute_params(module: GPTModule,
                   state_dict: Optional[Dict[str, torch.Tensor]] = None,
                   ) -> dict:
    """The serving programs' parameter dict, on the module's device:
    embeddings and Dense weights cast to the compute dtype, LayerNorm
    parameters in f32. ``state_dict`` (the module's own by default) is
    what a weight load or a hot swap hands in."""
    sd = module.state_dict() if state_dict is None else state_dict
    dev = module.device
    return _param_tree(module, lambda name, dtype: sd[name].detach().to(
        device=dev, dtype=dtype).contiguous())


def _param_tree(module: GPTModule,
                get: Callable[[str, torch.dtype], torch.Tensor],
                tp: bool = False) -> dict:
    """The programs' parameter dict, each tensor ``get(name, dtype)``:
    embeddings and Dense weights in the compute dtype, LayerNorm
    parameters in f32. An MoE block's parameters stay f32: the reference
    runs its router and experts on the f32 LayerNorm output; its expert
    axis and strategy ride along (``ep``), ``ep_impl`` checked here, on
    every path, as the reference's ``MoEFFN`` checks it at every call.
    ``tp``: the training forward of a tensor-parallel module, whose
    blocks carry their ``tp_layer`` entry."""
    dt = module.dtype
    if module.n_experts and module.ep_impl not in ("replicated", "alltoall"):
        raise ValueError(f"unknown ep_impl {module.ep_impl!r}; "
                         "expected 'replicated' or 'alltoall'")

    def t(name, dtype=dt):
        return get(name, dtype)

    def lin(prefix):
        return t(f"{prefix}.weight"), t(f"{prefix}.bias")

    def ln(prefix):
        return (t(f"{prefix}.weight", torch.float32),
                t(f"{prefix}.bias", torch.float32))

    layers = []
    for i in range(module.layers):
        b = f"blocks.{i}"
        lp = {"ln0": ln(f"{b}.ln0"), "q": lin(f"{b}.q"), "k": lin(f"{b}.k"),
              "v": lin(f"{b}.v"), "out": lin(f"{b}.out"),
              "ln1": ln(f"{b}.ln1"), "heads": module.heads}
        if module.n_experts:
            lp["moe"] = {n: t(f"{b}.moe.{n}", torch.float32)
                         for n in ("router", "wi", "bi", "wo", "bo")}
            lp["ep"] = (module.ep_axis, module.ep_impl)
        else:
            lp["fc0"], lp["fc1"] = lin(f"{b}.fc0"), lin(f"{b}.fc1")
        if tp and module.tp_axis is not None:
            lp["tp"] = tp_layer(module, i, t(f"{b}.out.bias", torch.float32),
                                t(f"{b}.fc1.bias", torch.float32))
        layers.append(lp)
    return {"tok_embed": t("tok_embed.weight"),
            "pos_embed": t("pos_embed.weight"),
            "ln_f": ln("ln_f"), "layers": layers}


def _layer_norm(x: torch.Tensor, w: torch.Tensor,
                b: torch.Tensor) -> torch.Tensor:
    """flax LayerNorm(dtype=f32): f32 statistics with the fast variance
    E[x^2] - E[x]^2 clipped at 0, then (x - mean) * (rsqrt(var + eps) *
    scale) + bias."""
    x = x.float()
    mean = x.mean(-1, keepdim=True)
    var = torch.clamp((x * x).mean(-1, keepdim=True) - mean * mean, min=0.0)
    mul = torch.rsqrt(var + LN_EPS) * w
    return (x - mean) * mul + b


def _dense(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """flax Dense/DenseGeneral in the compute dtype: the product rounded
    to that dtype, then the bias added and rounded again. F.linear's
    fused bias rounds once, which in bf16 differs from the reference."""
    return F.linear(x, w) + b


def _block(lp: dict, h: torch.Tensor,
           attend: Callable[[torch.Tensor, torch.Tensor, torch.Tensor],
                            torch.Tensor],
           drop: Callable[[torch.Tensor], torch.Tensor] = lambda t: t,
           pad_mask: Optional[torch.Tensor] = None,
           aux: Optional[list] = None) -> torch.Tensor:
    """One pre-LN decoder block. ``attend(q, k, v)`` maps [B, T, H, Dh]
    projections to the [B, T, H, Dh] attention output — the dense
    forward attends within the window, the paged steps write K/V into
    the slab and read it back through the page table. ``drop`` is the
    training forward's dropout after the out-projection and the FFN.

    An MoE block (``lp["moe"]``) routes the [B·T] tokens of the f32
    LayerNorm output, the pads of ``pad_mask`` [B, T] left out, runs its
    experts in f32 (over the expert axis of ``lp["ep"]`` when it names
    one: ``_moe_expert_parallel``) and appends its load-balance aux to
    ``aux``; its f32 output makes the residual stream f32 from there on,
    as the reference's type promotion does.

    A tensor-parallel block (``lp["tp"]``, ``tp_layer``) runs each pair
    the entry splits through ``parallel/manual.py``'s layers over its
    model axis: ``attend`` then sees this rank's heads / n heads."""
    dt = lp["q"][0].dtype
    H = lp["heads"]
    tp = lp.get("tp")
    x = _layer_norm(h, *lp["ln0"]).to(dt)
    if tp is not None and tp["heads"]:
        q, k, v = (tp_heads_dense(x, *lp[n], H, tp["axis"])
                   for n in ("q", "k", "v"))
        out = tp_out_dense(attend(q, k, v), lp["out"][0], tp["out_bias"],
                           tp["axis"])
    else:
        q, k, v = (_dense(x, *lp[n]).unflatten(-1, (H, -1))
                   for n in ("q", "k", "v"))
        out = _dense(attend(q, k, v).flatten(-2), *lp["out"])
    h = h + drop(out)
    if "moe" in lp:
        x = _layer_norm(h, *lp["ln1"])
        axis, impl = lp["ep"]
        if axis is None:
            y, a = moe_apply(lp["moe"], x.flatten(0, 1), k=MOE_K,
                             capacity_factor=CAPACITY_FACTOR,
                             token_mask=pad_mask.flatten())
        else:
            y, a = _moe_expert_parallel(lp["moe"], x.flatten(0, 1),
                                        pad_mask.flatten(), axis, impl)
        aux.append(a)
        return h + drop(y.view_as(x))
    x = _layer_norm(h, *lp["ln1"]).to(dt)
    if tp is not None and tp["ffn"]:
        x = F.gelu(tp_column_dense(x, *lp["fc0"], tp["axis"]),
                   approximate="tanh")
        return h + drop(tp_row_dense(x, lp["fc1"][0], tp["fc1_bias"],
                                     tp["axis"]))
    x = F.gelu(_dense(x, *lp["fc0"]), approximate="tanh")
    return h + drop(_dense(x, *lp["fc1"]))


def _moe_expert_parallel(moe: dict, x: torch.Tensor,
                         token_mask: torch.Tensor, axis_name: str,
                         impl: str) -> tuple:
    """An MoE block's experts over the expert axis ``axis_name`` (the
    reference's ``MoEFFN`` with ``ep_axis``) -> (y [T, D], aux).
    "replicated": the shared routing preamble on this rank's tokens, then
    ``ep_partial_ffn``. "alltoall": this rank routes its contiguous 1/n
    of the tokens (per-shard capacity, the aux averaged over the axis so
    it stays the same on every rank), ``ep_alltoall_ffn`` runs the slots
    through their experts' ranks, and the ranks' outputs are gathered
    back into the whole token set."""
    e, n = moe["wi"].shape[0], dist_lib.axis_size(axis_name)
    if e % n:
        raise ValueError(f"{e} experts do not divide over a {n}-way "
                         "expert axis")
    if impl == "alltoall":
        t = x.shape[0]
        if t % n:
            raise ValueError(f"{t} tokens do not divide over a {n}-way "
                             "expert axis (ep_impl='alltoall')")
        rows = slice(dist_lib.axis_index(axis_name) * (t // n),
                     (dist_lib.axis_index(axis_name) + 1) * (t // n))
        x_local = x[rows]
        dispatch, combine, aux = route_tokens(
            moe["router"], x_local, k=MOE_K, capacity_factor=CAPACITY_FACTOR,
            token_mask=token_mask[rows])
        aux = dist_lib.psum(aux, axis_name) / n
        y_local = ep_alltoall_ffn(moe["wi"], moe["bi"], moe["wo"], moe["bo"],
                                  dispatch, combine, x_local, axis_name,
                                  dtype=x.dtype)
        return all_gather(y_local, axis_name), aux
    dispatch, combine, aux = route_tokens(
        moe["router"], x, k=MOE_K, capacity_factor=CAPACITY_FACTOR,
        token_mask=token_mask)
    y = ep_partial_ffn(moe["wi"], moe["bi"], moe["wo"], moe["bo"], dispatch,
                       combine, x, axis_name, dtype=x.dtype)
    return y, aux


def _fold(key: int, data: int) -> int:
    """A 64-bit seed from a 64-bit key and a count (jax.random's fold_in,
    through numpy's SeedSequence)."""
    return int(np.random.SeedSequence(
        [key & 0xFFFFFFFF, key >> 32, int(data)]).generate_state(
            1, np.uint64)[0])


def pp_stage(rate: float, causal: bool, moe: bool) -> Callable:
    """The pipelined trunk's stage function (``pp_trunk``):
    stage_fn(stage_layers, act, (mask, key)) runs ``stage_layers``
    (``_param_tree``'s per-block dicts: the stage's blocks [s·L/P,
    (s+1)·L/P)) over one [B/M, T, D] microbatch ``act``, attention under
    its pad ``mask`` (``causal`` or not), dropout at ``rate`` from a
    generator per (microbatch ``key``, global block); a block's output
    cast back to the activation's dtype (an MoE block's is f32), as the
    reference's stage carries it. Returns the activation, and with
    ``moe`` the blocks' aux summed."""
    def stage_fn(stage_layers, act, const):
        mask, key = const
        first = dist_lib.axis_index(STAGE_AXIS) * len(stage_layers)
        attend = lambda q, k, v: masked_attention(  # noqa: E731
            q, k, v, mask, causal=causal)
        aux: list = []
        for i, lp in enumerate(stage_layers):
            gen = None
            if key is not None:
                gen = torch.Generator(device=act.device).manual_seed(
                    _fold(key, first + i))
            act = _block(lp, act, attend,
                         lambda t, g=gen: _dropout(t, rate, g), mask,
                         aux).to(act.dtype)
        return (act, sum(aux)) if moe else act
    return stage_fn


def pp_keys(generator, microbatches: int, rate: float) -> list:
    """One dropout key a microbatch: the step generator's key
    (``generator.initial_seed()``: the engine seeds it from the step's key
    data) folded with the microbatch, as the reference splits one key a
    microbatch; None each at rate 0."""
    if rate == 0.0:
        return [None] * microbatches
    return [_fold(generator.initial_seed(), j) for j in range(microbatches)]


def pp_trunk(layers: list, h: torch.Tensor, pad_mask: torch.Tensor,
             generator, rate: float, causal: bool, microbatches: int,
             moe: bool) -> tuple:
    """The reference's pipelined trunk: the [B, T, D] activation cut into
    ``microbatches`` contiguous [B/M, T, D] microbatches through the
    blocks ``layers`` (``pp_stage``'s stage function; the microbatch's
    pad mask and dropout key as its consts), over the current grid's
    stage axis (``parallel/pp.pipeline_lane``: this stage runs blocks
    [s·L/P, (s+1)·L/P)) or, without one, ``parallel/pp.sequential_apply``
    of one stage of every block. The dropout draws depend on the
    microbatch and the global block only: the same on every stage rank
    and at every P. -> ([B, T, D], the MoE blocks' aux summed over every
    block and microbatch; 0.0 for a dense trunk)."""
    n = dist_lib.axis_size(STAGE_AXIS)
    if len(layers) % n:
        raise ValueError(f"{len(layers)} layers do not split over a "
                         f"{n}-stage axis")
    M = microbatches
    B, T, D = h.shape
    stage_fn = pp_stage(rate, causal, moe)
    hm = h.reshape(M, B // M, T, D)
    consts = (pad_mask.reshape(M, B // M, T), pp_keys(generator, M, rate))
    if n == 1:
        out = sequential_apply(stage_fn, stack_stage_params([layers]), hm,
                               has_aux=moe, consts=consts)
        ys, aux = out if moe else (out, 0.0)
    else:
        per = len(layers) // n
        sid = dist_lib.axis_index(STAGE_AXIS)
        ys, aux = pipeline_lane(stage_fn, layers[sid * per:(sid + 1) * per],
                                hm, has_aux=moe, consts=consts)
    return ys.reshape(B, T, D), aux if moe else 0.0


def _lm_head(p: dict, h: torch.Tensor) -> torch.Tensor:
    """Final LayerNorm and the weight-tied head, logits as f32."""
    emb = p["tok_embed"]
    h = _layer_norm(h, *p["ln_f"]).to(emb.dtype)
    return (h @ emb.t()).float()


def _check_servable(kv_dtype: str) -> bool:
    if kv_dtype not in _KV_DTYPES:
        raise ValueError(
            f"kv_dtype must be one of {_KV_DTYPES}, got {kv_dtype!r}")
    return kv_dtype == "int8"


def _int8_write_decode(pages, scales, layer, rows, write_page, write_off):
    """Quantize-on-write of one layer's decode rows [S, H, Dh] (f32) into
    int8 pages with per-page symmetric scales (scale = amax/127, value =
    q * scale), updating ``pages``/``scales`` in place.

    A page's scale is the running amax of its written rows: each write
    maxes the row's amax into the stored scale and requantizes the
    page's existing rows under the new scale (factor = old/new <= 1).
    write_off == 0 resets the scale first (pages always fill from row 0,
    so offset 0 is a first write — this also clears a reused page's
    stale scale). Inactive lanes point at null page 0, offset 0."""
    old = scales[layer, write_page]
    old = torch.where(write_off == 0, torch.zeros_like(old), old)
    amax = rows.abs().amax(dim=(1, 2))
    new = torch.maximum(old, amax / 127.0)
    pos = new > 0
    safe = torch.where(pos, new, torch.ones_like(new))
    factor = torch.where(pos, old / safe, torch.zeros_like(new))
    requant = torch.round(pages[layer, write_page].float()
                          * factor[:, None, None, None])
    pages[layer, write_page] = requant.to(torch.int8)
    qrow = torch.clamp(torch.round(rows / safe[:, None, None]), -127, 127)
    pages[layer, write_page, write_off] = qrow.to(torch.int8)
    scales[layer, write_page] = new


def _int8_write_prefill(pages, scales, layer, rows, write_pages,
                        write_offs, in_chunk):
    """Chunked twin of _int8_write_decode: C rows [C, H, Dh] (f32) land
    across up to two pages per chunk. Per-page amaxes accumulate with a
    scatter-max; the reset rule applies per page when any row of the
    chunk writes its offset 0. The requant writes identical bytes for
    duplicate page indices (the factor depends on the page alone)."""
    base = scales[layer]
    reset = torch.zeros_like(base).scatter_reduce(
        0, write_pages, (write_offs == 0).float() * in_chunk, reduce="amax")
    base = torch.where(reset > 0, torch.zeros_like(base), base)
    amax = rows.abs().amax(dim=(1, 2)) * in_chunk
    new = base.scatter_reduce(0, write_pages, amax / 127.0, reduce="amax")
    pos = new > 0
    safe = torch.where(pos, new, torch.ones_like(new))
    factor = torch.where(pos, base / safe, torch.zeros_like(new))
    requant = torch.round(pages[layer, write_pages].float()
                          * factor[write_pages][:, None, None, None])
    pages[layer, write_pages] = requant.to(torch.int8)
    qrows = torch.clamp(torch.round(rows / safe[write_pages][:, None, None]),
                        -127, 127)
    pages[layer, write_pages, write_offs] = qrows.to(torch.int8)
    scales[layer] = new


def _write_kv(slab, layer, k, v, pages_idx, offs, quantized, in_chunk=None):
    """Write one layer's new K/V rows ([N, H, Dh]) into the slab, in
    place (the reference returns new arrays; the port updates the slab
    tensors instead, which keeps device memory flat)."""
    if quantized:
        if in_chunk is None:
            _int8_write_decode(slab.k, slab.k_scale, layer, k.float(),
                               pages_idx, offs)
            _int8_write_decode(slab.v, slab.v_scale, layer, v.float(),
                               pages_idx, offs)
        else:
            _int8_write_prefill(slab.k, slab.k_scale, layer, k.float(),
                                pages_idx, offs, in_chunk)
            _int8_write_prefill(slab.v, slab.v_scale, layer, v.float(),
                                pages_idx, offs, in_chunk)
    else:
        slab.k[layer, pages_idx, offs] = k.to(slab.k.dtype)
        slab.v[layer, pages_idx, offs] = v.to(slab.v.dtype)


def _sample(logits: torch.Tensor, temps: np.ndarray,
            key_data: np.ndarray) -> torch.Tensor:
    """Next-token picks [S]: greedy where temps <= 0, else a Gumbel-max
    draw over logits/temp from a Philox generator seeded by the row's
    (request seed, position) key — so a request's tokens never depend on
    the rows it shares a batch with. (jax.random's threefry stream cannot
    be reproduced, so sampled tokens differ from the JAX package's.)"""
    nxt = torch.argmax(logits, dim=-1)
    for s in np.flatnonzero(temps > 0):
        gen = torch.Generator(device=logits.device)
        gen.manual_seed((int(key_data[s, 0]) << 32) | int(key_data[s, 1]))
        u = torch.rand(logits.shape[-1], generator=gen,
                       device=logits.device)
        u = u.clamp_min(torch.finfo(torch.float32).tiny)
        gumbel = -torch.log(-torch.log(u))
        nxt[s] = torch.argmax(logits[s] / float(temps[s]) + gumbel)
    return nxt


def build_paged_decode_step(module: GPTModule, kv_dtype: str = "f32"):
    """One-token-per-slot decode step over the paged KV slab — the
    serving plane's persistent program (serve/engine.py):

      step(params, slab, tokens[S], pos[S], page_tables[S, Pmax],
           write_page[S], write_off[S], active[S], temps[S] (host),
           key_data[S, 2] (host), copy_src[S], copy_dst[S], poison[S])
        -> (next_tokens[S], bad[S]); the slab is updated in place.

    Every per-request quantity is data: inactive slots compute garbage
    rows whose K/V land on the null page 0 with validity 0. Each active
    slot consumes its token at position pos and gets its next-token pick.

    copy_src/copy_dst are the prefix cache's copy-on-write lane: before
    anything else, page copy_src[s] is duplicated into copy_dst[s] (K,
    V, scales, validity); 0 -> 0 is a null-page no-op. All sources are
    gathered before any destination is written, as the reference's
    functional update does.

    bad[S] is the on-device non-finite guard: 1.0 for an active row
    whose logits went non-finite (checked before the never-emit-PAD mask
    puts a legitimate -inf in every row); flagged rows are zeroed before
    sampling and their pick forced to 0. poison[S] forces a row
    non-finite through the same guard (fault injection).

    Slots are rows: no reduction crosses slots, which is what makes a
    request's tokens the same alone or in a batch.
    """
    if module.n_experts or module.seq_axis is not None \
            or module.tp_axis is not None:
        raise ValueError(
            "paged decode serves dense GPT modules only (no MoE, "
            "sequence-parallel, or manual-TP variants)")
    quantized = _check_servable(kv_dtype)
    dtype = module.dtype

    def step(params, slab, tokens, pos, page_tables, write_page, write_off,
             active, temps, key_data, copy_src, copy_dst, poison):
        S = tokens.shape[0]
        G = slab.valid.shape[1]
        C = page_tables.shape[1] * G
        for t in (slab.k, slab.v, slab.k_scale, slab.v_scale):
            t[:, copy_dst] = t[:, copy_src]     # right side gathers first
        slab.valid[copy_dst] = slab.valid[copy_src]
        h = (params["tok_embed"][tokens] + params["pos_embed"][pos])[:, None]
        # this token's validity lands BEFORE the context read, so a
        # slot's first token attends to itself
        slab.valid[write_page, write_off] = active * (tokens != PAD_ID).float()
        ctx_valid = slab.valid[page_tables].reshape(S, C)
        causal = (torch.arange(C, device=pos.device)[None, :]
                  <= pos[:, None]).float()
        bias = ((1.0 - ctx_valid * causal) * NEG_INF)[:, None, None, :]
        for i, lp in enumerate(params["layers"]):
            def attend(q, k, v, i=i):
                _write_kv(slab, i, k[:, 0], v[:, 0], write_page, write_off,
                          quantized)
                return paged_attention(
                    q, slab.k[i], slab.v[i], slab.k_scale[i],
                    slab.v_scale[i], page_tables, bias, quantized=quantized,
                    compute_dtype=dtype)
            h = _block(lp, h, attend)
        logits = _lm_head(params, h)[:, 0]
        logits = torch.where(poison[:, None] > 0,
                             torch.full_like(logits, float("nan")), logits)
        bad = active * (~torch.isfinite(logits).all(dim=-1)).float()
        logits = torch.where(bad[:, None] > 0, torch.zeros_like(logits),
                             logits)
        logits[:, PAD_ID] = -float("inf")   # never emit PAD
        nxt = _sample(logits, temps, key_data)
        nxt = torch.where(bad > 0, torch.zeros_like(nxt), nxt)
        return nxt, bad

    return step


def build_paged_prefill_step(module: GPTModule, chunk: int,
                             kv_dtype: str = "f32"):
    """Chunked prefill over the paged KV slab: C prompt tokens of ONE slot
    per call (the serving plane's second program):

      prefill(params, slab, tokens[C], pos[C], page_table[Pmax],
              write_pages[C], write_offs[C], in_chunk[C])
        -> None; the slab is updated in place.

    The chunk size is fixed; prompts shorter than C pad the tail with
    in_chunk = 0 rows whose writes land on the null page with validity 0.
    No logits: the LAST prompt token always goes through the decode step,
    which samples the first output. Chunk K/V and validity are written
    before the context read, and the bias keeps kv position j for query
    position p iff valid[j] and j <= p — the mask the decode step
    applies one row at a time.
    """
    if chunk < 1:
        raise ValueError(f"prefill chunk must be >= 1, got {chunk}")
    if module.n_experts or module.seq_axis is not None \
            or module.tp_axis is not None:
        raise ValueError(
            "paged prefill serves dense GPT modules only (no MoE, "
            "sequence-parallel, or manual-TP variants)")
    quantized = _check_servable(kv_dtype)
    dtype = module.dtype

    def prefill(params, slab, tokens, pos, page_table, write_pages,
                write_offs, in_chunk):
        G = slab.valid.shape[1]
        C = page_table.shape[0] * G
        h = (params["tok_embed"][tokens] + params["pos_embed"][pos])[None]
        slab.valid[write_pages, write_offs] = \
            in_chunk * (tokens != PAD_ID).float()
        ctx_valid = slab.valid[page_table].reshape(C)
        causal = (torch.arange(C, device=pos.device)[None, :]
                  <= pos[:, None]).float()                  # [chunk, C]
        bias = ((1.0 - ctx_valid[None, :] * causal) * NEG_INF)[None, None]
        tables = page_table[None]
        for i, lp in enumerate(params["layers"]):
            def attend(q, k, v, i=i):
                _write_kv(slab, i, k[0], v[0], write_pages, write_offs,
                          quantized, in_chunk=in_chunk)
                return paged_attention(
                    q, slab.k[i], slab.v[i], slab.k_scale[i],
                    slab.v_scale[i], tables, bias, quantized=quantized,
                    compute_dtype=dtype)
            h = _block(lp, h, attend)

    return prefill


def build_paged_multi_step_decode(module: GPTModule, steps: int,
                                  kv_dtype: str = "f32"):
    """K decode steps per call — the serving plane's third program, used
    only in the all-decode steady state (serve/engine.py):

      multi(params, slab, tokens[S], pos[S], page_tables[S, Pmax],
            live[S], temps[S], seeds[S], eos_ids[S], budgets[S])
        -> (out_tokens[K, S], out_bad[K, S]) on the device; the slab is
            updated in place.

    The inputs are host arrays, sent once; each lane's token, position,
    ``live`` flag and emitted count then stay on the device for all K
    steps, so nothing is read back inside the call. Each step calls the
    single step of ``build_paged_decode_step`` with the inputs the
    engine's host loop would give it: write page and offset from the page
    table and position, the (seed, position) sampling key (built on the
    host: a lane's key for step j is (seed, pos + j)). A lane that ends
    inside the call (EOS, its token budget, or the non-finite guard)
    drops its ``live`` flag, and every later step presents it as an
    unoccupied slot (token 0, position 0, a write to the null page,
    active 0); its sampled picks are discarded by the host, like an
    inactive slot's. eos_ids holds -1 for requests without an EOS id;
    budgets holds each lane's remaining token budget. Bit-identity with K
    single calls follows from row independence: every live row sees
    exactly the single step's inputs.
    """
    steps = int(steps)
    if steps < 2:
        raise ValueError(
            f"multi-step decode needs steps >= 2 (1 is the single-step "
            f"program), got {steps}")
    step = build_paged_decode_step(module, kv_dtype)

    def multi(params, slab, tokens, pos, page_tables, live, temps, seeds,
              eos_ids, budgets):
        dev = slab.valid.device
        S = tokens.shape[0]
        G = slab.valid.shape[1]
        Pmax = page_tables.shape[1]
        rows = torch.arange(S, device=dev)
        zero = torch.zeros(S, dtype=torch.long, device=dev)
        zero_f = torch.zeros(S, dtype=torch.float32, device=dev)
        tables = _to_device(page_tables, dev)
        tok_d, pos_d, live_d, eos_d, budget_d = _to_device(np.stack(
            [tokens, pos, live, eos_ids, budgets]).astype(np.int64), dev)
        emitted = torch.zeros_like(live_d)
        out_tokens, out_bad = [], []
        for j in range(steps):
            on = live_d > 0
            pi = torch.clamp(pos_d // G, 0, Pmax - 1)
            write_page = torch.where(on, tables[rows, pi].long(), zero)
            write_off = torch.where(on, pos_d % G, zero)
            key_data = np.stack([seeds, (pos + j).astype(np.uint32)], 1)
            nxt, bad = step(params, slab, torch.where(on, tok_d, zero),
                            torch.where(on, pos_d, zero), tables,
                            write_page, write_off, live_d.float(), temps,
                            key_data, zero, zero, zero_f)
            emitted = emitted + live_d
            done = ((nxt == eos_d) & (eos_d >= 0)) | (emitted >= budget_d) \
                | (bad > 0)
            tok_d = torch.where(on, nxt, tok_d)
            pos_d = torch.where(on, pos_d + 1, pos_d)
            live_d = live_d * (~done).long()
            out_tokens.append(nxt)
            out_bad.append(bad)
        return torch.stack(out_tokens), torch.stack(out_bad)

    return multi


def build_paged_spec_verify_step(module: GPTModule, draft_module: GPTModule,
                                 steps: int, window: int,
                                 kv_dtype: str = "f32"):
    """Draft-propose + target-verify + rollback-replay in ONE call — the
    serving plane's fourth program (serve/engine.py):

      verify(params, draft_params, slab, window_toks[S, W], pos[S],
             page_tables[S, Pmax], live[S], temps[S], seeds[S], wlen[S])
        -> (picks[K+1, S], bads[K+1, S], accepted[S]) on the device; the
            slab is updated in place.

    window_toks[s, :pos[s]+1] is slot s's whole context (prompt + emitted
    tokens); wlen[s] = min(K+1, remaining budget) caps the verify steps of
    lane s. The inputs are host arrays, sent once. The stateless draft
    re-forwards the whole window for each of its K greedy proposals (PAD
    never proposed) through ``_causal_trunk``, whose attention is the
    flash forward on the card; it keeps no KV cache, so a rejection needs
    no draft rollback.

    The target runs the single step of ``build_paged_decode_step`` twice
    over the K+1 teacher-forced inputs (the real token at pos, then the
    proposals). Pass 1 runs every step j < wlen on the live slab (its
    writes feed the window's later steps) and keeps the picks; the pages
    it can write — each lane's pages under positions pos..pos+K, and the
    null page 0 — are saved first and restored after it, so the slab is
    back to its state before the call (a copy of (K+1)·S+1 pages, not of
    the pool). ``accepted`` is the length of the longest prefix whose
    target picks equal the proposals (non-finite rows end it), clamped
    to wlen - 1. Pass 2 replays the steps j <= accepted on
    the live slab, so the slab ends holding exactly the writes of a run
    that never proposed — int8 scales included, which requantize on
    every write and so cannot be restored row by row: acceptance is a
    prefix and the causal mask hides later positions, so each accepted
    step sees the same context in both passes. Emitted tokens are always
    the target's picks under the (seed, position) keys, so the output
    equals the non-speculative run at any temperature. Pass 2's picks are
    never used, so it samples nothing (greedy picks, discarded), and its
    mask comes from the device's ``accepted`` with no read between the
    passes.
    """
    steps = int(steps)
    window = int(window)
    if steps < 1:
        raise ValueError(f"speculative decode needs steps >= 1, "
                         f"got {steps}")
    if not isinstance(draft_module, GPTModule) or draft_module.n_experts \
            or draft_module.seq_axis is not None \
            or draft_module.tp_axis is not None:
        raise ValueError(
            "speculative draft must be a dense GPT module (no MoE, "
            "sequence-parallel, or manual-TP variants)")
    if draft_module.vocab_size != module.vocab_size:
        raise ValueError(
            f"draft vocab ({draft_module.vocab_size}) must match the "
            f"target vocab ({module.vocab_size})")
    if window < 2 or window > module.max_len \
            or window > draft_module.max_len:
        raise ValueError(
            f"verify window must be in [2, min(target max_len "
            f"{module.max_len}, draft max_len {draft_module.max_len})], "
            f"got {window}")
    step = build_paged_decode_step(module, kv_dtype)

    def verify(params, draft_params, slab, window_toks, pos, page_tables,
               live, temps, seeds, wlen):
        dev = slab.valid.device
        S, W = window_toks.shape
        G = slab.valid.shape[1]
        Pmax = page_tables.shape[1]
        rows = torch.arange(S, device=dev)
        zero = torch.zeros(S, dtype=torch.long, device=dev)
        zero_f = torch.zeros(S, dtype=torch.float32, device=dev)
        tables = _to_device(page_tables, dev)
        win = _to_device(window_toks.astype(np.int64), dev)
        pos_d, live_d, wlen_d = _to_device(
            np.stack([pos, live, wlen]).astype(np.int64), dev)

        # the draft proposes K tokens, greedy, re-forwarding the window
        draft_win = win.clone()
        props = []
        for i in range(1, steps + 1):
            h = _causal_trunk(draft_params, draft_win)[0]
            at = torch.clamp(pos_d + i - 1, 0, W - 1)
            lg = _lm_head(draft_params, h[rows, at][:, None])[:, 0]
            lg[:, PAD_ID] = -float("inf")
            d = torch.argmax(lg, dim=-1)
            draft_win[rows, torch.clamp(pos_d + i, 0, W - 1)] = d
            props.append(d)
        proposals = torch.stack(props)                       # [K, S]
        inputs = torch.cat([win[rows, torch.clamp(pos_d, 0, W - 1)][None],
                            proposals])                      # [K+1, S]

        def run_pass(target, keep, temps_of):
            # keep(j): lane liveness at verify step j (device); a masked
            # lane presents the unoccupied-slot inputs
            picks, bads = [], []
            for j in range(steps + 1):
                on_i = keep(j)
                on = on_i > 0
                posj = pos_d + j
                pi = torch.clamp(posj // G, 0, Pmax - 1)
                write_page = torch.where(on, tables[rows, pi].long(), zero)
                write_off = torch.where(on, posj % G, zero)
                key_data = np.stack([seeds, (pos + j).astype(np.uint32)], 1)
                nxt, bad = step(params, target,
                                torch.where(on, inputs[j], zero),
                                torch.where(on, posj, zero), tables,
                                write_page, write_off, on_i.float(),
                                temps_of(j), key_data, zero, zero, zero_f)
                picks.append(nxt)
                bads.append(bad)
            return torch.stack(picks), torch.stack(bads)

        # pass 1: verify on the live slab — all wlen steps write — with
        # every page it can write saved before and restored after
        span = torch.arange(steps + 1, device=dev)
        pi = torch.clamp((pos_d[:, None] + span) // G, 0, Pmax - 1)
        touched = torch.cat([zero[:1], tables[rows[:, None], pi].long()
                             .flatten()])
        saved = _save_pages(slab, touched)
        picks, bads = run_pass(
            slab, lambda j: live_d * (j < wlen_d).long(),
            lambda j: np.where((live > 0) & (j < wlen), temps,
                               0.0).astype(np.float32))
        _restore_pages(slab, touched, saved)
        ok = ((picks[:steps] == proposals)
              & (bads[:steps] == 0)).long()                  # [K, S]
        accepted = torch.cumprod(ok, dim=0).sum(dim=0)
        accepted = torch.clamp(torch.minimum(accepted, wlen_d - 1),
                               min=0) * live_d
        # pass 2: rollback as replay — only steps <= accepted write
        no_temps = np.zeros(S, np.float32)
        run_pass(slab,
                 lambda j: live_d * ((j < wlen_d)
                                     & (j <= accepted)).long(),
                 lambda j: no_temps)
        return picks, bads, accepted

    return verify


def _to_device(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


def _save_pages(slab, pages: torch.Tensor) -> tuple:
    """Copies of the slab's K, V, scales and validity at ``pages`` (a
    page may repeat)."""
    return (slab.k[:, pages], slab.v[:, pages], slab.k_scale[:, pages],
            slab.v_scale[:, pages], slab.valid[pages])


def _restore_pages(slab, pages: torch.Tensor, saved: tuple) -> None:
    """Write ``_save_pages``' copies back; a repeated page gets the same
    bytes from each of its copies."""
    k, v, k_scale, v_scale, valid = saved
    slab.k[:, pages] = k
    slab.v[:, pages] = v
    slab.k_scale[:, pages] = k_scale
    slab.v_scale[:, pages] = v_scale
    slab.valid[pages] = valid


# ------------------------------------------------------------------ training
def _shift_targets(x: torch.Tensor):
    """(targets, token_mask) for next-token prediction on [B, T] ids:
    position t predicts x[:, t+1]; a position counts iff it and its
    target are real (non-pad) tokens; the last position has no target."""
    targets = torch.cat([x[:, 1:], torch.full_like(x[:, :1], PAD_ID)], 1)
    mask = ((x != PAD_ID) & (targets != PAD_ID)).float()
    return targets, mask


def _token_nll(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """optax.softmax_cross_entropy_with_integer_labels per token [B, T]:
    logsumexp of the f32 logits minus the target's logit."""
    return F.cross_entropy(logits.flatten(0, 1), targets.flatten().long(),
                           reduction="none").view(targets.shape)


def _lm_per_example(logits: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Per-sequence mean next-token cross-entropy [B] — the LM loss."""
    targets, tok_mask = _shift_targets(x)
    per_tok = _token_nll(logits, targets)
    return (per_tok * tok_mask).sum(1) / tok_mask.sum(1).clamp_min(1.0)


def _shift_targets_sp(x_local: torch.Tensor, axis_name: str):
    """Sequence-parallel _shift_targets on a rank's [B, T/n] block: the
    block's last position targets the NEXT rank's first token, fetched
    with one ring hop; the global last position (the last rank's last
    column) keeps the dense semantics and is masked out."""
    n = dist_lib.axis_size(axis_name)
    idx = dist_lib.axis_index(axis_name)
    nxt_first = dist_lib.ring_shift(x_local[:, :1].contiguous(), axis_name,
                                    offset=-1)
    targets = torch.cat([x_local[:, 1:], nxt_first], 1)
    mask = ((x_local != PAD_ID) & (targets != PAD_ID)).float()
    if idx == n - 1:
        mask[:, -1] = 0.0
    return targets, mask


def _lm_per_example_sp(logits: torch.Tensor, x_local: torch.Tensor,
                       axis_name: str) -> torch.Tensor:
    """Sequence-parallel _lm_per_example: the per-sequence mean reduces
    over the whole sequence through sums over the seq group of the
    block's token-loss sum and count, so every seq rank holds the dense
    loss (``psum``: its backward sums the cotangents)."""
    targets, tok_mask = _shift_targets_sp(x_local, axis_name)
    per_tok = _token_nll(logits, targets)
    num = dist_lib.psum((per_tok * tok_mask).sum(1), axis_name)
    den = dist_lib.psum(tok_mask.sum(1), axis_name)
    return num / den.clamp_min(1.0)


def _forward_seq_parallel(module, x, grid, impl: str, forward,
                          gather: bool = True):
    """The models' ``forward_seq_parallel``: ``forward(module, block)`` of
    this rank's [B, T/n] block of the [B, T] ids in seq mode, no grad,
    the blocks' outputs gathered along T (``gather``) or returned as
    they are (an output already equal on every seq rank)."""
    if impl not in ("ring", "ulysses"):
        raise ValueError(f"unknown seq-parallel impl {impl!r}; "
                         "expected 'ring' or 'ulysses'")
    grid = dist_lib.current_grid() if grid is None \
        else dist_lib.make_grid(grid.n_seq, grid.n_expert, grid.n_model)
    n = grid.n_seq
    x = torch.as_tensor(np.asarray(x), device=module.device)
    if x.shape[1] % n:
        raise ValueError(f"sequence length {x.shape[1]} not divisible by "
                         f"the seq-axis size {n}")
    # the reference's module.clone(seq_axis=..., seq_impl=...), on the
    # same parameters
    dense = (module.seq_axis, module.seq_impl)
    module.seq_axis, module.seq_impl = SEQ_AXIS, impl
    try:
        with torch.no_grad():
            out = forward(module, _seq_block(x, n, grid.seq_index))
    finally:
        module.seq_axis, module.seq_impl = dense
    return gather_seq(out, grid) if gather else out


@register_model("gpt-mini")
class GPTMini(KubeModel):
    """~6M-param decoder-only LM (4 layers x 256 hidden x 4 heads),
    dropout 0.1. ``loss`` returns one value per sequence (the mean over
    its real next-token positions), so the K-avg engine treats a
    sequence as the reference treats one sample."""

    name = "gpt-mini"

    def __init__(self, dtype: torch.dtype = torch.bfloat16):
        self.dtype = dtype   # compute dtype of the modules it builds

    # sequence parallelism: the seq-carrying batch key and its dim (the
    # base enable_seq_parallel makes build() give seq-parallel modules)
    seq_batch_dims = {"x": 0}
    # tensor parallelism: the Megatron table (the decoder blocks have the
    # BERT blocks' layout)
    tp_rules = TRANSFORMER_TP_RULES

    def build(self, dtype: Optional[torch.dtype] = None,
              device: DeviceLike = None) -> GPTModule:
        return GPTModule(**GPT_CONFIGS[self.name],
                         dropout=GPT_DROPOUT[self.name],
                         dtype=dtype or self.dtype, device=device,
                         seq_axis=self.seq_axis, seq_impl=self.seq_impl,
                         tp_axis=self.tp_axis, tp_plan=self.tp_plan)

    def params_to_flax(self, state):
        return params_to_flax(state, heads=GPT_CONFIGS[self.name]["heads"])

    def params_from_flax(self, params):
        return params_from_flax(params)

    # pipeline parallelism: the decoder blocks are a uniform trunk
    # (KubeModel.enable_pipeline_parallel)
    pipeline_trunk = True

    def loss(self, module, batch, generator, sample_mask):
        x = batch["x"].to(module.device)
        if self._pp_microbatches:
            return self._pp_forward_loss(module, x, generator)
        logits = module.logits(x, train=True, generator=generator)
        if module.seq_axis is not None:
            return _lm_per_example_sp(logits, x, module.seq_axis)
        return _lm_per_example(logits, x)

    def _pp_forward_loss(self, module, x, generator) -> torch.Tensor:
        """The pipelined per-sequence loss (the reference's
        ``_pp_forward_loss``): the embeddings and their dropout (drawn
        from the step's ``generator``, as the dense path draws them), the
        blocks through ``pp_trunk`` in ``_pp_microbatches`` microbatches,
        the final LayerNorm, the head and the LM loss on every stage; an
        MoE trunk adds ``aux_coef`` times its aux over layers x
        microbatches, the pipelined analog of the dense loss's mean over
        the layers."""
        B, T = x.shape
        if T > module.max_len:
            raise InferenceInputError(
                f"sequence length {T} exceeds max_len {module.max_len}")
        M = self._pp_microbatches
        if B % M:
            raise ValueError(f"batch {B} not divisible by {M} microbatches")
        named = dict(module.named_parameters())
        p = _param_tree(module, lambda name, dtype: named[name].to(dtype))
        pad_mask = (x != PAD_ID).float()
        rate = module.dropout
        h = _dropout(p["tok_embed"][x] + p["pos_embed"][:T][None], rate,
                     generator)
        h, aux = pp_trunk(p["layers"], h, pad_mask, generator, rate, True,
                          M, bool(module.n_experts))
        per_ex = _lm_per_example(_lm_head(p, h), x)
        if module.n_experts:
            per_ex = per_ex + self.aux_coef * aux / (module.layers * M)
        return per_ex

    def metrics(self, module, batch):
        x = batch["x"].to(module.device)
        axis = module.seq_axis
        with torch.no_grad():
            logits = module.logits(x)
            if axis is not None:
                targets, tok_mask = _shift_targets_sp(x, axis)
            else:
                targets, tok_mask = _shift_targets(x)
            per_tok = _token_nll(logits, targets)
            hit = (logits.argmax(-1) == targets).float()
            sums = torch.stack([(per_tok * tok_mask).sum(1),
                                (hit * tok_mask).sum(1), tok_mask.sum(1)])
            if axis is not None:
                sums = dist_lib.psum(sums, axis)
        denom = sums[2].clamp_min(1.0)
        return {"loss": sums[0] / denom, "accuracy": sums[1] / denom}

    def forward_seq_parallel(self, module, x, grid=None,
                             impl: str = "ring") -> torch.Tensor:
        """The causal forward over the rank grid's seq axis (the
        reference's over its mesh): every rank of a seq group passes the
        same [B, T] ids (T divisible by n), runs its [B, T/n] block with
        ``module``'s parameters (the dense module: the same parameters)
        and gets the full [B, T, vocab] f32 logits, equal to the dense
        forward. ``grid``: a ``distributed.make_grid`` grid (None: the
        current one; n = 1 without a group)."""
        return _forward_seq_parallel(module, x, grid, impl,
                                     lambda m, xb: m.logits(xb))

    def forward_pipelined(self, module, x, grid=None, microbatches: int = 4):
        """The causal forward with the blocks pipelined over the rank
        grid's stage axis (the reference's over its mesh): every rank of a
        stage group passes the same pad-free [B, T] ids (B divisible by
        ``microbatches``) and gets the [B, T, vocab] f32 logits, no grad,
        with ``module``'s parameters. An MoE trunk routes each
        microbatch on its own (per-microbatch capacity, the reference's
        pipelined semantics) and returns (logits, aux), the aux over
        layers x microbatches; over a grid's expert axis its experts
        split under the module's ``ep_impl`` ("replicated" or
        "alltoall"). ``grid``: a ``distributed.make_grid`` grid (None: the
        current one; one stage without a group). The reference's guards,
        in its order: an expert axis without experts, layers that do not
        split over the stages, a batch that does not split into the
        microbatches, T > max_len, padded rows."""
        grid = dist_lib.current_grid() if grid is None \
            else dist_lib.make_grid(grid.n_seq, grid.n_expert, grid.n_model,
                                    grid.n_stage)
        if grid.n_expert > 1 and not module.n_experts:
            raise ValueError("the mesh has an expert axis but the model "
                             "has no experts")
        if grid.n_expert > 1 and module.n_experts % grid.n_expert:
            # the blocks' own refusal, raised here on every rank alike: a
            # stage that raised inside the trunk would leave the others
            # waiting at its hops
            raise ValueError(f"{module.n_experts} experts do not divide "
                             f"over a {grid.n_expert}-way expert axis")
        L = module.layers
        if L % grid.n_stage:
            raise ValueError(f"{L} layers do not split over a "
                             f"{grid.n_stage}-stage axis")
        x = torch.as_tensor(np.asarray(x), device=module.device)
        B, T = x.shape
        M = microbatches
        if B % M:
            raise ValueError(f"batch {B} not divisible by {M} microbatches")
        if T > module.max_len:
            raise ValueError(f"sequence length {T} exceeds max_len "
                             f"{module.max_len}")
        if bool((x == PAD_ID).any()):
            raise ValueError("forward_pipelined requires pad-free rows "
                             "(the pipelined trunk runs without a pad "
                             "mask); use the dense forward for padded "
                             "batches")
        moe = bool(module.n_experts)
        # the reference's block built with the grid's expert axis, on the
        # same parameters
        dense = module.ep_axis
        module.ep_axis = EXPERT_AXIS if grid.n_expert > 1 else None
        try:
            with torch.no_grad():
                p = compute_params(module)
                h = p["tok_embed"][x] + p["pos_embed"][:T][None]
                h, aux = pp_trunk(p["layers"], h,
                                  torch.ones(B, T, device=x.device), None,
                                  0.0, True, M, moe)
                logits = _lm_head(p, h)
        finally:
            module.ep_axis = dense
        return (logits, aux / (L * M)) if moe else logits

    def configure_optimizers(self, lr, epoch):
        """The reference's ``optax.adamw(lr, weight_decay=0.01)`` as
        ``torch.optim.AdamW(lr, betas=(0.9, 0.999), eps=1e-8,
        weight_decay=0.01)``: the same update — decoupled weight decay on
        every parameter (optax's default mask is None), bias-corrected
        moments, eps outside the square root — in another rounding
        order."""
        return functools.partial(torch.optim.AdamW, lr=lr,
                                 betas=(0.9, 0.999), eps=1e-8,
                                 weight_decay=0.01)


@register_model("gpt-nano")
class GPTNano(GPTMini):
    """~60k-param 2-layer LM, dropout 0 — the CPU tier's model, same
    architecture and parameter names as gpt-mini."""

    name = "gpt-nano"


@register_model("gpt-moe-mini")
class GPTMoEMini(GPTMini):
    """gpt-mini with a mixture-of-experts FFN in every block: 8 experts of
    a 512-wide FFN, top-2 GShard routing at capacity factor 1.25
    (``parallel/ep.py``), the same attention stack, dropout and AdamW.
    Every sequence's loss adds ``aux_coef`` times the mean over the
    layers of the load-balance aux (under a seq axis the mean of the seq
    ranks' per-shard aux, as the reference's).

    Its parallel paths: ``enable_seq_parallel`` (the dense family's: each
    seq rank routes its own block of the sequence, per-shard capacity),
    ``enable_expert_parallel`` (the experts split over the rank grid's
    expert axis, alone or with a seq or a stage axis),
    ``enable_pipeline_parallel`` (the dense family's: routing capacity
    per microbatch, the aux over layers x microbatches),
    ``forward_seq_parallel`` and ``forward_pipelined`` (the dense
    family's). The reference's ``ep_mesh`` takes a JAX ``Mesh``, which
    has no counterpart here (ROADMAP C.13): its GSPMD route and its
    manual one are both the port's expert axis."""

    name = "gpt-moe-mini"
    aux_coef = 0.01
    # the Megatron table would split only the attention stack while the
    # expert FFNs (the bulk of the parameters) stay replicated
    tp_rules = None
    #: the expert axis and strategy the modules build with
    #: (``enable_expert_parallel``); None = every expert on each rank
    ep_axis: Optional[str] = None
    ep_impl: str = "replicated"

    def __init__(self, dtype: torch.dtype = torch.bfloat16, ep_mesh=None):
        if ep_mesh is not None:
            raise ValueError(
                "gpt-moe-mini's ep_mesh takes a JAX Mesh, which has no "
                "counterpart in kubeml_tpu_torch (ROADMAP C.13): split "
                "the experts over the rank grid's expert axis with "
                "--expert-parallel E (model.enable_expert_parallel())")
        super().__init__(dtype)

    def build(self, dtype: Optional[torch.dtype] = None,
              device: DeviceLike = None) -> GPTModule:
        return GPTModule(**GPT_MOE_CONFIG, dropout=GPT_DROPOUT["gpt-mini"],
                         dtype=dtype or self.dtype, device=device,
                         seq_axis=self.seq_axis, seq_impl=self.seq_impl,
                         ep_axis=self.ep_axis, ep_impl=self.ep_impl)

    def params_to_flax(self, state):
        return params_to_flax(state, heads=GPT_MOE_CONFIG["heads"])

    def loss(self, module, batch, generator, sample_mask):
        x = batch["x"].to(module.device)
        if self._pp_microbatches:
            # the pipelined trunk folds the aux into its loss
            return self._pp_forward_loss(module, x, generator)
        logits, aux = module.logits_and_aux(x, train=True,
                                            generator=generator)
        mean_aux = sum(aux) / max(1, module.layers)
        axis = module.seq_axis
        if axis is None:
            return _lm_per_example(logits, x) + self.aux_coef * mean_aux
        # the per-shard aux averaged over the seq group, so the loss is
        # the same on every seq rank
        mean_aux = dist_lib.psum(mean_aux, axis) / dist_lib.axis_size(axis)
        return _lm_per_example_sp(logits, x, axis) + self.aux_coef * mean_aux

    def enable_expert_parallel(self) -> None:
        """Build the modules with the experts split over the rank grid's
        expert axis (the job calls it for ``--expert-parallel`` > 1; it
        composes with ``enable_seq_parallel``), with the reference's
        refusals: a module without experts, an ``ep_impl`` other than
        ``'replicated'`` (the training round's sum over the axis is what
        keeps the loss the same on every expert rank)."""
        if not self.build(device="meta").n_experts:
            super().enable_expert_parallel()
        if self.ep_impl != "replicated":
            raise ValueError(
                "the expert-parallel training round requires "
                "ep_impl='replicated' (the expert psum keeps the loss "
                "expert-axis-invariant); ep_impl='alltoall' serves the "
                "pipelined and forward paths only")
        self.ep_axis = EXPERT_AXIS

    def enable_tensor_parallel(self) -> None:
        raise ValueError(
            "gpt-moe-mini does not support tensor parallelism (the "
            "Megatron split would leave the expert FFNs — the bulk of the "
            "params — replicated); use expert parallelism (ep_mesh) for "
            "this family")
