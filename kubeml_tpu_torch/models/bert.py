"""BERT-tiny encoder for sequence classification (twin of
kubeml_tpu/models/bert.py; SST-2, BASELINE config 5): 2 layers, hidden
128, 2 heads of 64, FFN 512, dropout 0.1, bf16 matmuls over f32
parameters, f32 LayerNorm and logits.

The encoder block is the GPT family's pre-LN block (``models/gpt.py``
``_block``: the same parameter names, LayerNorm with epsilon 1e-6 and
flax's variance, tanh GELU, dropout after the out-projection and the
FFN), with attention through ``masked_attention(causal=False)`` under
the [B, T] keep-mask ``x != 0``: the non-causal flash kernels on the
card. After the blocks come the final LayerNorm, the keep-mask mean-pool
(``max(den, 1)``, so an all-pad row pools to 0 and stays finite) and the
classifier.

State names follow GPTModule's (``tok_embed``, ``pos_embed``,
``blocks.i.{ln0,q,k,v,out,ln1,fc0,fc1}``, ``ln_f``) plus ``classifier``;
``convert.bert_params_{to,from}_flax`` map them onto the flax tree.

Sequence parallelism (``seq_axis``, ``seq_impl``, ``enable_seq_parallel``,
``forward_seq_parallel``) runs over the rank grid's seq axis: each rank
holds a [B, T/n] block, positions are offset by its seq index, attention
is the non-causal flash ring or Ulysses, and the mean-pool sums its
numerator and count over the seq group (``psum``), after which the
classifier's logits are equal on every seq rank.

Tensor parallelism (``tp_axis``, ``tp_plan``, ``enable_tensor_parallel``)
runs every encoder block's Megatron pairs over the rank grid's model axis
as the GPT block does (``models/gpt.py``: the heads split, non-causal
attention on the local heads, the out-projection and the FFN's second
Dense summed over the axis), alone or with the seq axis's ring; the
parameters stay whole. Pipeline parallelism (``enable_pipeline_parallel``)
runs the encoder blocks as the GPT family's pipelined trunk
(``models/gpt.pp_trunk``, not causal) over the rank grid's stage axis;
the embeddings, the final LayerNorm, the masked mean-pool and the
classifier run on every stage.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional

import torch
from torch import nn

from kubeml_tpu_torch._device import DeviceLike, resolve_device
from kubeml_tpu_torch.convert import (bert_params_from_flax,
                                      bert_params_to_flax)
from kubeml_tpu_torch.models.base import (PAD_ID, ClassifierModel,
                                          InferenceInputError,
                                          register_model)
from kubeml_tpu_torch.models.gpt import (LN_EPS, DecoderBlock, _block,
                                         _forward_seq_parallel, _layer_norm,
                                         check_tp, pp_trunk, seq_attention,
                                         seq_draw, tp_layer)
from kubeml_tpu_torch.models.layers import Dense, _dropout
from kubeml_tpu_torch.ops.attention import masked_attention
from kubeml_tpu_torch.parallel import distributed as dist_lib
from kubeml_tpu_torch.parallel.tp import TRANSFORMER_TP_RULES

HEADS = 2   # BERT-tiny's attention heads (restores the flax q/k/v layout)


class EncoderBlock(DecoderBlock):
    """One pre-LN encoder block: the GPT block's parameters and math
    with non-causal attention under the keep-mask."""

    def __init__(self, hidden: int, heads: int, ffn: int, dropout: float,
                 dtype: torch.dtype, device: torch.device):
        super().__init__(hidden, heads, ffn, device)
        self.heads, self.dropout, self.dtype = heads, float(dropout), dtype

    def forward(self, h: torch.Tensor, pad_mask: torch.Tensor,
                train: bool = False, generator=None, attend=None,
                tp: Optional[dict] = None) -> torch.Tensor:
        """[B, T, hidden] -> [B, T, hidden]; ``pad_mask`` [B, T] 1/0 keeps
        the real tokens as keys; with ``train`` dropout is drawn from
        ``generator``. ``attend(q, k, v)`` replaces the dense attention
        (the sequence-parallel one); ``tp`` is the block's
        tensor-parallel entry (``models/gpt.tp_layer``)."""
        lp = self.layer_params()
        if tp is not None:
            lp["tp"] = tp
        rate = self.dropout if train else 0.0
        if attend is None:
            attend = lambda q, k, v: masked_attention(  # noqa: E731
                q, k, v, pad_mask, causal=False)
        return _block(lp, h, attend, lambda t: _dropout(t, rate, generator))

    def layer_params(self) -> dict:
        """The block's parameter dict for ``models/gpt._block``: Dense
        weights cast to the compute dtype, LayerNorm parameters f32."""
        dt = self.dtype

        def lin(m):
            return m.weight.to(dt), m.bias.to(dt)

        return {"ln0": (self.ln0.weight, self.ln0.bias), "q": lin(self.q),
                "k": lin(self.k), "v": lin(self.v), "out": lin(self.out),
                "ln1": (self.ln1.weight, self.ln1.bias), "fc0": lin(self.fc0),
                "fc1": lin(self.fc1), "heads": self.heads}


class BertModule(nn.Module):
    """BERT-tiny's parameters (f32) and its classifier forward.

    ``device=None`` means CUDA and raises where no CUDA device exists;
    ``dtype`` is the compute dtype. ``seq_axis`` (the rank grid's
    ``"seq"``) and ``seq_impl`` ("ring" or "ulysses") select the
    sequence-parallel forward; ``tp_axis`` (the rank grid's
    ``"model"``) and ``tp_plan`` the tensor-parallel one (module
    docstring)."""

    def __init__(self, vocab_size: int = 30522, max_len: int = 128,
                 hidden: int = 128, layers: int = 2, heads: int = HEADS,
                 ffn: int = 512, num_classes: int = 2, dropout: float = 0.1,
                 dtype: torch.dtype = torch.bfloat16,
                 device: DeviceLike = None, seq_axis: Optional[str] = None,
                 seq_impl: str = "ring", tp_axis: Optional[str] = None,
                 tp_plan: Optional[dict] = None):
        super().__init__()
        if seq_impl not in ("ring", "ulysses"):
            raise ValueError(f"unknown seq_impl {seq_impl!r}; expected "
                             "'ring' or 'ulysses'")
        if hidden % heads:
            raise ValueError(f"hidden {hidden} does not split over "
                             f"{heads} heads")
        self.vocab_size, self.max_len = vocab_size, max_len
        self.hidden, self.layers, self.heads = hidden, layers, heads
        self.ffn, self.num_classes = ffn, num_classes
        self.dtype, self.dropout = dtype, float(dropout)
        self.seq_axis, self.seq_impl = seq_axis, seq_impl
        self.tp_axis, self.tp_plan = tp_axis, tp_plan
        self.head_dim = hidden // heads
        dev = resolve_device(device)
        self.tok_embed = nn.Embedding(vocab_size, hidden, device=dev)
        self.pos_embed = nn.Embedding(max_len, hidden, device=dev)
        self.blocks = nn.ModuleList(
            EncoderBlock(hidden, heads, ffn, dropout, dtype, dev)
            for _ in range(layers))
        self.ln_f = nn.LayerNorm(hidden, eps=LN_EPS, device=dev)
        self.classifier = Dense(hidden, num_classes, dtype=dtype,
                                device=dev)

    @property
    def device(self) -> torch.device:
        return self.tok_embed.weight.device

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        """int token ids [B, T] (pad id 0, T <= max_len) -> [B, classes]
        f32 logits; differentiable; with ``train`` dropout follows the
        embeddings, each attention out-projection and each FFN, drawn
        from ``generator``. With ``seq_axis`` x is this rank's [B, T/n]
        block of the sequence and the logits are the whole sequence's,
        equal on every seq rank. With ``tp_axis`` the blocks run over the
        model axis; the logits are equal on every model rank."""
        check_tp(self)
        B, T = x.shape
        axis = self.seq_axis
        n = 1 if axis is None else dist_lib.axis_size(axis)
        if T * n > self.max_len:
            # a ValueError the serving layer answers with a 4xx
            raise InferenceInputError(
                f"sequence length {T * n} exceeds max_len {self.max_len}")
        x = x.to(self.device)
        pad_mask = (x != PAD_ID).float()
        dt = self.dtype
        rate = self.dropout if train else 0.0
        attend = None
        if axis is None:
            pos_embed = self.pos_embed.weight[:T]
        else:
            pos = dist_lib.axis_index(axis) * T \
                + torch.arange(T, device=x.device)
            pos_embed = self.pos_embed.weight[pos]
            attend = seq_attention(axis, self.seq_impl, pos, pad_mask,
                                   causal=False)
            generator = seq_draw(generator, axis, T)
        # gather the f32 rows, then cast: the values of flax's Embed, which
        # casts the whole table to the compute dtype before the take
        h = self.tok_embed.weight[x].to(dt) + pos_embed.to(dt)[None]
        h = _dropout(h, rate, generator)
        for i, blk in enumerate(self.blocks):
            h = blk(h, pad_mask, train, generator, attend,
                    tp_layer(self, i, blk.out.bias, blk.fc1.bias))
        return self._head(h, pad_mask)

    def _head(self, h: torch.Tensor, pad_mask: torch.Tensor) -> torch.Tensor:
        """The final LayerNorm, the keep-mask mean-pool (its sums over the
        seq group under a seq axis: the logits after it are the same on
        every seq rank) and the classifier -> [B, classes] f32."""
        h = _layer_norm(h, self.ln_f.weight, self.ln_f.bias)
        num = (h * pad_mask[..., None]).sum(1)
        den = pad_mask.sum(1)
        if self.seq_axis is not None:
            num = dist_lib.psum(num, self.seq_axis)
            den = dist_lib.psum(den, self.seq_axis)
        pooled = num / den.clamp_min(1.0)[..., None]
        return self.classifier(pooled).float()

    def pipelined_logits(self, x: torch.Tensor, generator,
                         microbatches: int) -> torch.Tensor:
        """The reference's pipelined classifier forward
        (``BertTiny._pp_forward_loss`` up to the loss): the embeddings and
        their dropout (from the step's ``generator``), the encoder blocks
        through ``models/gpt.pp_trunk`` (not causal) in ``microbatches``
        microbatches, then the head on every stage -> [B, classes] f32."""
        B, T = x.shape
        if T > self.max_len:
            raise InferenceInputError(
                f"sequence length {T} exceeds max_len {self.max_len}")
        if B % microbatches:
            raise ValueError(
                f"batch {B} not divisible by {microbatches} microbatches")
        x = x.to(self.device)
        pad_mask = (x != PAD_ID).float()
        dt = self.dtype
        h = self.tok_embed.weight[x].to(dt) \
            + self.pos_embed.weight[:T].to(dt)[None]
        h = _dropout(h, self.dropout, generator)
        h, _ = pp_trunk([blk.layer_params() for blk in self.blocks], h,
                        pad_mask, generator, self.dropout, False,
                        microbatches, False)
        return self._head(h, pad_mask)


@register_model("bert-tiny")
class BertTiny(ClassifierModel):
    """BERT-tiny sequence classifier over {'x': int ids [B, T], 'y':
    labels}: per-example cross-entropy, AdamW with weight decay 0.01."""

    name = "bert-tiny"
    num_classes = 2
    # sequence parallelism over the token dim of 'x' (the base
    # enable_seq_parallel makes build() give seq-parallel modules); the
    # per-example loss is seq-invariant: the module sums its mean-pool
    # over the seq group
    seq_batch_dims = {"x": 0}
    # tensor parallelism: the Megatron table over the encoder blocks
    tp_rules = TRANSFORMER_TP_RULES
    # pipeline parallelism: the encoder blocks are a uniform trunk
    pipeline_trunk = True

    def __init__(self, dtype: torch.dtype = torch.bfloat16):
        self.dtype = dtype   # compute dtype of the modules it builds

    def build(self, dtype: Optional[torch.dtype] = None,
              device: DeviceLike = None) -> BertModule:
        return BertModule(num_classes=self.num_classes,
                          dtype=dtype or self.dtype, device=device,
                          seq_axis=self.seq_axis, seq_impl=self.seq_impl,
                          tp_axis=self.tp_axis, tp_plan=self.tp_plan)

    def loss(self, module, batch, generator, sample_mask):
        if self._pp_microbatches:
            logits = module.pipelined_logits(
                batch["x"], generator, self._pp_microbatches)
        else:
            logits = module(batch["x"], train=True, generator=generator)
        return torch.nn.functional.cross_entropy(
            logits, batch["y"].to(logits.device).long(), reduction="none")

    def configure_optimizers(self, lr, epoch):
        """The reference's ``optax.adamw(lr, weight_decay=0.01)``, as
        GPTMini's: decoupled decay on every parameter, eps 1e-8 outside
        the square root."""
        return functools.partial(torch.optim.AdamW, lr=lr,
                                 betas=(0.9, 0.999), eps=1e-8,
                                 weight_decay=0.01)

    def params_to_flax(self, state: Dict[str, torch.Tensor]) -> dict:
        return bert_params_to_flax(state, heads=HEADS)

    def params_from_flax(self, params: dict) -> Dict[str, torch.Tensor]:
        return bert_params_from_flax(params)

    def forward_seq_parallel(self, module, x, grid=None,
                             impl: str = "ring") -> torch.Tensor:
        """The classifier's forward over the rank grid's seq axis: every
        rank of a seq group passes the same [B, T] ids (T divisible by
        n) and gets the [B, classes] f32 logits, equal to the dense
        forward, from its [B, T/n] block and ``module``'s parameters.
        ``grid``: a ``distributed.make_grid`` grid (None: the current
        one; n = 1 without a group)."""
        return _forward_seq_parallel(module, x, grid, impl,
                                     lambda m, xb: m(xb), gather=False)
