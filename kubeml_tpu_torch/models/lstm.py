"""2-layer LSTM text classifier (twin of kubeml_tpu/models/lstm.py;
AG-News, BASELINE config 4): vocab 32000, embed 128, hidden 256, 2
layers, 4 classes, bf16 compute over f32 parameters, f32 logits, Adam.

The math is flax 0.12's ``nn.RNN(nn.OptimizedLSTMCell)`` as the
reference module calls it:
  - the carry (c, h) starts at f32 zeros; each step the four gates'
    input kernels and the four hidden kernels run as one bf16 product
    each (flax concatenates them), the hidden product's bias added in
    bf16, the two sums added in bf16; i, f, o = sigmoid, g = tanh (bf16);
    c' = f*c + i*g and h' = o*tanh(c') promote to f32, so the carry and
    the layer's outputs stay f32;
  - the recurrence runs over all T steps, pads included: the reference
    passes ``seq_lengths``, which flax uses only with ``return_carry`` or
    ``reverse``, neither of which the module sets. Only the mean-pool
    masks the pads (``x != 0``, ``max(den, 1)``).
No TPU kernel covers the recurrence (the reference runs it as a
``lax.scan``): the port runs it as a loop over T of ``torch.matmul`` and
elementwise ops, with the input projection of all T steps in one matmul
before the loop.

Submodules carry the flax names, so a state name is the flax path:
``Embed_0``, ``OptimizedLSTMCell_{i}.{ii,if,ig,io}`` (input kernels, no
bias) and ``.{hi,hf,hg,ho}`` (hidden kernels and biases), ``Dense_0``
(``convert.lstm_params_{to,from}_flax``). flax creates the cells in the
classifier's scope, so they sit at the top of the tree, not under the
``lstm_{i}`` RNN wrappers.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from kubeml_tpu_torch._device import DeviceLike, resolve_device
from kubeml_tpu_torch.convert import (lstm_params_from_flax,
                                      lstm_params_to_flax)
from kubeml_tpu_torch.models.base import (PAD_ID, ClassifierModel,
                                          flax_default_init_,
                                          register_model)
from kubeml_tpu_torch.models.layers import Dense

GATES = "ifgo"   # flax's gate order in the concatenated kernels


class OptimizedLSTMCell(nn.Module):
    """The parameters of one flax ``OptimizedLSTMCell``: per gate an input
    kernel ``i<gate>`` (no bias) and a hidden kernel ``h<gate>`` with its
    bias, as [out, in] Linear weights."""

    def __init__(self, in_features: int, hidden: int, device: torch.device):
        super().__init__()
        self.hidden = hidden
        for g in GATES:
            self.add_module(f"i{g}", nn.Linear(in_features, hidden,
                                               bias=False, device=device))
            self.add_module(f"h{g}", nn.Linear(hidden, hidden,
                                               device=device))

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """The recurrence over [B, T, in] inputs -> [B, T, hidden] f32
        outputs, computing in ``dtype``."""
        sub = self._modules
        wi = torch.cat([sub[f"i{g}"].weight for g in GATES]).to(dtype)
        wh = torch.cat([sub[f"h{g}"].weight for g in GATES]).to(dtype)
        bh = torch.cat([sub[f"h{g}"].bias for g in GATES]).to(dtype)
        B, T, _ = x.shape
        H = self.hidden
        zi = F.linear(x.to(dtype), wi)                  # [B, T, 4H]
        c = torch.zeros((B, H), device=x.device)
        h = torch.zeros((B, H), device=x.device)
        outs = []
        for t in range(T):
            z = (F.linear(h.to(dtype), wh) + bh) + zi[:, t]
            gates = torch.sigmoid(z)
            i, f, o = gates[:, :H], gates[:, H:2 * H], gates[:, 3 * H:]
            g = torch.tanh(z[:, 2 * H:3 * H])
            c = f.float() * c + (i * g).float()
            h = o.float() * torch.tanh(c)
            outs.append(h)
        return torch.stack(outs, 1)


class LSTMClassifierModule(nn.Module):
    """Embedding -> ``num_layers`` LSTM layers -> masked mean-pool ->
    ``Dense_0``; int ids [B, T] (pad id 0) -> [B, classes] f32 logits.
    ``device=None`` means CUDA; ``dtype`` is the compute dtype."""

    def __init__(self, vocab_size: int = 32000, embed_dim: int = 128,
                 hidden_dim: int = 256, num_layers: int = 2,
                 num_classes: int = 4, dtype: torch.dtype = torch.bfloat16,
                 device: DeviceLike = None):
        super().__init__()
        dev = resolve_device(device)
        self.dtype, self.num_layers = dtype, num_layers
        self.Embed_0 = nn.Embedding(vocab_size, embed_dim, device=dev)
        for i in range(num_layers):
            self.add_module(f"OptimizedLSTMCell_{i}", OptimizedLSTMCell(
                embed_dim if i == 0 else hidden_dim, hidden_dim, dev))
        self.Dense_0 = Dense(hidden_dim, num_classes, dtype=dtype,
                             device=dev)

    @property
    def device(self) -> torch.device:
        return self.Embed_0.weight.device

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = x.to(self.device)
        mask = (x != PAD_ID).float()
        # gather the f32 rows, then cast (flax's Embed casts the table)
        h = self.Embed_0.weight[x].to(self.dtype)
        for i in range(self.num_layers):
            h = self._modules[f"OptimizedLSTMCell_{i}"](h, self.dtype)
        pooled = (h * mask[..., None]).sum(1) \
            / mask.sum(1).clamp_min(1.0)[..., None]
        return self.Dense_0(pooled).float()


@register_model("lstm")
class LSTMClassifier(ClassifierModel):
    """The 2-layer LSTM classifier over {'x': int ids [B, T], 'y':
    labels}: per-example cross-entropy, Adam."""

    name = "lstm"
    num_classes = 4

    def __init__(self, dtype: torch.dtype = torch.bfloat16):
        self.dtype = dtype   # compute dtype of the modules it builds

    def build(self, dtype: Optional[torch.dtype] = None,
              device: DeviceLike = None) -> LSTMClassifierModule:
        return LSTMClassifierModule(num_classes=self.num_classes,
                                    dtype=dtype or self.dtype,
                                    device=device)

    def init_module(self, sample_batch, generator, device=None):
        """flax's initializers in distribution: lecun_normal input
        kernels and head, the embedding's normal, zero biases, and
        orthogonal hidden kernels (flax's ``recurrent_kernel_init``)."""
        module = self.build(device=device)
        flax_default_init_(module, generator)
        with torch.no_grad():
            for name, sub in module.named_modules():
                if name.rsplit(".", 1)[-1] in {f"h{g}" for g in GATES}:
                    w = torch.empty(sub.weight.shape)
                    nn.init.orthogonal_(w, generator=generator)
                    sub.weight.copy_(w)
        return module

    def configure_optimizers(self, lr, epoch):
        """The reference's ``optax.adam(lr)``: betas (0.9, 0.999), eps
        1e-8 outside the square root, no weight decay."""
        return functools.partial(torch.optim.Adam, lr=lr,
                                 betas=(0.9, 0.999), eps=1e-8)

    def params_to_flax(self, state: Dict[str, torch.Tensor]) -> dict:
        return lstm_params_to_flax(state)

    def params_from_flax(self, params: dict) -> Dict[str, torch.Tensor]:
        return lstm_params_from_flax(params)
