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
slab through the paged-attention kernel.

Training: ``GPTModule.logits`` is the differentiable forward (f32 master
weights cast to the compute dtype at use, dropout from an explicit
generator, attention through ``masked_attention(causal=True)`` — the flash
kernels on the card), and ``GPTMini``/``GPTNano`` carry the model
contract (per-sequence LM loss, metrics, AdamW).
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
from kubeml_tpu_torch.ops.attention import (NEG_INF, composed_bias,
                                            masked_attention,
                                            multi_head_attention)
from kubeml_tpu_torch.ops.paged_attention import paged_attention

LN_EPS = 1e-6  # flax LayerNorm's default, not torch's 1e-5

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

# serving KV storage modes (mirrors serve/pager.py KV_DTYPES)
_KV_DTYPES = ("f32", "int8")


class DecoderBlock(nn.Module):
    """Parameters of one pre-LN block; the math is ``_block`` below."""

    def __init__(self, hidden: int, heads: int, ffn: int,
                 device: torch.device):
        super().__init__()
        self.ln0 = nn.LayerNorm(hidden, eps=LN_EPS, device=device)
        self.q = nn.Linear(hidden, hidden, device=device)
        self.k = nn.Linear(hidden, hidden, device=device)
        self.v = nn.Linear(hidden, hidden, device=device)
        self.out = nn.Linear(hidden, hidden, device=device)
        self.ln1 = nn.LayerNorm(hidden, eps=LN_EPS, device=device)
        self.fc0 = nn.Linear(hidden, ffn, device=device)
        self.fc1 = nn.Linear(ffn, hidden, device=device)


class GPTModule(nn.Module):
    """GPT parameters (f32, like flax's) plus the dense inference forward.

    device=None means CUDA and raises where no CUDA device exists; pass
    device="cpu" to run on the CPU. ``dtype`` is the compute dtype;
    ``dropout`` applies in the training forward only.
    """

    def __init__(self, vocab_size: int = 8192, max_len: int = 512,
                 hidden: int = 256, layers: int = 4, heads: int = 4,
                 ffn: int = 1024, dropout: float = 0.1,
                 dtype: torch.dtype = torch.bfloat16,
                 device: DeviceLike = None):
        super().__init__()
        if hidden % heads:
            raise ValueError(f"hidden {hidden} does not split over "
                             f"{heads} heads")
        self.vocab_size, self.max_len = vocab_size, max_len
        self.hidden, self.layers, self.heads = hidden, layers, heads
        self.ffn, self.dtype, self.dropout = ffn, dtype, float(dropout)
        self.head_dim = hidden // heads
        dev = resolve_device(device)
        self.tok_embed = nn.Embedding(vocab_size, hidden, device=dev)
        self.pos_embed = nn.Embedding(max_len, hidden, device=dev)
        self.blocks = nn.ModuleList(
            DecoderBlock(hidden, heads, ffn, dev) for _ in range(layers))
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
                q, k, v, bias))
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
        B, T = x.shape
        if T > self.max_len:
            raise InferenceInputError(
                f"sequence length {T} exceeds max_len {self.max_len}")
        x = x.to(self.device)
        named = dict(self.named_parameters())
        p = _param_tree(self, lambda name, dtype: named[name].to(dtype))
        pad_mask = (x != PAD_ID).float()
        rate = self.dropout if train else 0.0

        def drop(t):
            return _dropout(t, rate, generator)

        h = drop(p["tok_embed"][x] + p["pos_embed"][:T][None])
        for lp in p["layers"]:
            h = _block(lp, h, lambda q, k, v: masked_attention(
                q, k, v, pad_mask, causal=True), drop)
        return _lm_head(p, h)


def _dropout(x: torch.Tensor, rate: float,
             generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax nn.Dropout: keep each element with probability 1 - rate
    (uniforms from ``generator``), scale kept ones by 1 / (1 - rate) in
    x's dtype; rate 0 is the identity. (jax.random's bits cannot be
    reproduced, so the kept set differs from the JAX package's.)"""
    if rate == 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) \
        < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


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
                get: Callable[[str, torch.dtype], torch.Tensor]) -> dict:
    """The programs' parameter dict, each tensor ``get(name, dtype)``:
    embeddings and Dense weights in the compute dtype, LayerNorm
    parameters in f32."""
    dt = module.dtype

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
        layers.append({
            "ln0": ln(f"{b}.ln0"), "q": lin(f"{b}.q"), "k": lin(f"{b}.k"),
            "v": lin(f"{b}.v"), "out": lin(f"{b}.out"),
            "ln1": ln(f"{b}.ln1"), "fc0": lin(f"{b}.fc0"),
            "fc1": lin(f"{b}.fc1"), "heads": module.heads})
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


def _block(lp: dict, h: torch.Tensor,
           attend: Callable[[torch.Tensor, torch.Tensor, torch.Tensor],
                            torch.Tensor],
           drop: Callable[[torch.Tensor], torch.Tensor] = lambda t: t
           ) -> torch.Tensor:
    """One pre-LN decoder block. ``attend(q, k, v)`` maps [B, T, H, Dh]
    projections to the [B, T, H, Dh] attention output — the dense
    forward attends within the window, the paged steps write K/V into
    the slab and read it back through the page table. ``drop`` is the
    training forward's dropout after the out-projection and the FFN."""
    dt = lp["q"][0].dtype
    H = lp["heads"]
    x = _layer_norm(h, *lp["ln0"]).to(dt)
    q, k, v = (F.linear(x, *lp[n]).unflatten(-1, (H, -1))
               for n in ("q", "k", "v"))
    attn = attend(q, k, v)
    h = h + drop(F.linear(attn.flatten(-2), *lp["out"]))
    x = _layer_norm(h, *lp["ln1"]).to(dt)
    x = F.gelu(F.linear(x, *lp["fc0"]), approximate="tanh")
    return h + drop(F.linear(x, *lp["fc1"]))


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


@register_model("gpt-mini")
class GPTMini(KubeModel):
    """~6M-param decoder-only LM (4 layers x 256 hidden x 4 heads),
    dropout 0.1. ``loss`` returns one value per sequence (the mean over
    its real next-token positions), so the K-avg engine treats a
    sequence as the reference treats one sample."""

    name = "gpt-mini"

    def __init__(self, dtype: torch.dtype = torch.bfloat16):
        self.dtype = dtype   # compute dtype of the modules it builds

    def build(self, dtype: Optional[torch.dtype] = None,
              device: DeviceLike = None) -> GPTModule:
        return GPTModule(**GPT_CONFIGS[self.name],
                         dropout=GPT_DROPOUT[self.name],
                         dtype=dtype or self.dtype, device=device)

    def params_to_flax(self, state):
        return params_to_flax(state, heads=GPT_CONFIGS[self.name]["heads"])

    def params_from_flax(self, params):
        return params_from_flax(params)

    def loss(self, module, batch, generator, sample_mask):
        x = batch["x"].to(module.device)
        return _lm_per_example(module.logits(x, train=True,
                                             generator=generator), x)

    def metrics(self, module, batch):
        x = batch["x"].to(module.device)
        with torch.no_grad():
            logits = module.logits(x)
        targets, tok_mask = _shift_targets(x)
        per_tok = _token_nll(logits, targets)
        hit = (logits.argmax(-1) == targets).float()
        denom = tok_mask.sum(1).clamp_min(1.0)
        return {"loss": (per_tok * tok_mask).sum(1) / denom,
                "accuracy": (hit * tok_mask).sum(1) / denom}

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
