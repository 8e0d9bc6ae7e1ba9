"""Weight bridge between the JAX package's flax parameter trees and the
port's state dicts: ``GPTModule``'s (gpt-moe-mini's too), ``BertModule``'s
(the GPT mapping plus ``classifier``), ``MLPModule``'s and
``LSTMClassifierModule``'s (the vision mapping below, plus
``Embed_0/embedding``).

A flax GPT tree (``variables["params"]``) maps onto the port as:

  tok_embed/embedding [V, hidden]        -> tok_embed.weight
  pos_embed/embedding [max_len, hidden]  -> pos_embed.weight
  layer_i/LayerNorm_{0,1}/{scale,bias}   -> blocks.i.ln{0,1}.{weight,bias}
  layer_i/{q,k,v}/kernel [hidden, H, Dh] -> blocks.i.{q,k,v}.weight [H*Dh, hidden]
  layer_i/{q,k,v}/bias [H, Dh]           -> blocks.i.{q,k,v}.bias [H*Dh]
  layer_i/out/kernel [H, Dh, hidden]     -> blocks.i.out.weight [hidden, H*Dh]
  layer_i/Dense_{0,1}/kernel [in, out]   -> blocks.i.fc{0,1}.weight [out, in]
  layer_i/moe/{router,wi,bi,wo,bo}       -> blocks.i.moe.{...} (an MoE
                                            block's FFN, the flax layouts
                                            kept: expert axis leading)
  LayerNorm_0 (top level)                -> ln_f

A flax MLP tree maps as Dense_{0,1}/kernel [in, out] -> fc{0,1}.weight
[out, in] and Dense_{0,1}/bias -> fc{0,1}.bias.

The vision models (``models/lenet.py``, ``models/resnet.py``,
``models/vgg.py``) name their submodules as flax does, so a state dict
name is its flax path and only the leaves change
(``vision_params_to_flax``):

  params/.../Conv_j/kernel [kh, kw, in, out] -> ....Conv_j.weight
                                                [out, in, kh, kw]
  params/.../Dense_j/kernel [in, out]        -> ....Dense_j.weight [out, in]
  params/.../BatchNorm_j/{scale,bias}        -> ....BatchNorm_j.{weight,bias}
  batch_stats/.../BatchNorm_j/{mean,var}     -> ....BatchNorm_j.running_{mean,var}

A registered buffer named ``running_<leaf>`` is the flax ``batch_stats``
leaf ``<leaf>``; every other name is a ``params`` leaf.

Leaves are numpy arrays on the flax side and CPU float32 tensors on the
port's side; ``GPTModule.load_state_dict`` moves them to the module's
device. The trees hold parameters only (no JAX types), so this module
needs no JAX.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Tuple

import numpy as np
import torch

_DENSE = {"Dense_0": "fc0", "Dense_1": "fc1"}
_LN = {"LayerNorm_0": "ln0", "LayerNorm_1": "ln1"}
# port submodule -> flax submodule, and each one's leaf names
_FLAX_SUB = {v: k for k, v in (_DENSE | _LN).items()}
_LN_LEAF = {"weight": "scale", "bias": "bias"}
_DENSE_LEAF = {"weight": "kernel", "bias": "bias"}


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))


_STAT = "running_"    # buffer-name prefix of a batch_stats leaf


def _flax_path(name: str) -> Tuple[str, ...]:
    """The flax variable-tree path (collection first) of a port state
    name; a name this bridge does not map keeps its own dotted path (a
    plain nested dict) under its collection."""
    parts = name.split(".")
    if parts[-1].startswith(_STAT):
        return ("batch_stats", *parts[:-1], parts[-1][len(_STAT):])
    return ("params", *_params_path(parts))


def _params_path(parts) -> Tuple[str, ...]:
    if len(parts) == 2 and parts[0] in ("tok_embed", "pos_embed") \
            and parts[1] == "weight":
        return parts[0], "embedding"
    if len(parts) == 2 and parts[0] == "ln_f" and parts[1] in _LN_LEAF:
        return "LayerNorm_0", _LN_LEAF[parts[1]]
    if len(parts) == 4 and parts[0] == "blocks":
        _, i, sub, leaf = parts
        if sub in ("ln0", "ln1") and leaf in _LN_LEAF:
            return f"layer_{i}", _FLAX_SUB[sub], _LN_LEAF[leaf]
        if sub in ("fc0", "fc1", "q", "k", "v", "out") \
                and leaf in _DENSE_LEAF:
            return f"layer_{i}", _FLAX_SUB.get(sub, sub), _DENSE_LEAF[leaf]
        if sub == "moe":
            return f"layer_{i}", sub, leaf
    return tuple(parts)


def flax_leaf_order(names: Iterable[str]) -> List[str]:
    """Port state names in the order in which ``jax.tree_util`` flattens
    the matching flax variable tree: dict keys sorted at every level, so
    ``batch_stats`` before ``params``, ``LayerNorm_0`` < ``layer_0`` <
    ``layer_10`` < ``layer_2`` < ``pos_embed`` < ``tok_embed``, inside a
    GPT layer ``Dense_*`` < ``LayerNorm_*`` < ``k`` < ``moe`` < ``out`` <
    ``q`` < ``v`` (an MoE FFN's ``bi`` < ``bo`` < ``router`` < ``wi`` <
    ``wo``), and ``BasicBlock_10`` < ``BasicBlock_2``. The vision leaves keep
    their port names, whose order inside a module is flax's (``bias`` <
    ``weight`` as ``bias`` < ``kernel``/``scale``; ``mean`` < ``var``). The
    merge plans its buckets over this order, so bucket membership equals
    the reference's."""
    return sorted(names, key=_flax_path)


def _tree_leaves(node) -> list:
    """The leaves of a nested dict in ``jax.tree_util``'s order (keys
    sorted at every level)."""
    if not isinstance(node, dict):
        return [node]
    return [leaf for key in sorted(node) for leaf in _tree_leaves(node[key])]


def flax_layout_shapes(names: Iterable[str], variables: dict
                       ) -> Dict[str, Tuple[int, ...]]:
    """Each port state name's shape in the JAX package's layout: the flax
    variable tree ``variables`` ({"params": ...[, "batch_stats": ...]},
    as a model's params_to_flax gives it) flattened in jax's order,
    matched leaf for leaf to ``flax_leaf_order(names)``. A GPT's q kernel
    is [hidden, H, Dh] here where the port holds [H*Dh, hidden]; the
    SyncDP engine's ZeRO layout rule reads these shapes."""
    order = flax_leaf_order(names)
    leaves = _tree_leaves(variables)
    if len(leaves) != len(order):
        raise ValueError(f"the flax tree has {len(leaves)} leaves, the "
                         f"state {len(order)}")
    return {n: tuple(np.shape(leaf)) for n, leaf in zip(order, leaves)}


def params_from_flax(params: dict) -> Dict[str, torch.Tensor]:
    """flax GPT ``params`` tree (numpy leaves) -> port state dict."""
    sd = {"tok_embed.weight": _t(params["tok_embed"]["embedding"]),
          "pos_embed.weight": _t(params["pos_embed"]["embedding"]),
          "ln_f.weight": _t(params["LayerNorm_0"]["scale"]),
          "ln_f.bias": _t(params["LayerNorm_0"]["bias"])}
    n_layers = sum(1 for k in params if k.startswith("layer_"))
    for i in range(n_layers):
        lp, b = params[f"layer_{i}"], f"blocks.{i}"
        for flax_name, name in _LN.items():
            sd[f"{b}.{name}.weight"] = _t(lp[flax_name]["scale"])
            sd[f"{b}.{name}.bias"] = _t(lp[flax_name]["bias"])
        for name in ("q", "k", "v"):
            kern = np.asarray(lp[name]["kernel"])           # [hidden, H, Dh]
            sd[f"{b}.{name}.weight"] = _t(kern.reshape(kern.shape[0], -1).T)
            sd[f"{b}.{name}.bias"] = _t(np.asarray(lp[name]["bias"]).ravel())
        kern = np.asarray(lp["out"]["kernel"])              # [H, Dh, hidden]
        sd[f"{b}.out.weight"] = _t(kern.reshape(-1, kern.shape[-1]).T)
        sd[f"{b}.out.bias"] = _t(lp["out"]["bias"])
        if "moe" in lp:
            for leaf, a in lp["moe"].items():
                sd[f"{b}.moe.{leaf}"] = _t(a)
            continue
        for flax_name, name in _DENSE.items():
            sd[f"{b}.{name}.weight"] = _t(np.asarray(
                lp[flax_name]["kernel"]).T)
            sd[f"{b}.{name}.bias"] = _t(lp[flax_name]["bias"])
    return sd


def params_to_flax(state_dict: Dict[str, torch.Tensor], heads: int) -> dict:
    """Port state dict -> flax GPT ``params`` tree of float32 numpy
    arrays (the inverse of params_from_flax; ``heads`` restores the
    [hidden, H, Dh] attention kernel layout)."""
    def a(name):
        return state_dict[name].detach().cpu().float().numpy().copy()

    params = {"tok_embed": {"embedding": a("tok_embed.weight")},
              "pos_embed": {"embedding": a("pos_embed.weight")},
              "LayerNorm_0": {"scale": a("ln_f.weight"),
                              "bias": a("ln_f.bias")}}
    n_layers = len({k.split(".")[1] for k in state_dict
                    if k.startswith("blocks.")})
    for i in range(n_layers):
        b, lp = f"blocks.{i}", {}
        for flax_name, name in _LN.items():
            lp[flax_name] = {"scale": a(f"{b}.{name}.weight"),
                             "bias": a(f"{b}.{name}.bias")}
        for name in ("q", "k", "v"):
            w = a(f"{b}.{name}.weight")                     # [H*Dh, hidden]
            lp[name] = {"kernel": w.T.reshape(w.shape[1], heads, -1).copy(),
                        "bias": a(f"{b}.{name}.bias").reshape(heads, -1)}
        w = a(f"{b}.out.weight")                            # [hidden, H*Dh]
        lp["out"] = {"kernel": w.T.reshape(heads, -1, w.shape[0]).copy(),
                     "bias": a(f"{b}.out.bias")}
        if f"{b}.moe.router" in state_dict:
            lp["moe"] = {leaf: a(f"{b}.moe.{leaf}")
                         for leaf in ("router", "wi", "bi", "wo", "bo")}
        else:
            for flax_name, name in _DENSE.items():
                lp[flax_name] = {"kernel": a(f"{b}.{name}.weight").T.copy(),
                                 "bias": a(f"{b}.{name}.bias")}
        params[f"layer_{i}"] = lp
    return params


def mlp_params_from_flax(params: dict) -> Dict[str, torch.Tensor]:
    """flax MLP ``params`` tree (numpy leaves) -> port state dict."""
    sd = {}
    for flax_name, name in _DENSE.items():
        sd[f"{name}.weight"] = _t(np.asarray(params[flax_name]["kernel"]).T)
        sd[f"{name}.bias"] = _t(params[flax_name]["bias"])
    return sd


def mlp_params_to_flax(state_dict: Dict[str, torch.Tensor]) -> dict:
    """Port MLP state dict -> flax ``params`` tree of float32 numpy
    arrays (the inverse of mlp_params_from_flax)."""
    def a(name):
        return state_dict[name].detach().cpu().float().numpy().copy()

    return {flax_name: {"kernel": a(f"{name}.weight").T.copy(),
                        "bias": a(f"{name}.bias")}
            for flax_name, name in _DENSE.items()}


def bert_params_from_flax(params: dict) -> Dict[str, torch.Tensor]:
    """flax BERT ``params`` tree (numpy leaves) -> port state dict: the
    GPT tree's mapping (the encoder blocks have the GPT blocks' names
    and layouts) plus ``classifier/kernel`` [hidden, classes] ->
    ``classifier.weight`` [classes, hidden]."""
    sd = params_from_flax(params)
    sd["classifier.weight"] = _t(np.asarray(params["classifier"]["kernel"]).T)
    sd["classifier.bias"] = _t(params["classifier"]["bias"])
    return sd


def bert_params_to_flax(state_dict: Dict[str, torch.Tensor],
                        heads: int) -> dict:
    """Port BERT state dict -> flax ``params`` tree of float32 numpy
    arrays (the inverse of bert_params_from_flax)."""
    params = params_to_flax({k: v for k, v in state_dict.items()
                             if not k.startswith("classifier.")}, heads)
    w = state_dict["classifier.weight"].detach().cpu().float().numpy()
    params["classifier"] = {
        "kernel": w.T.copy(),
        "bias": state_dict["classifier.bias"].detach().cpu().float()
        .numpy().copy()}
    return params


_LSTM_EMBED = ("Embed_0.weight", ("Embed_0", "embedding"))


def lstm_params_from_flax(params: dict) -> Dict[str, torch.Tensor]:
    """flax LSTM classifier ``params`` tree -> port state dict. The port's
    submodules carry the flax names (``Embed_0``,
    ``OptimizedLSTMCell_{i}.{ii,if,ig,io,hi,hf,hg,ho}``, ``Dense_0``), so
    a kernel [in, out] becomes ``<path>.weight`` [out, in] and the
    embedding ``Embed_0/embedding`` becomes ``Embed_0.weight``."""
    name, (mod, leaf) = _LSTM_EMBED
    rest = {k: v for k, v in params.items() if k != mod}
    sd = vision_params_from_flax({"params": rest})
    sd[name] = _t(params[mod][leaf])
    return sd


def lstm_params_to_flax(state_dict: Dict[str, torch.Tensor]) -> dict:
    """Port LSTM classifier state dict -> flax ``params`` tree of float32
    numpy arrays (the inverse of lstm_params_from_flax)."""
    name, (mod, leaf) = _LSTM_EMBED
    params = vision_params_to_flax({k: v for k, v in state_dict.items()
                                    if k != name})["params"]
    params[mod] = {leaf: state_dict[name].detach().cpu().float().numpy()
                   .copy()}
    return params


def vision_params_to_flax(state: Dict[str, torch.Tensor]) -> dict:
    """Port state dict of a flax-named vision module -> the flax variable
    tree ``{"params": ..., "batch_stats": ...}`` of numpy arrays (no
    ``batch_stats`` key when the module has no running statistics).
    Floating leaves become float32, integer leaves keep their dtype."""
    tree: dict = {}
    for name, t in state.items():
        a = t.detach().cpu()
        a = (a.float() if a.is_floating_point() else a).numpy().copy()
        path = list(_flax_path(name))
        if path[0] == "params" and path[-1] == "weight":
            if a.ndim == 4:                       # [out, in, kh, kw]
                path[-1], a = "kernel", a.transpose(2, 3, 1, 0).copy()
            elif a.ndim == 2:                     # [out, in]
                path[-1], a = "kernel", a.T.copy()
            else:                                 # a norm's scale
                path[-1] = "scale"
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = a
    return tree


def vision_params_from_flax(variables: dict) -> Dict[str, torch.Tensor]:
    """The inverse of vision_params_to_flax: a flax variable tree
    (``params`` and optionally ``batch_stats``, numpy leaves) -> CPU state
    dict (float leaves f32, integer leaves as stored)."""
    sd: Dict[str, torch.Tensor] = {}

    def walk(node, path, collection):
        for key, leaf in node.items():
            if isinstance(leaf, dict):
                walk(leaf, path + [key], collection)
                continue
            a = np.asarray(leaf)
            if collection == "batch_stats":
                name = ".".join(path + [_STAT + key])
            elif key == "kernel" and a.ndim == 4:   # [kh, kw, in, out]
                name, a = ".".join(path + ["weight"]), a.transpose(3, 2, 0, 1)
            elif key == "kernel" and a.ndim == 2:
                name, a = ".".join(path + ["weight"]), a.T
            elif key == "scale":
                name = ".".join(path + ["weight"])
            else:
                name = ".".join(path + [key])
            sd[name] = (_t(a) if np.issubdtype(a.dtype, np.floating)
                        else torch.from_numpy(np.array(a, copy=True)))

    unknown = set(variables) - {"params", "batch_stats"}
    if unknown:
        raise KeyError(f"unknown variable collections {sorted(unknown)}")
    for collection in ("params", "batch_stats"):
        walk(variables.get(collection, {}), [], collection)
    return sd


def random_flax_params(vocab_size: int, max_len: int, hidden: int,
                       layers: int, heads: int, ffn: int,
                       seed: int = 0, n_experts: int = 0) -> dict:
    """A flax-layout GPT ``params`` tree of random float32 numpy arrays
    from ``seed`` (no JAX needed): normal weights with flax's init
    scales (embeddings and kernels ~ 1/sqrt(fan_in)), and small random
    biases and LayerNorm offsets so every parameter carries signal.
    ``n_experts`` > 0 gives every layer an MoE FFN (``moe``) of that many
    experts in place of ``Dense_0``/``Dense_1``."""
    rng = np.random.default_rng(seed)
    dh = hidden // heads

    def w(shape, fan_in):
        return (rng.standard_normal(shape) / np.sqrt(fan_in)).astype(
            np.float32)

    def small(shape):
        return (0.02 * rng.standard_normal(shape)).astype(np.float32)

    def ln():
        return {"scale": 1.0 + small((hidden,)), "bias": small((hidden,))}

    params = {"tok_embed": {"embedding": w((vocab_size, hidden), hidden)},
              "pos_embed": {"embedding": w((max_len, hidden), hidden)},
              "LayerNorm_0": ln()}
    for i in range(layers):
        lp = {"LayerNorm_0": ln(), "LayerNorm_1": ln()}
        for name in ("q", "k", "v"):
            lp[name] = {"kernel": w((hidden, heads, dh), hidden),
                        "bias": small((heads, dh))}
        lp["out"] = {"kernel": w((heads, dh, hidden), hidden),
                     "bias": small((hidden,))}
        if n_experts:
            e = n_experts
            lp["moe"] = {"router": w((hidden, e), hidden),
                         "wi": w((e, hidden, ffn), hidden),
                         "bi": small((e, ffn)),
                         "wo": w((e, ffn, hidden), ffn),
                         "bo": small((e, hidden))}
        else:
            lp["Dense_0"] = {"kernel": w((hidden, ffn), hidden),
                             "bias": small((ffn,))}
            lp["Dense_1"] = {"kernel": w((ffn, hidden), ffn),
                             "bias": small((hidden,))}
        params[f"layer_{i}"] = lp
    return params
