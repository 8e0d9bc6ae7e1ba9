"""Tensor-parallel sharding rules over the rank grid's ``model`` axis
(twin of kubeml_tpu/parallel/tp.py).

The JAX package places each parameter with a ``NamedSharding`` from one
rule table (Megatron's column/row split of every transformer block) and
lets XLA's SPMD partitioner insert the collectives; a leaf whose sharded
dimension does not divide over the axis is replicated instead
(``shard_variables``). The port keeps the table and its fallback, and
reads them as a plan: which of a block's two Megatron pairs split over
the model ranks (through ``parallel/manual.py``'s layers) and which run
whole on every rank. The parameters themselves stay whole on every rank
(ROADMAP C.14), so checkpoints, the merge and ``/infer`` are those of
the dense model.

Rule format: (path regex, spec), the spec one grid-axis name or None per
dimension of the leaf in its flax layout. First match wins; no match is
full replication (the empty spec). Paths are '/'-joined flax parameter
paths, e.g. "layer_0/q/kernel" (what a model's ``params_to_flax``
gives).
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Sequence, Tuple

from kubeml_tpu_torch.parallel.distributed import MODEL_AXIS

Spec = Tuple[Optional[str], ...]
Rules = Sequence[Tuple[str, Spec]]

# Megatron split of the transformer blocks (the GPT decoder and the BERT
# encoder share the q/k/v/out + Dense_0/Dense_1 layout):
#   q/k/v kernels [hidden, heads, head_dim] -> shard heads;
#   the attention out kernel [heads, head_dim, hidden] -> shard heads
#     (row-parallel: one sum after it);
#   FFN Dense_0 [hidden, ffn] -> column split; Dense_1 [ffn, hidden] ->
#     row split (again one sum);
#   embeddings, LayerNorms and the row layers' biases stay replicated.
TRANSFORMER_TP_RULES: List[Tuple[str, Spec]] = [
    (r".*/(q|k|v)/kernel$", (None, MODEL_AXIS, None)),
    (r".*/(q|k|v)/bias$", (MODEL_AXIS, None)),
    (r".*/out/kernel$", (MODEL_AXIS, None, None)),
    (r".*/Dense_0/kernel$", (None, MODEL_AXIS)),
    (r".*/Dense_0/bias$", (MODEL_AXIS,)),
    (r".*/Dense_1/kernel$", (MODEL_AXIS, None)),
]

# a block's two Megatron pairs, by the flax module names in them
_PAIRS = {"heads": ("q", "k", "v", "out"), "ffn": ("Dense_0", "Dense_1")}


def spec_for(path: str, rules: Rules) -> Spec:
    for pattern, spec in rules:
        if re.match(pattern, path):
            return tuple(spec)
    return ()


def _paths(tree: dict, prefix: str = "") -> Dict[str, object]:
    """{'/'-joined path: leaf} of a nested dict."""
    out = {}
    for key, node in tree.items():
        path = f"{prefix}{key}"
        if isinstance(node, dict):
            out.update(_paths(node, path + "/"))
        else:
            out[path] = node
    return out


def tree_specs(tree: dict, rules: Rules) -> dict:
    """The spec tree matching ``tree`` (a flax ``params`` tree) under
    ``rules``."""
    def walk(node, prefix):
        return {k: walk(v, f"{prefix}{k}/") if isinstance(v, dict)
                else spec_for(f"{prefix}{k}", rules)
                for k, v in node.items()}
    return walk(tree, "")


def _divides(shape, spec: Spec, n: int) -> bool:
    """shard_variables' test: every named dimension exists and divides
    over the n-way axis."""
    return all(dim < len(shape) and shape[dim] % n == 0
               for dim, name in enumerate(spec) if name is not None)


def shard_plan(tree: dict, rules: Rules, n: int) -> Dict[str, dict]:
    """shard_variables' fallback as a plan over an ``n``-way model axis:
    {block name ("layer_i"): {"heads": bool, "ffn": bool}}, True where
    every sharded leaf of the pair divides (the rules make q/k/v/out
    divide together by heads, and Dense_0/Dense_1 by ffn), False where
    the pair runs whole on every model rank. ``tree`` is a flax
    ``params`` tree whose leaves have ``.shape``."""
    plan: Dict[str, dict] = {}
    for path, leaf in _paths(tree).items():
        parts = path.split("/")
        spec = spec_for(path, rules)
        if len(parts) < 3 or not any(name is not None for name in spec):
            continue
        for pair, subs in _PAIRS.items():
            if parts[-2] in subs:
                block = plan.setdefault(parts[-3], {"heads": True,
                                                    "ffn": True})
                block[pair] = block[pair] and _divides(
                    tuple(leaf.shape), spec, n)
    return plan
