"""The sync round's weight merge (twin of kubeml_tpu/parallel/merge.py).

This slice ports the default strategy only: ``MonolithicMerge`` with an
f32 wire, one reduction per parameter. On one device the cross-lane sum
of the reference is the sum the engine already holds, so the merge is
the average-and-guard step: the f32 contribution sum divided by the
contributor count and cast back to the leaf's dtype, or — when every
worker was dropped (raw count 0) — the round-start value carried forward
instead of a silent zero. The bucketed and compressed strategies (and
the fused merge kernel they use) are not ported yet.
"""

from __future__ import annotations

from typing import Dict

import torch

State = Dict[str, torch.Tensor]


class MergeStrategy:
    """One sync round's merge.

    lane_merge(contrib, ref, raw_count, count):
      contrib    f32 contribution sums, by parameter name
      ref        round-start values (carry-forward + dtype source)
      raw_count  live-contributor count (0 => all dropped), a tensor
      count      max(raw_count, 1), the safe divisor
    returns the merged values. raw_count == 0 must return ``ref``."""

    name = "?"

    def lane_merge(self, contrib: State, ref: State, raw_count: torch.Tensor,
                   count: torch.Tensor) -> State:
        raise NotImplementedError

    def comm_proxy(self, variables: State) -> Dict[str, int]:
        """Deterministic communication proxy of one merge, from shapes
        alone: wire payload bytes per lane per round and the number of
        collectives (and buckets) per round."""
        raise NotImplementedError


class MonolithicMerge(MergeStrategy):
    """One reduction per parameter over an f32 wire."""

    name = "monolithic"

    def lane_merge(self, contrib, ref, raw_count, count):
        # a select, never a multiply: the carried-forward value is exactly
        # the round-start one
        return {n: torch.where(raw_count > 0, (c / count).to(ref[n].dtype),
                               ref[n])
                for n, c in contrib.items()}

    def comm_proxy(self, variables):
        return {"merge_payload_bytes": sum(4 * t.numel()
                                           for t in variables.values()),
                "buckets_per_round": len(variables),
                "collectives_per_round": len(variables)}
