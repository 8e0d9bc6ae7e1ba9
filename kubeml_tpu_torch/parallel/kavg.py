"""K-step local SGD with weight averaging on one device (twin of
kubeml_tpu/parallel/kavg.py).

One sync round:

    for each virtual worker w (one after another on the one device):
        start from the round-start weights,
        take K masked local optimizer steps with a FRESH optimizer,
    then average the resulting weights (not gradients) over the workers
    that contributed.

Semantics kept from the reference (``kavg.py:15-38``):
  - weights are averaged, dividing the f32 sum by the contributor count
    and casting back to each parameter's dtype (``merge.MonolithicMerge``);
  - the optimizer is re-created for every worker of every round;
  - a worker whose weights or loss sum went non-finite is dropped from the
    merge by a SELECT (NaN * 0 is NaN, so a multiply would poison the
    sum), and reported in ``RoundStats.dropped``; when every worker drops,
    the round-start weights carry forward;
  - step and sample masks: padded examples are excluded from each step's
    masked-mean loss, padded steps change nothing.

Since the masks are host data, the port decides on the host what the
reference decides with on-device selects: a step whose ``step_mask`` is 0
and a worker whose ``worker_mask`` is 0 are not run at all (the reference
runs them and selects their results away, which leaves exactly the same
weights, optimizer state, loss sums and counts). The one visible
difference: a masked step whose loss would have been non-finite cannot
poison its worker here. Each step's dropout generator is a Philox
``torch.Generator`` seeded from that step's (worker, step) key data
(``rngs [W, S, 2]`` uint32); jax.random's bits cannot be reproduced.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np
import torch

from kubeml_tpu_torch.parallel.merge import MonolithicMerge

State = Dict[str, torch.Tensor]
# loss_fn(module, batch, generator, sample_mask) -> per-example loss [B]
LossFn = Callable[..., torch.Tensor]
# metrics_fn(module, batch) -> {name: per-example values [B]}
MetricsFn = Callable[..., Dict[str, torch.Tensor]]
# tx_factory(lr, epoch) -> (params -> torch.optim.Optimizer)
TxFactory = Callable[[float, int], Callable]


class RoundStats:
    """Host view of one sync round. ``loss_sum`` and ``dropped`` read the
    device lazily (each read synchronizes); ``step_count`` and
    ``sample_count`` come from the host masks. ``contributors`` counts
    the workers that merged: the worker-mask sum minus the drops."""

    def __init__(self, loss_sum_device: torch.Tensor, step_count: np.ndarray,
                 sample_count: np.ndarray, contributors: float,
                 dropped_device: torch.Tensor):
        self.loss_sum_device = loss_sum_device    # [W] masked loss sums
        self.dropped_device = dropped_device      # [W] 1 = non-finite drop
        self.step_count = step_count              # [W] real local steps
        self.sample_count = sample_count          # [W] real samples
        self.planned_contributors = contributors  # host mask sum

    @property
    def loss_sum(self) -> np.ndarray:
        """[W] sum of each worker's per-step masked-mean losses."""
        return self.loss_sum_device.cpu().numpy()

    @property
    def dropped(self) -> np.ndarray:
        return self.dropped_device.cpu().numpy()

    @property
    def contributors(self) -> float:
        return float(self.planned_contributors - self.dropped.sum())


def tree_all_finite(state: State) -> torch.Tensor:
    """0-d bool tensor: every floating tensor of ``state`` is finite
    (integer tensors cannot go non-finite and are skipped)."""
    return torch.stack([torch.isfinite(t).all() for t in state.values()
                        if t.is_floating_point()]).all()


def masked_scalar_loss(loss_fn: LossFn, module: torch.nn.Module,
                       batch: State, generator: torch.Generator,
                       smask: torch.Tensor) -> torch.Tensor:
    """The per-step loss: the mean of the per-example losses over the
    real examples (padded ones excluded, zero-sample guard)."""
    per_ex = loss_fn(module, batch, generator, smask)
    return (per_ex * smask).sum() / smask.sum().clamp_min(1.0)


def _generator(key_data: np.ndarray, device: torch.device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed((int(key_data[0]) << 32) | int(key_data[1]))
    return gen


class KAvgEngine:
    """Runs sync rounds of ``module`` (whose parameters are the workers'
    working copy) on the module's device.

    ``variables`` are the shared weights by parameter name (f32, like the
    module's own state dict); ``train_round`` returns the merged ones.
    """

    def __init__(self, module: torch.nn.Module, loss_fn: LossFn,
                 metrics_fn: MetricsFn, tx_factory: TxFactory):
        self.module = module
        self.loss_fn = loss_fn
        self.metrics_fn = metrics_fn
        self.tx_factory = tx_factory
        self.device = next(module.parameters()).device
        self._params = dict(module.named_parameters())
        self._merge = MonolithicMerge()

    def _load(self, variables: State) -> None:
        with torch.no_grad():
            for name, p in self._params.items():
                p.copy_(variables[name])

    def _to_device(self, batch: Dict) -> State:
        return {k: torch.as_tensor(v, device=self.device)
                for k, v in batch.items()}

    def train_round(self, variables: State, batch: Dict,
                    sample_mask: np.ndarray, step_mask: np.ndarray,
                    worker_mask: np.ndarray, rngs: np.ndarray, lr: float,
                    epoch: int) -> Tuple[State, RoundStats]:
        """One sync round. batch leaves [W, S, B, ...]; sample_mask
        [W, S, B]; step_mask [W, S]; worker_mask [W]; rngs [W, S, 2]
        uint32 key data (all host arrays)."""
        step_mask = np.asarray(step_mask, np.float32)
        worker_mask = np.asarray(worker_mask, np.float32)
        sample_mask = np.asarray(sample_mask, np.float32)
        rngs = np.asarray(rngs, np.uint32)
        W, S = step_mask.shape
        dev = self.device
        data = self._to_device(batch)
        smasks = torch.as_tensor(sample_mask, device=dev)
        contrib = {n: torch.zeros_like(v, dtype=torch.float32, device=dev)
                   for n, v in variables.items()}
        zero = torch.zeros((), device=dev)
        loss_sums, dropped = [zero] * W, [zero] * W
        eff_count = zero
        for w in range(W):
            if worker_mask[w] == 0:
                continue                 # masked out: contributes nothing
            self._load(variables)
            opt = self.tx_factory(lr, epoch)(list(self._params.values()))
            loss_sum = zero
            for s in range(S):
                if step_mask[w, s] == 0:
                    continue             # a padded step changes nothing
                loss = masked_scalar_loss(
                    self.loss_fn, self.module,
                    {k: v[w, s] for k, v in data.items()},
                    _generator(rngs[w, s], dev), smasks[w, s])
                opt.zero_grad(set_to_none=True)
                loss.backward()
                opt.step()
                loss_sum = loss_sum + loss.detach()
            with torch.no_grad():
                new = {n: p.detach() for n, p in self._params.items()}
                ok = tree_all_finite(new) & torch.isfinite(loss_sum)
                for n, c in contrib.items():
                    c += torch.where(ok, new[n], 0).float()
                loss_sums[w] = torch.where(ok, loss_sum, zero)
                dropped[w] = (~ok).float()
                eff_count = eff_count + ok.float()
        avg = self._merge.lane_merge(contrib, variables, eff_count,
                                     eff_count.clamp_min(1.0))
        stats = RoundStats(
            loss_sum_device=torch.stack(loss_sums),
            step_count=step_mask.sum(axis=1),
            sample_count=sample_mask.sum(axis=(1, 2)),
            contributors=float(worker_mask.sum()),
            dropped_device=torch.stack(dropped))
        return avg, stats

    @torch.no_grad()
    def eval_round(self, variables: State, batch: Dict,
                   sample_mask: np.ndarray,
                   metric_names: Tuple[str, ...] = ("loss", "accuracy")
                   ) -> Dict[str, float]:
        """Datapoint-weighted evaluation over every worker's batches:
        metric = sum(per-example value * sample mask) / n."""
        sample_mask = np.asarray(sample_mask, np.float32)
        W, S = sample_mask.shape[:2]
        self._load(variables)
        data = self._to_device(batch)
        smasks = torch.as_tensor(sample_mask, device=self.device)
        sums = {name: torch.zeros((), device=self.device)
                for name in metric_names}
        for w in range(W):
            for s in range(S):
                vals = self.metrics_fn(self.module,
                                       {k: v[w, s] for k, v in data.items()})
                for name in metric_names:
                    sums[name] += (vals[name] * smasks[w, s]).sum()
        n = max(float(sample_mask.sum()), 1.0)
        return {k: float(v) / n for k, v in sums.items()} | {"n": n}
