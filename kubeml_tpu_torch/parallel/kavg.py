"""K-step local SGD with weight averaging over data lanes on one device
(twin of kubeml_tpu/parallel/kavg.py).

One sync round:

    for each virtual worker w (one after another on the one device):
        start from the round-start weights,
        take K masked local optimizer steps with a FRESH optimizer,
        add the resulting weights to its lane's f32 contribution sum,
    then merge (average) the lanes' sums over the workers that contributed.

Lanes are the reference's ``data`` mesh axis laid out as a leading axis on
one device: with ``n_lanes`` = D, lane d owns workers
``[d * W / D, (d + 1) * W / D)`` and keeps its own contribution sum and
contributor count. The merge strategy (``parallel/merge.py``: monolithic,
bucketed with the fused merge-apply kernel, or error-feedback bf16/int8)
reduces over the lanes; the EF strategies keep per-lane residuals as
engine state from round to round.

Semantics kept from the reference (``kavg.py:15-38``):
  - weights are averaged, dividing the f32 sum by the contributor count
    and casting back to each parameter's dtype;
  - the optimizer is re-created for every worker of every round;
  - a worker whose weights or loss sum went non-finite is dropped from the
    merge by a SELECT (NaN * 0 is NaN, so a multiply would poison the
    sum), and reported in ``RoundStats.dropped``; when every worker drops,
    the round-start weights carry forward; a lane with no live contributor
    is dead for the merge (its EF residual is zeroed);
  - step and sample masks: padded examples are excluded from each step's
    masked-mean loss, padded steps change nothing.

Since the masks are host data, the port decides on the host what the
reference decides with on-device selects: a step whose ``step_mask`` is 0
and a worker whose ``worker_mask`` is 0 are not run at all (the reference
runs them and selects their results away, which leaves exactly the same
weights, optimizer state, loss sums and counts). The one visible
difference: a masked step whose loss would have been non-finite cannot
poison its worker here. A skipped step also leaves a BatchNorm's running
statistics exactly where the reference's select leaves them.

The round's state is the module's variables (``models.base.module_state``):
its parameters and its registered buffers, the flax ``params`` and
``batch_stats``. Each worker starts from the round-start values of both,
its train-mode forwards update the buffers in place, and the buffers join
the finite guard, the contribution sums and the merge like any leaf
(integer leaves are averaged in f32 and truncated, as in the reference).
The optimizer steps the parameters only.

Index-fed rounds (``train_round(s)_indexed``) take the samples from a
device-resident dataset cache (``data/device_cache.py``): the dispatch
carries [W, S, B] gather indices, the round gathers the samples on the
device, applies the dataset's device transform, and runs the same round
body, so an index-fed round equals the host-staged round of the same
samples. Each step's dropout generator is a Philox
``torch.Generator`` seeded from that step's (worker, step) key data
(``rngs [W, S, 2]`` uint32); jax.random's bits cannot be reproduced.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from kubeml_tpu_torch.models.base import module_state
from kubeml_tpu_torch.parallel import merge as merge_lib
from kubeml_tpu_torch.parallel.merge import _lane_sum

State = Dict[str, torch.Tensor]
# loss_fn(module, batch, generator, sample_mask) -> per-example loss [B]
LossFn = Callable[..., torch.Tensor]
# metrics_fn(module, batch) -> {name: per-example values [B]}
MetricsFn = Callable[..., Dict[str, torch.Tensor]]
# tx_factory(lr, epoch) -> (params -> torch.optim.Optimizer)
TxFactory = Callable[[float, int], Callable]


class RoundStats:
    """Host view of one sync round (or of R rounds, with a leading R axis
    on every array). ``loss_sum`` and ``dropped`` read the device lazily
    (each read synchronizes); ``step_count`` and ``sample_count`` come
    from the host masks. ``contributors`` counts the workers that merged:
    the worker-mask sum minus the drops.

    With ``collect_stats=True``, ``stat_device`` holds the [W, 3] (or
    [R, W, 3]) per-worker health stats — the step-masked sums of the
    squared global grad norm, the squared update norm (the applied delta)
    and the squared param norm — and ``spread_device`` the cross-worker
    loss spread (a scalar, or [R])."""

    def __init__(self, loss_sum_device: torch.Tensor, step_count: np.ndarray,
                 sample_count: np.ndarray, contributors: float,
                 dropped_device: torch.Tensor,
                 stat_device: Optional[torch.Tensor] = None,
                 spread_device: Optional[torch.Tensor] = None):
        self.loss_sum_device = loss_sum_device    # [W] masked loss sums
        self.dropped_device = dropped_device      # [W] 1 = non-finite drop
        self.step_count = step_count              # [W] real local steps
        self.sample_count = sample_count          # [W] real samples
        self.planned_contributors = contributors  # host mask sum
        self.stat_device = stat_device
        self.spread_device = spread_device

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


def _float_values(state: State):
    return [t for t in state.values() if t is not None
            and t.is_floating_point()]


def tree_all_finite(state: State) -> torch.Tensor:
    """0-d bool tensor: every floating tensor of ``state`` is finite
    (integer tensors cannot go non-finite and are skipped)."""
    return torch.stack([torch.isfinite(t).all()
                        for t in _float_values(state)]).all()


def tree_sq_norm(state: State) -> torch.Tensor:
    """0-d f32: the sum of squares over every floating tensor of
    ``state`` (the square of the global L2 norm); integer tensors are
    skipped, as in tree_all_finite."""
    total = None
    for t in _float_values(state):
        sq = t.float().square().sum()
        total = sq if total is None else total + sq
    return total


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

    ``variables`` are the shared weights by name: the module's parameters
    and buffers (``module_state``), f32 like the module's own;
    ``train_round`` returns the merged ones.

    n_lanes: data lanes D (the reference's ``data`` mesh axis); W must be
    a multiple of it. merge_dtype (a floating torch dtype), merge_bucket_mb
    and merge_compress ("none" | "bf16" | "int8") pick the merge strategy
    as in the reference (``merge.make_strategy``). collect_stats adds the
    per-worker health stats and the loss spread to ``RoundStats``; they
    are extra outputs and change no weight.
    """

    def __init__(self, module: torch.nn.Module, loss_fn: LossFn,
                 metrics_fn: MetricsFn, tx_factory: TxFactory,
                 n_lanes: int = 1, merge_dtype: Optional[torch.dtype] = None,
                 merge_bucket_mb: float = 0.0, merge_compress: str = "none",
                 collect_stats: bool = False):
        if int(n_lanes) < 1:
            raise ValueError(f"n_lanes must be >= 1, got {n_lanes}")
        if merge_dtype is not None and not merge_dtype.is_floating_point:
            raise ValueError(f"merge_dtype must be a floating dtype, got "
                             f"{merge_dtype}")
        self.module = module
        self.loss_fn = loss_fn
        self.metrics_fn = metrics_fn
        self.tx_factory = tx_factory
        self.n_lanes = int(n_lanes)
        self.collect_stats = bool(collect_stats)
        self.merge_bucket_mb = float(merge_bucket_mb)
        self.merge_compress = str(merge_compress or "none")
        self.device = next(module.parameters()).device
        self._params = dict(module.named_parameters())
        self._state = module_state(module)
        self._merge = merge_lib.make_strategy(
            merge_dtype=merge_dtype, bucket_mb=self.merge_bucket_mb,
            compress=self.merge_compress)
        self._ef = self._merge.needs_residual
        # per-lane EF residuals: flat [D * L] f32 tensors by bucket name,
        # lane-major; None until the first compressed round
        self._ef_state: Optional[State] = None

    @property
    def merge_strategy(self) -> str:
        """Registered name of the active merge strategy."""
        return self._merge.name

    def merge_comm_proxy(self, variables: State) -> Dict[str, int]:
        """Deterministic per-round wire numbers of this engine's merge
        strategy over ``variables`` (merge.MergeStrategy.comm_proxy)."""
        out = self._merge.comm_proxy(variables)
        out["strategy"] = self._merge.name
        return out

    def reset_merge_residuals(self) -> None:
        """Drop the EF residual state (membership or shape changes, or a
        cold restart where carrying stale error would be wrong)."""
        self._ef_state = None

    def _ef_residuals(self, variables: State) -> State:
        """The current per-lane EF residuals, zero-initialised on first
        use and re-made when the bucket plan changes."""
        sizes = self._merge.residual_sizes(variables)
        state = self._ef_state
        if (state is not None and set(state) == set(sizes)
                and all(state[k].numel() == self.n_lanes * n
                        for k, n in sizes.items())):
            return state
        self._ef_state = {k: torch.zeros(self.n_lanes * n,
                                         device=self.device)
                          for k, n in sizes.items()}
        return self._ef_state

    def _load(self, variables: State) -> None:
        """Round-start values into the module: every parameter and every
        buffer (the state must name them all)."""
        with torch.no_grad():
            for name, t in self._state.items():
                t.copy_(variables[name])

    def _to_device(self, batch: Dict) -> State:
        return {k: torch.as_tensor(v, device=self.device)
                for k, v in batch.items()}

    def _workers_per_lane(self, W: int) -> int:
        if W % self.n_lanes:
            raise ValueError(f"W={W} not a multiple of lanes={self.n_lanes}")
        return W // self.n_lanes

    def _worker(self, variables: State, data: State, smasks: torch.Tensor,
                step_mask: np.ndarray, rngs: np.ndarray, w: int, lr: float,
                epoch: int):
        """K masked local steps of worker w from the round-start state:
        (new state, loss sum, [3] stat sums or None)."""
        dev = self.device
        self._load(variables)
        params = list(self._params.values())
        opt = self.tx_factory(lr, epoch)(params)
        loss_sum = torch.zeros((), device=dev)
        stat_sum = torch.zeros(3, device=dev) if self.collect_stats else None
        for s in range(step_mask.shape[1]):
            if step_mask[w, s] == 0:
                continue                 # a padded step changes nothing
            loss = masked_scalar_loss(
                self.loss_fn, self.module,
                {k: v[w, s] for k, v in data.items()},
                _generator(rngs[w, s], dev), smasks[w, s])
            opt.zero_grad(set_to_none=True)
            loss.backward()
            if self.collect_stats:
                with torch.no_grad():
                    before = {n: p.detach().clone()
                              for n, p in self._params.items()}
                    gsq = tree_sq_norm({n: p.grad
                                        for n, p in self._params.items()})
            opt.step()
            if self.collect_stats:
                with torch.no_grad():
                    delta = {n: p.detach() - before[n]
                             for n, p in self._params.items()}
                    stat_sum = stat_sum + torch.stack(
                        [gsq, tree_sq_norm(delta), tree_sq_norm(before)])
            loss_sum = loss_sum + loss.detach()
        return ({n: t.detach() for n, t in self._state.items()}, loss_sum,
                stat_sum)

    def _round(self, variables: State, data: State, smasks: torch.Tensor,
               step_mask: np.ndarray, worker_mask: np.ndarray,
               rngs: np.ndarray, lr: float, epoch: int):
        """One sync round on device-resident inputs: (merged weights,
        loss sums [W], drops [W], stat rows [W, 3] or None, spread or
        None)."""
        W = step_mask.shape[0]
        per_lane = self._workers_per_lane(W)
        D, dev = self.n_lanes, self.device
        collect = self.collect_stats
        contrib = {n: torch.zeros((D, *v.shape), dtype=torch.float32,
                                  device=dev) for n, v in variables.items()}
        zero = torch.zeros((), device=dev)
        loss_sums, dropped = [zero] * W, [zero] * W
        stat_rows = [torch.zeros(3, device=dev)] * W
        eff = [zero] * D
        m1, m2 = [zero] * D, [zero] * D   # spread moments, per lane
        for w in range(W):
            if worker_mask[w] == 0:
                continue                 # masked out: contributes nothing
            d = w // per_lane
            new, loss_sum, stat_sum = self._worker(
                variables, data, smasks, step_mask, rngs, w, lr, epoch)
            with torch.no_grad():
                ok = tree_all_finite(new) & torch.isfinite(loss_sum)
                for n, c in contrib.items():
                    c[d] += torch.where(ok, new[n], 0).float()
                loss_sums[w] = torch.where(ok, loss_sum, zero)
                dropped[w] = (~ok).float()
                eff[d] = eff[d] + ok.float()
                if collect:
                    # the same select-not-multiply guard as the loss: a
                    # dropped worker's NaN stats must not poison the sums
                    stat_rows[w] = torch.where(ok, stat_sum, 0.0)
                    mean_v = loss_sum / max(float(step_mask[w].sum()), 1.0)
                    safe = torch.where(ok, mean_v, 0.0)
                    m1[d] = m1[d] + safe
                    m2[d] = m2[d] + safe * safe
        eff_count = torch.stack(eff)                 # [D] per-lane counts
        raw_count = _lane_sum(eff_count)
        count = raw_count.clamp_min(1.0)   # guard the 0-contributor divide
        with torch.no_grad():
            avg, new_resid = self._merge.lane_merge(
                contrib, variables, raw_count, count,
                lane_alive=eff_count > 0,
                residual=self._ef_residuals(variables) if self._ef else None)
        if self._ef:
            self._ef_state = new_resid
        spread = None
        if collect:
            # population std of the merged workers' per-step mean losses
            mean1 = _lane_sum(torch.stack(m1)) / count
            mean2 = _lane_sum(torch.stack(m2)) / count
            spread = torch.sqrt((mean2 - mean1 * mean1).clamp_min(0.0))
        return (avg, torch.stack(loss_sums), torch.stack(dropped),
                torch.stack(stat_rows) if collect else None, spread)

    @staticmethod
    def _masks(sample_mask, step_mask, worker_mask, rngs):
        return (np.asarray(sample_mask, np.float32),
                np.asarray(step_mask, np.float32),
                np.asarray(worker_mask, np.float32),
                np.asarray(rngs, np.uint32))

    def _single(self, variables: State, batch_fn: Callable[[], State],
                sample_mask, step_mask, worker_mask, rngs, lr: float,
                epoch: int) -> Tuple[State, RoundStats]:
        """One round over the device batch ``batch_fn()`` gives."""
        sample_mask, step_mask, worker_mask, rngs = self._masks(
            sample_mask, step_mask, worker_mask, rngs)
        self._workers_per_lane(step_mask.shape[0])
        avg, loss_sums, dropped, stats, spread = self._round(
            variables, batch_fn(),
            torch.as_tensor(sample_mask, device=self.device), step_mask,
            worker_mask, rngs, lr, epoch)
        return avg, RoundStats(
            loss_sum_device=loss_sums,
            step_count=step_mask.sum(axis=1),
            sample_count=sample_mask.sum(axis=(1, 2)),
            contributors=float(worker_mask.sum()),
            dropped_device=dropped, stat_device=stats, spread_device=spread)

    def _multi(self, variables: State, batch_fn: Callable[[int], State],
               sample_mask, step_mask, worker_mask, rngs, lr: float,
               epoch: int) -> Tuple[State, RoundStats]:
        """R rounds, round r over the device batch ``batch_fn(r)``."""
        sample_mask, step_mask, worker_mask, rngs = self._masks(
            sample_mask, step_mask, worker_mask, rngs)
        self._workers_per_lane(step_mask.shape[1])
        smasks = torch.as_tensor(sample_mask, device=self.device)
        outs = []
        for r in range(step_mask.shape[0]):
            variables, *rest = self._round(
                variables, batch_fn(r), smasks[r], step_mask[r],
                worker_mask[r], rngs[r], lr, epoch)
            outs.append(rest)
        loss_sums, dropped, stats, spread = zip(*outs)
        collect = self.collect_stats
        return variables, RoundStats(
            loss_sum_device=torch.stack(loss_sums),
            step_count=step_mask.sum(axis=2),
            sample_count=sample_mask.sum(axis=(2, 3)),
            contributors=float(worker_mask.sum()),
            dropped_device=torch.stack(dropped),
            stat_device=torch.stack(stats) if collect else None,
            spread_device=torch.stack(spread) if collect else None)

    def train_round(self, variables: State, batch: Dict,
                    sample_mask: np.ndarray, step_mask: np.ndarray,
                    worker_mask: np.ndarray, rngs: np.ndarray, lr: float,
                    epoch: int) -> Tuple[State, RoundStats]:
        """One sync round. batch leaves [W, S, B, ...]; sample_mask
        [W, S, B]; step_mask [W, S]; worker_mask [W]; rngs [W, S, 2]
        uint32 key data (all host arrays). W must be a multiple of
        n_lanes."""
        return self._single(variables, lambda: self._to_device(batch),
                            sample_mask, step_mask, worker_mask, rngs, lr,
                            epoch)

    def train_rounds(self, variables: State, batch: Dict,
                     sample_mask: np.ndarray, step_mask: np.ndarray,
                     worker_mask: np.ndarray, rngs: np.ndarray, lr: float,
                     epoch: int) -> Tuple[State, RoundStats]:
        """R consecutive sync rounds: the train_round contract with a
        leading round axis R on every array (batch leaves
        [R, W, S, B, ...], sample_mask [R, W, S, B], step_mask [R, W, S],
        worker_mask [R, W], rngs [R, W, S, 2]). Merges run between the
        rounds exactly as in R train_round calls, EF residuals carried.
        Stats come back per round: loss_sum_device [R, W],
        step_count/sample_count [R, W]."""
        data = self._to_device(batch)
        return self._multi(variables,
                           lambda r: {k: v[r] for k, v in data.items()},
                           sample_mask, step_mask, worker_mask, rngs, lr,
                           epoch)

    def _gather(self, cache, idx) -> State:
        """A round's batch from the device cache: the [W, S, B] gather
        indices (lane-local into lane w // (W / D)'s slab for a sharded
        cache, global for a replicated one) uploaded, the raw leaves
        gathered on the device, then the dataset's device transform."""
        idx = torch.as_tensor(np.asarray(idx, np.int32),
                              device=self.device).long()
        if cache.layout == "sharded":
            if cache.n_lanes != self.n_lanes:
                raise ValueError(f"a sharded cache of {cache.n_lanes} lanes "
                                 f"cannot feed {self.n_lanes} lanes")
            W = idx.shape[0]
            lane = (torch.arange(W, device=self.device)
                    // self._workers_per_lane(W)).view(W, 1, 1)
            raw = {k: v[lane, idx] for k, v in cache.arrays.items()}
        else:
            raw = {k: v[idx] for k, v in cache.arrays.items()}
        if cache.device_transform is not None:
            return dict(cache.device_transform(raw["x"], raw["y"]))
        return raw

    def train_round_indexed(self, variables: State, cache, idx: np.ndarray,
                            sample_mask: np.ndarray, step_mask: np.ndarray,
                            worker_mask: np.ndarray, rngs: np.ndarray,
                            lr: float, epoch: int
                            ) -> Tuple[State, RoundStats]:
        """One sync round against the device-resident dataset cache
        (data/device_cache.py): the train_round contract and results, with
        ``idx`` [W, S, B] int32 gather indices (lane-local for a sharded
        cache, global for a replicated one) in place of the batch
        leaves."""
        return self._single(variables, lambda: self._gather(cache, idx),
                            sample_mask, step_mask, worker_mask, rngs, lr,
                            epoch)

    def train_rounds_indexed(self, variables: State, cache,
                             idx: np.ndarray, sample_mask: np.ndarray,
                             step_mask: np.ndarray, worker_mask: np.ndarray,
                             rngs: np.ndarray, lr: float, epoch: int
                             ) -> Tuple[State, RoundStats]:
        """R index-fed sync rounds: train_rounds with ``idx``
        [R, W, S, B] in place of the batch leaves; each round gathers its
        own samples."""
        return self._multi(variables, lambda r: self._gather(cache, idx[r]),
                           sample_mask, step_mask, worker_mask, rngs, lr,
                           epoch)

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
