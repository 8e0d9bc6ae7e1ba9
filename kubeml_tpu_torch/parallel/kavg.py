"""K-step local SGD with weight averaging over data lanes (twin of
kubeml_tpu/parallel/kavg.py), on one device or over the ranks of a
process group.

One sync round:

    for each virtual worker w (one after another on the one device):
        start from the round-start weights,
        take K masked local optimizer steps with a FRESH optimizer,
        add the resulting weights to its lane's f32 contribution sum,
    then merge (average) the lanes' sums over the workers that contributed.

Lanes are the reference's ``data`` mesh axis: with ``n_lanes`` = D, lane
d owns workers ``[d * W / D, (d + 1) * W / D)`` and keeps its own
contribution sum and contributor count. Without a process group the lanes
are a leading axis on one device. Under an initialized group
(``parallel/distributed.py``) they are laid out over the ranks, slice-
major (``lane_layout``: D % world == 0, lane d on rank d // (D / world)):
every rank is handed the same round, copies to its device only the
batch rows and sample masks of its own lanes' workers and runs only those
workers, and the merge's lane sums, the contributor count and the spread
moments are summed across ranks (all-reduces), so every rank holds the
same merged weights. The per-worker [W] loss sums, drop flags and stat
rows are gathered, so every rank returns the same ``RoundStats`` as the
reference's replicated global arrays. The merge strategy
(``parallel/merge.py``: monolithic, bucketed with the fused merge-apply
kernel, or error-feedback bf16/int8) reduces over the lanes; the EF
strategies keep the residuals of the rank's lanes as engine state from
round to round.

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

Inner axes (the reference's model axis, ``n_model`` > 1; its seq round,
``n_seq`` > 1 with ``batch_seq_dims``; its stage axis, ``n_stage`` > 1;
its expert axis, ``n_expert`` > 1): the ranks form the rank grid
(``distributed.make_grid``: data outermost, then model, seq and stage,
expert innermost). The lanes are laid out over the data group, whose
ranks merge; the n_model x n_seq x n_stage x n_expert ranks of one data
index (its inner group) run the same workers: a model rank on the same
tokens as its model group, running its share of every block's heads and
FFN columns (``parallel/manual.py``'s Megatron layers), a seq rank on its
own [T / n_seq] slice of every seq-carrying key (``seq_batch_dims``:
{key: per-example dim}), through the models' ring or Ulysses attention,
a stage rank on the same batch as its stage group, running its stage of
the model's pipelined trunk (``parallel/pp.py``; the model's
``enable_pipeline_parallel``), an expert rank on the same tokens as its
expert group, running its share of the experts
(``parallel/manual.ep_partial_ffn``). The reference gets these axes'
gradient sums from ``check_vma``; here the model's per-example loss is
the same on every rank of the inner group (its sums over an axis are
``distributed.psum``, whose backward sums the cotangents), each rank
backpropagates 1 / n_inner of it, and the parameters' gradients are
summed over the inner group (one all-reduce a step), so
every rank of it steps the same global gradient and holds the same
weights bit for bit: every dropout mask is drawn from the step's key on
each of them alike. The loss sums, the drop flags and every branch of
the round are decided from values equal on every rank of the inner
group (the summed loss, the equal weights); the merge's sums and the
gathered rows run over the data group. The merge takes the reference's
ring for a lossy wire (``use_ring``, ``parallel/merge.py``) where the
reference's does (its ``_wire_ring``): an inner axis whose round is not
fully manual, i.e. neither a seq round nor ``manual_inner`` (the job
sets it for the manual tensor-parallel route and for a pipelined
job).

Index-fed rounds (``train_round(s)_indexed``) take the samples from a
device-resident dataset cache (``data/device_cache.py``): the dispatch
carries [W, S, B] gather indices, the round gathers the samples on the
device, applies the dataset's device transform, and runs the same round
body, so an index-fed round equals the host-staged round of the same
samples.

Cost ledger (metrics/ledger.py): ``self.ledger`` records each round
program (``kavg.train``, ``kavg.train_multi``, ``kavg.train_indexed``,
``kavg.train_multi_indexed``, ``kavg.eval``) and the merge's wire plan
(``merge.<strategy>``). The port builds no compiled program, so a
dispatch counts as "compiled" exactly when the reference's program
cache would miss: the engine keeps the reference's cache keys (worker
count per lane, step and batch shape, batch keys or the device cache's
signature, ``collect_stats``). At such a dispatch the closed-form
record is installed (``recaptures`` counts a program's later ones), and
every dispatch attributes its real samples; ``RoundStats.compiled``
carries the flag to the job's compile tracker. Each step's dropout
generator is a Philox
``torch.Generator`` seeded from that step's (worker, step) key data
(``rngs [W, S, 2]`` uint32); jax.random's bits cannot be reproduced.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from kubeml_tpu_torch.metrics.ledger import CostLedger
from kubeml_tpu_torch.models.base import module_state
from kubeml_tpu_torch.parallel import distributed as dist_lib
from kubeml_tpu_torch.parallel import merge as merge_lib
from kubeml_tpu_torch.parallel.merge import _local_sum

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
                 spread_device: Optional[torch.Tensor] = None,
                 compiled: bool = False):
        # True when the reference would have built a new program for
        # this dispatch (a new round key): the job's compile tracker
        # counts these
        self.compiled = compiled
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


def gather_batch(cache, idx, device, lane=None) -> State:
    """The samples the gather indices ``idx`` name in a device cache
    (``data/device_cache.py``), then the dataset's device transform:
    global indices into a replicated cache, or, with ``lane`` (the lane
    of each index's leading row, broadcastable against it), lane-local
    ones into a sharded cache's slabs."""
    idx = torch.as_tensor(np.asarray(idx, np.int32), device=device).long()
    if lane is None:
        raw = {k: v[idx] for k, v in cache.arrays.items()}
    else:
        raw = {k: v[lane, idx] for k, v in cache.arrays.items()}
    if cache.device_transform is not None:
        return dict(cache.device_transform(raw["x"], raw["y"]))
    return raw


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

    n_lanes: data lanes D (the reference's ``data`` mesh axis), over the
    data group's ranks when a process group is initialized (D a multiple
    of its size); W must be a multiple of D. merge_dtype (a floating
    torch dtype), merge_bucket_mb and merge_compress ("none" | "bf16" |
    "int8") pick the merge strategy as in the reference
    (``merge.make_strategy``, with the reference's ring, ``use_ring``,
    where the reference takes it: an inner axis, no seq round and not
    ``manual_inner``).
    collect_stats adds the per-worker health stats and the loss spread to
    ``RoundStats``; they are extra outputs and change no weight. n_seq
    and batch_seq_dims, n_expert, n_model, n_stage: the inner round
    (module docstring); ``module`` must then be built after the model's
    ``enable_seq_parallel`` / ``enable_expert_parallel`` /
    ``enable_tensor_parallel`` (its loss taken after its
    ``enable_pipeline_parallel``), and the world must split into inner
    groups of n_model x n_seq x n_stage x n_expert ranks. manual_inner:
    the round is the reference's fully-manual one (its manual
    tensor-parallel or pipeline route), whose merge takes no ring.
    """

    def __init__(self, module: torch.nn.Module, loss_fn: LossFn,
                 metrics_fn: MetricsFn, tx_factory: TxFactory,
                 n_lanes: int = 1, merge_dtype: Optional[torch.dtype] = None,
                 merge_bucket_mb: float = 0.0, merge_compress: str = "none",
                 collect_stats: bool = False, n_seq: int = 1,
                 batch_seq_dims: Optional[Dict[str, int]] = None,
                 n_expert: int = 1, n_model: int = 1,
                 manual_inner: bool = False, n_stage: int = 1):
        if int(n_lanes) < 1:
            raise ValueError(f"n_lanes must be >= 1, got {n_lanes}")
        self.grid = dist_lib.make_grid(int(n_seq), int(n_expert),
                                       int(n_model), int(n_stage))
        # this rank's lanes over the data group (every lane without one)
        self.layout = dist_lib.lane_layout(int(n_lanes), self.grid.n_data,
                                           self.grid.data_index)
        self.batch_seq_dims = dict(batch_seq_dims or {})
        self._seq_train = self.grid.n_seq > 1 and bool(self.batch_seq_dims)
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
        # the reference's ring: a lossy wire on a mesh whose inner axes
        # stay AUTO (its round is not fully manual: no seq round, not the
        # manual tensor-parallel route)
        self._wire_ring = self.grid.n_inner > 1 and not (
            self._seq_train or bool(manual_inner))
        self._merge = merge_lib.make_strategy(
            merge_dtype=merge_dtype, bucket_mb=self.merge_bucket_mb,
            compress=self.merge_compress, use_ring=self._wire_ring)
        self._ef = self._merge.needs_residual
        # the EF residuals of this rank's lanes: flat [D_local * L] f32
        # tensors by bucket name, lane-major; None until the first
        # compressed round
        self._ef_state: Optional[State] = None
        # the reference's program-cache keys: a dispatch whose key is new
        # is the one the reference compiles (and captures cost) at
        self._train_keys: set = set()
        self._eval_keys: set = set()
        # analytic cost ledger (metrics/ledger.py): one record per round
        # program, dispatches attribute samples, and the merge wire plan
        # is registered as an exact analytic kernel record
        self.ledger = CostLedger()

    @property
    def merge_strategy(self) -> str:
        """Registered name of the active merge strategy."""
        return self._merge.name

    @property
    def programs_compiled(self) -> int:
        """Distinct train-round programs the reference would have built
        for this engine's dispatches."""
        return len(self._train_keys)

    def merge_comm_proxy(self, variables: State) -> Dict[str, int]:
        """Deterministic per-round wire numbers of this engine's merge
        strategy over ``variables`` (merge.MergeStrategy.comm_proxy)."""
        out = self._merge.comm_proxy(variables)
        out["strategy"] = self._merge.name
        return out

    def _cost_fallback(self, variables: State, samples: int) -> dict:
        """The reference's closed-form per-dispatch record: ~6 flops per
        weight per sample (dense forward + backward + update) over the
        variables read and written plus the merge wire payload."""
        nbytes = sum(int(t.numel()) * int(t.element_size())
                     for t in variables.values())
        payload = self._merge.comm_proxy(variables)["merge_payload_bytes"]
        return {"flops": 6.0 * (nbytes / 4.0) * max(samples, 1),
                "hbm_bytes": float(3 * nbytes + payload)}

    def _account(self, program: str, key: tuple, variables: State,
                 sample_mask) -> bool:
        """The ledger's side of one train dispatch, before it runs (as
        the reference's): on a new key install the program's record and
        the merge's; then attribute the dispatch's real samples. Returns
        whether the reference would have compiled."""
        samples = int(np.asarray(sample_mask).sum())
        compiled = key not in self._train_keys
        if compiled:
            self._train_keys.add(key)
            self.ledger.capture(
                program, "train", None,
                fallback=self._cost_fallback(variables, samples))
            merge_lib.register_strategy_cost(self.ledger, self._merge,
                                             variables)
        self.ledger.note_dispatch(program, samples=samples)
        return compiled

    def reset_merge_residuals(self) -> None:
        """Drop the EF residual state (membership or shape changes, or a
        cold restart where carrying stale error would be wrong)."""
        self._ef_state = None

    def _ef_residuals(self, variables: State) -> State:
        """The current per-lane EF residuals, zero-initialised on first
        use and re-made when the bucket plan changes."""
        sizes = self._merge.residual_sizes(variables)
        state = self._ef_state
        lanes = self.layout.per_rank
        if (state is not None and set(state) == set(sizes)
                and all(state[k].numel() == lanes * n
                        for k, n in sizes.items())):
            return state
        self._ef_state = {k: torch.zeros(lanes * n, device=self.device)
                          for k, n in sizes.items()}
        return self._ef_state

    def _load(self, variables: State) -> None:
        """Round-start values into the module: every parameter and every
        buffer (the state must name them all)."""
        with torch.no_grad():
            for name, t in self._state.items():
                t.copy_(variables[name])

    def _to_device(self, batch: Dict, lead: int = 3) -> State:
        """A host batch on the device; under the seq round, each
        seq-carrying key's [T / n_seq] slice of this rank (``lead``: the
        axes before the per-example ones, [W, S, B] or [R, W, S, B])."""
        if self._seq_train:
            n, i = self.grid.n_seq, self.grid.seq_index
            batch = dict(batch)
            for k, d in self.batch_seq_dims.items():
                if k in batch:
                    v = np.asarray(batch[k])
                    T = v.shape[lead + d]
                    idx = [slice(None)] * v.ndim
                    idx[lead + d] = slice(i * (T // n), (i + 1) * (T // n))
                    batch[k] = v[tuple(idx)]
        return {k: torch.as_tensor(v, device=self.device)
                for k, v in batch.items()}

    def _inner_grads(self) -> None:
        """The inner round's gradient: the parameters' gradients summed
        over the inner group, in one all-reduce (each rank backpropagated
        1 / n_inner of the loss every rank of it computes alike)."""
        params = list(self._params.values())
        flat = torch.cat([(p.grad if p.grad is not None
                           else torch.zeros_like(p)).reshape(-1).float()
                          for p in params])
        flat = dist_lib.all_reduce(flat, group=self.grid.inner_group)
        off = 0
        for p in params:
            k = p.numel()
            p.grad = flat[off:off + k].view_as(p).to(p.dtype)
            off += k

    def _workers_per_lane(self, W: int) -> int:
        if W % self.n_lanes:
            raise ValueError(f"W={W} not a multiple of lanes={self.n_lanes}")
        return W // self.n_lanes

    def _own(self, W: int) -> slice:
        """This rank's workers of a round of W (every worker without a
        group): the rows of the worker axis it copies to its device."""
        per_lane = self._workers_per_lane(W)
        w0 = self.layout.first_lane * per_lane
        return slice(w0, w0 + self.layout.per_rank * per_lane)

    def _worker(self, variables: State, data: State, smasks: torch.Tensor,
                step_mask: np.ndarray, rngs: np.ndarray, lr: float,
                epoch: int):
        """K masked local steps of one worker from the round-start state,
        given its own [S, ...] rows of every array: (new state, loss sum,
        [3] stat sums or None)."""
        dev = self.device
        self._load(variables)
        params = list(self._params.values())
        opt = self.tx_factory(lr, epoch)(params)
        loss_sum = torch.zeros((), device=dev)
        stat_sum = torch.zeros(3, device=dev) if self.collect_stats else None
        for s in range(step_mask.shape[0]):
            if step_mask[s] == 0:
                continue                 # a padded step changes nothing
            loss = masked_scalar_loss(
                self.loss_fn, self.module,
                {k: v[s] for k, v in data.items()},
                _generator(rngs[s], dev), smasks[s])
            opt.zero_grad(set_to_none=True)
            if self.grid.n_inner > 1:
                (loss / self.grid.n_inner).backward()
                self._inner_grads()
            else:
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
        """One sync round: (merged weights, loss sums [W], drops [W],
        stat rows [W, 3] or None, spread or None). ``data`` and ``smasks``
        are on the device and hold only this rank's workers (``_own``);
        the host masks and rngs hold all W. Under a group this rank runs
        the workers of its own lanes; the count, the moments and the lane
        sums are summed across ranks, the per-worker rows gathered."""
        dist_lib.use_grid(self.grid)   # the merge sums over its data group
        W = step_mask.shape[0]
        per_lane = self._workers_per_lane(W)
        D, dev = self.layout.per_rank, self.device
        w0 = self.layout.first_lane * per_lane    # this rank's workers
        collect = self.collect_stats
        contrib = {n: torch.zeros((D, *v.shape), dtype=torch.float32,
                                  device=dev) for n, v in variables.items()}
        zero = torch.zeros((), device=dev)
        Wl = D * per_lane
        loss_sums, dropped = [zero] * Wl, [zero] * Wl
        stat_rows = [torch.zeros(3, device=dev)] * Wl
        eff = [zero] * D
        m1, m2 = [zero] * D, [zero] * D   # spread moments, per lane
        for wl in range(Wl):
            w = w0 + wl
            if worker_mask[w] == 0:
                continue                 # masked out: contributes nothing
            d = wl // per_lane
            new, loss_sum, stat_sum = self._worker(
                variables, {k: v[wl] for k, v in data.items()}, smasks[wl],
                step_mask[w], rngs[w], lr, epoch)
            with torch.no_grad():
                ok = tree_all_finite(new) & torch.isfinite(loss_sum)
                for n, c in contrib.items():
                    c[d] += torch.where(ok, new[n], 0).float()
                loss_sums[wl] = torch.where(ok, loss_sum, zero)
                dropped[wl] = (~ok).float()
                eff[d] = eff[d] + ok.float()
                if collect:
                    # the same select-not-multiply guard as the loss: a
                    # dropped worker's NaN stats must not poison the sums
                    stat_rows[wl] = torch.where(ok, stat_sum, 0.0)
                    mean_v = loss_sum / max(float(step_mask[w].sum()), 1.0)
                    safe = torch.where(ok, mean_v, 0.0)
                    m1[d] = m1[d] + safe
                    m2[d] = m2[d] + safe * safe
        eff_count = torch.stack(eff)           # [D_local] per-lane counts
        # the count and the spread moments: the rank's lanes in lane
        # order, then one sum across the data group's ranks
        data_group = self.grid.data_group
        sums = dist_lib.all_reduce(torch.stack(
            [_local_sum(eff_count)]
            + ([_local_sum(torch.stack(m1)), _local_sum(torch.stack(m2))]
               if collect else [])), group=data_group)
        raw_count = sums[0]
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
            mean1 = sums[1] / count
            mean2 = sums[2] / count
            spread = torch.sqrt((mean2 - mean1 * mean1).clamp_min(0.0))
        # every worker's [loss, drop, 3 stats] row, in worker order
        rows = dist_lib.all_gather_cat(torch.cat(
            [torch.stack(loss_sums)[:, None], torch.stack(dropped)[:, None]]
            + ([torch.stack(stat_rows)] if collect else []), dim=1),
            group=data_group)
        return (avg, rows[:, 0], rows[:, 1],
                rows[:, 2:] if collect else None, spread)

    @staticmethod
    def _masks(sample_mask, step_mask, worker_mask, rngs):
        return (np.asarray(sample_mask, np.float32),
                np.asarray(step_mask, np.float32),
                np.asarray(worker_mask, np.float32),
                np.asarray(rngs, np.uint32))

    def _single(self, variables: State, batch_fn: Callable[[], State],
                sample_mask, step_mask, worker_mask, rngs, lr: float,
                epoch: int, compiled: bool) -> Tuple[State, RoundStats]:
        """One round over the device batch ``batch_fn()`` gives (this
        rank's workers)."""
        sample_mask, step_mask, worker_mask, rngs = self._masks(
            sample_mask, step_mask, worker_mask, rngs)
        own = self._own(step_mask.shape[0])
        avg, loss_sums, dropped, stats, spread = self._round(
            variables, batch_fn(),
            torch.as_tensor(sample_mask[own], device=self.device), step_mask,
            worker_mask, rngs, lr, epoch)
        return avg, RoundStats(
            loss_sum_device=loss_sums,
            step_count=step_mask.sum(axis=1),
            sample_count=sample_mask.sum(axis=(1, 2)),
            contributors=float(worker_mask.sum()),
            dropped_device=dropped, stat_device=stats, spread_device=spread,
            compiled=compiled)

    def _multi(self, variables: State, batch_fn: Callable[[int], State],
               sample_mask, step_mask, worker_mask, rngs, lr: float,
               epoch: int, compiled: bool) -> Tuple[State, RoundStats]:
        """R rounds, round r over the device batch ``batch_fn(r)`` (this
        rank's workers)."""
        sample_mask, step_mask, worker_mask, rngs = self._masks(
            sample_mask, step_mask, worker_mask, rngs)
        own = self._own(step_mask.shape[1])
        smasks = torch.as_tensor(sample_mask[:, own], device=self.device)
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
            spread_device=torch.stack(spread) if collect else None,
            compiled=compiled)

    def train_round(self, variables: State, batch: Dict,
                    sample_mask: np.ndarray, step_mask: np.ndarray,
                    worker_mask: np.ndarray, rngs: np.ndarray, lr: float,
                    epoch: int) -> Tuple[State, RoundStats]:
        """One sync round. batch leaves [W, S, B, ...]; sample_mask
        [W, S, B]; step_mask [W, S]; worker_mask [W]; rngs [W, S, 2]
        uint32 key data (all host arrays). W must be a multiple of
        n_lanes."""
        w_per_lane = self._workers_per_lane(int(np.shape(step_mask)[0]))
        tree = tuple(sorted(batch))
        key = (w_per_lane, tuple(np.shape(batch[tree[0]])[1:3]), tree,
               self.collect_stats)
        compiled = self._account("kavg.train", key, variables, sample_mask)
        own = self._own(int(np.shape(step_mask)[0]))
        return self._single(variables,
                            lambda: self._to_device(
                                {k: v[own] for k, v in batch.items()}),
                            sample_mask, step_mask, worker_mask, rngs, lr,
                            epoch, compiled)

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
        R, W = np.shape(step_mask)[:2]
        w_per_lane = self._workers_per_lane(int(W))
        tree = tuple(sorted(batch))
        key = ("multi", int(R), w_per_lane,
               tuple(np.shape(batch[tree[0]])[2:4]), tree,
               self.collect_stats)
        compiled = self._account("kavg.train_multi", key, variables,
                                 sample_mask)
        own = self._own(int(W))
        data = self._to_device({k: v[:, own] for k, v in batch.items()},
                               lead=4)
        return self._multi(variables,
                           lambda r: {k: v[r] for k, v in data.items()},
                           sample_mask, step_mask, worker_mask, rngs, lr,
                           epoch, compiled)

    def _refuse_seq_indexed(self) -> None:
        if self._seq_train:
            raise ValueError("index-fed rounds do not support "
                             "sequence-parallel batch sharding")

    def _gather(self, cache, idx) -> State:
        """A round's batch from the device cache, this rank's workers: the
        [W, S, B] gather indices (lane-local into lane w // (W / D)'s slab
        for a sharded cache, global for a replicated one) of those workers
        uploaded, the raw leaves gathered on the device, then the
        dataset's device transform."""
        W = int(np.shape(idx)[0])
        own = self._own(W)
        lane = None
        if cache.layout == "sharded":
            if cache.n_lanes != self.n_lanes:
                raise ValueError(f"a sharded cache of {cache.n_lanes} lanes "
                                 f"cannot feed {self.n_lanes} lanes")
            lane = (torch.arange(own.start, own.stop, device=self.device)
                    // self._workers_per_lane(W)).view(-1, 1, 1)
        return gather_batch(cache, idx[own], self.device, lane)

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
        self._refuse_seq_indexed()
        w_per_lane = self._workers_per_lane(int(np.shape(step_mask)[0]))
        key = ("idx", w_per_lane, tuple(np.shape(idx)[1:3]),
               cache.signature, self.collect_stats)
        compiled = self._account("kavg.train_indexed", key, variables,
                                 sample_mask)
        return self._single(variables, lambda: self._gather(cache, idx),
                            sample_mask, step_mask, worker_mask, rngs, lr,
                            epoch, compiled)

    def train_rounds_indexed(self, variables: State, cache,
                             idx: np.ndarray, sample_mask: np.ndarray,
                             step_mask: np.ndarray, worker_mask: np.ndarray,
                             rngs: np.ndarray, lr: float, epoch: int
                             ) -> Tuple[State, RoundStats]:
        """R index-fed sync rounds: train_rounds with ``idx``
        [R, W, S, B] in place of the batch leaves; each round gathers its
        own samples."""
        self._refuse_seq_indexed()
        R, W = np.shape(step_mask)[:2]
        w_per_lane = self._workers_per_lane(int(W))
        key = ("idx-multi", int(R), w_per_lane, tuple(np.shape(idx)[2:4]),
               cache.signature, self.collect_stats)
        compiled = self._account("kavg.train_multi_indexed", key, variables,
                                 sample_mask)
        return self._multi(variables, lambda r: self._gather(cache, idx[r]),
                           sample_mask, step_mask, worker_mask, rngs, lr,
                           epoch, compiled)

    @torch.no_grad()
    def eval_round(self, variables: State, batch: Dict,
                   sample_mask: np.ndarray,
                   metric_names: Tuple[str, ...] = ("loss", "accuracy")
                   ) -> Dict[str, float]:
        """Datapoint-weighted evaluation over every worker's batches:
        metric = sum(per-example value * sample mask) / n."""
        samples = int(np.asarray(sample_mask).sum())
        sample_mask = np.asarray(sample_mask, np.float32)
        W, S = sample_mask.shape[:2]
        tree = tuple(sorted(batch))
        key = (self._workers_per_lane(W),
               tuple(np.shape(batch[tree[0]])[1:3]), tuple(metric_names),
               tree)
        if key not in self._eval_keys:
            self._eval_keys.add(key)
            self.ledger.capture(
                "kavg.eval", "train", None,
                fallback=self._cost_fallback(variables, samples))
        self.ledger.note_dispatch("kavg.eval", samples=samples)
        dist_lib.use_grid(self.grid)   # the model's inner collectives
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
