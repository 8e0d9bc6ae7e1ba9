"""Synchronous data parallelism over data lanes on one device, with
persistent optimizer state (twin of kubeml_tpu/parallel/syncdp.py).

The JAX package's second training engine: every step averages the
GRADIENT of one global batch and applies it with an optimizer whose state
persists across steps, dispatches and epochs, where the K-avg engine
(``parallel/kavg.py``) averages weights every K steps and builds a fresh
optimizer for every worker of every round. Lanes are the reference's
``data`` mesh axis laid out on one device, as in ``KAvgEngine``: lane d
owns the contiguous slice ``[d * G / D, (d + 1) * G / D)`` of each step's
global batch of G samples.

Two gradient paths, as in the reference:

  - IMPLICIT (``merge_strategy=None``): one masked-mean loss and one
    backward over the whole global batch per step. That is what the
    reference's GSPMD all-reduce computes; a BatchNorm's running
    statistics come from global-batch statistics.
  - EXPLICIT (``merge_strategy`` "monolithic" | "bucketed" | "ef_bf16" |
    "ef_int8", ``parallel/merge.py``): each lane takes the gradient of
    its UNNORMALIZED masked loss sum over its slice, every lane starting
    from the same model buffers; the strategy's ``lane_merge`` sums the
    lanes (``count`` = 1 over a zero ``ref``: the bucketed and EF
    strategies finish through the fused merge, ``ops/fused_merge.py``),
    and the sum is divided by the global real-sample count. Float buffers
    come back as the cross-lane mean (the DDP convention), integer ones
    pass through. EF strategies keep per-lane residuals in the state
    (``merge_resid``: flat [D * L] f32 per compressible bucket).

The skip-step guard: a step with real samples whose merged gradient or
loss is non-finite (or, explicit path, one of whose lanes went
non-finite: EF payload masking would hide it) is skipped: parameters,
buffers and the optimizer's state, its step count included, stay where
they were, the step reports loss 0 and raises its skipped flag, and the
EF residuals are zeroed. The guard's verdict is READ BACK once per real
step (``readbacks`` counts these host syncs): torch's optimizers update
in place and keep the bias-correction step on the host, so the port
decides on the host whether to call ``step()`` where the reference
selects whole optimizer states on the device. An all-masked step (an
epoch's ragged tail) is a true no-op, decided on the host from the
sample mask as in kavg: it is not run, and the EF residuals carry.

ZeRO-1 and FSDP: ``param_specs`` and ``opt_specs`` hold the reference's
layout decisions (``_opt_spec_for``: shard dim 0 of a leaf's layout
shape over ``data`` when it divides D, else replicate; the optimizer's
scalar step counts always replicate), read from each parameter's shape
in the JAX package's layout (``layout_shapes``,
``convert.flax_layout_shapes``). On one device nothing is laid out
differently (the reference's one-chip mesh has a data axis of 1), so the
engine computes the same numbers with ``zero1``/``fsdp`` on or off. The
engine runs in one process: under a process group of more than one rank
(``parallel/distributed.py``) it raises NotPortedError; SyncDP over ranks,
with physical ZeRO-1/FSDP shards, is ROADMAP A.20 (C.12 for this
difference).

The state ``init_state`` builds is ``{params, model_state, opt_state[,
merge_resid]}``: the engine's own copies of the parameters and buffers by
name, and the persistent ``torch.optim.Optimizer`` over the module's
parameters (its moments are the opt_state). A dispatch loads the state
into the module, runs its steps and stores the module back into the
state's tensors: the state passed in is updated and returned, as a
donated one is in the reference. Each dispatch rebuilds
``tx_factory(lr, epoch)`` over the parameters and copies its
hyperparameters (every param-group entry but the parameters) into the
persistent optimizer, as the reference rebuilds its transformation over
the carried opt_state: the schedule moves, the moments stay.

Index-fed dispatches (``train_steps_indexed``) gather the [S, G] global
samples from a replicated device cache (``data/device_cache.py``) and run
the same steps, so they equal the host-staged dispatch of the same
samples.

Cost ledger (metrics/ledger.py): ``syncdp.train`` and
``syncdp.train_indexed`` with the reference's closed form (flops = 6 x
parameter elements x samples, hbm_bytes = 3 x parameter bytes) installed
when the reference would compile (a new program key), and the explicit
strategy's wire record ``merge.<strategy>``; every dispatch attributes
its real samples. Each step's dropout generator is seeded from its
``rngs[s]`` key data, the same seed for every lane (the reference hands
every lane the same key); jax.random's bits cannot be reproduced.

Not ported, of the reference's knobs: ``donate`` (the state is always
updated in place, as a donated one), ``merge_fused`` (its Pallas apply
and lax chain agree bit for bit; here the tensors' device picks the
kernel or its plain version) and the ring reduction ``use_ring`` (the
ring runs over ranks, which come to this engine with ROADMAP A.20).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from kubeml_tpu_torch.api.errors import NotPortedError
from kubeml_tpu_torch.metrics.ledger import CostLedger
from kubeml_tpu_torch.parallel import distributed as dist_lib
from kubeml_tpu_torch.parallel import merge as merge_lib
from kubeml_tpu_torch.parallel.kavg import (LossFn, State, TxFactory,
                                            _generator, gather_batch,
                                            masked_scalar_loss,
                                            tree_all_finite, tree_sq_norm)
from kubeml_tpu_torch.parallel.merge import _lane_sum

# the reference's layout specs as tuples: PartitionSpec("data") and P()
DATA_AXIS = "data"
SHARDED: Tuple[str, ...] = (DATA_AXIS,)
REPLICATED: Tuple[str, ...] = ()


class SyncDPEngine:
    """Per-step gradient-averaging trainer of ``module`` over ``n_lanes``
    data lanes on the module's device.

    loss_fn and tx_factory follow the KAvgEngine contract
    (KubeModel.loss / KubeModel.configure_optimizers). ``layout_shapes``
    maps parameter names to their shapes in the JAX package's layout
    (the ZeRO rule reads them); by default the tensors' own shapes."""

    def __init__(self, module: torch.nn.Module, loss_fn: LossFn,
                 tx_factory: TxFactory, n_lanes: int = 1, zero1: bool = True,
                 fsdp: bool = False, collect_stats: bool = False,
                 merge_strategy: Optional[str] = None,
                 merge_bucket_mb: float = 0.0,
                 layout_shapes: Optional[Dict[str, tuple]] = None):
        if int(n_lanes) < 1:
            raise ValueError(f"n_lanes must be >= 1, got {n_lanes}")
        if dist_lib.world_size() > 1:
            raise NotPortedError(
                "the SyncDP engine over several ranks",
                "SyncDP over ranks with physical ZeRO-1/FSDP shards, "
                "ROADMAP A.20")
        if merge_strategy is not None and fsdp:
            raise ValueError("explicit merge strategies are incompatible "
                             "with fsdp (sharded params rely on GSPMD's "
                             "gradient reduce-scatter)")
        self.module = module
        self.loss_fn = loss_fn
        self.tx_factory = tx_factory
        self.n_lanes = int(n_lanes)
        self.zero1 = bool(zero1 or fsdp)
        self.fsdp = bool(fsdp)
        self.collect_stats = bool(collect_stats)
        self.device = next(module.parameters()).device
        self._params = dict(module.named_parameters())
        self._buffers = dict(module.named_buffers())
        self._merge = (merge_lib.strategy_by_name(
            merge_strategy, bucket_mb=float(merge_bucket_mb))
            if merge_strategy is not None else None)
        self._ef = self._merge is not None and self._merge.needs_residual
        shapes = dict(layout_shapes or {})
        self._layout = {n: tuple(shapes.get(n, tuple(p.shape)))
                        for n, p in self._params.items()}
        # the reference's decisions (filled by init_state, as there)
        self.param_specs: Optional[Dict[str, tuple]] = None
        self.opt_specs: Optional[Dict[str, tuple]] = None
        # the reference's program-cache keys: a dispatch whose key is new
        # is the one the reference compiles (and captures cost) at
        self._keys: set = set()
        self.ledger = CostLedger()
        self.last_compiled = False
        # [S] 0/1 device tensor of the last dispatch: 1 = a real step
        # whose update was skipped (non-finite gradient)
        self.last_skipped_device: Optional[torch.Tensor] = None
        # [S, 3] device tensor with collect_stats: per step the squared
        # global grad norm, update norm and (new) param norm; zero rows
        # for masked and skipped steps
        self.last_stats_device: Optional[torch.Tensor] = None
        # host syncs made by the skip-step guard: one per real step
        self.readbacks = 0
        dev = self.device
        self._zero = torch.zeros((), device=dev)
        self._one = torch.ones((), device=dev)
        self._lanes_f = torch.tensor(float(self.n_lanes), device=dev)
        self._zeros: Optional[State] = None

    @property
    def merge_strategy(self) -> Optional[str]:
        """Registered name of the explicit merge strategy, or None when
        the implicit global-batch gradient is in charge."""
        return self._merge.name if self._merge is not None else None

    @property
    def programs_compiled(self) -> int:
        """Distinct train programs the reference would have built for
        this engine's dispatches."""
        return len(self._keys)

    def merge_comm_proxy(self, variables: State) -> Dict[str, int]:
        """Deterministic per-step gradient-merge wire numbers. The
        implicit path is reported as the monolithic strategy over the
        parameters (one full-f32 all-reduce of the gradient)."""
        strategy = self._merge or merge_lib.MERGE_STRATEGIES["monolithic"]()
        params = ({n: variables[n] for n in self._params}
                  if set(self._params) <= set(variables) else variables)
        out = strategy.comm_proxy(params)
        out["strategy"] = self.merge_strategy or "monolithic"
        return out

    # ----------------------------------------------------------------- state

    def _opt_spec_for(self, shape: tuple) -> tuple:
        """ZeRO layout rule: shard dim 0 over ``data`` when it divides the
        axis; scalars and indivisible leaves replicate."""
        if (self.zero1 and len(shape) >= 1 and shape[0] > 0
                and shape[0] % self.n_lanes == 0):
            return SHARDED
        return REPLICATED

    def init_state(self, variables: State, lr: float = 0.0,
                   epoch: int = 0) -> dict:
        """{params, model_state, opt_state[, merge_resid]} from the
        variables (parameters and buffers by name): the engine's own
        copies, a fresh persistent optimizer over the module's
        parameters, and zero EF residuals. Records the layout decisions
        in ``param_specs`` / ``opt_specs``."""
        self.param_specs = {
            n: self._opt_spec_for(self._layout[n]) if self.fsdp
            else REPLICATED for n in self._params}
        self.opt_specs = {n: self._opt_spec_for(self._layout[n])
                          for n in self._params}
        dev = self.device
        state = {
            "params": {n: variables[n].detach().to(dev, p.dtype).clone()
                       for n, p in self._params.items()},
            "model_state": {n: variables[n].detach().to(dev, b.dtype).clone()
                            for n, b in self._buffers.items()},
            "opt_state": self.tx_factory(lr, epoch)(
                list(self._params.values())),
        }
        if self._ef:
            state["merge_resid"] = {
                k: torch.zeros(self.n_lanes * n, device=dev)
                for k, n in self._merge.residual_sizes(
                    state["params"]).items()}
        return state

    def variables(self, state: dict) -> State:
        """The flat variables view (eval, checkpoints, serving): the
        state's parameters, then its buffers."""
        return {**state["params"], **state["model_state"]}

    def _retune(self, opt: torch.optim.Optimizer, lr: float,
                epoch: int) -> None:
        """This dispatch's hyperparameters into the persistent optimizer:
        ``tx_factory(lr, epoch)`` rebuilt over the parameters, its
        param-group entries copied over the old ones; the moments and
        step counts stay."""
        fresh = self.tx_factory(lr, epoch)(list(self._params.values()))
        if type(fresh) is not type(opt) or \
                len(fresh.param_groups) != len(opt.param_groups):
            raise ValueError(
                f"tx_factory built a {type(fresh).__name__} with "
                f"{len(fresh.param_groups)} parameter groups for a state "
                f"whose optimizer is a {type(opt).__name__} with "
                f"{len(opt.param_groups)}")
        for group, new in zip(opt.param_groups, fresh.param_groups):
            group.update({k: v for k, v in new.items() if k != "params"})

    @torch.no_grad()
    def _load(self, state: dict) -> None:
        for n, p in self._params.items():
            p.copy_(state["params"][n])
        for n, b in self._buffers.items():
            b.copy_(state["model_state"][n])

    @torch.no_grad()
    def _store(self, state: dict) -> None:
        for n, p in self._params.items():
            state["params"][n].copy_(p)
        for n, b in self._buffers.items():
            state["model_state"][n].copy_(b)

    def _snapshot_buffers(self) -> State:
        return {n: b.detach().clone() for n, b in self._buffers.items()}

    @torch.no_grad()
    def _set_buffers(self, values: State) -> None:
        for n, b in self._buffers.items():
            b.copy_(values[n])

    # ----------------------------------------------------------------- train

    def _grads(self, loss: torch.Tensor) -> State:
        """d loss / d parameters by name (zeros for an unused one)."""
        params = list(self._params.values())
        gs = torch.autograd.grad(loss, params, allow_unused=True)
        return {n: torch.zeros_like(p) if g is None else g
                for (n, p), g in zip(self._params.items(), gs)}

    def _zero_ref(self) -> State:
        """The zero ``ref`` of the per-step lane merge (read only)."""
        if self._zeros is None:
            self._zeros = {n: torch.zeros(p.shape, dtype=torch.float32,
                                          device=self.device)
                           for n, p in self._params.items()}
        return self._zeros

    def _lane_grads(self, mb: State, smask: torch.Tensor, key: np.ndarray,
                    base: Optional[State], residual: Optional[State]):
        """The explicit path's step from the buffers ``base``: per-lane
        gradients of the lanes' unnormalized masked loss sums, merged by
        the strategy and divided by the global real-sample count. Returns
        (grads, loss, bad-lane count, buffers after the step, new
        residuals or None)."""
        D = self.n_lanes
        L = smask.shape[0] // D
        lane_grads, lsums, lane_bufs = [], [], []
        for d in range(D):
            if d and base is not None:
                self._set_buffers(base)     # every lane starts alike
            sl = slice(d * L, (d + 1) * L)
            lm = smask[sl]
            per_ex = self.loss_fn(self.module, {k: v[sl] for k, v in
                                                mb.items()},
                                  _generator(key, self.device), lm)
            lsum = (per_ex * lm).sum()
            lane_grads.append(self._grads(lsum))
            lsums.append(lsum.detach().float())
            if base is not None:
                lane_bufs.append(self._snapshot_buffers())
        contrib = {n: torch.stack([g[n] for g in lane_grads]).float()
                   for n in self._params}
        lsum = torch.stack(lsums)                                  # [D]
        # a lane whose gradients went non-finite poisons the step for
        # every lane; the count travels explicitly because EF payload
        # masking would hide its NaN from the merged gradient
        lane_finite = torch.stack(
            [torch.isfinite(c).reshape(D, -1).all(1)
             for c in contrib.values()]).all(0) & torch.isfinite(lsum)
        lane_n = smask.reshape(D, L).sum(1)
        alive = (lane_n > 0) & lane_finite
        raw = _lane_sum(alive.float())
        bad = _lane_sum(1.0 - lane_finite.float())
        with torch.no_grad():
            gsum, new_resid = self._merge.lane_merge(
                contrib, self._zero_ref(), raw, self._one,
                lane_alive=alive, residual=residual)
        dn = _lane_sum(lane_n).clamp_min(1.0)
        grads = {n: gsum[n] / dn for n in self._params}
        loss = _lane_sum(torch.where(lane_finite, lsum, 0.0)) / dn
        new_bufs = None
        if base is not None:
            new_bufs = {}
            for n, b in base.items():
                if b.is_floating_point():
                    mean = _lane_sum(torch.stack(
                        [lb[n].float() for lb in lane_bufs])) / self._lanes_f
                    new_bufs[n] = mean.to(b.dtype)
                else:    # counters advance alike on every lane
                    new_bufs[n] = lane_bufs[0][n]
        return grads, loss, bad, new_bufs, new_resid

    def _step(self, state: dict, mb: State, smask: torch.Tensor,
              key: np.ndarray):
        """One real step: (loss, skipped, stat row or None)."""
        explicit = self._merge is not None
        before = self._snapshot_buffers() if self._buffers else None
        if explicit:
            grads, loss, bad, new_bufs, new_resid = self._lane_grads(
                mb, smask, key, before, state.get("merge_resid"))
            ok = tree_all_finite(grads) & torch.isfinite(loss) & (bad == 0)
        else:
            loss = masked_scalar_loss(self.loss_fn, self.module, mb,
                                      _generator(key, self.device), smask)
            grads = self._grads(loss)
            loss = loss.detach()
            ok = tree_all_finite(grads) & torch.isfinite(loss)
        self.readbacks += 1
        if not bool(ok):               # the guard's one readback per step
            if before is not None:
                self._set_buffers(before)
            if self._ef:
                state["merge_resid"] = {
                    k: torch.zeros_like(v)
                    for k, v in state["merge_resid"].items()}
            zero3 = torch.zeros(3, device=self.device) \
                if self.collect_stats else None
            return self._zero, True, zero3
        opt = state["opt_state"]
        old = ([p.detach().clone() for p in self._params.values()]
               if self.collect_stats else None)
        for n, p in self._params.items():
            p.grad = grads[n]
        opt.step()
        opt.zero_grad(set_to_none=True)
        if explicit:
            if new_bufs is not None:
                self._set_buffers(new_bufs)
            if self._ef:
                state["merge_resid"] = new_resid
        row = None
        if self.collect_stats:
            with torch.no_grad():
                new = {n: p.detach() for n, p in self._params.items()}
                delta = {n: new[n] - o for n, o in zip(new, old)}
                row = torch.stack([tree_sq_norm(grads), tree_sq_norm(delta),
                                   tree_sq_norm(new)])
        return loss, False, row

    def _dispatch(self, state: dict, data_fn: Callable[[], State],
                  sample_mask, rngs, lr: float, epoch: int):
        """S steps over the [S, G] device batch ``data_fn()`` gives."""
        smask = np.asarray(sample_mask, np.float32)
        rngs = np.asarray(rngs, np.uint32)
        self._retune(state["opt_state"], lr, epoch)
        self._load(state)
        dev = self.device
        data = data_fn()
        sm = torch.as_tensor(smask, device=dev)
        losses, skipped, stats = [], [], []
        zero3 = torch.zeros(3, device=dev)
        for s in range(smask.shape[0]):
            if not smask[s].any():
                # an all-masked step is a true no-op (ragged epoch tail):
                # not run, residuals carried
                losses.append(self._zero)
                skipped.append(0.0)
                stats.append(zero3)
                continue
            loss, skip, row = self._step(
                state, {k: v[s] for k, v in data.items()}, sm[s], rngs[s])
            losses.append(loss)
            skipped.append(float(skip))
            stats.append(row)
        self._store(state)
        self.last_skipped_device = torch.tensor(skipped, device=dev)
        self.last_stats_device = (torch.stack(stats) if self.collect_stats
                                  else None)
        return state, torch.stack(losses)

    def _account(self, program: str, key: tuple, state: dict,
                 sample_mask) -> None:
        """The ledger's side of one dispatch, before it runs (as the
        reference's): on a new key the program's closed-form record and
        the merge's wire record; then the dispatch's real samples."""
        samples = int(np.asarray(sample_mask).sum())
        self.last_compiled = key not in self._keys
        if self.last_compiled:
            self._keys.add(key)
            params = state["params"]
            nbytes = sum(int(t.numel()) * int(t.element_size())
                         for t in params.values())
            self.ledger.capture(
                program, "train", None,
                fallback={"flops": 6.0 * (nbytes / 4.0) * max(samples, 1),
                          "hbm_bytes": float(3 * nbytes)})
            if self._merge is not None:
                merge_lib.register_strategy_cost(self.ledger, self._merge,
                                                 params)
        self.ledger.note_dispatch(program, samples=samples)

    def _check(self, G: int) -> None:
        if self.param_specs is None:
            raise ValueError("call init_state() first")
        if G % self.n_lanes:
            raise ValueError(f"global batch {G} not divisible by the "
                             f"data-axis size {self.n_lanes}")

    def train_steps(self, state: dict, batch: Dict, sample_mask: np.ndarray,
                    rngs: np.ndarray, lr: float, epoch: int
                    ) -> Tuple[dict, torch.Tensor]:
        """Run S synchronous steps. batch leaves [S, G, ...] (host arrays)
        with G the GLOBAL batch (a multiple of n_lanes); sample_mask
        [S, G], 1 = real example; rngs [S, 2] uint32 key data. Returns
        (state, per-step mean losses [S] on the device); skipped steps
        report 0 and are flagged in ``last_skipped_device``."""
        tree = tuple(sorted(batch))
        lead = np.shape(batch[tree[0]])
        self._check(int(lead[1]))
        self._account("syncdp.train", (tuple(lead[:2]), tree,
                                       self.collect_stats),
                      state, sample_mask)
        return self._dispatch(
            state, lambda: {k: torch.as_tensor(np.asarray(v),
                                               device=self.device)
                            for k, v in batch.items()},
            sample_mask, rngs, lr, epoch)

    def train_steps_indexed(self, state: dict, cache, idx: np.ndarray,
                            sample_mask: np.ndarray, rngs: np.ndarray,
                            lr: float, epoch: int
                            ) -> Tuple[dict, torch.Tensor]:
        """train_steps against a device-resident dataset cache: ``idx``
        [S, G] int32 GLOBAL sample indices in place of the batch leaves.
        Needs a replicated cache: a lane's slice of the global batch
        interleaves every worker's samples, never one contiguous slab."""
        if cache.layout != "replicated":
            raise ValueError("sync-DP index-fed rounds need a replicated "
                             f"cache, got layout={cache.layout!r}")
        S, G = int(np.shape(idx)[0]), int(np.shape(idx)[1])
        self._check(G)
        self._account("syncdp.train_indexed",
                      ("idx", (S, G), cache.signature, self.collect_stats),
                      state, sample_mask)
        return self._dispatch(
            state, lambda: gather_batch(cache, idx, self.device),
            sample_mask, rngs, lr, epoch)
