"""Synchronous data parallelism over data lanes, with persistent optimizer
state and physical ZeRO-1/FSDP shards over ranks (twin of
kubeml_tpu/parallel/syncdp.py).

The JAX package's second training engine: every step averages the
GRADIENT of one global batch and applies it with an optimizer whose state
persists across steps, dispatches and epochs, where the K-avg engine
(``parallel/kavg.py``) averages weights every K steps and builds a fresh
optimizer for every worker of every round. Lanes are the reference's
``data`` mesh axis: lane d owns the contiguous slice
``[d * G / D, (d + 1) * G / D)`` of each step's global batch of G
samples. Without a process group every lane runs on the one device; under
an initialized group (``parallel/distributed.py``) the lanes are laid out
over the ranks as the K-avg engine lays them out (``lane_layout``: lane d
on rank d // (D / world)), and each rank copies to its device only its
lanes' contiguous slice of every global batch.

Two gradient paths, as in the reference:

  - IMPLICIT (``merge_strategy=None``): one masked loss and one backward
    per step. A rank's loss is the masked loss SUM of its slice divided by
    the GLOBAL real-sample count (read from the host's global mask), so
    the sum over the ranks of their gradients is the one-process masked
    mean: what the reference's GSPMD all-reduce computes. Dropout draws
    the whole global batch's uniforms from the step's generator and keeps
    the rank's rows (``models.layers.RowDraw``), so a rank drops what one
    process drops.
  - EXPLICIT (``merge_strategy`` "monolithic" | "bucketed" | "ef_bf16" |
    "ef_int8", ``parallel/merge.py``): each lane takes the gradient of
    its UNNORMALIZED masked loss sum over its slice, every lane starting
    from the same model buffers and drawing dropout from the same seed;
    the strategy's ``lane_merge`` sums the lanes over every rank
    (``count`` = 1 over a zero ``ref``: the bucketed and EF strategies
    finish through the fused merge, ``ops/fused_merge.py``, on every
    rank), and the sum is divided by the global real-sample count. Float
    buffers come back as the mean over all D lanes (the DDP convention),
    integer ones pass through. EF strategies keep the residuals of the
    rank's lanes in the state (``merge_resid``: flat [D_local * L] f32 per
    compressible bucket).

ZeRO-1 and FSDP. ``param_specs`` and ``opt_specs`` hold the reference's
layout decisions (``_opt_spec_for``: shard dim 0 of a leaf's layout
shape over ``data`` when it divides D, else replicate; the optimizer's
scalar step counts always replicate), read from each parameter's shape
in the JAX package's layout (``layout_shapes``,
``convert.flax_layout_shapes``). A leaf the rule shards is split over
the ranks as a FLAT tensor: rank r holds the contiguous elements
``[r * n / world, (r + 1) * n / world)`` (its lanes' pieces), 1/world of
the leaf. The persistent optimizer is built over these shard tensors and
the replicated leaves whole, so each rank keeps 1/world of the sharded
moments and computes 1/world of their update. The elements a rank holds
are not the reference's dim-0 rows (torch's Dense weight is flax's
kernel transposed); every update the port's models configure is
elementwise, so the numbers do not depend on it (ROADMAP C.12). A step
under a group:

  implicit: the rank's backward; one ``reduce_scatter`` of the sharded
    leaves' gradients packed rank-major into one flat buffer; one
    ``all_reduce`` of the replicated leaves' gradients with the guard's
    scalars (the loss and the rank's count of non-finite reduced shards);
    the guard's one readback; ``step()`` on the shards; one
    ``all_gather_into`` of the new shards into the module's parameters;
  explicit: the rank's lanes, ``lane_merge`` (every rank holds the
    merged sum), the guard, ``step()`` on the shards, the
    ``all_gather_into``.

With ``fsdp`` the state's ``params`` hold only the shards between
dispatches (the replicated leaves whole): each step starts with one
``all_gather_into`` that fills the module's working parameters, and a
dispatch releases their storage when it returns (the parameter becomes
an empty tensor until the next dispatch or ``variables``). Per-layer
gathers at use are not ported (ROADMAP). At world size 1 every shard is
whole: the engine computes the same numbers with ``zero1``/``fsdp`` on or
off. Without a group the same steps run, every collective an identity
(``parallel/distributed.py``), and none is issued.

The skip-step guard: a step with real samples whose merged gradient or
loss is non-finite (or, explicit path, one of whose lanes went
non-finite: EF payload masking would hide it) is skipped on every rank:
parameters, buffers and the optimizer's state, its step count included,
stay where they were, the step reports loss 0 and raises its skipped
flag, and the EF residuals are zeroed. The verdict comes from values
every rank holds alike after the step's collectives and is READ BACK
once per real step (``readbacks`` counts these host syncs): torch's
optimizers update in place and keep the bias-correction step on the
host, so the port decides on the host whether to call ``step()`` where
the reference selects whole optimizer states on the device. An
all-masked step (an epoch's ragged tail) is a true no-op, decided on the
host from the GLOBAL sample mask every rank is handed: it is not run,
and the EF residuals carry. A rank that took another branch than its
peers would hang in their next collective.

Over more than one rank the implicit path refuses a model whose layers
couple the batch's rows (a float buffer: BatchNorm's global-batch
statistics; a mixture of experts: its capacity over the batch's tokens):
a rank's slice would compute other statistics than the global batch's
(ROADMAP A.21). The explicit path takes them.

The state ``init_state`` builds is ``{params, model_state, opt_state[,
merge_resid]}``: the engine's own copies of the parameters (FSDP: the
shards) and buffers by name, and the persistent ``torch.optim.Optimizer``
(its moments are the opt_state). A dispatch loads the state into the
module, runs its steps and stores the module back into the state's
tensors: the state passed in is updated and returned, as a donated one
is in the reference. Each dispatch rebuilds ``tx_factory(lr, epoch)``
over the optimizer's tensors and copies its hyperparameters (every
param-group entry but the parameters) into the persistent optimizer, as
the reference rebuilds its transformation over the carried opt_state:
the schedule moves, the moments stay.

Index-fed dispatches (``train_steps_indexed``) gather the rank's slice of
the [S, G] global samples from a replicated device cache
(``data/device_cache.py``) and run the same steps, so they equal the
host-staged dispatch of the same samples.

Cost ledger (metrics/ledger.py): ``syncdp.train`` and
``syncdp.train_indexed`` with the reference's closed form (flops = 6 x
parameter elements x samples, hbm_bytes = 3 x parameter bytes, over the
whole model on every rank) installed when the reference would compile (a
new program key), and the explicit strategy's wire record
``merge.<strategy>``; every dispatch attributes its global real samples,
on every rank, as the K-avg records do under ranks. Each step's dropout
generator is seeded from its ``rngs[s]`` key data, the same seed for
every lane (the reference hands every lane the same key); jax.random's
bits cannot be reproduced.

Not ported, of the reference's knobs: ``donate`` (the state is always
updated in place, as a donated one), ``merge_fused`` (its Pallas apply
and lax chain agree bit for bit; here the tensors' device picks the
kernel or its plain version) and the ring reduction ``use_ring`` (the
reference takes it only on a mesh with inner axes, which a SyncDP job
refuses, as the reference's does: ROADMAP A.21).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from kubeml_tpu_torch.api.errors import NotPortedError
from kubeml_tpu_torch.metrics.ledger import CostLedger
from kubeml_tpu_torch.models.layers import RowDraw
from kubeml_tpu_torch.parallel import distributed as dist_lib
from kubeml_tpu_torch.parallel import merge as merge_lib
from kubeml_tpu_torch.parallel.kavg import (LossFn, State, TxFactory,
                                            _generator, gather_batch,
                                            tree_all_finite)
from kubeml_tpu_torch.parallel.merge import _lane_sum

# the reference's layout specs as tuples: PartitionSpec("data") and P()
DATA_AXIS = "data"
SHARDED: Tuple[str, ...] = (DATA_AXIS,)
REPLICATED: Tuple[str, ...] = ()


def couples_rows(module: torch.nn.Module) -> bool:
    """True for a model whose training forward couples the batch's rows:
    a float buffer (BatchNorm's running statistics over the batch) or a
    mixture of experts (capacity over the batch's tokens)."""
    return (any(b.is_floating_point() for b in module.buffers())
            or int(getattr(module, "n_experts", 0) or 0) > 0)


class SyncDPEngine:
    """Per-step gradient-averaging trainer of ``module`` over ``n_lanes``
    data lanes on the module's device, or over the ranks of the process
    group (D a multiple of its world size).

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
        # this rank's lanes (every lane without a group)
        self.layout = dist_lib.lane_layout(int(n_lanes))
        if merge_strategy is not None and fsdp:
            raise ValueError("explicit merge strategies are incompatible "
                             "with fsdp (sharded params rely on GSPMD's "
                             "gradient reduce-scatter)")
        if (merge_strategy is None and self.layout.world > 1
                and couples_rows(module)):
            raise NotPortedError(
                "the implicit SyncDP path over several ranks for a model "
                "whose layers couple the batch's rows (BatchNorm's "
                "statistics, expert capacity)",
                "global-batch statistics across ranks, ROADMAP A.21")
        self.module = module
        self.loss_fn = loss_fn
        self.tx_factory = tx_factory
        self.n_lanes = int(n_lanes)
        self.zero1 = bool(zero1 or fsdp)
        self.fsdp = bool(fsdp)
        # FSDP keeps only shards between dispatches where there are ranks
        # to shard over; at world size 1 it is ZeRO-1
        self._split = self.fsdp and self.layout.world > 1
        self.collect_stats = bool(collect_stats)
        self.device = next(module.parameters()).device
        self._params = dict(module.named_parameters())
        # the parameters' shapes (an fsdp dispatch over ranks releases the
        # module's working copies between dispatches)
        self._shapes = {n: p.shape for n, p in self._params.items()}
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
        # the shard plan (init_state): each sharded leaf's elements per
        # rank and its offset in a rank's packed segment
        self._chunk: Dict[str, int] = {}
        self._offset: Dict[str, int] = {}
        self._segment = 0
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

    def shard_elements(self) -> Dict[str, int]:
        """The elements of each parameter this rank's optimizer state
        holds (and, with fsdp over ranks, its parameter shard): 1/world of
        a leaf the rule shards, the leaf whole otherwise."""
        return {n: self._chunk.get(n, p.numel())
                for n, p in self._params.items()}

    def _meta(self) -> State:
        """The parameters' shapes and dtypes as meta tensors (what the
        bucket plans and the ledger read)."""
        return {n: torch.empty(self._shapes[n], dtype=p.dtype, device="meta")
                for n, p in self._params.items()}

    def _shard_shape(self, n: str) -> torch.Size:
        return self._shapes[n] if self.layout.world == 1 \
            else torch.Size([self._chunk[n]])

    def _piece(self, t: torch.Tensor, n: str) -> torch.Tensor:
        """This rank's shard of ``t`` (a whole tensor of sharded leaf
        ``n``): a view of its contiguous 1/world of the flat elements; t
        itself at world size 1."""
        if self.layout.world == 1:
            return t
        c, r = self._chunk[n], self.layout.rank
        return t.view(-1)[r * c:(r + 1) * c]

    def init_state(self, variables: State, lr: float = 0.0,
                   epoch: int = 0) -> dict:
        """{params, model_state, opt_state[, merge_resid]} from the
        variables (parameters and buffers by name, whole): the engine's
        own copies (with fsdp over ranks, this rank's shards of the
        sharded leaves), a fresh persistent optimizer over this rank's
        shards, and zero EF residuals. Records the layout decisions in
        ``param_specs`` / ``opt_specs`` and the shard plan."""
        self.param_specs = {
            n: self._opt_spec_for(self._layout[n]) if self.fsdp
            else REPLICATED for n in self._params}
        self.opt_specs = {n: self._opt_spec_for(self._layout[n])
                          for n in self._params}
        world = self.layout.world
        self._chunk, self._offset, off = {}, {}, 0
        for n, p in self._params.items():
            if self.opt_specs[n] == SHARDED:
                self._chunk[n] = self._shapes[n].numel() // world
                self._offset[n] = off
                off += self._chunk[n]
        self._segment = off
        dev = self.device
        params = {}
        for n, p in self._params.items():
            whole = variables[n].detach().to(dev, p.dtype)
            params[n] = (self._piece(whole.contiguous(), n).clone()
                         if self._split and n in self._chunk
                         else whole.clone())
        state = {
            "params": params,
            "model_state": {n: variables[n].detach().to(dev, b.dtype).clone()
                            for n, b in self._buffers.items()},
        }
        state["opt_state"] = self.tx_factory(lr, epoch)(
            self._opt_tensors(state))
        if self._ef:
            state["merge_resid"] = {
                k: torch.zeros(self.layout.per_rank * n, device=dev)
                for k, n in self._merge.residual_sizes(
                    self._meta()).items()}
        return state

    def _opt_tensors(self, state: dict) -> List[torch.Tensor]:
        """What the persistent optimizer steps, in parameter order: this
        rank's shard of each sharded leaf (the state's own shard under
        fsdp over ranks, else a view into the module's parameter) and the
        module's replicated parameters whole."""
        out = []
        for n, p in self._params.items():
            if self._split and n in self._chunk:
                out.append(state["params"][n])
            elif n in self._chunk:
                out.append(self._piece(p.detach(), n))
            else:
                out.append(p.detach())
        return out

    def variables(self, state: dict) -> State:
        """The flat variables view (eval, checkpoints, serving): the
        state's parameters whole, then its buffers. Under fsdp over ranks
        the shards are gathered (a collective every rank makes), and the
        module's working parameters get their storage back, so that an
        evaluation can load the view into the module."""
        if not self._split:
            return {**state["params"], **state["model_state"]}
        self._restore_working()
        whole = {n: torch.empty(self._shapes[n], dtype=p.dtype,
                                device=self.device)
                 if n in self._chunk else state["params"][n]
                 for n, p in self._params.items()}
        self._gather_into(whole, state["params"])
        return {**whole, **state["model_state"]}

    def held_tensors(self, state: dict) -> List[torch.Tensor]:
        """The tensors this rank keeps on its device for ``state``
        between dispatches: the state's parameters (shards under fsdp over
        ranks) and buffers, the optimizer's state and the EF residuals
        (the module's own working parameters aside)."""
        out = list(state["params"].values())
        out += list(state["model_state"].values())
        out += [v for st in state["opt_state"].state.values()
                for v in st.values() if torch.is_tensor(v)]
        out += list(state.get("merge_resid", {}).values())
        return out

    def _retune(self, opt: torch.optim.Optimizer, lr: float,
                epoch: int) -> None:
        """This dispatch's hyperparameters into the persistent optimizer:
        ``tx_factory(lr, epoch)`` rebuilt over the optimizer's tensors,
        its param-group entries copied over the old ones; the moments and
        step counts stay."""
        fresh = self.tx_factory(lr, epoch)(
            [t for g in opt.param_groups for t in g["params"]])
        if type(fresh) is not type(opt) or \
                len(fresh.param_groups) != len(opt.param_groups):
            raise ValueError(
                f"tx_factory built a {type(fresh).__name__} with "
                f"{len(fresh.param_groups)} parameter groups for a state "
                f"whose optimizer is a {type(opt).__name__} with "
                f"{len(opt.param_groups)}")
        for group, new in zip(opt.param_groups, fresh.param_groups):
            group.update({k: v for k, v in new.items() if k != "params"})

    def _restore_working(self) -> None:
        """Storage back for the working copies of the sharded parameters
        that the last fsdp dispatch over ranks released (their values
        come from a gather)."""
        for n in self._chunk:
            p = self._params[n]
            if p.shape != self._shapes[n]:
                p.data = torch.empty(self._shapes[n], dtype=p.dtype,
                                     device=self.device)

    @torch.no_grad()
    def _load(self, state: dict) -> None:
        if self._split:
            self._restore_working()   # filled at each step's start
        for n, p in self._params.items():
            if not (self._split and n in self._chunk):
                p.copy_(state["params"][n])
        for n, b in self._buffers.items():
            b.copy_(state["model_state"][n])

    @torch.no_grad()
    def _store(self, state: dict) -> None:
        for n, p in self._params.items():
            if self._split and n in self._chunk:
                # the working copy's storage goes between dispatches
                p.data = torch.empty(0, dtype=p.dtype, device=self.device)
            else:
                state["params"][n].copy_(p)
        for n, b in self._buffers.items():
            state["model_state"][n].copy_(b)

    def _snapshot_buffers(self) -> State:
        return {n: b.detach().clone() for n, b in self._buffers.items()}

    @torch.no_grad()
    def _set_buffers(self, values: State) -> None:
        for n, b in self._buffers.items():
            b.copy_(values[n])

    # ----------------------------------------------------- shard collectives

    @torch.no_grad()
    def _gather_into(self, whole: State, shards: Dict[str, torch.Tensor]
                     ) -> None:
        """One ``all_gather_into`` of this rank's packed shards of every
        sharded leaf, written into the whole tensors ``whole`` (at world
        size 1 without a group, a copy)."""
        if not self._chunk:
            return
        names = list(self._chunk)
        world = self.layout.world
        send = torch.cat([shards[n].reshape(-1) for n in names])
        got = dist_lib.all_gather_into(send).view(world, self._segment)
        for n in names:
            off, c = self._offset[n], self._chunk[n]
            whole[n].view(world, c).copy_(got[:, off:off + c])

    def _reduce_scatter(self, grads: State) -> Dict[str, torch.Tensor]:
        """One ``reduce_scatter`` of the sharded leaves' gradients packed
        rank-major: this rank's shard of each summed over the ranks."""
        names = list(self._chunk)
        world = self.layout.world
        send = torch.empty(world, self._segment, device=self.device)
        for n in names:
            off, c = self._offset[n], self._chunk[n]
            send[:, off:off + c].copy_(grads[n].reshape(world, c))
        got = dist_lib.reduce_scatter(send.view(-1))
        return {n: got[self._offset[n]:self._offset[n] + self._chunk[n]]
                .view(self._shard_shape(n)) for n in names}

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
        gradients of this rank's lanes' unnormalized masked loss sums,
        merged by the strategy over every lane and divided by the global
        real-sample count. Returns (grads, loss, bad-lane count, buffers
        after the step, new residuals or None)."""
        D = self.layout.per_rank
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
        # the live lanes, the bad ones, the samples and the loss: each
        # summed over every lane in one collective
        raw, bad, dn, loss = _lane_sum(torch.stack(
            [alive.float(), 1.0 - lane_finite.float(), lane_n,
             torch.where(lane_finite, lsum, 0.0)], 1))
        with torch.no_grad():
            gsum, new_resid = self._merge.lane_merge(
                contrib, self._zero_ref(), raw, self._one,
                lane_alive=alive, residual=residual)
        dn = dn.clamp_min(1.0)
        grads = {n: gsum[n] / dn for n in self._params}
        loss = loss / dn
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

    def _implicit(self, mb: State, smask: torch.Tensor, key: np.ndarray,
                  count: torch.Tensor, rows: slice, G: int):
        """The implicit path's step: this rank's slice's masked loss sum
        over the global real-sample count ``count``, its backward and the
        reduction over the ranks. Returns (the optimizer's gradients by
        name, this rank's shard of each sharded leaf, the loss, the
        guard's verdict as a 0-d bool tensor)."""
        per_ex = self.loss_fn(self.module, mb,
                              RowDraw(_generator(key, self.device), rows, G),
                              smask)
        loss = (per_ex * smask).sum() / count
        grads = self._grads(loss)
        loss = loss.detach()
        shard = self._reduce_scatter(grads) if self._chunk else {}
        rep = [n for n in self._params if n not in self._chunk]
        bad = (torch.stack([~torch.isfinite(g).all()
                            for g in shard.values()]).any().float()
               if shard else self._zero)
        # the replicated leaves' gradients, the loss and the rank's count
        # of non-finite reduced shards: one all-reduce
        flat = dist_lib.all_reduce(torch.cat(
            [grads[n].reshape(-1).float() for n in rep]
            + [loss.reshape(1), bad.reshape(1)]))
        out, off = dict(shard), 0
        for n in rep:
            k = grads[n].numel()
            out[n] = flat[off:off + k].view(grads[n].shape)
            off += k
        ok = torch.isfinite(flat).all() & (flat[-1] == 0)
        return out, flat[-2], ok

    def _step(self, state: dict, mb: State, smask: torch.Tensor,
              key: np.ndarray, count: torch.Tensor, rows: slice, G: int):
        """One real step: (loss, skipped, stat row or None)."""
        explicit = self._merge is not None
        before = self._snapshot_buffers() if self._buffers else None
        if self._split:
            self._gather_into({n: p.detach() for n, p in
                               self._params.items()}, state["params"])
        if explicit:
            grads, loss, bad, new_bufs, new_resid = self._lane_grads(
                mb, smask, key, before, state.get("merge_resid"))
            ok = tree_all_finite(grads) & torch.isfinite(loss) & (bad == 0)
            grads = {n: self._piece(g, n) if n in self._chunk else g
                     for n, g in grads.items()}
        else:
            grads, loss, ok = self._implicit(mb, smask, key, count, rows, G)
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
        tensors = [t for g in opt.param_groups for t in g["params"]]
        old = ([t.clone() for t in tensors] if self.collect_stats
               else None)
        for n, t in zip(self._params, tensors):
            t.grad = grads[n]
        opt.step()
        opt.zero_grad(set_to_none=True)
        if self.layout.world > 1 and self._chunk and not self._split:
            # the new shards into every rank's whole parameters
            self._gather_into({n: p.detach() for n, p in
                               self._params.items()},
                              dict(zip(self._params, tensors)))
        if explicit:
            if new_bufs is not None:
                self._set_buffers(new_bufs)
            if self._ef:
                state["merge_resid"] = new_resid
        row = None
        if self.collect_stats:
            row = self._stat_row(grads, tensors, old)
        return loss, False, row

    @torch.no_grad()
    def _stat_row(self, grads: State, new: List[torch.Tensor],
                  old: List[torch.Tensor]) -> torch.Tensor:
        """The step's squared global grad, update and param norms: this
        rank's shards, each replicated leaf counted once (on rank 0),
        summed over the ranks."""
        first = self.layout.rank == 0
        rows = [torch.stack([grads[n].float().square().sum(),
                             (t - o).float().square().sum(),
                             t.float().square().sum()])
                for n, t, o in zip(self._params, new, old)
                if n in self._chunk or first]
        row = rows[0]
        for r in rows[1:]:
            row = row + r
        return dist_lib.all_reduce(row)

    def _dispatch(self, state: dict, data_fn: Callable[[], State],
                  sample_mask, rngs, lr: float, epoch: int):
        """S steps over this rank's slice of the [S, G] batch
        ``data_fn()`` gives; ``sample_mask`` is the GLOBAL [S, G] mask."""
        smask = np.asarray(sample_mask, np.float32)
        rngs = np.asarray(rngs, np.uint32)
        G = smask.shape[1]
        rows = self._rows(G)
        self._retune(state["opt_state"], lr, epoch)
        self._load(state)
        dev = self.device
        data = data_fn()
        sm = torch.as_tensor(smask[:, rows], device=dev)
        counts = torch.as_tensor(np.maximum(smask.sum(1), 1.0), device=dev)
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
                state, {k: v[s] for k, v in data.items()}, sm[s], rngs[s],
                counts[s], rows, G)
            losses.append(loss)
            skipped.append(float(skip))
            stats.append(row)
        self._store(state)
        self.last_skipped_device = torch.tensor(skipped, device=dev)
        self.last_stats_device = (torch.stack(stats) if self.collect_stats
                                  else None)
        return state, torch.stack(losses)

    def _rows(self, G: int) -> slice:
        """This rank's contiguous columns of a global batch of G (all G
        without a group)."""
        L = G // self.n_lanes
        first = self.layout.first_lane * L
        return slice(first, first + self.layout.per_rank * L)

    def _to_device(self, batch: Dict) -> State:
        return {k: torch.as_tensor(np.asarray(v), device=self.device)
                for k, v in batch.items()}

    def _account(self, program: str, key: tuple, sample_mask) -> None:
        """The ledger's side of one dispatch, before it runs (as the
        reference's): on a new key the program's closed-form record and
        the merge's wire record; then the dispatch's real samples."""
        samples = int(np.asarray(sample_mask).sum())
        self.last_compiled = key not in self._keys
        if self.last_compiled:
            self._keys.add(key)
            params = self._meta()
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
        [S, G], 1 = real example; rngs [S, 2] uint32 key data. Under a
        group every rank is handed the same global batch and copies its
        lanes' slice. Returns (state, per-step mean losses [S] on the
        device); skipped steps report 0 and are flagged in
        ``last_skipped_device``."""
        tree = tuple(sorted(batch))
        lead = np.shape(batch[tree[0]])
        self._check(int(lead[1]))
        self._account("syncdp.train", (tuple(lead[:2]), tree,
                                       self.collect_stats), sample_mask)
        rows = self._rows(int(lead[1]))
        return self._dispatch(
            state, lambda: self._to_device(
                {k: np.ascontiguousarray(np.asarray(v)[:, rows])
                 for k, v in batch.items()}),
            sample_mask, rngs, lr, epoch)

    def train_steps_indexed(self, state: dict, cache, idx: np.ndarray,
                            sample_mask: np.ndarray, rngs: np.ndarray,
                            lr: float, epoch: int
                            ) -> Tuple[dict, torch.Tensor]:
        """train_steps against a device-resident dataset cache: ``idx``
        [S, G] int32 GLOBAL sample indices in place of the batch leaves
        (the rank gathers its slice's). Needs a replicated cache: a
        lane's slice of the global batch interleaves every worker's
        samples, never one contiguous slab."""
        if cache.layout != "replicated":
            raise ValueError("sync-DP index-fed rounds need a replicated "
                             f"cache, got layout={cache.layout!r}")
        S, G = int(np.shape(idx)[0]), int(np.shape(idx)[1])
        self._check(G)
        self._account("syncdp.train_indexed",
                      ("idx", (S, G), cache.signature, self.collect_stats),
                      sample_mask)
        rows = self._rows(G)
        return self._dispatch(
            state, lambda: gather_batch(cache, np.asarray(idx)[:, rows],
                                        self.device),
            sample_mask, rngs, lr, epoch)
