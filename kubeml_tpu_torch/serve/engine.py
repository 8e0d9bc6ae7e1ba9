"""Continuous-batching decode engine: slot state + the paged programs
(twin of kubeml_tpu/serve/engine.py).

Up to four programs serve every stream:

  decode     — every call advances every active slot by one token (its
               own feedback, or its final prompt token);
  prefill    — one slot per call, C prompt tokens bulk-written into its
               KV pages (fixed chunk, padded + masked); built when
               prefill_chunk > 0;
  multi-step — K decode steps per call with one read back to the host
               (models/gpt.py build_paged_multi_step_decode); built when
               decode_steps > 1;
  verify     — draft-propose + target-verify + rollback-replay in one
               call (build_paged_spec_verify_step); built when a draft
               module is given. One call emits the accepted prefix plus
               one bonus token per slot.

All of them read the KV context through the paged-attention kernel on
the card (ops/paged_attention.py), and the draft's forward goes through
the flash forward. A token-budget scheduler in step() spends at most
``prefill_budget`` prompt tokens on prefill chunks (FIFO over admission
order), then runs one decode call per weight generation for the streams
past their prompt, so in-flight streams keep their inter-token latency
while new prompts load. Only in the all-decode steady state (no join,
CoW split, prefill progress, stall, masked lane, fault plan or second
resident weight generation) does the scheduler hand the round to the
verify program, else the multi-step program; anything they decline
takes the single step.

Prefix caching rides the page tables: at attach, the prompt's full pages
are matched through the allocator's content-hash index
(pager.chain_hash) and any resident prefix is SHARED — the slot takes
references on the cached pages and its prefill cursor skips past them.
A write into a shared or registered page is COPY-ON-WRITE: the decode
step copies the page first, in the same call.

Weight generations (hot-swap): params are per-slot data. install_weights
adds a generation; every later attach pins to it while attached streams
finish on theirs, and a superseded generation (its params and its
prefix-cache partition) retires when its last slot releases.

Cost ledger (metrics/ledger.py): ``self.ledger`` holds the exact
``pager.decode_kv`` record (the slab's ``decode_bytes_per_token``,
reconciled at tol=0) and, at each program's first dispatch, the
reference's closed-form ``serve.decode``/``serve.prefill`` records;
every dispatch is noted (decode with the tokens it emitted), and
``compile_tracker`` counts each program's first dispatch as its compile.
The reference's XLA-capture records and their reconcile against the KV
proxy have no counterpart here (ROADMAP C.8).

Determinism contract: slot math is row-independent, writable pages of
different requests are disjoint, the attention softmax always runs over
the full fixed context with invalid positions masked, and sampling keys
derive from (request seed, position) only. A request therefore generates
the same tokens alone or packed with neighbours, chunked or token by
token, cache hit or miss — and resumed on a fresh engine after a crash
or a migration, since attach re-prefills prompt + emitted tokens.
"""

from __future__ import annotations

import logging
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from kubeml_tpu_torch._device import DeviceLike, resolve_device
from kubeml_tpu_torch.metrics.ledger import CostLedger
from kubeml_tpu_torch.metrics.runtime import JitCompileTracker
from kubeml_tpu_torch.models.base import PAD_ID, InferenceInputError
from kubeml_tpu_torch.models.gpt import (_param_tree,
                                         build_paged_decode_step,
                                         build_paged_multi_step_decode,
                                         build_paged_prefill_step,
                                         build_paged_spec_verify_step,
                                         compute_params)
from kubeml_tpu_torch.ops.paged_attention import (kernel_geometry_refusal,
                                                  kernel_smem_bytes)
from kubeml_tpu_torch.serve.flight import FlightRecorder
from kubeml_tpu_torch.serve.pager import (KVPageSlab, PageAllocator,
                                          PageGeometry, chain_hash)
from kubeml_tpu_torch.serve.slots import GenerateRequest

logger = logging.getLogger("kubeml_tpu_torch.serve.engine")

ATTN_IMPLS = ("auto", "kernel", "plain")


def check_kernel_geometry(module, geom: PageGeometry, kv_dtype: str,
                          prefill_chunk: int) -> None:
    """Raise ValueError when the paged kernel cannot serve an engine's
    decode (T = 1) or prefill (T = prefill_chunk) calls: head_dim and
    page dtype, or the shared memory of a call over the whole context
    (any page size is taken). A CUDA engine asks this before it
    allocates its slab."""
    G, Pmax = geom.page, geom.pages_per_slot
    D, dtype = module.head_dim, module.dtype
    quantized = kv_dtype == "int8"
    pages = "int8" if quantized else str(dtype).replace("torch.", "")
    for T in sorted({1, prefill_chunk} - {0}):
        why = kernel_geometry_refusal(T, D, G, Pmax, dtype, quantized)
        if why is not None:
            need = kernel_smem_bytes(T, D, G, Pmax, dtype, quantized)
            raise ValueError(
                f"the paged-attention kernel cannot serve this engine: "
                f"page size {G}, head_dim {D}, {pages} pages, {T}-token "
                f"calls over a {Pmax * G}-token context need {need} "
                f"bytes of shared memory: {why}")


def _state_bytes(module, state_dict: Optional[dict]) -> int:
    """Bytes of the parameters the serving programs read, as loaded (the
    module's own state by default)."""
    sd = module.state_dict() if state_dict is None else state_dict
    names: List[str] = []
    _param_tree(module, lambda name, dtype: names.append(name))
    return sum(int(sd[n].numel()) * int(sd[n].element_size())
               for n in names)


class _Slot:
    """Host-side state of one occupied decode slot."""

    __slots__ = ("req", "pos", "prompt", "n_prompt", "seq", "gen",
                 "hash_chain", "hashed_pages", "cached_pages", "prefill_s")

    def __init__(self, req: GenerateRequest, prompt: List[int], seq: int,
                 gen: int = 1):
        self.req = req
        self.prompt = prompt
        self.n_prompt = len(prompt)
        self.pos = 0            # next position to consume
        self.seq = seq          # admission order (newest-stall shedding)
        self.gen = gen          # weight generation pinned at attach
        self.hash_chain = b""   # rolling digest over hashed_pages pages
        self.hashed_pages = 0   # prompt pages matched or registered so far
        self.cached_pages = 0   # prompt pages attached from the cache
        # wall seconds of the calls that computed this request's prompt
        # (the TTFT breakdown's prefill term)
        self.prefill_s = 0.0


class DecodeEngine:
    """Fixed pool of S decode slots over one paged KV slab.

    Not thread-safe by itself: attach/step/cancel/install_weights belong
    to the serving loop thread (ServeService); free_slots/stats reads are
    safe.

    device: None means CUDA (raising without a CUDA device); the module
    must live on the same device. ``variables`` is the module's state
    dict to serve (the module's own by default). prefill_chunk: prompt
    tokens per prefill call (0 disables the prefill program — prompts
    ride the decode step token by token). prefix_cache: share full prompt
    pages across requests by content hash. prefill_budget: prompt tokens
    the scheduler may spend on prefill per step (default: one chunk).
    kv_dtype: "f32" (pages in the module dtype) or "int8". attn_impl
    states what the caller expects of the context read, which the device
    decides (ops/paged_attention.py): "auto" takes either, "kernel"
    demands a CUDA device, "plain" the CPU; a mismatch raises here.
    decode_steps: K > 1 builds the multi-step
    program. draft_module (a GPTModule on the engine's device) with its
    state dict draft_variables builds the speculative verify program,
    with spec_steps = decode_steps if decode_steps > 1 else 4 proposals
    per call over a window of spec_window = min(target max_len, draft
    max_len, slot context) tokens. tracer: optional Tracer for the
    request span trees; flight_steps: the flight recorder's ring size (0
    turns it off); fault_plan: a faults.ServeFaultPlan; strict_pager:
    pager invariant violations raise (tests) instead of counting into
    stats["page_leaks"].

    On CUDA the engine checks, before it allocates its slab, that the
    paged kernel takes its geometry (``check_kernel_geometry``) and
    raises ValueError naming it if not: every step would fail otherwise.
    The CPU's plain version takes any geometry.
    """

    def __init__(self, module, variables: Optional[dict] = None,
                 geom: Optional[PageGeometry] = None, slots: int = 8,
                 page: int = 16, clock=time.perf_counter,
                 prefill_chunk: int = 16, prefix_cache: bool = True,
                 prefill_budget: Optional[int] = None,
                 tracer=None, flight_steps: int = 256,
                 decode_span_every: int = 16, fault_plan=None,
                 strict_pager: bool = True, kv_dtype: str = "f32",
                 attn_impl: str = "auto", decode_steps: int = 1,
                 draft_module=None, draft_variables: Optional[dict] = None,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        if module.device != self.device:
            raise ValueError(f"module lives on {module.device}, engine on "
                             f"{self.device}")
        if attn_impl not in ATTN_IMPLS:
            raise ValueError(f"attn_impl must be one of {ATTN_IMPLS}, got "
                             f"{attn_impl!r}")
        if attn_impl == "plain" and self.device.type != "cpu":
            raise ValueError("attn_impl='plain' is allowed only on the CPU")
        if attn_impl == "kernel" and self.device.type != "cuda":
            raise ValueError("attn_impl='kernel' needs a CUDA device")
        prefill_chunk = int(prefill_chunk)
        if prefill_chunk < 0:
            raise ValueError(
                f"serve prefill chunk must be >= 0 (0 disables chunked "
                f"prefill), got {prefill_chunk}")
        flight_steps = int(flight_steps)
        if flight_steps < 0:
            raise ValueError(
                f"flight_steps must be >= 0 (0 disables the recorder), "
                f"got {flight_steps}")
        self.module = module
        self.kv_dtype = kv_dtype
        self.attn_impl = attn_impl
        self.geom = geom or PageGeometry.for_module(
            slots=slots, page=page, max_len=module.max_len)
        if self.device.type == "cuda":
            check_kernel_geometry(module, self.geom, kv_dtype, prefill_chunk)
        self._step_fn = build_paged_decode_step(module, kv_dtype)
        self.clock = clock
        self.prefill_chunk = prefill_chunk
        self.prefix_cache = bool(prefix_cache)
        self.prefill_budget = int(prefill_budget) if prefill_budget \
            else max(prefill_chunk, 1)
        if self.prefill_budget < 1:
            raise ValueError(
                f"prefill budget must be >= 1, got {self.prefill_budget}")
        self.slab = KVPageSlab(self.geom, module.layers, module.heads,
                               module.head_dim, module.dtype, self.device,
                               kv_dtype=kv_dtype)
        self.pager = PageAllocator(self.geom)
        self._prefill_fn = None
        if prefill_chunk > 0:
            self._prefill_fn = build_paged_prefill_step(
                module, prefill_chunk, kv_dtype)
        # the decode accelerators, selected only in the all-decode steady
        # state (_step_inner); every other round keeps the single step
        decode_steps = int(decode_steps)
        if decode_steps < 1:
            raise ValueError(
                f"serve decode steps must be >= 1, got {decode_steps}")
        self.decode_steps = decode_steps
        self._multi_fn = None
        if decode_steps > 1:
            self._multi_fn = build_paged_multi_step_decode(
                module, decode_steps, kv_dtype)
        # speculation depth K: decode_steps when raised past 1, else 4;
        # the verify window is the largest context both trunks and the
        # slab hold — a slot whose cursor outruns it falls back
        self.draft_module = draft_module
        self._draft_variables = draft_variables
        self._verify_fn = None
        self._draft_params = None
        self.spec_steps = 0
        self.spec_window = 0
        if draft_module is not None:
            if draft_variables is None:
                raise ValueError(
                    "serving with a draft module needs draft_variables")
            self.spec_steps = decode_steps if decode_steps > 1 else 4
            self.spec_window = min(module.max_len,
                                   getattr(draft_module, "max_len", 0),
                                   self.geom.context)
            self._verify_fn = build_paged_spec_verify_step(
                module, draft_module, self.spec_steps, self.spec_window,
                kv_dtype)
            if draft_module.device != self.device:
                raise ValueError(f"draft module lives on "
                                 f"{draft_module.device}, engine on "
                                 f"{self.device}")
            self._draft_params = compute_params(draft_module,
                                                draft_variables)
        # weight generations: each holds its own params on the device
        # until its last slot releases (_maybe_retire)
        self.weight_generation = 1
        self._params_by_gen: Dict[int, dict] = {
            1: compute_params(module, variables)}
        # bytes of each generation's parameters as loaded (the weights
        # the reference's cost fallback sums; the programs' own copy
        # casts the matmul weights to the compute dtype)
        self._param_bytes_by_gen: Dict[int, int] = {
            1: _state_bytes(module, variables)}
        S, Pmax = self.geom.slots, self.geom.pages_per_slot
        self._tables = np.zeros((S, Pmax), np.int32)
        self._slots: List[Optional[_Slot]] = [None] * S
        self._seq = 0
        self.compile_tracker = JitCompileTracker()
        # analytic cost ledger: one record per serve program, installed at
        # its first dispatch, plus the paged-attention KV proxy as an exact
        # analytic record reconciled against the slab
        self.ledger = CostLedger()
        self.ledger.capture_analytic(
            "pager.decode_kv", "serve",
            hbm_bytes=float(self.slab.decode_bytes_per_token))
        self.ledger.reconcile("pager.decode_kv", "hbm_bytes",
                              self.slab.decode_bytes_per_token,
                              tolerance=0.0)
        # host-side observability: request spans on an optional tracer
        # (timestamps from this engine's clock) and the always-on flight
        # recorder; neither touches the device
        self.tracer = tracer
        self.flight = FlightRecorder(flight_steps) if flight_steps else None
        self.decode_span_every = max(1, int(decode_span_every))
        self.fault_plan = fault_plan
        self.strict_pager = bool(strict_pager)
        # an abandoned engine's step() is a no-op: a wedged loop thread
        # that wakes after the supervisor swapped in a replacement can
        # never double-emit tokens the replacement re-decodes
        self._abandoned = False
        self._step_count = 0
        self._dispatch_wall_s = 0.0   # wall time of prefill+decode calls
        self._shed_count = 0          # KV-exhaustion sheds
        self.stats: Dict[str, float] = {
            "dispatches": 0, "generated_tokens": 0, "occupancy_sum": 0,
            "stalls": 0, "prefill_dispatches": 0, "prefill_tokens": 0,
            "decode_tokens": 0, "prefix_hits": 0, "prefix_misses": 0,
            "cow_splits": 0, "weight_swaps": 0, "generations_retired": 0,
            "poisoned": 0, "deadline_expired": 0, "page_leaks": 0,
            "kv_bytes": 0,
            "multi_step_dispatches": 0, "multi_step_compiles": 0,
            "verify_dispatches": 0, "verify_compiles": 0,
            "draft_tokens": 0, "accepted_tokens": 0,
            "rejected_tokens": 0,
        }

    # ------------------------------------------------------------- capacity
    @property
    def slot_count(self) -> int:
        return self.geom.slots

    def active(self) -> int:
        return sum(1 for s in self._slots if s is not None)

    def free_slots(self) -> int:
        return self.geom.slots - self.active()

    def kv_utilization(self) -> float:
        return self.pager.utilization()

    @property
    def kv_bytes_per_token(self) -> int:
        """Device bytes one decoded token moves through the KV cache
        (page geometry x dtype, never a timer)."""
        return self.slab.decode_bytes_per_token

    @property
    def dispatches_per_token(self) -> float:
        """Decode calls per generated token: 1.0 for single-step decode,
        0.0 before the first generated token."""
        toks = self.stats["generated_tokens"]
        return (self.stats["dispatches"] / toks) if toks else 0.0

    @property
    def accepted_per_dispatch(self) -> float:
        """Tokens emitted per speculative verify call (accepted prefix +
        the bonus target pick), from counters; 0.0 before the first."""
        vd = self.stats["verify_dispatches"]
        return (self.stats["accepted_tokens"] / vd) if vd else 0.0

    def prefill_backlog_tokens(self) -> int:
        """Prompt tokens admitted to slots but not yet prefilled."""
        return sum(max(0, sl.n_prompt - 1 - sl.pos)
                   for sl in self._slots if sl is not None)

    def active_generations(self) -> List[int]:
        """Weight generations with resident params: the current one plus
        older ones still pinned by in-flight streams."""
        return sorted(self._params_by_gen)

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    # ------------------------------------------------------------- hot-swap
    def install_weights(self, variables: dict) -> int:
        """Install a new weight generation (a module state dict): streams
        in flight keep decoding on the generation they attached under,
        every later attach pins to the new one. Returns the new
        generation. Serving-loop thread only, like attach/step: a param
        copy racing a step would race the device."""
        self.weight_generation += 1
        self._param_bytes_by_gen[self.weight_generation] = _state_bytes(
            self.module, variables)
        self._params_by_gen[self.weight_generation] = compute_params(
            self.module, variables)
        self.stats["weight_swaps"] += 1
        for gen in list(self._params_by_gen):
            self._maybe_retire(gen)
        return self.weight_generation

    def _maybe_retire(self, gen: int) -> None:
        """Drop a superseded generation's params and prefix-cache
        partition once no slot is pinned to it. The current generation
        never retires."""
        if gen == self.weight_generation:
            return
        if any(sl is not None and sl.gen == gen for sl in self._slots):
            return
        if gen not in self._params_by_gen:
            return
        self.pager.drop_generation(gen)
        self.stats["generations_retired"] += 1
        # last: a reader on another thread that sees the generation gone
        # from active_generations() also sees its retirement counted
        del self._params_by_gen[gen]
        self._param_bytes_by_gen.pop(gen, None)
        logger.info("retired weight generation %d (current %d)", gen,
                    self.weight_generation)

    # -------------------------------------------------------------- tracing
    def _span(self, name: str, start: float, end: float,
              req: GenerateRequest, **args) -> None:
        """One request-tree span, parented to the request's ``generate``
        root; the request's trace_id rides in args."""
        if self.tracer is None:
            return
        if req.trace_id:
            args["trace_id"] = req.trace_id
        self.tracer.add_span(name, start, end, parent="generate",
                             rid=req.rid, **args)

    def _instant(self, name: str, ts: float, req: GenerateRequest,
                 **args) -> None:
        if self.tracer is None:
            return
        if req.trace_id:
            args["trace_id"] = req.trace_id
        self.tracer.instant(name, ts=ts, parent="generate", rid=req.rid,
                            **args)

    # ------------------------------------------------------------ lifecycle
    def check_admissible(self, prompt: List[int],
                         max_new_tokens: int) -> List[int]:
        """Validate + normalize a prompt at admission time. Trailing pads
        are stripped; interior pads stay, as masked-but-position-holding
        context."""
        prompt = [int(t) for t in prompt]
        while prompt and prompt[-1] == PAD_ID:
            prompt.pop()
        if not prompt:
            raise InferenceInputError(
                "prompt needs at least one non-pad token")
        if any(not 0 <= t < self.module.vocab_size for t in prompt):
            raise InferenceInputError(
                f"prompt token ids must lie in [0, "
                f"{self.module.vocab_size})")
        if max_new_tokens < 1:
            raise InferenceInputError("max_new_tokens must be >= 1")
        limit = min(self.geom.context, self.module.max_len)
        if len(prompt) + max_new_tokens > limit:
            raise InferenceInputError(
                f"prompt ({len(prompt)}) + max_new_tokens "
                f"({max_new_tokens}) exceeds the serving context limit "
                f"{limit} (min of KV pages per slot x page size and the "
                f"model's max_len)")
        return prompt

    def attach(self, req: GenerateRequest) -> int:
        """Claim a free slot for a validated request; returns the slot.
        With the prefix cache on, the prompt's full pages are matched
        against the content-hash index and every hit is shared into the
        slot's table — the prefill cursor starts past the matched run.

        A request that already emitted tokens (supervisor recovery, fleet
        migration) is RESUMED: prompt + emitted tokens are re-prefilled as
        one context, and since sampling keys are (seed, position) the
        continuation equals the uninterrupted stream; positions before
        the last context token emit nothing. The stream re-pins its
        generation (resume_gen) when its params are still resident."""
        ctx = list(req.prompt)
        budget = req.max_new_tokens
        if req.tokens:
            ctx = ctx + [int(t) for t in req.tokens]
            budget = max(1, req.max_new_tokens - len(req.tokens))
        prompt = self.check_admissible(ctx, budget)
        gen = self.weight_generation
        if req.resume_gen is not None \
                and req.resume_gen in self._params_by_gen:
            gen = req.resume_gen
        for s, cur in enumerate(self._slots):
            if cur is None:
                t0 = self.clock()
                slot = _Slot(req, prompt, self._seq, gen=gen)
                self._seq += 1
                self._slots[s] = slot
                if self.prefix_cache:
                    self._match_prefix(s, slot)
                t1 = self.clock()
                req.admitted_at = t1
                if req.submitted_at is not None:
                    self._span("queue_wait", req.submitted_at, t0, req)
                self._span("admit", t0, t1, req, slot=s,
                           prompt_tokens=slot.n_prompt,
                           prefix_hit_pages=slot.cached_pages,
                           generation=slot.gen)
                return s
        raise RuntimeError("attach() with no free slot — admission "
                           "accounting is broken")

    def _match_prefix(self, s: int, slot: _Slot) -> None:
        """Walk the prompt's full pages through the prefix cache (the
        slot's generation's partition); stop at the first miss (the chain
        hash makes later pages unmatchable)."""
        G = self.geom.page
        k = 0
        chain = b""
        while (k + 1) * G <= slot.n_prompt and k < self.geom.pages_per_slot:
            digest = chain_hash(chain, slot.prompt[k * G:(k + 1) * G])
            pid = self.pager.lookup_prefix(digest, slot.gen)
            if pid is None:
                self.stats["prefix_misses"] += 1
                break
            self._tables[s, k] = pid
            chain = digest
            k += 1
            self.stats["prefix_hits"] += 1
        slot.hash_chain = chain
        slot.hashed_pages = k
        slot.cached_pages = k
        # the cached KV equals what prefill would write, so the cursor
        # jumps past it; the LAST prompt token always goes through
        # decode, which samples the first output
        slot.pos = min(k * G, slot.n_prompt - 1)

    def _register_full_pages(self, s: int, slot: _Slot) -> None:
        """Publish the slot's newly completed full prompt pages under
        their chain hashes (CoW copies are never re-registered)."""
        G = self.geom.page
        while (slot.hashed_pages + 1) * G <= slot.n_prompt \
                and slot.pos >= (slot.hashed_pages + 1) * G:
            pi = slot.hashed_pages
            digest = chain_hash(slot.hash_chain,
                                slot.prompt[pi * G:(pi + 1) * G])
            self.pager.register_prefix(int(self._tables[s, pi]), digest,
                                       slot.gen)
            slot.hash_chain = digest
            slot.hashed_pages += 1

    def _free_slot(self, s: int) -> _Slot:
        """Drop slot s's page references (shared prefix pages survive in
        the cache) and clear it."""
        slot = self._slots[s]
        held = [int(p) for p in self._tables[s] if p]
        if held:
            self.pager.free(held)
        self._tables[s] = 0
        self._slots[s] = None
        return slot

    def release(self, s: int, outcome: str,
                error: Optional[str] = None) -> None:
        """Free a slot and emit the request's terminal event. Covers
        cancel at any phase, including mid-prefill."""
        if self._slots[s] is None:
            return
        slot = self._free_slot(s)
        slot.req.finished_at = self.clock()
        if outcome == "cancelled":
            kind = "cancel"
        elif outcome == "error" and error and "shed" in error:
            kind = "shed"
        else:
            kind = "finish"
        self._instant(kind, slot.req.finished_at, slot.req,
                      outcome=outcome, tokens=len(slot.req.tokens),
                      **({"error": error} if error else {}))
        slot.req.finish(outcome, error)
        # the last reader of a superseded generation frees it
        self._maybe_retire(slot.gen)
        # every release audits page conservation, so a leak is caught at
        # the request that caused it
        self.check_pager()

    def evacuate(self, s: int) -> Optional[GenerateRequest]:
        """Forced-teardown detach for fleet migration: free slot s's
        pages WITHOUT finishing its request, which a surviving replica
        adopts and resumes (attach re-prefills prompt + emitted tokens).
        The pager audit runs as on any release."""
        if self._slots[s] is None:
            return None
        slot = self._free_slot(s)
        self._maybe_retire(slot.gen)
        self.check_pager()
        return slot.req

    def check_pager(self) -> None:
        """Run the allocator's invariant audit. Violations raise in
        strict mode; otherwise they count into stats["page_leaks"]."""
        problems = self.pager.check_invariants()
        if not problems:
            return
        self.stats["page_leaks"] += 1
        msg = "KV pager invariants violated: " + "; ".join(problems)
        if self.strict_pager:
            raise AssertionError(msg)
        logger.error(msg)

    def cancel_request(self, req: GenerateRequest) -> bool:
        for s, slot in enumerate(self._slots):
            if slot is not None and slot.req is req:
                self.release(s, "cancelled")
                return True
        return False

    # ------------------------------------------------------------ supervisor
    def abandon(self) -> None:
        """Mark this engine dead (the supervisor swapped a replacement
        in): step() becomes a no-op, and a wedge spin ends."""
        self._abandoned = True

    def drop_slab(self) -> None:
        """Free an abandoned engine's KV slab. Called by the loop thread
        that drove it, as that thread exits: until then it may still be
        inside a step that reads the slab."""
        if self._abandoned:
            self.slab = None

    def spawn_recovered(self) -> "DecodeEngine":
        """This engine's replacement after a crash or wedge: a fresh slab
        on the same device, pager, tables and slots, the same knobs and
        fault plan. It adopts every resident weight generation, so resumed
        streams re-attach pinned to the params they started under; the
        prefix cache starts cold (its KV lived in the dead slab)."""
        eng = DecodeEngine(
            self.module, geom=self.geom, clock=self.clock,
            prefill_chunk=self.prefill_chunk,
            prefix_cache=self.prefix_cache,
            prefill_budget=self.prefill_budget, tracer=self.tracer,
            flight_steps=self.flight.capacity if self.flight else 0,
            decode_span_every=self.decode_span_every,
            fault_plan=self.fault_plan, strict_pager=self.strict_pager,
            kv_dtype=self.kv_dtype, attn_impl=self.attn_impl,
            decode_steps=self.decode_steps, draft_module=self.draft_module,
            draft_variables=self._draft_variables, device=self.device)
        eng.weight_generation = self.weight_generation
        eng._params_by_gen = dict(self._params_by_gen)
        eng._param_bytes_by_gen = dict(self._param_bytes_by_gen)
        eng.check_pager()
        return eng

    # ----------------------------------------------------------------- cost
    def _cost_fallback(self, steps: int = 1) -> dict:
        """The reference's closed-form per-dispatch record: every slot
        runs the model once per fused step (~2 flops per weight per
        slot-step) over the params read once plus each slot's paged KV
        traffic per step."""
        nbytes = self._param_bytes_by_gen.get(self.weight_generation, 0)
        S = self.geom.slots
        return {"flops": 2.0 * (nbytes / 4.0) * S * steps,
                "hbm_bytes": float(
                    nbytes + S * steps * self.slab.decode_bytes_per_token)}

    def _ledger_capture(self, program: str, steps: int = 1) -> bool:
        """Install `program`'s record at its first dispatch, which is the
        dispatch the reference compiles at; returns whether this is it.
        (The reference also reconciles an XLA record against the KV proxy
        here; the port has none, ROADMAP C.8.)"""
        if self.ledger.record(program) is not None:
            return False
        self.ledger.capture(program, "serve", None,
                            fallback=self._cost_fallback(steps))
        return True

    # -------------------------------------------------------------- prefill
    def _dispatch_prefill(self, s: int, slot: _Slot) -> int:
        """One prefill chunk for slot s: grant pages, bulk-write up to C
        prompt tokens of KV, advance the cursor. Returns the number of
        prompt tokens processed; 0 means the slot STALLED on page
        exhaustion before making any progress."""
        G = self.geom.page
        C = self.prefill_chunk
        start = slot.pos
        end = min(start + C, slot.n_prompt - 1)
        granted = 0
        for pi in range(start // G, (end - 1) // G + 1):
            if self._tables[s, pi] == 0:
                pid = self.pager.alloc()
                if pid is None:
                    # shrink the chunk to the pages held; a partial chunk
                    # still makes progress, zero progress stalls
                    end = min(end, pi * G)
                    break
                self._tables[s, pi] = pid
                granted += 1
        n = end - start
        if n <= 0:
            return 0
        p = np.arange(start, end)
        tokens = np.zeros(C, np.int64)
        pos = np.zeros(C, np.int64)
        write_pages = np.zeros(C, np.int64)
        write_offs = np.zeros(C, np.int64)
        in_chunk = np.zeros(C, np.float32)
        tokens[:n] = slot.prompt[start:end]
        pos[:n] = p
        write_pages[:n] = self._tables[s, p // G]
        write_offs[:n] = p % G
        in_chunk[:n] = 1.0
        compiled = self._ledger_capture("serve.prefill")
        t0 = self.clock()
        self._prefill_fn(
            self._params_by_gen[slot.gen], self.slab, self._tensor(tokens),
            self._tensor(pos), self._tensor(self._tables[s].copy()),
            self._tensor(write_pages), self._tensor(write_offs),
            self._tensor(in_chunk))
        t1 = self.clock()
        self.compile_tracker.note(compiled, t1 - t0, program="serve.prefill")
        self.ledger.note_dispatch("serve.prefill")
        self.stats["prefill_dispatches"] += 1
        self.stats["prefill_tokens"] += n
        slot.prefill_s += t1 - t0
        self._dispatch_wall_s += t1 - t0
        self._span("prefill_chunk", t0, t1, slot.req, tokens=n,
                   pages_granted=granted, start_pos=start)
        slot.pos = end
        if self.prefix_cache:
            self._register_full_pages(s, slot)
        return n

    def _in_prefill(self, slot: _Slot) -> bool:
        """Chunked-prefill phase: positions [pos, n_prompt-1) still owed
        to the prefill program."""
        return self._prefill_fn is not None and slot.pos < slot.n_prompt - 1

    # ----------------------------------------------------------------- step
    @torch.no_grad()
    def step(self, exclude: frozenset = frozenset()
             ) -> List[GenerateRequest]:
        """One scheduler round: up to prefill_budget prompt tokens of
        prefill chunks (FIFO), then one decode call per weight generation
        advancing every decode-phase slot by one token. Returns the
        requests that reached a terminal state this round.

        ``exclude`` masks streams by rid for this round only: they skip
        prefill and decode and do not advance (the service's bisection
        retries a failed step with suspect lanes masked). Every step
        leaves one record in the flight recorder."""
        if self._abandoned:
            return []
        self._step_count += 1
        mark = None if self.flight is None else (
            self.stats["prefill_dispatches"], self.stats["dispatches"],
            self.stats["generated_tokens"], self.stats["cow_splits"],
            self._dispatch_wall_s, self._shed_count,
            self.stats["deadline_expired"])
        try:
            return self._step_inner(exclude)
        finally:
            if mark is not None:
                self._record_flight(mark)

    def _record_flight(self, mark) -> None:
        pf0, d0, g0, c0, w0, sh0, dl0 = mark
        pf = int(self.stats["prefill_dispatches"] - pf0)
        de = int(self.stats["dispatches"] - d0)
        if self._shed_count > sh0:
            kind = "shed"
        elif pf and de:
            kind = "mixed"
        elif pf:
            kind = "prefill"
        elif de:
            kind = "decode"
        else:
            kind = "idle"
        self.flight.record({
            "step": self._step_count,
            "ts": self.clock(),
            "kind": kind,
            "active_slots": self.active(),
            "prefill_backlog": self.prefill_backlog_tokens(),
            "kv_pages": self.pager.in_use,
            "cow_splits": int(self.stats["cow_splits"] - c0),
            "prefill_dispatches": pf,
            "decode_dispatches": de,
            "dispatch_s": round(self._dispatch_wall_s - w0, 9),
            "tokens": int(self.stats["generated_tokens"] - g0),
            "weight_generation": self.weight_generation,
            "generations": len(self._params_by_gen),
            "deadlines": int(self.stats["deadline_expired"] - dl0),
        })

    def _note_first_token(self, slot: _Slot, t1: float) -> None:
        """First generated token: fill the additive TTFT breakdown
        (queue + prefill + interleave == TTFT; interleave is the
        remainder) and drop the instant on the timeline."""
        req = slot.req
        args = {}
        if req.submitted_at is not None:
            ttft = t1 - req.submitted_at
            queue = (req.admitted_at if req.admitted_at is not None
                     else req.submitted_at) - req.submitted_at
            prefill = slot.prefill_s
            req.ttft_breakdown = {"queue": queue, "prefill": prefill,
                                  "interleave": ttft - queue - prefill}
            args = dict(ttft=ttft, **req.ttft_breakdown)
        self._instant("first_token", t1, req, **args)

    # ----------------------------------------- multi-step / speculative
    def _grant_range(self, s: int, start: int,
                     count: int) -> Optional[List[int]]:
        """Pre-grant the pages covering positions [start, start+count)
        for slot s (the accelerated programs write up to K positions
        ahead in one call). Returns the page-table indices newly granted,
        or None when the pool ran dry — already rolled back, and freeing
        re-sorts the pool, so the free list matches never having
        tried."""
        G = self.geom.page
        granted: List[int] = []
        for pi in range(start // G, (start + count - 1) // G + 1):
            if pi >= self.geom.pages_per_slot:
                break
            if self._tables[s, pi] == 0:
                pid = self.pager.alloc()
                if pid is None:
                    self._ungrant(s, granted)
                    return None
                self._tables[s, pi] = pid
                granted.append(pi)
        return granted

    def _ungrant(self, s: int, granted: List[int]) -> None:
        for pi in granted:
            self.pager.free([int(self._tables[s, pi])])
            self._tables[s, pi] = 0

    def _walk_emitted(self, s: int, toks, bads, k_max: int, t0: float,
                      t1: float, finished: List[GenerateRequest]) -> None:
        """The host's mirror of the device's per-lane early exit: emit
        this lane's picks row by row until its own end (non-finite guard,
        EOS, token budget), advancing pos exactly as k_max single calls
        would. Rows past the end are discarded, like an inactive slot's
        pick."""
        slot = self._slots[s]
        live_steps = 0
        for k in range(k_max):
            p = slot.pos
            slot.pos = p + 1
            live_steps += 1
            if bads[k] > 0:
                req = slot.req
                self.stats["poisoned"] += 1
                self.release(s, "error", "non-finite logits at position "
                             f"{p}; request poisoned and isolated")
                finished.append(req)
                break
            if p <= slot.n_prompt - 1:
                # the first fused step computed prompt context (the
                # TTFT prefill term)
                slot.prefill_s += t1 - t0
            if self.prefix_cache:
                self._register_full_pages(s, slot)
            tok = int(toks[k])
            if slot.req.first_token_at is None:
                slot.req.first_token_at = t1
                self._note_first_token(slot, t1)
            slot.req.emit_token(tok)
            self.stats["generated_tokens"] += 1
            n_out = len(slot.req.tokens)
            if self.tracer is not None and n_out > 1 \
                    and n_out % self.decode_span_every == 0:
                self._span("decode", t0, t1, slot.req, pos=p,
                           token_index=n_out, cow=0)
            if (slot.req.eos_id is not None and tok == slot.req.eos_id) \
                    or len(slot.req.tokens) >= slot.req.max_new_tokens:
                self.release(s, "ok")
                finished.append(slot.req)
                break
        # retained decode work only: kv_bytes stays exactly
        # decode_tokens x decode_bytes_per_token across every program
        self.stats["decode_tokens"] += live_steps
        self.stats["kv_bytes"] += \
            live_steps * self.slab.decode_bytes_per_token

    def _dispatch_multi(self, members: List[int],
                        finished: List[GenerateRequest]) -> bool:
        """One multi-step call covering every ready slot: K decode steps,
        one read back to the host. Returns False (page grant rolled back,
        no other side effect) when a slot cannot pre-grant its K-step page
        window; the caller then takes the single step for this round."""
        K = self.decode_steps
        S = self.geom.slots
        grants: Dict[int, List[int]] = {}
        for s in members:
            slot = self._slots[s]
            budget = slot.req.max_new_tokens - len(slot.req.tokens)
            g = self._grant_range(s, slot.pos, min(K, max(budget, 1)))
            if g is None:
                for gs, gl in grants.items():
                    self._ungrant(gs, gl)
                return False
            grants[s] = g
        tokens = np.zeros(S, np.int64)
        pos = np.zeros(S, np.int64)
        live = np.zeros(S, np.int64)
        temps = np.zeros(S, np.float32)
        seeds = np.zeros(S, np.uint32)
        eos_ids = np.full(S, -1, np.int64)
        budgets = np.zeros(S, np.int64)
        for s in members:
            slot = self._slots[s]
            live[s] = 1
            tokens[s] = slot.prompt[slot.pos] \
                if slot.pos < slot.n_prompt else slot.req.tokens[-1]
            pos[s] = slot.pos
            temps[s] = slot.req.temperature
            seeds[s] = slot.req.seed & 0xFFFFFFFF
            if slot.req.eos_id is not None:
                eos_ids[s] = slot.req.eos_id
            budgets[s] = slot.req.max_new_tokens - len(slot.req.tokens)
        compiled = self._ledger_capture("serve.multi_step", steps=K)
        t0 = self.clock()
        toks, bads = self._multi_fn(
            self._params_by_gen[self.weight_generation], self.slab, tokens,
            pos, self._tables.copy(), live, temps, seeds, eos_ids, budgets)
        # the call's one read back: tokens and guard flags together
        host = torch.stack((toks, bads.to(toks.dtype))).cpu().numpy()
        t1 = self.clock()
        self.compile_tracker.note(compiled, t1 - t0,
                                  program="serve.multi_step")
        self._dispatch_wall_s += t1 - t0
        self.stats["dispatches"] += 1
        self.stats["multi_step_dispatches"] += 1
        self.stats["multi_step_compiles"] += int(compiled)
        self.stats["occupancy_sum"] += len(members)
        g0 = self.stats["generated_tokens"]
        for s in members:
            self._walk_emitted(s, host[0, :, s], host[1, :, s], K, t0, t1,
                               finished)
        self.ledger.note_dispatch(
            "serve.multi_step", tokens=self.stats["generated_tokens"] - g0)
        return True

    def _dispatch_spec(self, members: List[int],
                       finished: List[GenerateRequest]) -> bool:
        """One speculative verify call covering every ready slot: the
        draft proposes K tokens per lane, the target scores them all, and
        the accepted prefix plus one bonus target pick emits. Rejected
        tokens were rolled back on the device by the replay pass (KV
        bytes, validity, int8 scales), so this method only rewinds the
        host cursors: pos stops at the kept prefix and the page grant is
        trimmed back to it — freeing re-sorts the pool, so the allocator
        matches a run that never proposed. Returns False (grant rolled
        back) when a lane's window or page grant does not fit; the caller
        falls back to multi or single step."""
        K = self.spec_steps
        W = self.spec_window
        G = self.geom.page
        S = self.geom.slots
        wlens: Dict[int, int] = {}
        for s in members:
            slot = self._slots[s]
            # the draft writes proposals into window rows pos+1 .. pos+K
            if slot.pos + K + 1 > W:
                return False
            budget = slot.req.max_new_tokens - len(slot.req.tokens)
            wlens[s] = min(K + 1, max(budget, 1))
        grants: Dict[int, List[int]] = {}
        for s in members:
            g = self._grant_range(s, self._slots[s].pos, wlens[s])
            if g is None:
                for gs, gl in grants.items():
                    self._ungrant(gs, gl)
                return False
            grants[s] = g
        window = np.zeros((S, W), np.int64)
        pos = np.zeros(S, np.int64)
        live = np.zeros(S, np.int64)
        temps = np.zeros(S, np.float32)
        seeds = np.zeros(S, np.uint32)
        wlen_arr = np.zeros(S, np.int64)
        for s in members:
            slot = self._slots[s]
            # the whole context = prompt + emitted tokens; in the steady
            # state its length is exactly pos + 1
            ctx = slot.prompt + [int(t) for t in slot.req.tokens]
            live[s] = 1
            pos[s] = slot.pos
            window[s, :slot.pos + 1] = ctx[:slot.pos + 1]
            temps[s] = slot.req.temperature
            seeds[s] = slot.req.seed & 0xFFFFFFFF
            wlen_arr[s] = wlens[s]
        compiled = self._ledger_capture("serve.spec_verify", steps=K + 1)
        t0 = self.clock()
        picks, bads, acc = self._verify_fn(
            self._params_by_gen[self.weight_generation], self._draft_params,
            self.slab, window, pos, self._tables.copy(), live, temps, seeds,
            wlen_arr)
        # the call's one read back: picks, guard flags and acceptance
        host = torch.cat((picks, bads.to(picks.dtype),
                          acc[None].to(picks.dtype))).cpu().numpy()
        t1 = self.clock()
        self.compile_tracker.note(compiled, t1 - t0,
                                  program="serve.spec_verify")
        self._dispatch_wall_s += t1 - t0
        self.stats["dispatches"] += 1
        self.stats["verify_dispatches"] += 1
        self.stats["verify_compiles"] += int(compiled)
        self.stats["occupancy_sum"] += len(members)
        picks_host, bads_host = host[:K + 1], host[K + 1:2 * K + 2]
        acc_host = host[2 * K + 2]
        g0 = self.stats["generated_tokens"]
        for s in members:
            slot = self._slots[s]
            a = int(acc_host[s])
            p_start = slot.pos
            self.stats["draft_tokens"] += K
            # accepted prefix + the bonus pick (what the verifier kept;
            # emission may still stop earlier at EOS)
            self.stats["accepted_tokens"] += a + 1
            self.stats["rejected_tokens"] += K - a
            self._walk_emitted(s, picks_host[:a + 1, s],
                               bads_host[:a + 1, s], a + 1, t0, t1,
                               finished)
            if self._slots[s] is None:
                continue   # released: its pages were freed wholesale
            keep_pi = (slot.pos - 1) // G
            for pi in range(keep_pi + 1, (p_start + wlens[s] - 1) // G + 1):
                pid = int(self._tables[s, pi])
                if pid:
                    self.pager.free([pid])
                    self._tables[s, pi] = 0
        self.ledger.note_dispatch(
            "serve.spec_verify", tokens=self.stats["generated_tokens"] - g0)
        return True

    def _step_inner(self, exclude: frozenset) -> List[GenerateRequest]:
        G = self.geom.page
        stalled: List[int] = []

        # reap cancellations first: a cancelled slot's pages go back to
        # the pool before this round's tables are built
        finished: List[GenerateRequest] = []
        for s, slot in enumerate(self._slots):
            if slot is not None and slot.req.cancelled:
                req = slot.req
                self.release(s, "cancelled")
                finished.append(req)

        # deadline reaper: expired streams release with the terminal
        # `deadline` outcome, whatever phase they are in
        now = self.clock()
        for s, slot in enumerate(self._slots):
            if slot is None or slot.req.deadline_at is None \
                    or now < slot.req.deadline_at:
                continue
            req = slot.req
            self.stats["deadline_expired"] += 1
            self.release(s, "deadline",
                         f"deadline of {req.deadline_ms:g}ms exceeded "
                         f"after {len(req.tokens)} token(s)")
            finished.append(req)

        # fault hooks BEFORE any page maintenance: an injected crash
        # leaves the step free of side effects, so the bisection's retries
        # all start from the same tables
        if self.fault_plan is not None:
            occupants = [(s, sl.req.rid) for s, sl in enumerate(self._slots)
                         if sl is not None and sl.req.rid not in exclude]
            self.fault_plan.check_crash(self._step_count, occupants)
            self.fault_plan.sleep(self._step_count)

        # ------------------------------------------------- prefill lane
        progressed = False
        if self._prefill_fn is not None:
            budget = self.prefill_budget
            order = sorted(
                (s for s, sl in enumerate(self._slots)
                 if sl is not None and self._in_prefill(sl)
                 and sl.req.rid not in exclude),
                key=lambda s: self._slots[s].seq)
            for s in order:
                slot = self._slots[s]
                while budget > 0 and slot.pos < slot.n_prompt - 1:
                    n = self._dispatch_prefill(s, slot)
                    if n == 0:
                        stalled.append(s)
                        break
                    progressed = True
                    budget -= n
                if budget <= 0:
                    break

        # -------------------------------------------------- decode lane
        # per-slot page maintenance first (alloc / copy-on-write), then
        # one decode call per active weight generation
        ready: List[int] = []
        cow: Dict[int, tuple] = {}
        for s, slot in enumerate(self._slots):
            if slot is None or self._in_prefill(slot) \
                    or slot.req.rid in exclude:
                continue
            pi = slot.pos // G
            pid = int(self._tables[s, pi])
            if pid == 0:
                pid = self.pager.alloc()
                if pid is None:
                    stalled.append(s)   # no page: sit this round out
                    continue
                self._tables[s, pi] = pid
            elif not self.pager.writable(pid):
                # shared or cache-registered page: copy-on-write split
                # inside this call (copies run before any write)
                dst = self.pager.alloc()
                if dst is None:
                    stalled.append(s)
                    continue
                cow[s] = (pid, dst)
                self._tables[s, pi] = dst
                self.pager.free([pid])  # drop this slot's share
                self.stats["cow_splits"] += 1
            ready.append(s)

        if stalled:
            self.stats["stalls"] += len(stalled)
        if not ready:
            if stalled and not progressed:
                # every runnable slot is out of pages and nothing moved:
                # shed the NEWEST stream (the oldest is closest to
                # finishing and freeing)
                victim = max(stalled, key=lambda s: self._slots[s].seq)
                req = self._slots[victim].req
                logger.warning("KV slab exhausted with all slots stalled; "
                               "shedding newest stream")
                self._shed_count += 1
                self.release(victim, "error",
                             "KV cache pages exhausted; request shed")
                finished.append(req)
            return finished

        # snapshot each ready slot's generation up front: an earlier
        # generation's call may release its members
        gen_of = {s: self._slots[s].gen for s in ready}

        # the all-decode steady state: every ready slot past its prompt,
        # nothing prefilled, stalled or CoW-split this round, no fault
        # plan, no masked lane, one resident weight generation — the only
        # rounds the accelerated programs take. Verify first, then the
        # multi-step program; whatever they decline (a page grant or a
        # window that does not fit, rolled back inside) falls through to
        # the single step below.
        if (not exclude and not stalled and not cow and not progressed
                and not finished and self.fault_plan is None
                and (self._verify_fn is not None
                     or self._multi_fn is not None)
                and len(self._params_by_gen) == 1
                and not any(sl is not None and self._in_prefill(sl)
                            for sl in self._slots)
                and all(self._slots[s].pos >= self._slots[s].n_prompt - 1
                        for s in ready)):
            if self._verify_fn is not None \
                    and self._dispatch_spec(ready, finished):
                return finished
            if self._multi_fn is not None \
                    and self._dispatch_multi(ready, finished):
                return finished
        for gen in sorted(set(gen_of.values())):
            members = [s for s in ready if gen_of[s] == gen]
            self._dispatch_decode(gen, members, cow, finished)
        return finished

    def _dispatch_decode(self, gen: int, members: List[int],
                         cow: Dict[int, tuple],
                         finished: List[GenerateRequest]) -> None:
        """One decode call for the members of one weight generation. The
        other slots' write page and copy pair stay 0 (the null page), so
        generations never clobber each other's KV."""
        S, G = self.geom.slots, self.geom.page
        tokens = np.zeros(S, np.int64)
        pos = np.zeros(S, np.int64)
        write_page = np.zeros(S, np.int64)
        write_off = np.zeros(S, np.int64)
        active = np.zeros(S, np.float32)
        temps = np.zeros(S, np.float32)
        key_data = np.zeros((S, 2), np.uint32)
        copy_src = np.zeros(S, np.int64)
        copy_dst = np.zeros(S, np.int64)
        poison = np.zeros(S, np.float32)
        if self.fault_plan is not None:
            for s in self.fault_plan.nan_hits(self._step_count, members):
                poison[s] = 1.0
        for s in members:
            slot = self._slots[s]
            active[s] = 1.0
            tokens[s] = slot.prompt[slot.pos] \
                if slot.pos < slot.n_prompt else slot.req.tokens[-1]
            pos[s] = slot.pos
            write_page[s] = self._tables[s, slot.pos // G]
            write_off[s] = slot.pos % G
            temps[s] = slot.req.temperature
            # per-(request, position) key: sampling is independent of
            # co-resident streams
            key_data[s] = (slot.req.seed & 0xFFFFFFFF, slot.pos)
            if s in cow:
                copy_src[s], copy_dst[s] = cow[s]
        compiled = self._ledger_capture("serve.decode")
        t0 = self.clock()
        nxt, bad = self._step_fn(
            self._params_by_gen[gen], self.slab, self._tensor(tokens),
            self._tensor(pos), self._tensor(self._tables.copy()),
            self._tensor(write_page), self._tensor(write_off),
            self._tensor(active), temps, key_data, self._tensor(copy_src),
            self._tensor(copy_dst), self._tensor(poison))
        nxt_host = nxt.cpu().numpy()
        bad_host = bad.cpu().numpy()
        t1 = self.clock()      # after the readback: the tokens exist
        self.compile_tracker.note(compiled, t1 - t0, program="serve.decode")
        self._dispatch_wall_s += t1 - t0
        self.stats["dispatches"] += 1
        self.stats["occupancy_sum"] += len(members)
        self.stats["decode_tokens"] += len(members)
        # every decode-phase lane reads its whole paged context once per
        # layer (geometry x dtype)
        self.stats["kv_bytes"] += \
            len(members) * self.slab.decode_bytes_per_token

        gen_before_emit = self.stats["generated_tokens"]
        for s in members:
            slot = self._slots[s]
            p = slot.pos
            slot.pos = p + 1
            if bad_host[s] > 0:
                # the non-finite guard fired for this lane: terminate only
                # this stream, before its pages could be published
                req = slot.req
                self.stats["poisoned"] += 1
                self.release(s, "error", "non-finite logits at position "
                             f"{p}; request poisoned and isolated")
                finished.append(req)
                continue
            if p <= slot.n_prompt - 1:
                # this call computed prompt context for the slot (the
                # TTFT prefill term)
                slot.prefill_s += t1 - t0
            if self.prefix_cache:
                # a prompt whose length is a page multiple completes its
                # final page on this very advance — publish it
                self._register_full_pages(s, slot)
            if p < slot.n_prompt - 1:
                continue  # token-by-token prefill: output discarded
            tok = int(nxt_host[s])
            if slot.req.first_token_at is None:
                slot.req.first_token_at = t1
                self._note_first_token(slot, t1)
            slot.req.emit_token(tok)
            self.stats["generated_tokens"] += 1
            n_out = len(slot.req.tokens)
            if self.tracer is not None and n_out > 1 \
                    and n_out % self.decode_span_every == 0:
                # sampled: one decode span every Nth output token
                self._span("decode", t0, t1, slot.req, pos=p,
                           token_index=n_out, cow=int(s in cow))
            if (slot.req.eos_id is not None and tok == slot.req.eos_id) \
                    or len(slot.req.tokens) >= slot.req.max_new_tokens:
                self.release(s, "ok")
                finished.append(slot.req)
        self.ledger.note_dispatch(
            "serve.decode",
            tokens=self.stats["generated_tokens"] - gen_before_emit)
