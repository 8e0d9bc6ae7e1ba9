"""Continuous-batching decode engine: slot state + the paged programs
(twin of kubeml_tpu/serve/engine.py).

Two programs serve every stream:

  decode   — every call advances every active slot by one token (its own
             feedback, or its final prompt token);
  prefill  — one slot per call, C prompt tokens bulk-written into its KV
             pages (fixed chunk, padded + masked); built when
             prefill_chunk > 0.

Both read the KV context through the paged-attention kernel on the card
(ops/paged_attention.py). A token-budget scheduler in step() spends at
most ``prefill_budget`` prompt tokens on prefill chunks (FIFO over
admission order), then runs one decode call for the streams past their
prompt, so in-flight streams keep their inter-token latency while new
prompts load.

Prefix caching rides the page tables: at attach, the prompt's full pages
are matched through the allocator's content-hash index
(pager.chain_hash) and any resident prefix is SHARED — the slot takes
references on the cached pages and its prefill cursor skips past them.
A write into a shared or registered page is COPY-ON-WRITE: the decode
step copies the page first, in the same call.

Determinism contract: slot math is row-independent, writable pages of
different requests are disjoint, the attention softmax always runs over
the full fixed context with invalid positions masked, and sampling keys
derive from (request seed, position) only. A request therefore generates
the same tokens alone or packed with neighbours, chunked or token by
token, cache hit or miss.
"""

from __future__ import annotations

import logging
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from kubeml_tpu_torch._device import DeviceLike, resolve_device
from kubeml_tpu_torch.models.base import PAD_ID, InferenceInputError
from kubeml_tpu_torch.models.gpt import (build_paged_decode_step,
                                         build_paged_prefill_step,
                                         compute_params)
from kubeml_tpu_torch.ops.paged_attention import (kernel_geometry_refusal,
                                                  kernel_smem_bytes)
from kubeml_tpu_torch.serve.pager import (KVPageSlab, PageAllocator,
                                          PageGeometry, chain_hash)
from kubeml_tpu_torch.serve.slots import GenerateRequest

logger = logging.getLogger("kubeml_tpu_torch.serve.engine")

ATTN_IMPLS = ("auto", "kernel", "plain")


class _Slot:
    """Host-side state of one occupied decode slot."""

    __slots__ = ("req", "pos", "prompt", "n_prompt", "seq", "hash_chain",
                 "hashed_pages", "cached_pages")

    def __init__(self, req: GenerateRequest, prompt: List[int], seq: int):
        self.req = req
        self.prompt = prompt
        self.n_prompt = len(prompt)
        self.pos = 0            # next position to consume
        self.seq = seq          # admission order (newest-stall shedding)
        self.hash_chain = b""   # rolling digest over hashed_pages pages
        self.hashed_pages = 0   # prompt pages matched or registered so far
        self.cached_pages = 0   # prompt pages attached from the cache


class DecodeEngine:
    """Fixed pool of S decode slots over one paged KV slab.

    Not thread-safe by itself: attach/step/cancel belong to the serving
    loop thread (ServeService); free_slots/stats reads are safe.

    device: None means CUDA (raising without a CUDA device); the module
    must live on the same device. prefill_chunk: prompt tokens per
    prefill call (0 disables the prefill program — prompts ride the
    decode step token by token). prefix_cache: share full prompt pages
    across requests by content hash. prefill_budget: prompt tokens the
    scheduler may spend on prefill per step (default: one chunk).
    kv_dtype: "f32" (pages in the module dtype) or "int8". attn_impl
    states what the caller expects of the context read, which the device
    decides (ops/paged_attention.py): "auto" takes either, "kernel"
    demands a CUDA device, "plain" the CPU; a mismatch raises here.

    On CUDA the engine checks, before it allocates its slab, that the
    paged kernel takes its geometry (page size, head_dim, page dtype and
    the shared memory of a decode call and of a prefill call over the
    whole context) and raises ValueError naming them if not: every step
    would fail otherwise. The CPU's plain version takes any geometry.
    """

    def __init__(self, module, variables: Optional[dict] = None,
                 geom: Optional[PageGeometry] = None, slots: int = 8,
                 page: int = 16, clock=time.perf_counter,
                 prefill_chunk: int = 16, prefix_cache: bool = True,
                 prefill_budget: Optional[int] = None,
                 strict_pager: bool = True, kv_dtype: str = "f32",
                 attn_impl: str = "auto", device: DeviceLike = None):
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
        self.module = module
        self.kv_dtype = kv_dtype
        self._step_fn = build_paged_decode_step(module, kv_dtype)
        self.geom = geom or PageGeometry.for_module(
            slots=slots, page=page, max_len=module.max_len)
        if self.device.type == "cuda":
            self._check_kernel_geometry(prefill_chunk)
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
        self.params = compute_params(module, variables)
        S, Pmax = self.geom.slots, self.geom.pages_per_slot
        self._tables = np.zeros((S, Pmax), np.int32)
        self._slots: List[Optional[_Slot]] = [None] * S
        self._seq = 0
        self.strict_pager = bool(strict_pager)
        self.stats: Dict[str, float] = {
            "dispatches": 0, "generated_tokens": 0, "occupancy_sum": 0,
            "stalls": 0, "prefill_dispatches": 0, "prefill_tokens": 0,
            "decode_tokens": 0, "prefix_hits": 0, "prefix_misses": 0,
            "cow_splits": 0, "poisoned": 0, "deadline_expired": 0,
            "page_leaks": 0, "kv_bytes": 0,
        }

    def _check_kernel_geometry(self, prefill_chunk: int) -> None:
        """Raise ValueError when the paged kernel cannot serve this
        engine's decode (T = 1) or prefill (T = prefill_chunk) calls."""
        G, Pmax = self.geom.page, self.geom.pages_per_slot
        D, dtype = self.module.head_dim, self.module.dtype
        quantized = self.kv_dtype == "int8"
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

    # ------------------------------------------------------------- capacity
    @property
    def slot_count(self) -> int:
        return self.geom.slots

    def active(self) -> int:
        return sum(1 for s in self._slots if s is not None)

    def free_slots(self) -> int:
        return self.geom.slots - self.active()

    def prefill_backlog_tokens(self) -> int:
        """Prompt tokens admitted to slots but not yet prefilled."""
        return sum(max(0, sl.n_prompt - 1 - sl.pos)
                   for sl in self._slots if sl is not None)

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

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
        slot's table — the prefill cursor starts past the matched run."""
        prompt = self.check_admissible(req.prompt, req.max_new_tokens)
        for s, cur in enumerate(self._slots):
            if cur is None:
                slot = _Slot(req, prompt, self._seq)
                self._seq += 1
                self._slots[s] = slot
                if self.prefix_cache:
                    self._match_prefix(s, slot)
                req.admitted_at = self.clock()
                return s
        raise RuntimeError("attach() with no free slot — admission "
                           "accounting is broken")

    def _match_prefix(self, s: int, slot: _Slot) -> None:
        """Walk the prompt's full pages through the prefix cache; stop at
        the first miss (the chain hash makes later pages unmatchable)."""
        G = self.geom.page
        k = 0
        chain = b""
        while (k + 1) * G <= slot.n_prompt and k < self.geom.pages_per_slot:
            digest = chain_hash(chain, slot.prompt[k * G:(k + 1) * G])
            pid = self.pager.lookup_prefix(digest)
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
            self.pager.register_prefix(int(self._tables[s, pi]), digest)
            slot.hash_chain = digest
            slot.hashed_pages += 1

    def release(self, s: int, outcome: str,
                error: Optional[str] = None) -> None:
        """Free a slot and drop its page references (shared prefix pages
        survive in the cache); emits the request's terminal event. Covers
        cancel at any phase, including mid-prefill."""
        slot = self._slots[s]
        if slot is None:
            return
        held = [int(p) for p in self._tables[s] if p]
        if held:
            self.pager.free(held)
        self._tables[s] = 0
        self._slots[s] = None
        slot.req.finished_at = self.clock()
        slot.req.finish(outcome, error)
        # every release audits page conservation, so a leak is caught at
        # the request that caused it
        self.check_pager()

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
        for pi in range(start // G, (end - 1) // G + 1):
            if self._tables[s, pi] == 0:
                pid = self.pager.alloc()
                if pid is None:
                    # shrink the chunk to the pages held; a partial chunk
                    # still makes progress, zero progress stalls
                    end = min(end, pi * G)
                    break
                self._tables[s, pi] = pid
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
        self._prefill_fn(
            self.params, self.slab, self._tensor(tokens), self._tensor(pos),
            self._tensor(self._tables[s].copy()), self._tensor(write_pages),
            self._tensor(write_offs), self._tensor(in_chunk))
        self.stats["prefill_dispatches"] += 1
        self.stats["prefill_tokens"] += n
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
    def step(self) -> List[GenerateRequest]:
        """One scheduler round: up to prefill_budget prompt tokens of
        prefill chunks (FIFO), then one decode call advancing every
        decode-phase slot by one token. Returns the requests that reached
        a terminal state this round."""
        S = self.geom.slots
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

        # ------------------------------------------------- prefill lane
        progressed = False
        if self._prefill_fn is not None:
            budget = self.prefill_budget
            order = sorted(
                (s for s, sl in enumerate(self._slots)
                 if sl is not None and self._in_prefill(sl)),
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
        # one decode call for every ready slot
        ready: List[int] = []
        cow: Dict[int, tuple] = {}
        for s, slot in enumerate(self._slots):
            if slot is None or self._in_prefill(slot):
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
                self.release(victim, "error",
                             "KV cache pages exhausted; request shed")
                finished.append(req)
            return finished

        tokens = np.zeros(S, np.int64)
        pos = np.zeros(S, np.int64)
        write_page = np.zeros(S, np.int64)
        write_off = np.zeros(S, np.int64)
        active = np.zeros(S, np.float32)
        temps = np.zeros(S, np.float32)
        key_data = np.zeros((S, 2), np.uint32)
        copy_src = np.zeros(S, np.int64)
        copy_dst = np.zeros(S, np.int64)
        for s in ready:
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
        nxt, bad = self._step_fn(
            self.params, self.slab, self._tensor(tokens), self._tensor(pos),
            self._tensor(self._tables.copy()), self._tensor(write_page),
            self._tensor(write_off), self._tensor(active), temps, key_data,
            self._tensor(copy_src), self._tensor(copy_dst),
            self._tensor(np.zeros(S, np.float32)))
        self.stats["dispatches"] += 1
        self.stats["occupancy_sum"] += len(ready)
        self.stats["decode_tokens"] += len(ready)
        # every decode-phase lane reads its whole paged context once per
        # layer (geometry x dtype)
        self.stats["kv_bytes"] += len(ready) * self.slab.decode_bytes_per_token
        nxt_host = nxt.cpu().numpy()
        bad_host = bad.cpu().numpy()
        t1 = self.clock()

        for s in ready:
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
            if self.prefix_cache:
                # a prompt whose length is a page multiple completes its
                # final page on this very advance — publish it
                self._register_full_pages(s, slot)
            if p < slot.n_prompt - 1:
                continue  # token-by-token prefill: output discarded
            tok = int(nxt_host[s])
            if slot.req.first_token_at is None:
                slot.req.first_token_at = t1
            slot.req.emit_token(tok)
            self.stats["generated_tokens"] += 1
            if (slot.req.eos_id is not None and tok == slot.req.eos_id) \
                    or len(slot.req.tokens) >= slot.req.max_new_tokens:
                self.release(s, "ok")
                finished.append(slot.req)
        return finished
