"""Paged KV cache: geometry, the device slab, and the host page allocator
(twin of kubeml_tpu/serve/pager.py; the allocator is a copy of the
reference's, since the port imports nothing of the JAX package).

Page 0 is RESERVED as the null page: inactive slots' writes land there
(every step writes S rows — masking is data, not shape), page-table
tails point there, and its validity row stays zero so reads through it
never contribute to attention. The allocator never hands it out.

Pages live in three states: FREE (on the free list), REFERENCED
(refcount >= 1; a full prompt page can also be REGISTERED under its
chain hash so later requests with the same prefix share it), and CACHED
(refcount 0 but still registered, parked in an LRU that alloc() evicts
after the free list runs dry). A slot may only write into a page it
exclusively owns (``writable()``); otherwise the engine allocates a
fresh page and the decode step copies the shared page first
(copy-on-write).
"""

from __future__ import annotations

import dataclasses
import hashlib
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch


def chain_hash(prefix_digest: bytes, tokens: Sequence[int]) -> bytes:
    """Rolling content hash for prefix caching: the key of page i is
    H(key of page i-1, tokens of page i), with b"" as the root. Keying
    on the whole chain means two prompts share a page only when
    everything before it matches too (positional embeddings make equal
    tokens at different offsets produce different KV)."""
    h = hashlib.sha256(prefix_digest)
    h.update(np.asarray(tokens, np.int32).tobytes())
    return h.digest()


def routing_digest(prompt: Sequence[int], page: int) -> bytes:
    """Prefix-affinity key: the chain hash of the FIRST FULL prompt page
    (exactly the first digest the prefix cache registers); prompts
    shorter than one page hash whole."""
    page = max(1, int(page))
    toks = prompt[:page] if len(prompt) >= page else prompt
    return chain_hash(b"", list(toks))


@dataclasses.dataclass(frozen=True)
class PageGeometry:
    """Static shape of the paged cache; everything per-request lives in
    the page tables and step inputs, not here."""

    slots: int            # S: concurrent streams the step serves
    page: int             # G: tokens per page
    pages: int            # P: physical pages in the slab, incl. null page 0
    pages_per_slot: int   # Pmax: page-table width = context cap / G

    def __post_init__(self):
        if self.slots < 1 or self.page < 1 or self.pages_per_slot < 1:
            raise ValueError(f"degenerate page geometry: {self}")
        if self.pages < 2:
            raise ValueError("need at least one usable page besides the "
                             "reserved null page 0")

    @property
    def context(self) -> int:
        """Max tokens (prompt + generated) one slot can hold."""
        return self.pages_per_slot * self.page

    @property
    def usable_pages(self) -> int:
        return self.pages - 1  # page 0 is the null page

    @classmethod
    def for_module(cls, slots: int, page: int, max_len: int,
                   pages: int = 0) -> "PageGeometry":
        """Geometry sized so a slot can reach the module's max_len; by
        default the slab holds every slot at full context, a smaller
        explicit `pages` turns on real contention."""
        pps = -(-max_len // page)
        return cls(slots=slots, page=page,
                   pages=pages or slots * pps + 1, pages_per_slot=pps)


# "f32" keeps pages in the module's own compute dtype (f32 or bf16);
# "int8" quantizes pages with one symmetric f32 scale per (layer, page)
KV_DTYPES = ("f32", "int8")


class KVPageSlab:
    """The device-resident tensors: K/V pages for every layer plus the
    shared per-page validity plane and the per-page scales.

    k/v: [L, P, G, H, Dh] in the module dtype (int8 under
    kv_dtype="int8"); valid: [P, G] f32, 1.0 where a real token was
    written; k_scale/v_scale: [L, P] f32 (all zero and unused under
    "f32", so both modes share one step signature). The serving steps
    update these tensors in place.
    """

    def __init__(self, geom: PageGeometry, layers: int, heads: int,
                 head_dim: int, dtype: torch.dtype,
                 device: torch.device, kv_dtype: str = "f32"):
        if kv_dtype not in KV_DTYPES:
            raise ValueError(
                f"serve kv_dtype must be one of {KV_DTYPES}, "
                f"got {kv_dtype!r}")
        self.geom = geom
        self.kv_dtype = kv_dtype
        self.quantized = kv_dtype == "int8"
        shape = (layers, geom.pages, geom.page, heads, head_dim)
        store = torch.int8 if self.quantized else dtype
        self.k = torch.zeros(shape, dtype=store, device=device)
        self.v = torch.zeros(shape, dtype=store, device=device)
        self.k_scale = torch.zeros((layers, geom.pages), dtype=torch.float32,
                                   device=device)
        self.v_scale = torch.zeros_like(self.k_scale)
        self.valid = torch.zeros((geom.pages, geom.page),
                                 dtype=torch.float32, device=device)

    @property
    def device_bytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in
                   (self.k, self.v, self.valid, self.k_scale, self.v_scale))

    @property
    def decode_bytes_per_token(self) -> int:
        """Deterministic device bytes per decoded token, from page
        geometry and dtype (the reference's formula): per layer, the
        slot's whole context read plus one row written for K and V, and
        in int8 mode the per-page scale reads and the scale write:

            L * (2*(C+1)*H*Dh*itemsize + int8? 2*4*(Pmax+1))
        """
        L, _, _, H, Dh = self.k.shape
        per_layer = 2 * (self.geom.context + 1) * H * Dh \
            * self.k.element_size()
        if self.quantized:
            per_layer += 2 * 4 * (self.geom.pages_per_slot + 1)
        return int(L * per_layer)


class PageAllocator:
    """Refcounted host allocator over pages 1..P-1 (page 0 reserved null)
    with a prefix-cache layer (module docstring for the page states).

    alloc() returns the lowest free id (deterministic), falls back to
    evicting the LRU unreferenced cached page, and returns None only
    when every page is actively referenced; the engine turns None into a
    slot STALL and sheds load before stalls can deadlock. Every page
    handed to a slot carries one reference; sharing a cached page via
    lookup_prefix() adds one more; free() drops exactly one per page.
    """

    def __init__(self, geom: PageGeometry):
        self.geom = geom
        # pop() takes from the tail; store descending so ids come out 1, 2, …
        self._free: List[int] = list(range(geom.pages - 1, 0, -1))
        self._refs: Dict[int, int] = {}          # pid -> refcount (>= 1)
        # the prefix cache is partitioned by weight generation: KV bytes
        # are a function of the weights that produced them
        self._hash_of: Dict[int, tuple] = {}     # pid -> (gen, chain hash)
        self._by_hash: Dict[tuple, int] = {}     # (gen, chain hash) -> pid
        # refcount-0 registered pages, oldest first (eviction order)
        self._lru: "OrderedDict[int, None]" = OrderedDict()
        self.evictions = 0

    # ------------------------------------------------------------ allocation
    def alloc(self) -> Optional[int]:
        if self._free:
            pid = self._free.pop()
        elif self._lru:
            # revivable but unreferenced: the cheapest page to sacrifice
            pid, _ = self._lru.popitem(last=False)
            self._unregister(pid)
            self.evictions += 1
        else:
            return None
        self._refs[pid] = 1
        return pid

    def free(self, page_ids: Sequence[int]) -> None:
        """Drop ONE reference per listed page. A page whose refcount
        reaches 0 returns to the free list — unless it is registered in
        the prefix cache, in which case it parks in the LRU with its
        contents intact. The re-sort keeps alloc/free an exact
        involution (free-list order included)."""
        released = False
        for pid in page_ids:
            pid = int(pid)
            if not 0 < pid < self.geom.pages:
                raise ValueError(f"freeing page {pid} outside slab "
                                 f"(1..{self.geom.pages - 1})")
            if pid not in self._refs:
                raise ValueError(f"double free of page {pid}")
            self._refs[pid] -= 1
            if self._refs[pid] > 0:
                continue
            del self._refs[pid]
            if pid in self._hash_of:
                self._lru[pid] = None      # newest at the end
            else:
                self._free.append(pid)
                released = True
        if released:
            # keep lowest-id-first allocation after churn (determinism)
            self._free.sort(reverse=True)

    # ---------------------------------------------------------- prefix cache
    def register_prefix(self, pid: int, digest: bytes,
                        gen: int = 0) -> bool:
        """Publish a referenced, fully-written prompt page under its
        chain hash. Returns False (no-op) when the key is already mapped
        — first writer wins."""
        if pid not in self._refs:
            raise ValueError(f"registering unreferenced page {pid}")
        key = (int(gen), digest)
        if key in self._by_hash or pid in self._hash_of:
            return False
        self._hash_of[pid] = key
        self._by_hash[key] = pid
        return True

    def lookup_prefix(self, digest: bytes, gen: int = 0) -> Optional[int]:
        """Prefix-cache hit: take one reference on the page registered
        under (gen, digest), reviving it from the LRU if it was parked
        there. Returns None on miss."""
        pid = self._by_hash.get((int(gen), digest))
        if pid is None:
            return None
        self._lru.pop(pid, None)
        self._refs[pid] = self._refs.get(pid, 0) + 1
        return pid

    def drop_generation(self, gen: int) -> int:
        """Unregister every page of a weight generation's partition;
        parked (refcount-0) ones go straight back to the free list.
        Returns the number of pages unregistered."""
        gen = int(gen)
        victims = [pid for pid, (g, _) in self._hash_of.items() if g == gen]
        released = False
        for pid in victims:
            self._unregister(pid)
            if pid in self._refs:
                continue  # frees normally when its last stream releases
            if pid in self._lru:
                del self._lru[pid]
            self._free.append(pid)
            released = True
        if released:
            self._free.sort(reverse=True)
        return len(victims)

    def writable(self, pid: int) -> bool:
        """True when a slot may write into the page in place: exactly one
        reference and not published in the prefix cache."""
        return self._refs.get(pid, 0) == 1 and pid not in self._hash_of

    def refcount(self, pid: int) -> int:
        return self._refs.get(int(pid), 0)

    def _unregister(self, pid: int) -> None:
        digest = self._hash_of.pop(pid, None)
        if digest is not None:
            self._by_hash.pop(digest, None)

    # ------------------------------------------------------------ accounting
    def check_invariants(self) -> List[str]:
        """Audit the three-state pool; returns human-readable violation
        strings (empty = healthy). The load-bearing identity is page
        conservation: null + free + referenced + parked == every page."""
        problems: List[str] = []
        free, refd = set(self._free), set(self._refs)
        parked = set(self._lru)
        if len(free) != len(self._free):
            problems.append("free list holds duplicate page ids")
        sets = {"free": free, "referenced": refd, "parked": parked}
        for name, ids in sets.items():
            bad = [p for p in ids if not 0 < p < self.geom.pages]
            if bad:
                problems.append(f"{name} pages outside slab: {bad}")
        for a, b in (("free", "referenced"), ("free", "parked"),
                     ("referenced", "parked")):
            inter = sets[a] & sets[b]
            if inter:
                problems.append(f"pages both {a} and {b}: {sorted(inter)}")
        accounted = 1 + len(free) + len(refd) + len(parked)
        if accounted != self.geom.pages:
            problems.append(
                f"page conservation broken: null(1) + free({len(free)}) "
                f"+ referenced({len(refd)}) + parked({len(parked)}) "
                f"= {accounted}, slab has {self.geom.pages}")
        if any(c < 1 for c in self._refs.values()):
            problems.append("refcount below 1 retained in _refs")
        if len(self._by_hash) != len(self._hash_of):
            problems.append("prefix-hash index is not a bijection")
        for pid, key in self._hash_of.items():
            if self._by_hash.get(key) != pid:
                problems.append(f"hash index mismatch for page {pid}")
        unreg = parked - set(self._hash_of)
        if unreg:
            problems.append(f"parked pages not registered: {sorted(unreg)}")
        return problems

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def evictable_pages(self) -> int:
        """Cached (registered, refcount-0) pages alloc() may evict."""
        return len(self._lru)

    @property
    def cached_pages(self) -> int:
        """Pages registered in the prefix cache (referenced or parked)."""
        return len(self._hash_of)

    @property
    def in_use(self) -> int:
        """Pages some slot currently references."""
        return len(self._refs)

    def utilization(self) -> float:
        return self.in_use / self.geom.usable_pages
