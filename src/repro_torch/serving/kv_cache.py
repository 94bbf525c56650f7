"""Paged KV cache: block-table allocation over a fixed pool of KV pages.

The dense engine's memory bill is ``batch_slots x max_seq`` cache rows no
matter how short the actual sequences are — the padded-waste problem
RedMulE/FantastIC4 attack with adaptive sizing. Here the cache is a fixed
pool of fixed-size *pages* (the device arrays live in the model's cache
pytree, shaped ``(n_pages, Hkv, page_size, dh)`` per layer); this module is
the **host-side** allocator that maps sequences onto pages:

  * each sequence owns an ordered list of physical page indices; logical
    token position ``p`` lives at ``(pages[p // page_size], p % page_size)``
  * pages are **reference counted**: a full page holding a page-aligned
    block of prompt tokens is immutable once written, so later requests
    with the same prompt prefix map the *same* physical page instead of
    re-prefilling it (``match_prefix``/``register_prefix`` keep a prefix
    index of chain hashes over page-aligned token blocks); a page recycles
    only when its refcount hits zero
  * a free list recycles pages the moment their last owner finishes (LIFO,
    so recently-touched pages are reused first). A freed page *stays in
    the prefix index* until the free list hands it out again (lazy
    eviction) — a system prompt survives in the pool between request
    waves for free
  * admission asks ``can_admit(n_tokens)`` — a request whose worst-case
    footprint exceeds the currently free pages stays queued instead of
    crashing or evicting others
  * the pool is **two-tier**: a preempted sequence's written pages can be
    ``offload``-ed to a host-memory tier (the engine snapshots the device
    bytes and hands them over as an opaque payload; the device pages are
    released ref-aware) and later ``onload``-ed back into freshly
    allocated device pages — the accounting here guarantees no double
    offload and exact free-list recovery, the engine guarantees the
    restored bytes are the written bytes
  * the prefix index is optionally **capacity-bounded**
    (``cache_pages=``): cached-free pages (refcount zero but still
    indexed) beyond the bound are evicted least-recently-used first, and
    fresh allocations prefer un-indexed free pages so a hot cached prefix
    is the last thing recycled (ref-aware eviction). Lookup/hit/eviction
    counters live in ``PoolStats``.

The *device* side consumes only the ``block_table`` this produces: an
``(n_seqs, pages_per_seq)`` int32 array of physical page indices that the
paged-attention kernel uses to gather K/V (see kernels/paged_attention.py).
Unused table slots point at page 0 and are masked by the context length.
Shared pages appear in several rows at once — the device neither knows nor
cares; ownership and copy-on-write live here and in the engine.

Sizing (all byte helpers return bytes; counts are tokens/pages):
``kv_bytes_per_token`` x ``page_size`` x ``n_pages`` is the whole pool —
derived from the *actual* cache dtype (and the codes+scale layout when the
pool is quantized); see docs/SERVING.md for a worked example.
"""
from __future__ import annotations

import dataclasses
import hashlib

import numpy as np

from repro_torch.core import spx
from repro_torch.runtime import planner

__all__ = [
    "PagePool", "StateCache", "PoolStats", "StateStats",
    "kv_bytes_per_token", "pool_bytes",
    "ssm_state_bytes_per_seq", "cross_kv_bytes_per_seq",
]


def _elem_bytes(cache_dtype=None, dtype_bytes: int | None = None) -> int:
    """Element width in bytes from an explicit dtype OR an explicit byte
    count — exactly one of the two. A raw int passed as ``cache_dtype`` is
    rejected (``np.dtype(2)`` would silently parse as float64): byte
    widths go through ``dtype_bytes=``."""
    if (cache_dtype is None) == (dtype_bytes is None):
        raise ValueError(
            "pass exactly one of cache_dtype= (a dtype such as "
            "jnp.bfloat16) or dtype_bytes= (an int byte width); got "
            f"cache_dtype={cache_dtype!r}, dtype_bytes={dtype_bytes!r}")
    if dtype_bytes is not None:
        if not isinstance(dtype_bytes, int) or dtype_bytes <= 0:
            raise ValueError(f"dtype_bytes must be a positive int, got "
                             f"{dtype_bytes!r}")
        return dtype_bytes
    if isinstance(cache_dtype, int):
        raise ValueError(
            f"cache_dtype={cache_dtype!r} is a raw int — ambiguous "
            f"(np.dtype(2) parses as float64, not 2 bytes). Pass a real "
            f"dtype, or the byte width via dtype_bytes=")
    return int(np.dtype(cache_dtype).itemsize)


def kv_bytes_per_token(cfg, cache_dtype=None, *,
                       dtype_bytes: int | None = None,
                       kv_scheme: str | None = None) -> int:
    """Bytes of K+V cache one token occupies across every attention layer.

    ``cfg``: an ArchConfig; ``cache_dtype``: the dtype the cache arrays
    are actually allocated with (e.g. ``jnp.float32``/``jnp.bfloat16`` —
    pass whatever went to ``init_caches``/``paged_init_caches``);
    ``dtype_bytes``: an explicit element byte width, mutually exclusive
    with ``cache_dtype``. ``kv_scheme`` set (any core/spx scheme name)
    switches to the quantized codes+scale layout: 1 byte of uint8 code per
    element plus a 4-byte f32 scale per (token, KV head) side — the dtype
    arguments are then ignored (and may be omitted), matching the
    allocation. Counts attention mixers only — SSM slots carry O(1) state
    (``ssm_state_bytes_per_seq``) and cross-attention KV is per-sequence
    (``cross_kv_bytes_per_seq``), not per-token.
    """
    n_attn = sum(1 for s in cfg.pattern
                 if s.split("+")[0] in ("attn", "xdec"))
    if kv_scheme is not None:
        per_head = spx.kv_token_side_bytes(cfg.dh)   # codes + f32 scale
    else:
        per_head = cfg.dh * _elem_bytes(cache_dtype, dtype_bytes)
    return 2 * cfg.n_periods * n_attn * cfg.n_kv_heads * per_head


def pool_bytes(cfg, n_pages: int, page_size: int, cache_dtype=None, *,
               dtype_bytes: int | None = None,
               kv_scheme: str | None = None) -> int:
    """Total device bytes of the paged K/V pool (all layers) — equal by
    construction to the summed ``.nbytes`` of the arrays
    ``models.lm.paged_init_caches`` allocates for the same geometry
    (regression-tested)."""
    return n_pages * page_size * kv_bytes_per_token(
        cfg, cache_dtype, dtype_bytes=dtype_bytes, kv_scheme=kv_scheme)


def ssm_state_bytes_per_seq(cfg, cache_dtype=None, *,
                            dtype_bytes: int | None = None) -> int:
    """Bytes of recurrent state one sequence pins across every SSM slot —
    the per-slab bill of the StateCache slab region. O(1) in sequence
    length: a mamba slot is a selective-scan ``h`` (f32) plus a conv
    window, an mLSTM slot is the (C, n, m) matrix-memory triplet (f32)
    plus a conv window, an sLSTM slot is four per-head f32 vectors.
    ``cache_dtype``/``dtype_bytes`` size the conv windows (they live in
    the cache dtype); the scan/cell states are f32 by construction.
    Returns 0 for attention-only patterns."""
    mixers = [s.split("+")[0] for s in cfg.pattern]
    if not any(m in ("mamba", "mlstm", "slstm") for m in mixers):
        return 0
    eb = _elem_bytes(cache_dtype, dtype_bytes)
    di = cfg.ssm_expand * cfg.d_model
    dc, ds, nh = cfg.ssm_d_conv, cfg.ssm_d_state, cfg.lstm_heads
    per_period = 0
    for m in mixers:
        if m == "mamba":
            per_period += 4 * di * ds + eb * (dc - 1) * di
        elif m == "mlstm":
            dh = di // nh
            per_period += 4 * (nh * dh * dh + nh * dh + nh) \
                + eb * (dc - 1) * di
        elif m == "slstm":
            per_period += 4 * 4 * nh * (cfg.d_model // nh)
    return cfg.n_periods * per_period


def cross_kv_bytes_per_seq(cfg, cache_dtype=None, *,
                           dtype_bytes: int | None = None) -> int:
    """Bytes of read-only cross-attention K+V one sequence references —
    the per-slot bill of the StateCache cross region (shared across
    sequences decoding the same input frames, so the *peak* bill is
    ``peak_cross_in_use`` slots, not one per sequence). Returns 0 for
    patterns without an ``xdec`` mixer."""
    n_xdec = sum(1 for s in cfg.pattern if s.split("+")[0] == "xdec")
    if n_xdec == 0:
        return 0
    eb = _elem_bytes(cache_dtype, dtype_bytes)
    return 2 * cfg.n_periods * n_xdec * cfg.n_kv_heads \
        * cfg.enc_seq_len * cfg.dh * eb


@dataclasses.dataclass
class PoolStats:
    """Allocator counters. Pages are counted in pages, not bytes;
    ``pages_in_use`` counts *distinct physical* pages (a page shared by
    three sequences counts once — that is the whole point of sharing)."""
    n_pages: int
    page_size: int
    pages_in_use: int = 0
    peak_pages_in_use: int = 0
    alloc_calls: int = 0
    release_calls: int = 0
    admission_denials: int = 0      # distinct sequences denied, not ticks
    prefix_pages_shared: int = 0    # cumulative refcount bumps from sharing
    # host tier (preemption offload)
    host_pages_in_use: int = 0      # pages of offloaded KV held on host
    peak_host_pages: int = 0
    offload_calls: int = 0
    onload_calls: int = 0
    # prefix-cache economics
    prefix_lookups: int = 0         # match_prefix calls
    prefix_hits: int = 0            # ... that returned >= 1 page
    prefix_evictions: int = 0       # index entries dropped (LRU + reuse)

    @property
    def occupancy(self) -> float:
        return self.pages_in_use / self.n_pages if self.n_pages else 0.0

    @property
    def peak_occupancy(self) -> float:
        return self.peak_pages_in_use / self.n_pages if self.n_pages \
            else 0.0


class PagePool:
    """Host-side page allocator: free list + refcounts + per-sequence page
    lists + prefix index.

    Deterministic (LIFO free list), single-threaded — the engine drives it
    from its scheduling loop. All methods are O(pages touched), except the
    O(pool) free-list removal when a cached free page is revived and the
    O(prefix tokens) hashing in ``match_prefix``/``register_prefix``.

    Mutations are transactional: every failure path — a capacity denial
    (returns None) or a caller error (raises) — leaves the free list,
    refcounts, sequence maps, prefix index and stats exactly as they were
    before the call. Validation runs before the first pop, so a partial
    allocation can never leak pages (regression-tested).

    ``host_pages`` bounds the host tier (pages of offloaded KV that may
    sit in host memory at once; None = unbounded). ``cache_pages`` bounds
    the prefix cache (cached-free indexed pages; None = the original lazy
    policy: entries survive until the page is physically reused).
    """

    # pure-SSM StateCaches run pageless (n_pages == 0); the plain PagePool
    # keeps requiring at least one page
    _min_pages = 1
    _stats_cls = PoolStats

    def __init__(self, n_pages: int, page_size: int, *,
                 host_pages: int | None = None,
                 cache_pages: int | None = None):
        if n_pages < self._min_pages or page_size <= 0:
            raise ValueError((n_pages, page_size))
        if host_pages is not None and host_pages < 0:
            raise ValueError(f"host_pages must be >= 0, got {host_pages}")
        if cache_pages is not None and cache_pages < 0:
            raise ValueError(f"cache_pages must be >= 0, got {cache_pages}")
        self.n_pages = n_pages
        self.page_size = page_size
        self.host_pages = host_pages
        self.cache_pages = cache_pages
        self._free: list[int] = list(range(n_pages - 1, -1, -1))
        self._ref: list[int] = [0] * n_pages
        self._seq_pages: dict[int, list[int]] = {}
        # host tier: seq -> (pages of KV parked on host, opaque payload —
        # the engine stores the snapshotted device bytes here)
        self._host_seqs: dict[int, tuple[int, object]] = {}
        # prefix index: chain hash of a page-aligned token prefix -> the
        # physical page holding its last block. _page_key is the inverse
        # (a page carries at most one index entry) so eviction is O(1).
        self._index: dict[bytes, int] = {}
        self._page_key: dict[int, bytes] = {}
        # LRU clock for cached prefixes: page -> last-touched tick
        # (touched on register / match / share / revive)
        self._tick = 0
        self._touched: dict[int, int] = {}
        self._denied: set[int] = set()
        self.stats = self._stats_cls(n_pages, page_size)

    # -- queries -------------------------------------------------------------

    def pages_for(self, n_tokens: int) -> int:
        """Pages needed to hold ``n_tokens`` tokens (ceil) with no shared
        prefix — the planner owns the page-count model."""
        return planner.plan_seq_pages(n_tokens, self.page_size)

    def free_pages(self) -> int:
        return len(self._free)

    def can_admit(self, n_tokens: int) -> bool:
        """Would ``allocate`` succeed for a new ``n_tokens``-token
        reservation right now (no shared prefix)?"""
        return self.pages_for(n_tokens) <= len(self._free)

    def seq_page_count(self, seq_id: int) -> int:
        return len(self._seq_pages.get(seq_id, ()))

    def seq_pages(self, seq_id: int) -> tuple[int, ...]:
        """The sequence's physical page list (copy; () when not live)."""
        return tuple(self._seq_pages.get(seq_id, ()))

    def ref_count(self, page: int) -> int:
        """Live owners of a physical page (0 = free or cached-free)."""
        return self._ref[page]

    def cached_prefix_pages(self) -> int:
        """Pages currently carrying a prefix-index entry (live + cached)."""
        return len(self._index)

    # -- prefix index --------------------------------------------------------

    def _page_keys(self, tokens, n_full: int) -> list[bytes]:
        """Chain keys for the first ``n_full`` page-aligned blocks of
        ``tokens``: key k hashes blocks 0..k, so equal keys mean equal
        *prefixes*, not just equal blocks (positional KV — RoPE — makes a
        block's cache content depend on everything before it)."""
        t = np.ascontiguousarray(np.asarray(tokens, dtype=np.int32))
        h = hashlib.sha1()
        keys = []
        for k in range(n_full):
            h.update(t[k * self.page_size:(k + 1) * self.page_size]
                     .tobytes())
            keys.append(h.digest())
        return keys

    def prompt_keys(self, tokens) -> list[bytes]:
        """Chain keys for every full page of ``tokens``. Hashing is O(len)
        — compute once per prompt and hand the result to ``match_prefix``
        / ``register_prefix`` so a blocked queue head retried every tick
        (or a prompt registered chunk by chunk) doesn't re-hash from
        block 0 each time."""
        return self._page_keys(tokens, len(tokens) // self.page_size)

    def match_prefix(self, tokens, *, keys=None) -> list[int]:
        """Physical pages holding the longest indexed page-aligned prefix
        of ``tokens`` (possibly all ``len(tokens) // page_size`` full
        pages). Read-only — pass the result to ``allocate(...,
        shared_prefix=...)`` in the same scheduling tick to claim it (a
        matched page may be a cached *free* page; an intervening fresh
        allocation could evict it). ``keys``: precomputed
        ``prompt_keys(tokens)``, to skip re-hashing."""
        if keys is None:
            keys = self.prompt_keys(tokens)
        pages: list[int] = []
        for key in keys:
            page = self._index.get(key)
            if page is None:
                break
            pages.append(page)
        self.stats.prefix_lookups += 1
        if pages:
            self.stats.prefix_hits += 1
            self._tick += 1
            for p in pages:
                self._touched[p] = self._tick
        return pages

    def register_prefix(self, seq_id: int, tokens,
                        n_tokens: int | None = None, *, keys=None):
        """Index the full pages covering the first ``n_tokens`` of
        ``tokens`` (a prompt) for sequence ``seq_id``. Call only once the
        pages are actually written (the engine registers after each
        prefill chunk). Idempotent: already-indexed prefixes (this
        sequence's own shared pages included) are skipped, and a page
        never carries more than one index entry. ``keys``: precomputed
        ``prompt_keys(tokens)``, to skip re-hashing."""
        if seq_id not in self._seq_pages:
            raise KeyError(f"seq {seq_id}: not live, cannot register")
        pages = self._seq_pages[seq_id]
        n = len(tokens) if n_tokens is None else min(n_tokens, len(tokens))
        n_full = n // self.page_size
        if keys is None:
            keys = self._page_keys(tokens, n_full)
        self._tick += 1
        for k, key in enumerate(keys[:n_full]):
            page = pages[k]
            if key in self._index or page in self._page_key:
                if page in self._page_key:
                    self._touched[page] = self._tick
                continue
            self._index[key] = page
            self._page_key[page] = key
            self._touched[page] = self._tick

    def _evict(self, page: int):
        """Drop the page's prefix-index entry (it is about to be rewritten
        by a fresh owner, or LRU-evicted past ``cache_pages``)."""
        key = self._page_key.pop(page, None)
        if key is not None:
            del self._index[key]
            self._touched.pop(page, None)
            self.stats.prefix_evictions += 1

    def _pop_fresh(self) -> int:
        """Pop a free page for a fresh allocation, preferring un-indexed
        pages (LIFO among those) so hot cached prefixes are the last thing
        recycled; when every free page carries a cached prefix, recycle
        the least-recently-touched one."""
        for i in range(len(self._free) - 1, -1, -1):
            if self._free[i] not in self._page_key:
                return self._free.pop(i)
        i = min(range(len(self._free)),
                key=lambda j: self._touched.get(self._free[j], 0))
        return self._free.pop(i)

    def _enforce_cache_capacity(self):
        """Evict cached-free prefix pages (refcount zero but still
        indexed) past the ``cache_pages`` bound, coldest first. Pages
        pinned by live owners never count against the bound — their index
        entries are free to keep (ref-aware)."""
        if self.cache_pages is None:
            return
        cached = [p for p in self._page_key if self._ref[p] == 0]
        while len(cached) > self.cache_pages:
            victim = min(cached, key=lambda p: self._touched.get(p, 0))
            self._evict(victim)
            cached.remove(victim)

    # -- mutation ------------------------------------------------------------

    def allocate(self, seq_id: int, n_tokens: int, *,
                 shared_prefix=()) -> list[int] | None:
        """Reserve pages for ``n_tokens`` tokens of sequence ``seq_id``
        (worst case up front — no mid-decode OOM, no preemption).

        ``shared_prefix``: physical pages from ``match_prefix`` to map
        into the head of the page list instead of allocating fresh —
        each gets a refcount bump (and a cached free page is pulled back
        out of the free list). Returns the full page list
        ``shared + fresh`` in logical order, or None when the pool can't
        cover the fresh remainder; the caller keeps the request queued.
        A denial is counted once per sequence, not once per retry — the
        engine re-asks every tick. Error paths (bad caller arguments)
        raise before any state change; a None return changes only the
        denial counters.
        """
        if seq_id in self._seq_pages:
            raise KeyError(f"seq {seq_id} already allocated")
        shared = [int(p) for p in shared_prefix]
        total = planner.plan_seq_pages(n_tokens, self.page_size)
        if len(shared) > total:
            raise ValueError(
                f"seq {seq_id}: shared_prefix has {len(shared)} pages but "
                f"{n_tokens} tokens only need {total}")
        # validate every shared page BEFORE mutating anything: a failure
        # here must not leak pages popped for earlier entries
        seen: set[int] = set()
        for p in shared:
            if not 0 <= p < self.n_pages or p in seen:
                raise ValueError(
                    f"seq {seq_id}: shared_prefix page {p} out of range "
                    f"or duplicated")
            if self._ref[p] == 0 and p not in self._page_key:
                raise ValueError(
                    f"seq {seq_id}: shared_prefix page {p} is neither "
                    f"live nor prefix-indexed (stale match?)")
            seen.add(p)
        n_fresh = total - len(shared)
        revive = [p for p in shared if self._ref[p] == 0]
        self.stats.alloc_calls += 1
        # revived cached pages leave the free list too — budget both
        if n_fresh + len(revive) > len(self._free):
            if seq_id not in self._denied:
                self._denied.add(seq_id)
                self.stats.admission_denials += 1
            return None
        self._denied.discard(seq_id)
        for p in revive:
            self._free.remove(p)
        fresh = [self._pop_fresh() for _ in range(n_fresh)]
        for p in fresh:
            self._evict(p)              # content dies with the new owner
            self._ref[p] = 1
        self._tick += 1
        for p in shared:
            self._ref[p] += 1
            if p in self._page_key:
                self._touched[p] = self._tick
        pages = shared + fresh
        self._seq_pages[seq_id] = pages
        self.stats.pages_in_use += n_fresh + len(revive)
        self.stats.prefix_pages_shared += len(shared)
        self.stats.peak_pages_in_use = max(self.stats.peak_pages_in_use,
                                           self.stats.pages_in_use)
        return pages

    def release(self, seq_id: int) -> int:
        """Drop a finished sequence's reference on each of its pages;
        pages whose refcount hits zero return to the free list. Returns
        the number of pages actually freed (shared pages with surviving
        owners stay in use). Freed pages keep their prefix-index entry
        until the free list reissues them — the cheap eviction policy that
        lets a later request with the same prompt revive them.

        Raises a descriptive ``KeyError`` when ``seq_id`` has no live
        allocation — a double release or a never-admitted sequence. This
        is deliberately an error rather than an idempotent no-op: the
        engine releases exactly once per finished sequence, so a stray
        release means a scheduler bug that silent page accounting would
        hide. Stats are untouched on the error path."""
        if seq_id not in self._seq_pages:
            raise KeyError(
                f"seq {seq_id}: no live page allocation to release "
                f"(double release, or never admitted); live seqs: "
                f"{sorted(self._seq_pages)}")
        pages = self._seq_pages.pop(seq_id)
        freed = 0
        for p in reversed(pages):       # LIFO: tail pages reissue first
            self._ref[p] -= 1
            if self._ref[p] == 0:
                self._free.append(p)
                freed += 1
        self.stats.pages_in_use -= freed
        self.stats.release_calls += 1
        self._enforce_cache_capacity()
        return freed

    # -- host tier (preemption offload) --------------------------------------

    def can_offload(self, n_pages: int) -> bool:
        """Would the host tier accept ``n_pages`` more pages right now?"""
        if self.host_pages is None:
            return True
        return self.stats.host_pages_in_use + n_pages <= self.host_pages

    def releasable_pages(self, seq_id: int) -> int:
        """Device pages an offload of this sequence would actually free:
        owned pages whose only reference is this sequence (shared prefix
        pages stay resident for their other owners)."""
        return sum(1 for p in self._seq_pages.get(seq_id, ())
                   if self._ref[p] == 1)

    def host_resident(self, seq_id: int) -> bool:
        return seq_id in self._host_seqs

    def host_payload_pages(self, seq_id: int) -> int:
        """Host pages the offloaded sequence occupies (0 if not parked)."""
        return self._host_seqs.get(seq_id, (0, None))[0]

    def offload(self, seq_id: int, n_host_pages: int,
                payload=None) -> int | None:
        """Park a live sequence's KV on the host tier: drop its device
        references ref-aware (exactly like ``release`` — shared pages
        survive for their other owners) and record ``n_host_pages`` of
        host occupancy plus an opaque ``payload`` (the engine passes the
        snapshotted page bytes; the pool never inspects it).

        Returns the number of device pages actually freed, or None when
        the host tier is full (``host_pages`` bound) — the sequence stays
        live on device, state untouched. Double offload and offload of a
        non-live sequence raise ``KeyError`` (scheduler bugs)."""
        if seq_id in self._host_seqs:
            raise KeyError(f"seq {seq_id}: already offloaded "
                           f"(double offload)")
        if seq_id not in self._seq_pages:
            raise KeyError(f"seq {seq_id}: not live, cannot offload")
        if not 0 <= n_host_pages <= len(self._seq_pages[seq_id]):
            raise ValueError(
                f"seq {seq_id}: n_host_pages {n_host_pages} outside "
                f"[0, {len(self._seq_pages[seq_id])}]")
        if not self.can_offload(n_host_pages):
            return None
        pages = self._seq_pages.pop(seq_id)
        freed = 0
        for p in reversed(pages):       # LIFO, same policy as release
            self._ref[p] -= 1
            if self._ref[p] == 0:
                self._free.append(p)
                freed += 1
        self.stats.pages_in_use -= freed
        self._host_seqs[seq_id] = (n_host_pages, payload)
        self.stats.offload_calls += 1
        self.stats.host_pages_in_use += n_host_pages
        self.stats.peak_host_pages = max(self.stats.peak_host_pages,
                                         self.stats.host_pages_in_use)
        self._enforce_cache_capacity()
        return freed

    def onload(self, seq_id: int, n_tokens: int):
        """Bring an offloaded sequence back onto the device: allocate a
        fresh worst-case ``n_tokens`` reservation (no prefix sharing —
        the restored bytes are private) and hand back
        ``(pages, payload)`` so the engine can scatter the snapshotted
        bytes into the new pages. Returns None on device-capacity denial
        — the sequence stays parked on host, accounting untouched (the
        denial is counted once per sequence, like ``allocate``)."""
        if seq_id not in self._host_seqs:
            raise KeyError(f"seq {seq_id}: not offloaded, cannot onload")
        n_host, payload = self._host_seqs[seq_id]
        pages = self.allocate(seq_id, n_tokens)
        if pages is None:
            return None
        del self._host_seqs[seq_id]
        self.stats.onload_calls += 1
        self.stats.host_pages_in_use -= n_host
        return pages, payload

    def drop_host(self, seq_id: int) -> int:
        """Forget a host-parked sequence without bringing it back — the
        mid-flight cancellation path for preempted-and-parked requests.
        The snapshot payload is dropped and its host occupancy returned
        to the tier. Returns the host pages released. Raises a
        descriptive ``KeyError`` when the sequence is not parked (same
        contract as ``onload``)."""
        if seq_id not in self._host_seqs:
            raise KeyError(f"seq {seq_id}: not offloaded, cannot drop")
        n_host, _ = self._host_seqs.pop(seq_id)
        self.stats.host_pages_in_use -= n_host
        self._denied.discard(seq_id)
        return n_host

    def block_table_row(self, seq_id: int, width: int) -> np.ndarray:
        """(width,) int32 physical-page row for the device block table.
        Slots past the sequence's allocation point at page 0 — the kernel
        masks them via the context length, never reads them as data."""
        pages = self._seq_pages.get(seq_id, [])
        if len(pages) > width:
            raise ValueError(f"seq {seq_id}: {len(pages)} pages > table "
                             f"width {width}")
        row = np.zeros(width, np.int32)
        row[:len(pages)] = pages
        return row

    # -- consistency ---------------------------------------------------------

    def validate(self):
        """Assert every internal invariant (tests call this after each
        mutation): page conservation, refcount == number of owning
        sequences, free list exactness, index/inverse agreement, stats
        coherence. Raises AssertionError on the first violation."""
        held: dict[int, int] = {}
        for pages in self._seq_pages.values():
            assert len(set(pages)) == len(pages), "page twice in one seq"
            for p in pages:
                held[p] = held.get(p, 0) + 1
        for p in range(self.n_pages):
            assert self._ref[p] == held.get(p, 0), \
                f"page {p}: ref {self._ref[p]} != owners {held.get(p, 0)}"
        assert len(self._free) == len(set(self._free)), "free-list dup"
        assert all(self._ref[p] == 0 for p in self._free), \
            "live page on the free list"
        assert len(self._free) + sum(r > 0 for r in self._ref) \
            == self.n_pages, "page conservation violated"
        assert self.stats.pages_in_use == sum(r > 0 for r in self._ref)
        assert 0 <= self.stats.pages_in_use <= self.stats.peak_pages_in_use
        assert self.stats.peak_pages_in_use <= self.n_pages
        for key, p in self._index.items():
            assert self._page_key.get(p) == key, "index/inverse mismatch"
        for p, key in self._page_key.items():
            assert self._index.get(key) == p, "inverse/index mismatch"
        assert set(self._touched) <= set(self._page_key), \
            "LRU clock entry for an un-indexed page"
        # host tier: a sequence lives on exactly one tier, occupancy is the
        # sum of its entries and stays under the bound
        assert not (set(self._host_seqs) & set(self._seq_pages)), \
            "sequence live on device and host at once"
        assert self.stats.host_pages_in_use == \
            sum(n for n, _ in self._host_seqs.values()), \
            "host occupancy out of sync"
        assert self.stats.host_pages_in_use <= self.stats.peak_host_pages \
            or self.stats.peak_host_pages == 0
        if self.host_pages is not None:
            assert self.stats.host_pages_in_use <= self.host_pages, \
                "host tier over capacity"
        if self.cache_pages is not None:
            cached_free = sum(1 for p in self._page_key
                              if self._ref[p] == 0)
            assert cached_free <= self.cache_pages, \
                f"{cached_free} cached-free pages > bound {self.cache_pages}"


@dataclasses.dataclass
class StateStats(PoolStats):
    """PoolStats plus the slab (recurrent SSM state) and cross
    (read-only encoder-output KV) region counters. Slabs are exclusive —
    one per live sequence with SSM slots; cross entries are refcounted and
    shared across sequences decoding the same input frames, so
    ``cross_in_use`` counts *distinct* entries."""
    n_slabs: int = 0
    slabs_in_use: int = 0
    peak_slabs_in_use: int = 0
    n_cross: int = 0
    cross_in_use: int = 0
    peak_cross_in_use: int = 0
    cross_lookups: int = 0          # admissions that needed a cross entry
    cross_hits: int = 0             # ... served from an existing entry
    cross_evictions: int = 0        # cached-free cross entries recycled


class StateCache(PagePool):
    """PagePool generalized into a unified state-cache with three region
    types under one budget, one admission policy, one stats surface:

      * the token-paged KV **page** region inherited from PagePool
        (attention and decoder-self-attention slots);
      * a fixed-size **slab** region for recurrent SSM state: one slab per
        live sequence holds the conv windows and selective-scan/cell
        states of *every* SSM slot x period (the device arrays are shaped
        ``(P, n_slabs, ...)`` per state leaf — see
        ``transformer.slot_init_paged_cache``). Slabs are exclusive
        (recurrent state is written every step, never shareable),
        allocated and released atomically with the sequence's pages, and
        preempt/offload-able: the engine snapshots the slab bytes into the
        offload payload and the slab returns to the free list;
      * a refcounted **cross** region of read-only encoder-output KV
        entries keyed by the input frames (``cross_key``): requests
        decoding the same audio/image share one entry — the enc-dec
        analogue of the prefix cache, reusing the *whole encoder pass*
        across requests. Entries go cached-free on last release (index
        kept, LRU-evicted only when a fresh admission needs the slot).

    Allocation is all-or-nothing across regions: ``allocate`` first
    budget-checks the slab and cross needs, then runs the (transactional)
    page allocation, then commits the slab/cross bookkeeping — a denial in
    any region leaves every region untouched, so a queued request never
    holds a slab while waiting for pages or vice versa.

    ``n_pages=0`` is legal (pure-SSM models run pageless: every
    reservation is 0 pages and ``allocate`` returns ``[]`` — callers must
    test ``pages is None``, never truthiness).
    """

    _min_pages = 0
    _stats_cls = StateStats

    def __init__(self, n_pages: int, page_size: int, *,
                 n_slabs: int = 0, n_cross: int = 0,
                 host_pages: int | None = None,
                 cache_pages: int | None = None):
        if n_slabs < 0 or n_cross < 0:
            raise ValueError((n_slabs, n_cross))
        super().__init__(n_pages, page_size, host_pages=host_pages,
                         cache_pages=cache_pages)
        self.stats.n_slabs = n_slabs
        self.stats.n_cross = n_cross
        self.n_slabs = n_slabs
        self.n_cross = n_cross
        # slab region: exclusive, LIFO free list, one per sequence
        self._slab_free: list[int] = list(range(n_slabs - 1, -1, -1))
        self._seq_slab: dict[int, int] = {}
        # cross region: refcounted + indexed by frames key, LRU shares the
        # page region's _tick clock
        self._cross_free: list[int] = list(range(n_cross - 1, -1, -1))
        self._seq_cross: dict[int, int] = {}
        self._cross_ref: list[int] = [0] * n_cross
        self._cross_index: dict[bytes, int] = {}
        self._cross_key: dict[int, bytes] = {}
        self._cross_touched: dict[int, int] = {}
        # sequences whose cross entry was a MISS: the engine must run the
        # encoder and fill the entry before the first decoder step
        self._cross_fresh: set[int] = set()
        # offloaded sequences that must reacquire a slab at onload
        self._host_needs: dict[int, bool] = {}

    # -- region queries ------------------------------------------------------

    def seq_slab(self, seq_id: int) -> int | None:
        """The sequence's slab index (None when it holds no slab)."""
        return self._seq_slab.get(seq_id)

    def seq_cross(self, seq_id: int) -> int | None:
        """The sequence's cross-entry index (None when it holds none).
        Survives offload — the entry is read-only and possibly shared, so
        parking the sequence on host keeps its reference alive and skips
        the encoder rerun at resume."""
        return self._seq_cross.get(seq_id)

    def consume_cross_fresh(self, seq_id: int) -> bool:
        """True exactly once after an admission whose cross entry was a
        miss: the caller must encode the frames and fill the entry."""
        if seq_id in self._cross_fresh:
            self._cross_fresh.discard(seq_id)
            return True
        return False

    def free_slabs(self) -> int:
        return len(self._slab_free)

    def free_cross(self) -> int:
        return len(self._cross_free)

    # -- cross-region internals ----------------------------------------------

    def _cross_evict(self, slot: int):
        """Drop a cached-free cross entry's index (its slot is about to be
        rewritten by a fresh encoder output)."""
        key = self._cross_key.pop(slot, None)
        if key is not None:
            del self._cross_index[key]
            self._cross_touched.pop(slot, None)
            self.stats.cross_evictions += 1

    def _pop_fresh_cross(self) -> int:
        """Pop a free cross slot, preferring un-indexed slots so hot
        cached encoder outputs are the last thing recycled; else recycle
        the least-recently-touched cached-free one."""
        for i in range(len(self._cross_free) - 1, -1, -1):
            if self._cross_free[i] not in self._cross_key:
                return self._cross_free.pop(i)
        i = min(range(len(self._cross_free)),
                key=lambda j: self._cross_touched.get(self._cross_free[j],
                                                      0))
        return self._cross_free.pop(i)

    # -- unified admission ---------------------------------------------------

    def allocate(self, seq_id: int, n_tokens: int, *, shared_prefix=(),
                 need_slab: bool = False,
                 cross_key: bytes | None = None) -> list[int] | None:
        """PagePool.allocate extended to the slab and cross regions,
        all-or-nothing. ``need_slab``: reserve one SSM-state slab;
        ``cross_key``: the frames hash — a hit maps the existing entry
        (refcount bump), a miss claims a fresh slot and marks the
        sequence ``consume_cross_fresh`` so the engine runs the encoder.
        Returns the page list (possibly ``[]`` on a pageless pool) or
        None when *any* region lacks capacity — no region is touched."""
        if seq_id in self._seq_pages:
            raise KeyError(f"seq {seq_id} already allocated")
        want_slab = need_slab and seq_id not in self._seq_slab
        want_cross = cross_key is not None and seq_id not in self._seq_cross
        cross_hit = (want_cross
                     and self._cross_index.get(cross_key) is not None)
        # a hit revives an existing slot (even cached-free: the slot just
        # leaves the free list); only a miss consumes a free slot
        if (want_slab and not self._slab_free) or \
                (want_cross and not cross_hit and not self._cross_free):
            self.stats.alloc_calls += 1
            if seq_id not in self._denied:
                self._denied.add(seq_id)
                self.stats.admission_denials += 1
            return None
        pages = super().allocate(seq_id, n_tokens,
                                 shared_prefix=shared_prefix)
        if pages is None:
            return None                 # super counted the denial
        if want_slab:
            slab = self._slab_free.pop()
            self._seq_slab[seq_id] = slab
            self.stats.slabs_in_use += 1
            self.stats.peak_slabs_in_use = max(
                self.stats.peak_slabs_in_use, self.stats.slabs_in_use)
        if want_cross:
            self.stats.cross_lookups += 1
            self._tick += 1
            if cross_hit:
                slot = self._cross_index[cross_key]
                self.stats.cross_hits += 1
                if self._cross_ref[slot] == 0:
                    self._cross_free.remove(slot)   # revive cached-free
                    self.stats.cross_in_use += 1
            else:
                slot = self._pop_fresh_cross()
                self._cross_evict(slot)
                self._cross_index[cross_key] = slot
                self._cross_key[slot] = cross_key
                self._cross_fresh.add(seq_id)
                self.stats.cross_in_use += 1
            self._cross_ref[slot] += 1
            self._cross_touched[slot] = self._tick
            self._seq_cross[seq_id] = slot
            self.stats.peak_cross_in_use = max(
                self.stats.peak_cross_in_use, self.stats.cross_in_use)
        return pages

    def release(self, seq_id: int) -> int:
        freed = super().release(seq_id)     # raises if not live
        slab = self._seq_slab.pop(seq_id, None)
        if slab is not None:
            self._slab_free.append(slab)
            self.stats.slabs_in_use -= 1
        slot = self._seq_cross.pop(seq_id, None)
        if slot is not None:
            self._cross_ref[slot] -= 1
            if self._cross_ref[slot] == 0:
                self._cross_free.append(slot)   # cached-free: index kept
                self.stats.cross_in_use -= 1
        self._cross_fresh.discard(seq_id)
        return freed

    # -- host tier ------------------------------------------------------------

    def offload(self, seq_id: int, n_host_pages: int,
                payload=None) -> int | None:
        """Like PagePool.offload, plus: the sequence's slab returns to the
        free list (the engine snapshots the slab bytes into the payload)
        and is reacquired at onload. The cross reference is *kept* — the
        entry is read-only and possibly shared, so resume skips the
        encoder rerun; host occupancy accounting stays pages-only."""
        freed = super().offload(seq_id, n_host_pages, payload)
        if freed is None:
            return None
        slab = self._seq_slab.pop(seq_id, None)
        if slab is not None:
            self._slab_free.append(slab)
            self.stats.slabs_in_use -= 1
        self._host_needs[seq_id] = slab is not None
        return freed

    def onload(self, seq_id: int, n_tokens: int):
        """PagePool.onload, rerouted through the unified ``allocate`` so
        the sequence reacquires a slab when it held one at offload (the
        new slab index may differ — the engine scatters the snapshotted
        bytes wherever ``seq_slab`` now points)."""
        if seq_id not in self._host_seqs:
            raise KeyError(f"seq {seq_id}: not offloaded, cannot onload")
        n_host, payload = self._host_seqs[seq_id]
        pages = self.allocate(seq_id, n_tokens,
                              need_slab=self._host_needs.get(seq_id,
                                                             False))
        if pages is None:
            return None
        del self._host_seqs[seq_id]
        self._host_needs.pop(seq_id, None)
        self.stats.onload_calls += 1
        self.stats.host_pages_in_use -= n_host
        return pages, payload

    def drop_host(self, seq_id: int) -> int:
        """PagePool.drop_host plus the reference ``offload`` deliberately
        retained: a parked sequence keeps its cross entry alive so resume
        skips the encoder rerun, but a *cancelled* one never resumes, so
        the share is released here (the entry goes cached-free at zero
        refs, index kept — revivable by a later request with the same
        frames)."""
        n_host = super().drop_host(seq_id)
        self._host_needs.pop(seq_id, None)
        slot = self._seq_cross.pop(seq_id, None)
        if slot is not None:
            self._cross_ref[slot] -= 1
            if self._cross_ref[slot] == 0:
                self._cross_free.append(slot)   # cached-free: index kept
                self.stats.cross_in_use -= 1
        self._cross_fresh.discard(seq_id)       # never-encoded entry
        return n_host

    # -- consistency ---------------------------------------------------------

    def validate(self):
        super().validate()
        # slab region: conservation, exclusivity, stats agreement
        assert len(self._slab_free) == len(set(self._slab_free)), \
            "slab free-list dup"
        assert len(self._slab_free) + len(self._seq_slab) == self.n_slabs,\
            "slab conservation violated"
        owned = list(self._seq_slab.values())
        assert len(owned) == len(set(owned)), "slab owned twice"
        assert not (set(owned) & set(self._slab_free)), \
            "owned slab on the free list"
        assert self.stats.slabs_in_use == len(self._seq_slab)
        assert set(self._seq_slab) <= set(self._seq_pages), \
            "slab held by a non-live sequence"
        # cross region: refcount == owners (offloaded sequences keep
        # their reference), free list == ref-zero slots, index/inverse
        held: dict[int, int] = {}
        for slot in self._seq_cross.values():
            held[slot] = held.get(slot, 0) + 1
        for slot in range(self.n_cross):
            assert self._cross_ref[slot] == held.get(slot, 0), \
                f"cross {slot}: ref {self._cross_ref[slot]} != owners"
        assert len(self._cross_free) == len(set(self._cross_free)), \
            "cross free-list dup"
        assert all(self._cross_ref[s] == 0 for s in self._cross_free), \
            "live cross entry on the free list"
        assert len(self._cross_free) \
            + sum(r > 0 for r in self._cross_ref) == self.n_cross, \
            "cross conservation violated"
        assert self.stats.cross_in_use == \
            sum(r > 0 for r in self._cross_ref)
        for key, slot in self._cross_index.items():
            assert self._cross_key.get(slot) == key, \
                "cross index/inverse mismatch"
        for slot, key in self._cross_key.items():
            assert self._cross_index.get(key) == slot, \
                "cross inverse/index mismatch"
        assert set(self._cross_fresh) <= set(self._seq_cross), \
            "cross-fresh mark without an entry"
