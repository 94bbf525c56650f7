"""What the serving engine plans: the KV page size and the per-sequence
page reservations.

The page size follows a Hopper rule in place of the TPU's sublane and VMEM
model: the largest power-of-two page, from 8 to 256 tokens, whose K+V pair
for one (slot, KV head) fits ``PAGE_PAIR_SMEM_BYTES`` (32 KiB). The
paged-decode kernel (``kernels/csrc/paged_decode.cu``) loads page rows
straight into registers and splits a sequence over blocks in whole pages,
so the page size is the allocator's granularity and the unit of the
kernel's split; the waste is at most one partly filled page per sequence.
For gemma-2b (head_dim 256, f32 pages) the rule gives 16 tokens per page;
for head_dim 128, 32. Quantized pools (``kv_scheme``) hold a page as codes,
1 byte per element, plus one f32 scale per token, so the same budget holds
larger pages: 32 tokens at head_dim 256, 64 at 128.

``plan_spx_launch`` picks the kernel of an ``spx_matmul`` launch
(``kernels/csrc/spx_matmul.cu``): the small-layer kernel, with its tile
and warps, where the layer's output tiles cannot fill the card (N <= 128,
K <= 1024: the paper's MLP and Q-network), else the decode kernel (M <= 8)
or the tensor-core prefill kernel, whose cluster splits the library
chooses.

``plan_seq_pages``, ``plan_resume_pages`` and ``plan_seq_state`` are the
reference's integer page math, verbatim. ``plan_shard_budget`` is the
reference's per-shard byte model of a tensor-parallel paged engine; its
kernel working set is this planner's page pair (``smem_bytes``) where the
reference's is the TPU kernel's VMEM. ``split_ranges`` and ``shard_heads``
are the uneven tensor-parallel cuts, where a count does not divide the
shards.
"""
from __future__ import annotations

import dataclasses
import functools
import os

from repro_torch.core import spx

__all__ = ["KVPagePlan", "plan_kv_pages", "plan_seq_pages",
           "plan_resume_pages", "StateReservation", "plan_seq_state",
           "ShardBudget", "kv_heads_split", "plan_shard_budget",
           "split_ranges", "HeadGroup", "shard_heads",
           "PAGE_PAIR_SMEM_BYTES", "SpxLaunchPlan", "plan_spx_launch",
           "spx_small_smem_bytes", "spx_small_max_warps"]

#: shared-memory budget of one K page + one V page of one (slot, KV head)
PAGE_PAIR_SMEM_BYTES = 32 * 1024

#: tokens-per-page candidates, ascending
_PAGE_CANDIDATES = (8, 16, 32, 64, 128, 256)


@dataclasses.dataclass(frozen=True)
class KVPagePlan:
    """page_size   tokens per page: the allocator's granularity AND the
                   unit the paged-decode kernel splits a sequence in
    smem_bytes  bytes of one K+V page pair of one (slot, KV head)"""
    page_size: int
    smem_bytes: int


def plan_kv_pages(dh: int, *, act_bytes: int = 4,
                  kv_scheme: str | None = None) -> KVPagePlan:
    """Tokens per page for a KV head of ``dh`` elements of ``act_bytes``
    each, or of ``dh`` one-byte codes and one f32 scale when ``kv_scheme``
    names a quantized cache. ``REPRO_PAGE_SIZE=N`` pins the page size."""
    token_bytes = (spx.kv_token_side_bytes(dh) if kv_scheme is not None
                   else dh * act_bytes)
    pinned = os.environ.get("REPRO_PAGE_SIZE")
    if pinned:
        ps = int(pinned)
        return KVPagePlan(ps, 2 * ps * token_bytes)
    fits = [ps for ps in _PAGE_CANDIDATES
            if 2 * ps * token_bytes <= PAGE_PAIR_SMEM_BYTES]
    ps = fits[-1] if fits else _PAGE_CANDIDATES[0]
    return KVPagePlan(ps, 2 * ps * token_bytes)


def plan_seq_pages(n_tokens: int, page_size: int, *,
                   shared_tokens: int = 0) -> int:
    """Fresh pages a sequence must reserve at admission:
    ``ceil(n_tokens / page_size)`` less the ``shared_tokens // page_size``
    pages a matched shared prefix maps in (a partly reused last page is
    billed as fresh: it is the copy-on-write destination)."""
    if page_size < 1 or n_tokens < 0 or not 0 <= shared_tokens <= n_tokens:
        raise ValueError((n_tokens, page_size, shared_tokens))
    return -(-n_tokens // page_size) - shared_tokens // page_size


def plan_resume_pages(n_written: int, n_total: int,
                      page_size: int) -> tuple[int, int]:
    """Page plan for resuming a preempted sequence:
    ``(pages_total, pages_restored)`` — the full worst-case reservation,
    and its leading slice that covers the ``n_written`` tokens in the
    cache at preemption (the rest restores as blank pages)."""
    if not 0 <= n_written <= n_total:
        raise ValueError((n_written, n_total, page_size))
    return (plan_seq_pages(n_total, page_size),
            plan_seq_pages(n_written, page_size))


@dataclasses.dataclass(frozen=True)
class StateReservation:
    """Per-sequence admission footprint across the StateCache regions:
    ``pages`` of token-paged KV, ``slabs`` of recurrent state (0 or 1),
    ``cross`` read-only encoder-output entries (0 or 1)."""
    pages: int
    slabs: int
    cross: int


def plan_seq_state(n_tokens: int, page_size: int, *,
                   shared_tokens: int = 0, needs_pages: bool = True,
                   needs_slab: bool = False,
                   needs_cross: bool = False) -> StateReservation:
    """Admission reservation for one sequence under the unified state
    cache (pages, plus one slab and one cross entry where needed)."""
    pages = plan_seq_pages(n_tokens, page_size,
                           shared_tokens=shared_tokens) if needs_pages \
        else 0
    return StateReservation(pages=pages, slabs=int(bool(needs_slab)),
                            cross=int(bool(needs_cross)))


# -- per-shard budgets (tensor-parallel serving) -------------------------------

@dataclasses.dataclass(frozen=True)
class ShardBudget:
    """Where one model shard's serving memory goes when the paged pools
    are head-sharded over a ``model`` axis of ``shards`` devices.

    kv_sharded          the pool's KV-head axis divides evenly, so each
                        shard holds ``kv_heads_per_shard`` of it; when
                        False the pool replicates and the per-shard
                        numbers equal the global ones
    kv_heads_per_shard  KV heads resident per shard
    page_bytes          one page's bytes on one shard (all layers)
    pool_bytes          the whole page pool's bytes on one shard
    slab_bytes          recurrent-slab bytes on one shard (slabs
                        replicate: sequence-private state, no head axis)
    smem_bytes          the paged-decode kernel's K+V page pair of one
                        (slot, KV head): the same on every shard, since
                        the kernel's grid covers a shard's heads
    """
    shards: int
    kv_sharded: bool
    kv_heads_per_shard: int
    page_bytes: int
    pool_bytes: int
    slab_bytes: int
    smem_bytes: int


def kv_heads_split(n_kv_heads: int, shards: int) -> bool:
    """Whether a tensor-parallel engine's KV heads, and so its paged
    pools, split over ``shards``: they divide evenly (else every shard
    holds them whole and the pools replicate). The one rule that the
    sharding policy, the engine and this budget read."""
    return shards > 1 and n_kv_heads % shards == 0


def split_ranges(n: int, parts: int, granule: int = 1) -> tuple:
    """(start, size) of ``parts`` contiguous pieces of ``n`` items, cut on
    multiples of ``granule`` (which must divide ``n``): equal where they
    divide, else the first pieces one granule larger. The one rule for
    every uneven tensor-parallel cut (heads, experts, FFN columns, a
    vocabulary that splits on neither axis)."""
    if n % granule:
        raise ValueError(f"{n} items do not cut on multiples of {granule}")
    units, extra = divmod(n // granule, parts)
    out, start = [], 0
    for s in range(parts):
        size = (units + (s < extra)) * granule
        out.append((start, size))
        start += size
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class HeadGroup:
    """One shard's heads: query heads ``[q0, q0 + nq)`` (``split_ranges``
    over the shards) and the KV heads ``[kv0, kv0 + nkv)`` they read.
    Where the shards outnumber the query heads a head is shared by
    ``parts`` shards: each computes it whole and this one, ``part``,
    takes its slice of the head's output (``out_rows``)."""
    q0: int
    nq: int
    kv0: int
    nkv: int
    part: int = 0
    parts: int = 1

    def out_rows(self, dh: int) -> tuple:
        """(start, size) of the attention output's columns, and of the
        ``wo`` rows, this shard takes: its heads', or its slice
        (``split_ranges`` of ``dh``) of its shared head's."""
        if self.parts == 1:
            return self.q0 * dh, self.nq * dh
        lo, size = split_ranges(dh, self.parts)[self.part]
        return self.q0 * dh + lo, size


@functools.lru_cache(maxsize=256)
def shard_heads(n_heads: int, n_kv_heads: int, shards: int) -> tuple:
    """The ``HeadGroup`` of every shard: ``n_heads`` query heads split as
    evenly as they go (12 over 8: 2, 2, 2, 2, 1, 1, 1, 1), each shard
    reading the KV heads of its queries (query head ``h`` reads KV head
    ``h // (n_heads // n_kv_heads)``). Where the shards outnumber the
    heads, the shards split over the heads instead (16 over 12: 2, 2, 2,
    2, 1, ..., 1 shards to a head), each shard of a head one ``part``."""
    rep = n_heads // n_kv_heads
    out = []
    if n_heads < shards:
        for h, (_, ns) in enumerate(split_ranges(shards, n_heads)):
            out.extend(HeadGroup(h, 1, h // rep, 1, part, ns)
                       for part in range(ns))
        return tuple(out)
    for q0, nq in split_ranges(n_heads, shards):
        kv0 = q0 // rep
        out.append(HeadGroup(q0, nq, kv0, (q0 + nq - 1) // rep + 1 - kv0))
    return tuple(out)


@functools.lru_cache(maxsize=256)
def _plan_shard_budget_cached(n_kv_heads: int, shards: int, page_size: int,
                              n_pages: int, n_layers: int, slab_bytes: int,
                              tok_side_bytes: int,
                              smem_bytes: int) -> ShardBudget:
    kv_sharded = kv_heads_split(n_kv_heads, shards)
    heads = n_kv_heads // shards if kv_sharded else n_kv_heads
    # K and V sides, every paged layer, the shard's resident heads
    page_bytes = 2 * page_size * tok_side_bytes * heads * n_layers
    return ShardBudget(shards=shards, kv_sharded=kv_sharded,
                       kv_heads_per_shard=heads, page_bytes=page_bytes,
                       pool_bytes=page_bytes * n_pages,
                       slab_bytes=slab_bytes, smem_bytes=smem_bytes)


def plan_shard_budget(n_kv_heads: int, dh: int, *, shards: int = 1,
                      page_size: int, n_pages: int, n_layers: int = 1,
                      slab_bytes: int = 0, act_bytes: int = 2,
                      kv_scheme: str | None = None) -> ShardBudget:
    """Per-shard page and slab budget of a tensor-parallel paged engine.

    The page pool is ``(layers, n_pages, Hkv, page_size, dh)`` per K/V
    side; sharding splits its ``Hkv`` axis over ``shards`` devices when
    it divides, else the pool replicates (``kv_heads_split``).
    ``slab_bytes`` never shards. ``kv_scheme`` switches the per-token
    bytes to the codes + scale layout, as ``plan_kv_pages`` does."""
    if shards < 1:
        raise ValueError(f"shards must be >= 1, got {shards}")
    tok_side = (spx.kv_token_side_bytes(dh) if kv_scheme is not None
                else dh * act_bytes)
    plan = plan_kv_pages(dh, act_bytes=act_bytes, kv_scheme=kv_scheme)
    return _plan_shard_budget_cached(n_kv_heads, shards, page_size, n_pages,
                                     n_layers, slab_bytes, tok_side,
                                     plan.smem_bytes)


# -- spx_matmul launches ------------------------------------------------------

#: rows of x the decode kernel (``_skinny``) takes; above, the prefill one
SPX_SKINNY_MAX_M = 8
#: the small-layer kernel's layers: at most this many output columns (two
#: of its widest tiles) and K rows (the staged tiles fit a block)
SPX_SMALL_MAX_N = 128
SPX_SMALL_MAX_K = 1024
#: its tiles: 8 I rows x 16 J columns, I and J in 1, 2, 4
_SMALL_TILES = (1, 2, 4)


def spx_small_max_warps(tile_m: int, tile_n: int) -> int:
    """Warps a small-path block may have: 16 on tiles of at most two
    8 x 16 fragments (their registers allow 512 threads), else 8."""
    return 16 if tile_m * tile_n <= 2 * 8 * 16 else 8

#: shared memory a block can have on the H100 (opt-in)
_SMEM_MAX = 232448
_LUT_MAX, _TAB_COPIES, _SCALE_BYTES = 256, 32, 64 * 4


@dataclasses.dataclass(frozen=True)
class SpxLaunchPlan:
    """The kernel of one ``spx_matmul`` launch.

    path    ``"skinny"`` (decode, M <= 8), ``"mma"`` (prefill, tensor
            cores) or ``"small"`` (layers whose tiles cannot fill the
            card); the first two split K over a cluster as the library
            chooses
    tile_m  small: rows of x per block (8, 16 or 32)
    tile_n  small: output columns per block (16, 32 or 64)
    warps   small: warps per block, splitting K in 16-row steps
    """
    path: str
    tile_m: int = 0
    tile_n: int = 0
    warps: int = 0


def spx_small_smem_bytes(tile_m: int, tile_n: int, k: int, packed: bool,
                         warps: int) -> int:
    """Shared memory of a small-path block (``small_layout`` in the CUDA
    source): the 8-bit codes' table and the tile's scales, then the larger
    of the staged codes and x (rows padded to 64 mod 128 bytes) and the
    warps' sums with the summed tile."""
    steps = -(-k // 16)
    xs = steps * 16 + (0 if steps % 2 else 16)
    row_bytes = tile_n // 2 if packed else tile_n
    stage = steps * 16 * row_bytes + tile_m * xs * 4
    red = (warps * tile_n + tile_n + 4) * tile_m * 4
    tab = (0 if packed else _LUT_MAX * _TAB_COPIES * 4) + _SCALE_BYTES
    return tab + max(stage, red)


def plan_spx_launch(m: int, k: int, n: int, packed: bool, lut_size: int,
                    sms: int) -> SpxLaunchPlan:
    """The kernel, tile and warps of ``spx_matmul`` on x (m, k) and a
    (k, n) weight of ``lut_size`` levels (4-bit codes packed two to a byte
    when ``packed``), on a card of ``sms`` SMs.

    Layers of at most SPX_SMALL_MAX_N columns and SPX_SMALL_MAX_K rows go
    to the small-layer kernel: its warps split K in 16-row steps (a warp a
    step, up to ``spx_small_max_warps``; for 8-bit codes at least 8, which
    share the table's build), and its tile is the largest that still
    gives the card half a block per SM (or as many blocks as the smallest
    tile gives, where even that cannot), taller before wider, and none
    more than half empty: each block decodes its columns' codes once, and
    reads its rows of x once. Every
    other layer keeps the decode kernel at M <= 8 and the prefill kernel
    above."""
    if not 1 <= lut_size <= _LUT_MAX:
        raise ValueError(f"spx_matmul: a LUT of {lut_size} entries (1 to "
                         f"{_LUT_MAX})")
    if m < 1 or n > SPX_SMALL_MAX_N or k > SPX_SMALL_MAX_K:
        return SpxLaunchPlan("skinny" if m <= SPX_SKINNY_MAX_M else "mma")
    steps = -(-k // 16)

    def blocks(i, j):
        return -(-m // (8 * i)) * -(-n // (16 * j))

    # a warp a step; 8-bit codes at least a warp a 32-entry round of the
    # shared table each block builds
    busy = max(1, steps) if packed else max(steps, _LUT_MAX // 32)

    def warps(i, j):
        return min(spx_small_max_warps(8 * i, 16 * j), busy)

    target = min(max(1, sms // 2), blocks(1, 1))
    fits = [(i, j) for i in _SMALL_TILES for j in _SMALL_TILES
            if (i == 1 or 4 * i < m) and (j == 1 or 8 * j < n)
            and spx_small_smem_bytes(8 * i, 16 * j, k, packed, warps(i, j))
            <= _SMEM_MAX and blocks(i, j) >= target]
    i, j = max(fits, key=lambda ij: (ij[0] * ij[1], ij[0]))
    return SpxLaunchPlan("small", 8 * i, 16 * j, warps(i, j))
