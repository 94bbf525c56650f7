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

``plan_attention`` picks the flash kernel's tile: 64 packed rows and 32
keys unless ``REPRO_BLOCKS_ATTN`` pins another of the built tiles
(``FLASH_TILES``) whose shared memory fits a block.

The knobs, read from the environment at every call (not at import):

  REPRO_BLOCKS_MATMUL="bm,bn,bk"  pin ``spx_matmul``'s launch to the one
                                  whose block is (bm, bn, bk)
                                  (``spx_matmul_block``): a small-path tile
                                  and warps, or the decode or prefill
                                  kernel's K per cluster split
  REPRO_BLOCKS_ATTN="bq,bkv"      pin the flash kernel's tile
  REPRO_PAGE_SIZE=N               pin the KV page size
  REPRO_AUTOTUNE=1                measured autotuning: the ops time the
                                  analytical launch and its neighbours
                                  (``spx_launch_candidates``, the paged
                                  kernels' splits and clusters) on the card
                                  and keep the fastest per shape key
                                  (``measured_best``)

A pin that no launch at the shape has raises ``ValueError`` naming the
legal ones; there is no fallback to the plain version. ``clear_plan_cache``
drops the measured winners and every cached launch choice.

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
import sys
import time
import types
from typing import Callable, Optional

from repro_torch.core import spx
from repro_torch.core.pipeline import H100_SXM, HwSpec

__all__ = ["KVPagePlan", "plan_kv_pages", "plan_seq_pages",
           "plan_resume_pages", "StateReservation", "plan_seq_state",
           "ShardBudget", "kv_heads_split", "plan_shard_budget",
           "split_ranges", "HeadGroup", "shard_heads",
           "PAGE_PAIR_SMEM_BYTES", "SpxLaunchPlan", "plan_spx_launch",
           "spx_small_smem_bytes", "spx_small_max_warps",
           "spx_small_min_warps", "spx_path_smem_bytes", "spx_kps",
           "spx_matmul_block", "spx_launch_candidates", "spx_pin_table",
           "AttentionBlocks", "FLASH_TILES", "flash_tile_smem_bytes",
           "flash_legal_tiles", "plan_attention", "FusedDecodePlan",
           "plan_fused_decode", "fused_decode_key", "autotune_enabled",
           "measured_plan", "measured_best", "measured_report",
           "MeasuredKey", "clear_plan_cache", "SMEM_MAX"]

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


# -- the knobs ----------------------------------------------------------------

def _env_override(var: str, n_fields: int) -> Optional[tuple[int, ...]]:
    """``var``'s ``n_fields`` comma-separated ints, or None when it is unset
    or empty; read at every call. Another count of fields raises."""
    raw = os.environ.get(var)
    if not raw:
        return None
    parts = tuple(int(p) for p in raw.replace(" ", "").split(","))
    if len(parts) != n_fields:
        raise ValueError(f"{var}={raw!r}: expected {n_fields} ints")
    return parts


# -- spx_matmul launches ------------------------------------------------------

#: rows of x the decode kernel (``_skinny``) takes; above, the prefill one
SPX_SKINNY_MAX_M = 8
#: the small-layer kernel's layers: at most this many output columns (two
#: of its widest tiles) and K rows (the staged tiles fit a block)
SPX_SMALL_MAX_N = 128
SPX_SMALL_MAX_K = 1024
#: its tiles: 8 I rows x 16 J columns, I and J in 1, 2, 4
_SMALL_TILES = (1, 2, 4)
#: the decode and prefill kernels: output columns a block, K rows a step
#: (a block's share of K is a whole number of them) and the largest
#: cluster of K splits
SPX_BLOCK_N = 256
SPX_K_STEP = 64
SPX_MAX_SPLITS = 16
#: the most launches the tuner times at one shape
SPX_MAX_CANDIDATES = 12


def spx_small_max_warps(tile_m: int, tile_n: int) -> int:
    """Warps a small-path block may have: 16 on tiles of at most two
    8 x 16 fragments (their registers allow 512 threads), else 8."""
    return 16 if tile_m * tile_n <= 2 * 8 * 16 else 8


def spx_small_min_warps(packed: bool) -> int:
    """Warps a small-path block needs: for 8-bit codes each of 8 warps
    loads a 32-entry round of the 256-entry table; 4-bit codes, one."""
    return 1 if packed else _LUT_MAX // 32


#: shared memory a block can have on the H100 (opt-in)
SMEM_MAX = 232448
_LUT_MAX, _TAB_COPIES, _SCALE_BYTES = 256, 32, 64 * 4


@dataclasses.dataclass(frozen=True)
class SpxLaunchPlan:
    """The kernel of one ``spx_matmul`` launch.

    path    ``"skinny"`` (decode, M <= 8), ``"mma"`` (prefill, tensor
            cores) or ``"small"`` (layers whose tiles cannot fill the
            card); the first two split K over a cluster
    tile_m  small: rows of x per block (8, 16 or 32)
    tile_n  small: output columns per block (16, 32 or 64)
    warps   small: warps per block, splitting K in 16-row steps
    splits  skinny and mma: blocks per cluster along K; 0 is the library's
            choice (``spx_matmul_splits``)
    """
    path: str
    tile_m: int = 0
    tile_n: int = 0
    warps: int = 0
    splits: int = 0


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


def spx_path_smem_bytes(plan: SpxLaunchPlan, m: int, k: int,
                        packed: bool) -> int:
    """Shared memory of a block of ``plan`` on x of ``m`` rows and K =
    ``k``: the small path's layout, the decode kernel's ring of 4 stages
    (16 KB of codes and the x slice of its 1, 2, 4 or 8 rows), or the
    prefill kernel's (``Pre`` in the CUDA source: two bf16 planes of W
    and 3 stages of x and codes, 64 rows of x a warpgroup)."""
    if plan.path == "small":
        return spx_small_smem_bytes(plan.tile_m, plan.tile_n, k, packed,
                                    plan.warps)
    row_bytes = SPX_BLOCK_N // 2 if packed else SPX_BLOCK_N
    if plan.path == "skinny":
        mt = 1 << (max(m, 1) - 1).bit_length()
        return 4 * (16384 + mt * (16384 // row_bytes) * 4)
    bm = 64 if m <= 64 else 128
    return (1024 + 2 * SPX_BLOCK_N * SPX_K_STEP * 2
            + 3 * (2 * bm * 128 + SPX_K_STEP * row_bytes))


def spx_kps(k: int, splits: int) -> int:
    """K rows a block of the decode or prefill kernel takes when K is split
    ``splits`` ways: an even share in whole K steps."""
    share = -(-k // splits)
    return -(-share // SPX_K_STEP) * SPX_K_STEP


def _even_splits(k: int, splits: int) -> int:
    """The splits that give ``spx_kps(k, splits)`` rows each and leave no
    block empty."""
    return -(-k // spx_kps(k, splits))


def spx_matmul_block(plan: SpxLaunchPlan, m: int, k: int) -> tuple:
    """(bm, bn, bk) of a launch, as ``REPRO_BLOCKS_MATMUL`` names it: rows
    of x a block, output columns a block, K rows a block (small: 16 a
    warp; skinny and mma: its K split). ``plan.splits`` must be explicit
    on the old kernels."""
    if plan.path == "small":
        return plan.tile_m, plan.tile_n, 16 * plan.warps
    bm = m if plan.path == "skinny" else (64 if m <= 64 else 128)
    return bm, SPX_BLOCK_N, spx_kps(k, plan.splits)


def _small_range(m: int, k: int, n: int) -> bool:
    return m >= 1 and n <= SPX_SMALL_MAX_N and k <= SPX_SMALL_MAX_K


def _small_tiles(m: int, n: int) -> list:
    """(I, J) of the small tiles no more than half empty at (m, n)."""
    return [(i, j) for i in _SMALL_TILES for j in _SMALL_TILES
            if (i == 1 or 4 * i < m) and (j == 1 or 8 * j < n)]


def _small_warps(i: int, j: int, k: int, packed: bool) -> int:
    """The analytical warps of tile (I, J): a warp a K step, up to the
    tile's most; for 8-bit codes at least 8, which share the table's
    build."""
    steps = -(-k // 16)
    busy = max(1, steps) if packed else max(steps, _LUT_MAX // 32)
    return min(spx_small_max_warps(8 * i, 16 * j), busy)


def _check_lut(lut_size: int) -> None:
    if not 1 <= lut_size <= _LUT_MAX:
        raise ValueError(f"spx_matmul: a LUT of {lut_size} entries (1 to "
                         f"{_LUT_MAX})")


def spx_analytical_launch(m: int, k: int, n: int, packed: bool,
                          lut_size: int, sms: int) -> SpxLaunchPlan:
    """The analytical kernel, tile and warps of ``spx_matmul`` on x (m, k)
    and a (k, n) weight of ``lut_size`` levels (4-bit codes packed two to
    a byte when ``packed``), on a card of ``sms`` SMs; no knob is read.

    Layers of at most SPX_SMALL_MAX_N columns and SPX_SMALL_MAX_K rows go
    to the small-layer kernel: its warps split K in 16-row steps (a warp a
    step, up to ``spx_small_max_warps``; for 8-bit codes at least 8, which
    share the table's build), and its tile is the largest that still
    gives the card half a block per SM (or as many blocks as the smallest
    tile gives, where even that cannot), taller before wider, and none
    more than half empty: each block decodes its columns' codes once, and
    reads its rows of x once. Every other layer keeps the decode kernel at
    M <= 8 and the prefill kernel above, with the library's splits."""
    _check_lut(lut_size)
    if not _small_range(m, k, n):
        return SpxLaunchPlan("skinny" if m <= SPX_SKINNY_MAX_M else "mma")

    def blocks(i, j):
        return -(-m // (8 * i)) * -(-n // (16 * j))

    target = min(max(1, sms // 2), blocks(1, 1))
    fits = [(i, j) for i, j in _small_tiles(m, n)
            if spx_small_smem_bytes(8 * i, 16 * j, k, packed,
                                    _small_warps(i, j, k, packed))
            <= SMEM_MAX and blocks(i, j) >= target]
    i, j = max(fits, key=lambda ij: (ij[0] * ij[1], ij[0]))
    return SpxLaunchPlan("small", 8 * i, 16 * j, _small_warps(i, j, k, packed))


@functools.lru_cache(maxsize=256)
def spx_pin_table(m: int, k: int, n: int,
                  packed: bool) -> types.MappingProxyType:
    """{(bm, bn, bk): plan} of every launch ``REPRO_BLOCKS_MATMUL`` may pin
    at this shape: on the small kernel's layers each tile no more than
    half empty, at every warp count it runs whose block fits; and the
    decode kernel (M <= 8) or the prefill kernel at every K split of 1 to
    16 (bk a multiple of 64, no block empty). Cached per shape."""
    table = {}
    if _small_range(m, k, n):
        for i, j in _small_tiles(m, n):
            for w in range(spx_small_min_warps(packed),
                           spx_small_max_warps(8 * i, 16 * j) + 1):
                if spx_small_smem_bytes(8 * i, 16 * j, k, packed, w) \
                        <= SMEM_MAX:
                    table[(8 * i, 16 * j, 16 * w)] = SpxLaunchPlan(
                        "small", 8 * i, 16 * j, w)
    path = "skinny" if m <= SPX_SKINNY_MAX_M else "mma"
    for s in range(1, SPX_MAX_SPLITS + 1):
        plan = SpxLaunchPlan(path, splits=_even_splits(k, s))
        table[spx_matmul_block(plan, m, k)] = plan
    return types.MappingProxyType(table)


def pinned_spx_launch(m: int, k: int, n: int, packed: bool,
                      lut_size: int) -> Optional[SpxLaunchPlan]:
    """The launch ``REPRO_BLOCKS_MATMUL="bm,bn,bk"`` pins at this shape
    (its splits explicit), or None when the variable is unset. Read at
    every call, never cached. A block no launch at the shape has raises
    ``ValueError`` naming the legal ones (the reference runs its oracle
    there instead; the port has no fallback)."""
    pinned = _env_override("REPRO_BLOCKS_MATMUL", 3)
    if pinned is None:
        return None
    _check_lut(lut_size)
    table = spx_pin_table(m, k, n, packed)
    plan = table.get(pinned)
    if plan is None:
        raise ValueError(
            f"REPRO_BLOCKS_MATMUL={','.join(map(str, pinned))}: no "
            f"spx_matmul launch at M={m}, K={k}, N={n} "
            f"({'4-bit packed' if packed else '8-bit'} codes) has that "
            f"block; the legal (bm, bn, bk) there: {sorted(table)}")
    return plan


def plan_spx_launch(m: int, k: int, n: int, packed: bool, lut_size: int,
                    sms: int) -> SpxLaunchPlan:
    """The launch of ``spx_matmul`` at this shape: the one
    ``REPRO_BLOCKS_MATMUL`` pins (``pinned_spx_launch``), else the
    analytical one (``spx_analytical_launch``; splits 0, the library's)."""
    pinned = pinned_spx_launch(m, k, n, packed, lut_size)
    if pinned is not None:
        return pinned
    return spx_analytical_launch(m, k, n, packed, lut_size, sms)


def spx_launch_candidates(m: int, k: int, n: int, packed: bool,
                          lut_size: int, sms: int, splits: int) -> tuple:
    """The launches the tuner times at this shape, the analytical one first
    (its splits the library's ``splits``), at most SPX_MAX_CANDIDATES, each
    with its splits explicit. On the small kernel's layers: the other
    kernel of the layer's M (decode at M <= 8, else prefill) at the
    library's splits, then each tile no more than half empty, nearest the
    analytical first, at its analytical warps and half of them, where the
    block fits and the codes allow; elsewhere the library's splits halved
    and doubled, within 1 to 16, no block empty."""
    seed = spx_analytical_launch(m, k, n, packed, lut_size, sms)
    if seed.path != "small":
        seed = dataclasses.replace(seed, splits=splits)
    out = [seed]

    def add(plan):
        if plan not in out and len(out) < SPX_MAX_CANDIDATES and \
                spx_path_smem_bytes(plan, m, k, packed) <= SMEM_MAX:
            out.append(plan)
    if seed.path == "small":
        add(SpxLaunchPlan("skinny" if m <= SPX_SKINNY_MAX_M else "mma",
                          splits=splits))
        i0, j0 = seed.tile_m // 8, seed.tile_n // 16

        def distance(ij):       # I and J are powers of two
            return (abs(ij[0].bit_length() - i0.bit_length())
                    + abs(ij[1].bit_length() - j0.bit_length()),
                    -ij[0] * ij[1], -ij[0])
        for i, j in sorted(_small_tiles(m, n), key=distance):
            w = _small_warps(i, j, k, packed)
            for warps in (w, w // 2):
                if warps >= spx_small_min_warps(packed):
                    add(SpxLaunchPlan("small", 8 * i, 16 * j, warps))
    else:
        for s in (splits // 2, 2 * splits):
            if 1 <= s <= SPX_MAX_SPLITS:
                add(SpxLaunchPlan(seed.path, splits=_even_splits(k, s)))
    return tuple(out)


# -- flash attention's tile ---------------------------------------------------

#: the flash kernel's built tiles: (packed query rows a block, 16 a warp;
#: keys a KV tile)
FLASH_TILES = ((32, 32), (32, 64), (64, 32), (64, 64), (128, 32), (128, 64))
#: the tile with no pin
FLASH_DEFAULT_TILE = (64, 32)


@dataclasses.dataclass(frozen=True)
class AttentionBlocks:
    """The flash kernel's tile: ``bq`` packed query rows a block, ``bkv``
    keys a KV tile, and the block's shared memory."""
    bq: int
    bkv: int
    smem_bytes: int


def flash_tile_smem_bytes(dh: int, bq: int, bkv: int) -> int:
    """Shared memory of a flash block (``Tile`` in the CUDA source): Q's
    bf16 hi and lo planes (rows of 2 dh + 16 bytes), K's and V's planes
    (where the f32 Q tile lands first, so at least its bytes), and the
    f32 stage of one K and V tile."""
    row = 2 * dh + 16
    return 2 * bq * row + max(4 * bkv * row, 4 * bq * dh) + 8 * bkv * dh


def flash_legal_tiles(dh: int) -> tuple:
    """The built tiles whose block fits the card's shared memory at head
    dim ``dh``: at 256 only (32, 32) and (64, 32)."""
    return tuple(t for t in FLASH_TILES
                 if flash_tile_smem_bytes(dh, *t) <= SMEM_MAX)


def plan_attention(sq: int, skv: int, dh: int) -> AttentionBlocks:
    """The flash kernel's tile over (Sq, Skv, dh): FLASH_DEFAULT_TILE, or
    the one ``REPRO_BLOCKS_ATTN="bq,bkv"`` pins (read at every call). A
    pin must be a built tile that fits at ``dh``, else ``ValueError``
    names the legal ones. ``sq`` and ``skv`` need not divide: the kernel
    masks the tail tiles (the reference's divisibility rule does not
    apply)."""
    del sq, skv
    pinned = _env_override("REPRO_BLOCKS_ATTN", 2)
    if pinned is None:
        bq, bkv = FLASH_DEFAULT_TILE
    else:
        legal = flash_legal_tiles(dh)
        if pinned not in legal:
            raise ValueError(
                f"REPRO_BLOCKS_ATTN={','.join(map(str, pinned))}: not a flash "
                f"tile at head dim {dh}; the legal (bq, bkv) there: "
                f"{list(legal)}")
        bq, bkv = pinned
    return AttentionBlocks(bq, bkv, flash_tile_smem_bytes(dh, bq, bkv))


# -- the ragged decode kernel's account ---------------------------------------

@dataclasses.dataclass(frozen=True)
class FusedDecodePlan:
    """The reference's §3.1 account of one step of the ragged decode
    kernel, on an H100: ``rows`` (rep * w) query rows against one K+V page
    pair, the codebook's ``lut_bytes`` (0 for an unquantized pool),
    whether loading the page pair takes no longer than its products
    (``pipelined``), their ratio (``margin``), and the working set in
    bytes (``smem_bytes``: K+V pages double-buffered, q, f32 accumulator
    and statistics, the codebook)."""
    rows: int
    lut_bytes: int
    pipelined: bool
    margin: float
    smem_bytes: int


def plan_fused_decode(dh: int, *, rep: int = 1, w: int = 1,
                      page_size: int = 16, act_bytes: int = 4,
                      kv_scheme: str | None = None,
                      hw: HwSpec = H100_SXM) -> FusedDecodePlan:
    """The account for a window of ``w`` positions (spec K+1, or 1) of
    ``rep`` query heads over pages of ``page_size`` tokens of ``dh``
    elements of ``act_bytes`` (or, with ``kv_scheme``, one-byte codes and
    an f32 scale per token and the scheme's codebook). The window's rows
    add products per page, never loads."""
    if kv_scheme is not None:
        tok_bytes = spx.kv_token_side_bytes(dh)
        lut_bytes = 4 * (1 << spx.code_width(spx.scheme_levels(kv_scheme)))
    else:
        tok_bytes, lut_bytes = dh * act_bytes, 0
    rows = rep * w
    t_load = 2 * page_size * tok_bytes / hw.hbm_bw
    t_compute = 4.0 * rows * page_size * dh / hw.peak_bf16_flops
    smem = (2 * 2 * page_size * tok_bytes + rows * dh * act_bytes
            + rows * dh * 4 + 2 * rows * 4 + lut_bytes)
    return FusedDecodePlan(rows, lut_bytes, t_load <= t_compute,
                           t_compute / max(t_load, 1e-30), int(smem))


def fused_decode_key(b: int, hkv: int, rep: int, w: int, dh: int,
                     page_size: int, max_pages: int, kv_scheme: str | None,
                     pool_dtype: str = "float32") -> tuple:
    """The tuner's key of one ragged decode workload: the reference's
    fields (the scheme and the window ``w`` among them: a coded pool and a
    verify window cost otherwise than a plain decode of the same shapes)
    and the pool's dtype (a bf16 winner, a cluster size, must not serve an
    f32 pool, whose choice is a split count). The single-token mode takes
    ``w = 1``."""
    return ("paged_decode_ragged", b, hkv, rep, w, dh, page_size, max_pages,
            kv_scheme, str(pool_dtype).removeprefix("torch."))


# -- measured autotuning (REPRO_AUTOTUNE) -------------------------------------

@dataclasses.dataclass(frozen=True)
class MeasuredKey:
    """One key's tuning: the analytical plan (the first candidate) and its
    seconds, the winner and its (None where nothing could be measured),
    every candidate with its seconds (None where it raised), and the
    seconds the tuning took."""
    seed: object
    seed_s: Optional[float]
    best: object
    best_s: Optional[float]
    tried: tuple
    seconds: float


_MEASURED: dict = {}
_REPORT: dict = {}


def autotune_enabled() -> bool:
    """True when ``REPRO_AUTOTUNE`` is 1, true or measured; read at every
    call."""
    return os.environ.get("REPRO_AUTOTUNE", "").lower() in ("1", "true",
                                                            "measured")


def measured_plan(key):
    """The winner measured for ``key``, or None."""
    return _MEASURED.get(key)


def measured_best(key, plans, runner: Callable[[object], float]):
    """Time each of ``plans`` with ``runner`` (seconds a call of the kernel
    on the real inputs) and keep the winner for ``key``. The analytical
    plan comes first, so the tuner only ever replaces it with a strictly
    faster one. A candidate that raises is reported and skipped; where
    none could be measured the first plan is returned and nothing is kept,
    so a passing failure pins nothing. A kept key is not measured again."""
    if key in _MEASURED:
        return _MEASURED[key]
    t0 = time.perf_counter()
    best, best_t, tried = None, float("inf"), []
    for plan in plans:
        try:
            t = runner(plan)
        except Exception as e:
            print(f"[planner] autotune candidate {plan} failed: {e!r}",
                  file=sys.stderr)
            tried.append((plan, None))
            continue
        tried.append((plan, t))
        if t < best_t:
            best, best_t = plan, t
    _REPORT[key] = MeasuredKey(plans[0], tried[0][1] if tried else None,
                               best, None if best is None else best_t,
                               tuple(tried), time.perf_counter() - t0)
    if best is None:
        return plans[0]
    _MEASURED[key] = best
    return best


def measured_report() -> dict:
    """{key: MeasuredKey} of every key tuned since the last
    ``clear_plan_cache()``, those where nothing could be measured too."""
    return dict(_REPORT)


def clear_plan_cache() -> None:
    """Drop the measured winners and every cached launch choice:
    ``spx_matmul``'s plans, pin tables and library splits, the paged
    kernels' splits and clusters, and the shard budgets. Needed after a planner variable
    changes mid-process."""
    from repro_torch.kernels import paged_attention, spx_matmul
    _MEASURED.clear()
    _REPORT.clear()
    _plan_shard_budget_cached.cache_clear()
    spx_pin_table.cache_clear()
    for cached in (spx_matmul._plan, spx_matmul.library_splits,
                   paged_attention.decode_splits,
                   paged_attention.decode_cluster,
                   paged_attention.cluster_used):
        cached.cache_clear()
