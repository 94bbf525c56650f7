"""Wrappers of the hand-written paged-decode kernels
(``csrc/paged_decode.cu``), the Hopper counterpart of
``repro/kernels/paged_attention.py``, over f32 pools, bf16 pools, f16
pools and SPx-quantized (uint8 codes + f32 per-token scale) pools. q and
the output are f32 whatever the pool holds; over bf16 (f16) pools the
kernel rounds each probability to bf16 (f16) before P @ V, as the TPU
kernel does.

``paged_decode_ragged_cuda`` and ``paged_decode_ragged_quant_cuda`` launch
the ragged decode-window kernel. ``paged_attention_cuda`` and
``paged_attention_quant_cuda`` (single-token decode over ``ctx_len``
positions) launch the same kernel in its single-token mode, where it takes
``w = 1``, ``ctx = max(ctx_len - 1, 0)`` and ``q_len = (ctx_len > 0)``
itself: row 0 then attends positions ``< ctx_len`` and a row with
``ctx_len == 0`` comes back zero, which is the single-token semantics
exactly, and no PyTorch op runs before the launch.

Over f32 and code pools the sequence is split across blocks
(flash-decoding, ``paged_decode_kernel``): ``decode_splits`` picks the
split count from the block table's width and the SM count, and is cached
per shape; a split is a multiple of ``SPLIT_GRANULE`` tokens
(``split_tokens``). With several splits the wrapper allocates one scratch
buffer for the partials and a second kernel, the merge pass, combines
them in a fixed order. Over bf16 and f16 pools one launch of
``paged_decode_mma_kernel`` (tensor cores) does it all: a thread-block
cluster of ``decode_cluster`` blocks per (slot, KV head, group of 8
rows) deals the slot's live context out in ``CHUNK``-token chunks to the
warps of its ``active_ranks`` blocks and merges them in shared memory,
in a fixed order; no scratch. Each wrapper keeps its own launch count, and
counts a launch over bf16 (f16) pools under its own name with ``_bf16``
(``_f16``) added. None falls back to the plain version.

Each wrapper takes an explicit ``plan``, the tuner's: the split count over
f32 and code pools, the cluster size asked for over bf16 and f16 pools.
``launch_candidates`` lists what the tuner times: ``decode_splits``, half
and twice it; or each cluster size the card gives up to
``decode_cluster``. For a given choice the merge order is fixed.
"""
from __future__ import annotations

import functools

import torch

from . import cuda_lib

__all__ = ["paged_decode_ragged_cuda", "paged_attention_cuda",
           "paged_decode_ragged_quant_cuda", "paged_attention_quant_cuda",
           "decode_splits", "split_tokens", "decode_cluster", "cluster_used",
           "active_ranks", "split_candidates", "cluster_candidates",
           "launch_candidates", "HEAD_DIMS", "ROW_GROUP", "SPLIT_GRANULE",
           "MAX_SPLITS", "CHUNK", "MMA_WARPS", "MAX_CLUSTER",
           "CHUNKS_PER_WARP"]

#: head dims the kernel is instantiated for
HEAD_DIMS = (32, 64, 128, 256)
#: query rows one block holds (the kernel's kRows)
ROW_GROUP = 8
#: a split covers a multiple of this many tokens, and at least this many:
#: one 4-token group for each of the kernel's 4 warps (its kSplitGranule)
SPLIT_GRANULE = 16
#: blocks per SM the split count aims at
BLOCKS_PER_SM = 2
#: the most splits a launch takes (the merge pass's kMaxSplits)
MAX_SPLITS = 1024
#: the 16-bit kernel: tokens per chunk (one MMA tile), warps per block, the
#: largest cluster and the chunks a warp takes before the work spreads
#: over more of the cluster (its kChunk, kMmaWarps, kMaxCluster and the 2
#: of its active-rank rule)
CHUNK = 16
MMA_WARPS = 4
MAX_CLUSTER = 16
CHUNKS_PER_WARP = 2


def split_tokens(max_tokens: int, splits: int) -> int:
    """Tokens per split for a table of ``max_tokens`` positions cut in
    ``splits`` (the kernel's rule): ``ceil(max_tokens / splits)`` rounded
    up to ``SPLIT_GRANULE``."""
    per = -(-max_tokens // splits)
    return max(1, -(-per // SPLIT_GRANULE)) * SPLIT_GRANULE


@functools.lru_cache(maxsize=None)
def decode_splits(batch: int, hkv: int, rows: int, max_pages: int,
                  page_size: int, sms: int) -> int:
    """Splits of the block table one launch uses: enough blocks for
    ``BLOCKS_PER_SM`` per SM, no split under ``SPLIT_GRANULE`` tokens,
    normalised so that every split but the last has ``split_tokens``
    tokens."""
    max_tokens = max_pages * page_size
    if max_tokens < 1:
        return 1
    blocks = batch * hkv * -(-rows // ROW_GROUP)
    want = -(-BLOCKS_PER_SM * sms // blocks)
    most = -(-max_tokens // SPLIT_GRANULE)
    splits = max(1, min(want, most))
    return -(-max_tokens // split_tokens(max_tokens, splits))


@functools.lru_cache(maxsize=None)
def decode_cluster(batch: int, hkv: int, rows: int, max_pages: int,
                   page_size: int, sms: int) -> int:
    """Blocks per cluster of the 16-bit kernel: the largest power of two
    <= ``MAX_CLUSTER`` that neither puts more blocks on the card than it
    has SMs nor gives a warp fewer than ``CHUNKS_PER_WARP`` chunks of a
    full block table. Of these the kernel keeps busy as many as the slot's
    live context needs (``active_ranks``); it takes a smaller cluster
    where the card cannot hold one this large (``cluster_used``)."""
    units = batch * hkv * -(-rows // ROW_GROUP)
    chunks = -(-max_pages * page_size // CHUNK)
    want = max(1, min(MAX_CLUSTER, sms // max(units, 1),
                      -(-chunks // (MMA_WARPS * CHUNKS_PER_WARP))))
    return 1 << (want.bit_length() - 1)


def active_ranks(n_chunks: int, cluster: int) -> int:
    """The cluster ranks the 16-bit kernel keeps busy for a slot of
    ``n_chunks`` live chunks: the fewest (a power of two <= ``cluster``)
    that give no warp more than ``CHUNKS_PER_WARP`` chunks. The others
    only keep the cluster's barriers; with one, no barrier runs."""
    a = 1
    while a < cluster and MMA_WARPS * CHUNKS_PER_WARP * a < n_chunks:
        a *= 2
    return a


@functools.lru_cache(maxsize=None)
def cluster_used(dtype: torch.dtype, dh: int, want: int) -> int:
    """The cluster size the card gives a bf16 or f16 launch at head dim
    ``dh`` that asks for ``want`` blocks: the largest power of two <=
    min(``want``, ``dh`` / 4) of which it holds one cluster."""
    return cuda_lib.library("paged_decode").paged_decode_cluster(
        dh, int(dtype == torch.float16), want)


def split_candidates(batch: int, hkv: int, rows: int, max_pages: int,
                     page_size: int, sms: int) -> tuple:
    """The split counts the tuner times over f32 and code pools:
    ``decode_splits`` first, then half and twice it, each normalised as
    ``decode_splits`` is, within 1 and the table's 16-token groups."""
    first = decode_splits(batch, hkv, rows, max_pages, page_size, sms)
    max_tokens = max_pages * page_size
    most = min(MAX_SPLITS, max(1, -(-max_tokens // SPLIT_GRANULE)))
    out = [first]
    for s in (first // 2, 2 * first):
        if 1 <= s <= most:
            s = -(-max_tokens // split_tokens(max_tokens, s))
            if s not in out:
                out.append(s)
    return tuple(out)


def cluster_candidates(want: int) -> tuple:
    """The cluster sizes asked for, from ``want`` (``decode_cluster``'s)
    down by halves to 1."""
    out = [want]
    while out[-1] > 1:
        out.append(out[-1] // 2)
    return tuple(out)


def launch_candidates(pool_dtype: torch.dtype, batch: int, hkv: int,
                      rows: int, dh: int, max_pages: int, page_size: int,
                      sms: int) -> tuple:
    """What the tuner times at a launch over pools of ``pool_dtype``
    (uint8 for code pools), the analytical choice first: split counts
    (``split_candidates``), or over bf16 and f16 pools each cluster size
    the card gives (``cluster_used``) up to ``decode_cluster``."""
    if pool_dtype not in _SUFFIXES:
        return split_candidates(batch, hkv, rows, max_pages, page_size, sms)
    out = []
    for want in cluster_candidates(decode_cluster(batch, hkv, rows,
                                                  max_pages, page_size,
                                                  sms)):
        used = cluster_used(pool_dtype, dh, want)
        if used and used not in out:
            out.append(used)
    return tuple(out)


#: the kernel's entry for each dtype of unquantized pools
_ENTRIES = {torch.float32: "paged_decode_ragged_f32",
            torch.bfloat16: "paged_decode_ragged_bf16",
            torch.float16: "paged_decode_ragged_f16"}
#: the launch count's suffix of each pool dtype's kernel instance
_SUFFIXES = {torch.bfloat16: "_bf16", torch.float16: "_f16"}


def _check(name: str, t: torch.Tensor, dtype, device) -> None:
    if t.device != device:
        raise ValueError(f"paged_decode: {name} on {t.device}, expected "
                         f"{device}")
    if t.dtype != dtype:
        raise TypeError(f"paged_decode: {name} is {t.dtype}, the kernel "
                        f"takes {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"paged_decode: {name} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"paged_decode: {name} must be 16-byte aligned")


def _launch(q, k_pages, v_pages, block_table, ctx_len, q_len, w: int,
            quant=None, plan: int | None = None):
    """``q_len`` None selects the single-token mode (``w`` must be 1).
    ``quant``: None for f32, bf16 or f16 pools, else (k_scale, v_scale,
    lut) with ``k_pages``/``v_pages`` the uint8 code pools. ``plan``: the
    split count (f32 and code pools) or the cluster size asked for (bf16
    and f16); None takes ``decode_splits`` or ``decode_cluster``. Returns
    the output and the pool dtype the kernel ran on."""
    device = q.device
    if device.type != "cuda":
        raise ValueError(f"paged_decode needs CUDA tensors, got {device}")
    b, hkv, rows, dh = q.shape
    n_pages, hkv_p, ps, dh_p = k_pages.shape
    if (hkv_p, dh_p) != (hkv, dh) or tuple(v_pages.shape) != tuple(
            k_pages.shape):
        raise ValueError(f"paged_decode: q {tuple(q.shape)} and pools "
                         f"{tuple(k_pages.shape)}/{tuple(v_pages.shape)} "
                         "disagree")
    if dh not in HEAD_DIMS:
        raise ValueError(f"paged_decode: head_dim {dh} not in {HEAD_DIMS}")
    if w < 1 or rows % w:
        raise ValueError(f"paged_decode: {rows} rows is not rep * w, w={w}")
    if block_table.ndim != 2 or block_table.shape[0] != b \
            or tuple(ctx_len.shape) != (b,) \
            or (q_len is not None and tuple(q_len.shape) != (b,)):
        raise ValueError("paged_decode: block_table (B, max_pages), ctx_len "
                         "(B,) and q_len (B,) must match q's batch")
    if quant is not None:
        pool_dtype = torch.uint8
    elif k_pages.dtype in _ENTRIES:
        pool_dtype = k_pages.dtype
    else:
        pool_dtype = torch.float32
    tensors = [("q", q, torch.float32), ("k_pages", k_pages, pool_dtype),
               ("v_pages", v_pages, pool_dtype),
               ("block_table", block_table, torch.int32),
               ("ctx_len", ctx_len, torch.int32)]
    if q_len is not None:
        tensors.append(("q_len", q_len, torch.int32))
    if quant is not None:
        k_scale, v_scale, lut = quant
        scale_shape = (n_pages, hkv, ps, 1)
        if tuple(k_scale.shape) != scale_shape \
                or tuple(v_scale.shape) != scale_shape:
            raise ValueError(f"paged_decode: scales {tuple(k_scale.shape)}/"
                             f"{tuple(v_scale.shape)}, expected "
                             f"{scale_shape}")
        if lut.ndim != 1 or not 1 <= lut.numel() <= 256:
            raise ValueError(f"paged_decode: lut of {lut.numel()} entries, "
                             "the kernel takes 1 to 256")
        tensors += [("k_scale", k_scale, torch.float32),
                    ("v_scale", v_scale, torch.float32),
                    ("lut", lut, torch.float32)]
    for name, t, dt in tensors:
        _check(name, t, dt, device)
    lib = cuda_lib.library("paged_decode")
    max_pages = block_table.shape[1]
    sms = cuda_lib.sm_count(device.index or 0)
    out = torch.empty_like(q)
    single = q_len is None
    qn = ctx_len if single else q_len
    stream = torch.cuda.current_stream(device).cuda_stream
    if pool_dtype in _SUFFIXES:
        err = getattr(lib, _ENTRIES[pool_dtype])(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            block_table.data_ptr(), ctx_len.data_ptr(), qn.data_ptr(),
            out.data_ptr(), b, hkv, rows, dh, w, int(single), ps, max_pages,
            plan or decode_cluster(b, hkv, rows, max_pages, ps, sms),
            dh ** -0.5, stream)
        cuda_lib.check(lib, err, "paged_decode launch")
        return out, pool_dtype
    splits = plan or decode_splits(b, hkv, rows, max_pages, ps, sms)
    scratch = (torch.empty(splits * b * hkv * rows * (dh + 2),
                           dtype=torch.float32, device=device)
               if splits > 1 else out)
    tail = (out.data_ptr(), scratch.data_ptr(), b, hkv, rows, dh, w,
            int(single), ps, max_pages, splits, dh ** -0.5, stream)
    if quant is None:
        err = getattr(lib, _ENTRIES[pool_dtype])(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            block_table.data_ptr(), ctx_len.data_ptr(), qn.data_ptr(), *tail)
    else:
        err = lib.paged_decode_ragged_quant_f32(
            q.data_ptr(), k_pages.data_ptr(), k_scale.data_ptr(),
            v_pages.data_ptr(), v_scale.data_ptr(), lut.data_ptr(),
            lut.numel(), block_table.data_ptr(), ctx_len.data_ptr(),
            qn.data_ptr(), *tail)
    cuda_lib.check(lib, err, "paged_decode launch")
    return out, pool_dtype


def _count(name: str, pool_dtype) -> None:
    cuda_lib.LAUNCHES[name + _SUFFIXES.get(pool_dtype, "")] += 1


def paged_decode_ragged_cuda(q, k_pages, v_pages, block_table, ctx_len,
                             q_len, *, w: int,
                             plan: int | None = None) -> torch.Tensor:
    """q (B, Hkv, rep * w, dh) rep-major rows; pools (n_pages, Hkv,
    page_size, dh) f32, bf16 or f16; block_table (B, max_pages), ctx_len
    (B,), q_len (B,) int32; ``plan`` as ``_launch``'s. Returns (B, Hkv,
    rep * w, dh) f32."""
    out, pool_dtype = _launch(q, k_pages, v_pages, block_table, ctx_len,
                              q_len, w, plan=plan)
    _count("paged_decode_ragged", pool_dtype)
    return out


def paged_attention_cuda(q, k_pages, v_pages, block_table, ctx_len, *,
                         plan: int | None = None) -> torch.Tensor:
    """q (B, Hkv, rep, dh); positions < ctx_len attended, ctx_len == 0
    gives zeros; pools f32, bf16 or f16. Returns (B, Hkv, rep, dh) f32."""
    out, pool_dtype = _launch(q, k_pages, v_pages, block_table, ctx_len,
                              None, 1, plan=plan)
    _count("paged_attention", pool_dtype)
    return out


def paged_decode_ragged_quant_cuda(q, k_codes, k_scale, v_codes, v_scale,
                                   block_table, ctx_len, q_len, lut, *,
                                   w: int,
                                   plan: int | None = None) -> torch.Tensor:
    """``paged_decode_ragged_cuda`` over quantized pools: k/v codes
    (n_pages, Hkv, page_size, dh) uint8, k/v scales (n_pages, Hkv,
    page_size, 1) f32, lut (<= 256,) f32 codebook."""
    out, _ = _launch(q, k_codes, v_codes, block_table, ctx_len, q_len, w,
                     quant=(k_scale, v_scale, lut), plan=plan)
    cuda_lib.LAUNCHES["paged_decode_ragged_quant"] += 1
    return out


def paged_attention_quant_cuda(q, k_codes, k_scale, v_codes, v_scale,
                               block_table, ctx_len, lut, *,
                               plan: int | None = None) -> torch.Tensor:
    """``paged_attention_cuda`` over quantized pools (arguments as
    ``paged_decode_ragged_quant_cuda``)."""
    out, _ = _launch(q, k_codes, v_codes, block_table, ctx_len, None, 1,
                     quant=(k_scale, v_scale, lut), plan=plan)
    cuda_lib.LAUNCHES["paged_attention_quant"] += 1
    return out
