"""Batched serving engine with SPx-quantized weights (the paper's
deployment mode), on two KV layouts:

* **paged** (the default): serving state lives in a ``StateCache``
  (serving/kv_cache.py, a copy of the reference's host-side allocator)
  over page pools on the device. Admission is all-or-nothing: a request
  enters a slot when the pool covers its worst-case footprint (prompt +
  max_new_tokens). Prompts stream through chunked prefill, one chunk per
  engine tick per slot, interleaved with the decode tick of the running
  sequences. A decode tick is one fused step by default
  (``models.lm.lm_paged_fused_step``): one ``paged_decode_ragged`` launch
  per layer for the whole batch. With ``fused_decode=False`` it is the
  one-token step instead (``lm_paged_verify`` at W = 1), through
  ``paged_attention`` (or ``paged_attention_quant``) in every layer. Two
  schedulers, as in the reference:
  ``fifo`` (strict submit order, a blocked head blocks the queue) and
  ``cb`` (continuous batching: priority admission with skip-ahead, and
  preemption of strictly lower-priority residents whose written pages go
  to a host tier and come back on resume).
* **dense** (``ServeConfig(kv_layout="dense")``, the reference's
  differential-test baseline): one ``(Hkv, max_seq, dh)`` cache row per
  slot. An admitted request is prefilled whole through ``lm_prefill``
  (the flash kernel) straight into its slot's row; every tick then
  decodes all slots with ``lm_decode_step``. ``fifo`` only.

The paged layout optionally shares KV pages across requests
(``prefix_cache=True`` / ``REPRO_PREFIX_CACHE=1``): admission maps the
matched full prompt pages into the sequence's block table (a refcount
bump, no prefill work), prefills only the unmatched tail, and copies the
last matched page to a private one (copy-on-write) when the whole prompt
is page-aligned identical, since its last token must be run again for
its logits and would write into the shared page.

It also decodes speculatively (``spec_decode=True`` / ``spec_k=K`` /
``REPRO_SPEC_K=K``): a prompt-lookup drafter (serving/spec.py) proposes
up to K tokens per decoding slot, one pass scores each K+1 window
(``lm_paged_fused_step`` at W = K+1, or ``lm_paged_verify`` on the
unfused tick), and the engine keeps the longest accepted prefix plus one
correction or bonus token, moving the write cursor back past a rejected
tail. A tick where no slot has a draft runs a plain decode.

Either layout stores K/V in f32 or, with ``Runtime(kv_quant=True,
kv_scheme=...)``, as SPx codebook codes (uint8) plus one f32 scale per
token; the paged decode then runs the quantized kernels.

Greedy decoding is ``argmax`` and equals the reference's tokens. Sampling
(``temperature > 0``) draws from a per-request ``torch.Generator`` seeded
from ``Request.seed`` or from the engine seed and the rid, so a sampled
output depends on the request alone; it cannot reproduce ``jax.random``'s
draws.

Not in this port yet (``ServeConfig.resolve`` raises): bf16 KV caches,
sharding and replicas, and every pattern but ``attn+dense``.
"""
from __future__ import annotations

import dataclasses
import hashlib
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import lm as lm_mod
from repro_torch.nn.layers import quantize_params, tree_leaves, tree_map
from repro_torch.runtime import Runtime, planner, resolve_device
from repro_torch.serving.config import ServeConfig
from repro_torch.serving.kv_cache import StateCache, kv_bytes_per_token
from repro_torch.serving.spec import PromptLookupDrafter
from repro_torch.serving.stream import StreamState, TokenStream

__all__ = ["Request", "ServeConfig", "ServeEngine"]

#: every engine timestamp comes through this hook; it must be monotonic
_now = time.monotonic


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray              # (len,) int32
    max_new_tokens: int = 32
    temperature: float = 0.0
    #: sampling seed (temperature > 0). None derives one from the engine
    #: seed and the rid.
    seed: Optional[int] = None
    #: priority class for the cb scheduler: higher admits first and may
    #: preempt strictly lower-priority residents; ties break FIFO
    priority: int = 0
    # filled by the engine:
    output: list = dataclasses.field(default_factory=list)
    done: bool = False
    t_enqueue: float = 0.0
    t_first_token: float = 0.0
    t_done: float = 0.0
    preemptions: int = 0
    generator: object = dataclasses.field(default=None, repr=False)
    _seq: int = dataclasses.field(default=0, repr=False)
    _resume: object = dataclasses.field(default=None, repr=False)


def _pad_pow2(n: int, cap: int) -> int:
    """Smallest power of two >= n, capped (chunk-padding bucket)."""
    return min(cap, 1 << max(0, (n - 1)).bit_length())


def _request_seed(engine_seed: int, rid: int) -> int:
    h = hashlib.blake2b(f"{engine_seed}:{rid}".encode(), digest_size=8)
    return int.from_bytes(h.digest(), "little") & ((1 << 63) - 1)


class ServeEngine:
    def __init__(self, params, cfg: ArchConfig,
                 config: ServeConfig | None = None, *,
                 rt: Runtime | None = None):
        if config is not None and not isinstance(config, ServeConfig):
            raise TypeError(
                f"config must be a ServeConfig, got {type(config).__name__}")
        self.cfg = cfg
        self.rt = rt or Runtime(q_chunk=256)
        self.device = resolve_device(self.rt.device)
        # with rt.kv_quant the caches hold uint8 codes + f32 scales under
        # rt.kv_scheme, and kv_cache_dtype is ignored by the allocators
        self.kv_scheme = self.rt.kv_scheme if self.rt.kv_quant else None
        sc = (config or ServeConfig()).resolve(cfg)
        self.config = sc
        self.batch_slots = sc.batch_slots
        self.max_seq = sc.max_seq
        self.kv_cache_dtype = sc.kv_cache_dtype
        self.kv_layout = sc.kv_layout
        self.prefix_cache = sc.prefix_cache
        self.spec_k = sc.spec_k
        self.fused_decode = sc.fused_decode
        self.scheduler = sc.scheduler
        self.host_pages = sc.host_pages
        self.prefix_cache_pages = sc.prefix_cache_pages
        params = tree_map(lambda _, leaf: leaf.to(self.device), params)
        if sc.quantize:
            params = quantize_params(params, sc.quantize)
        self.params = params
        self.seed = sc.seed

        self.slot_req: list[Optional[Request]] = [None] * self.batch_slots
        self.slot_pos = np.zeros(self.batch_slots, np.int64)  # tokens held
        self.queue: list[Request] = []
        self.finished: list[Request] = []
        self._streams: dict[int, StreamState] = {}
        self._cancelled = 0
        self._occ_samples: list[float] = []
        self._tokens_out = 0
        self._steps = 0
        self._wall = 0.0
        self._model_calls = 0
        # speculation: windows that carried >= 1 draft, and drafts
        # proposed / accepted across them
        self._spec_windows = 0
        self._spec_proposed = 0
        self._spec_accepted = 0
        self._preemptions = 0
        self._resumes = 0
        self._offload_bytes = 0
        self._onload_bytes = 0
        self._undrained_runs = 0
        self._submit_seq = 0
        self.drained = True
        if self.kv_layout == "paged":
            self._init_paged()
        else:
            self._init_dense()

    def _init_dense(self):
        self.caches = lm_mod.init_caches(
            self.cfg, self.batch_slots, self.max_seq,
            dtype=self.kv_cache_dtype, kv_quant=self.rt.kv_quant,
            device=self.device)

    def _init_paged(self):
        cfg, sc = self.cfg, self.config
        plan = planner.plan_kv_pages(cfg.dh,
                                     act_bytes=self.kv_cache_dtype.itemsize,
                                     kv_scheme=self.kv_scheme)
        self.page_size = min(sc.page_size or plan.page_size, self.max_seq)
        self.pages_per_seq = -(-self.max_seq // self.page_size)
        n_pages = sc.pool_pages or self.batch_slots * self.pages_per_seq
        self.pool = StateCache(n_pages, self.page_size,
                               host_pages=self.host_pages,
                               cache_pages=self.prefix_cache_pages)
        self.prefill_chunk = sc.prefill_chunk
        self.caches = lm_mod.paged_init_caches(
            cfg, self.pool.n_pages, self.page_size, dtype=self.kv_cache_dtype,
            kv_quant=self.rt.kv_quant, device=self.device)
        self.block_tables = np.zeros((self.batch_slots, self.pages_per_seq),
                                     np.int32)
        # per-slot prefill progress: prompt tokens already fed; -1 = decoding
        self._fed = np.full(self.batch_slots, -1, np.int64)
        if self.spec_k:
            self.drafter = PromptLookupDrafter()
        # prefix-cache work counters, and each in-flight prompt's page
        # chain keys (hashed once, reused by admission retries and by the
        # registration after every prefill chunk)
        self._prefix_hits = 0
        self._prefill_skipped = 0
        self._cow_copies = 0
        self._prompt_keys: dict[int, list[bytes]] = {}

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(a).to(self.device)

    # -- public API ----------------------------------------------------------

    @staticmethod
    def _worst_case_tokens(req: Request) -> int:
        return len(req.prompt) + req.max_new_tokens

    def _set_block_row(self, slot: int, rid: int):
        self.block_tables[slot] = self.pool.block_table_row(
            rid, self.pages_per_seq)

    def submit(self, req: Request):
        if len(req.prompt) < 1 or req.max_new_tokens < 1:
            raise ValueError(
                f"request {req.rid}: needs a non-empty prompt and "
                f"max_new_tokens >= 1 (got {len(req.prompt)}, "
                f"{req.max_new_tokens})")
        if self._worst_case_tokens(req) > self.max_seq:
            raise ValueError(
                f"request {req.rid}: prompt ({len(req.prompt)}) + "
                f"max_new_tokens ({req.max_new_tokens}) exceeds "
                f"max_seq={self.max_seq}")
        if req.done or req.output:
            raise ValueError(
                f"request {req.rid}: this Request object was already "
                f"served ({len(req.output)} output token(s), "
                f"done={req.done}) — build a fresh Request per submission")
        in_flight = ({r.rid for r in self.queue}
                     | {r.rid for r in self.slot_req if r is not None})
        if req.rid in in_flight:
            raise ValueError(f"request id {req.rid} already in flight")
        if any(r.rid == req.rid for r in self.finished):
            raise ValueError(
                f"request id {req.rid} already finished this measurement "
                "window — reuse a rid only after reset_metrics(), and "
                "always with a fresh Request object")
        if self.kv_layout == "paged":
            need = planner.plan_seq_pages(self._worst_case_tokens(req),
                                          self.page_size)
            if need > self.pool.n_pages:
                raise ValueError(
                    f"request {req.rid}: needs {need} pages but the pool "
                    f"only has {self.pool.n_pages} in total")
        if req.generator is None:
            seed = (req.seed if req.seed is not None
                    else _request_seed(self.seed, req.rid))
            req.generator = torch.Generator().manual_seed(seed)
        req.t_enqueue = _now()
        req._seq = self._submit_seq
        self._submit_seq += 1
        self._streams[req.rid] = StreamState(req)
        self.queue.append(req)

    def step(self):
        """One scheduling tick. Paged: admission (with preemption under
        cb), a prefill chunk per prefilling slot, one fused decode tick.
        Dense: whole-prompt prefill of each admitted request, one decode
        tick."""
        t0 = _now()
        self._tick()
        self._wall += _now() - t0

    def has_work(self) -> bool:
        return bool(self.queue) or any(r is not None for r in self.slot_req)

    def _tick(self):
        self._steps += 1
        if self.kv_layout == "dense":
            self._admit_dense()
            self._decode_step_dense()
            self._occ_samples.append(
                sum(r is not None for r in self.slot_req) / self.batch_slots)
        else:
            if self.scheduler == "cb":
                self._admit_cb()
            else:
                self._admit_fifo()
            self._prefill_tick()
            self._decode_step_paged()
            self._occ_samples.append(self.pool.stats.occupancy)
        for st in self._streams.values():
            st.notify()

    def run(self, max_steps: int = 10_000, *, strict: bool = True):
        """Drive until queue and slots drain (or the step limit). Stopping
        at ``max_steps`` with live work raises under ``strict=True``."""
        t0 = _now()
        for _ in range(max_steps):
            if not self.has_work():
                break
            self._tick()
        self._wall += _now() - t0
        self.drained = not self.has_work()
        if not self.drained:
            self._undrained_runs += 1
            if strict:
                exc = RuntimeError(
                    f"run(max_steps={max_steps}) stopped with live work: "
                    f"{len(self.queue)} queued, "
                    f"{sum(r is not None for r in self.slot_req)} resident "
                    f"({len(self.finished)} finished). Raise max_steps, or "
                    f"pass strict=False to accept partial progress.")
                for st in self._streams.values():
                    if st.status == "live":
                        st.fail(exc)
                raise exc
        return self.finished

    def stream(self, rid: int) -> TokenStream:
        """A token iterator over one submitted request (serving/stream.py)."""
        st = self._streams.get(rid)
        if st is None:
            raise KeyError(
                f"request {rid}: no stream state (never submitted, or "
                "pruned by reset_metrics())")
        return TokenStream(self, st)

    def cancel(self, rid: int) -> bool:
        """Abort a request at a tick boundary and free what it holds.
        Returns False when it already reached a terminal state."""
        st = self._streams.get(rid)
        for slot, r in enumerate(self.slot_req):
            if r is not None and r.rid == rid:
                self._release_slot(slot)
                self._drop_request(r, st)
                return True
        for r in list(self.queue):
            if r.rid == rid:
                self.queue.remove(r)
                if r._resume is not None:
                    self.pool.drop_host(rid)
                    r._resume = None
                self._drop_request(r, st)
                return True
        if st is not None or any(r.rid == rid for r in self.finished):
            return False
        raise KeyError(f"request {rid}: unknown rid (never submitted)")

    def _drop_request(self, req: Request, st: StreamState | None):
        if self.kv_layout == "paged":
            self._prompt_keys.pop(req.rid, None)
        req.done = True
        req.t_done = _now()
        self._cancelled += 1
        if st is not None:
            st.cancel()

    def reset_metrics(self):
        """Zero the throughput/latency/occupancy counters (cache state is
        kept): between a warm-up pass and the measured pass."""
        self.finished = []
        self._occ_samples = []
        self._tokens_out = 0
        self._steps = 0
        self._wall = 0.0
        self._model_calls = 0
        self._spec_windows = 0
        self._spec_proposed = 0
        self._spec_accepted = 0
        self._preemptions = 0
        self._resumes = 0
        self._offload_bytes = 0
        self._onload_bytes = 0
        self._undrained_runs = 0
        self._cancelled = 0
        self.drained = True
        self._streams = {rid: st for rid, st in self._streams.items()
                         if st.status == "live"}
        if self.kv_layout == "dense":
            return
        st = self.pool.stats
        st.peak_pages_in_use = st.pages_in_use
        st.admission_denials = 0
        st.offload_calls = 0
        st.onload_calls = 0
        st.peak_host_pages = st.host_pages_in_use
        st.prefix_lookups = 0
        st.prefix_hits = 0
        st.prefix_evictions = 0
        self._prefix_hits = 0
        self._prefill_skipped = 0
        self._cow_copies = 0

    def metrics(self) -> dict:
        """Throughput/latency/occupancy counters for the work so far."""
        lat = [r.t_done - r.t_enqueue for r in self.finished]
        ttft = [r.t_first_token - r.t_enqueue for r in self.finished]
        # bytes follow the layout allocated: the cache dtype, or codes +
        # scale when rt.kv_quant is set
        per_tok = kv_bytes_per_token(
            self.cfg, dtype_bytes=self.kv_cache_dtype.itemsize,
            kv_scheme=self.kv_scheme)
        if self.kv_layout == "paged":
            st = self.pool.stats
            peak_kv = st.peak_pages_in_use * self.page_size * per_tok
            page_bytes = self.page_size * per_tok
            paged = {
                "page_size": self.page_size,
                "n_pages": self.pool.n_pages,
                "pages_per_seq": self.pages_per_seq,
                "peak_kv_pages": st.peak_pages_in_use,
                "admission_denials": st.admission_denials,
                "prefill_chunk": self.prefill_chunk,
                "preemptions": self._preemptions,
                "resumes": self._resumes,
                "offload_bytes": self._offload_bytes,
                "onload_bytes": self._onload_bytes,
                "host_pages": self.pool.host_pages,
                "host_pages_in_use": st.host_pages_in_use,
                "peak_host_pages": st.peak_host_pages,
                "peak_host_bytes": st.peak_host_pages * page_bytes,
                # prefix-cache economics (pool-side counters)
                "prefix_cache_pages": self.pool.cache_pages,
                "prefix_lookups": st.prefix_lookups,
                "prefix_evictions": st.prefix_evictions,
                "prefix_hit_rate": st.prefix_hits / st.prefix_lookups
                if st.prefix_lookups else 0.0,
                "prefix_cache": self.prefix_cache,
                "prefix_hits": self._prefix_hits,
                "prefill_tokens_skipped": self._prefill_skipped,
                "cow_copies": self._cow_copies,
                "spec_decode": bool(self.spec_k),
                "spec_k": self.spec_k,
                "fused_decode": self.fused_decode,
                # drafts accepted per drafted window / per proposed draft
                "accepted_per_step": self._spec_accepted / self._spec_windows
                if self._spec_windows else 0.0,
                "draft_acceptance_rate":
                    self._spec_accepted / self._spec_proposed
                    if self._spec_proposed else 0.0,
            }
        else:
            # dense bills every slot its worst case up front
            peak_kv = self.batch_slots * self.max_seq * per_tok
            paged = {}
        return {
            "kv_layout": self.kv_layout,
            "scheduler": self.scheduler,
            "device": str(self.device),
            "undrained_runs": self._undrained_runs,
            "drained": self.drained,
            "kv_scheme": self.kv_scheme or "none",
            # what the cache tensors hold: the quantized layout ignores
            # kv_cache_dtype (codes uint8, scales f32)
            "kv_cache_dtype": ("uint8+f32scale" if self.kv_scheme else
                               str(self.kv_cache_dtype).replace("torch.",
                                                                "")),
            "requests_finished": len(self.finished),
            "requests_cancelled": self._cancelled,
            "tokens_generated": self._tokens_out,
            "engine_steps": self._steps,
            "model_calls": self._model_calls,
            "wall_s": self._wall,
            "tokens_per_s": self._tokens_out / self._wall
            if self._wall else 0.0,
            "ttft_p50_ms": 1e3 * float(np.median(ttft)) if ttft else 0.0,
            "ttft_p95_ms": 1e3 * float(np.percentile(ttft, 95))
            if ttft else 0.0,
            "latency_p50_ms": 1e3 * float(np.median(lat)) if lat else 0.0,
            "latency_p95_ms": 1e3 * float(np.percentile(lat, 95))
            if lat else 0.0,
            "occupancy_mean": float(np.mean(self._occ_samples))
            if self._occ_samples else 0.0,
            "occupancy_peak": float(np.max(self._occ_samples))
            if self._occ_samples else 0.0,
            "peak_kv_bytes": int(peak_kv),
            **paged,
        }

    # -- admission -----------------------------------------------------------

    def _admit_fifo(self):
        for slot in range(self.batch_slots):
            if not self.queue:
                return
            if self.slot_req[slot] is not None:
                continue
            if not self._try_admit(self.queue[0], slot):
                return                      # wait for a release

    def _admit_cb(self):
        while self.queue:
            free = [s for s in range(self.batch_slots)
                    if self.slot_req[s] is None]
            order = sorted(self.queue, key=lambda r: (-r.priority, r._seq))
            admitted = False
            if free:
                for req in order:
                    if self._try_admit(req, free[0]):
                        admitted = True
                        break
            if admitted:
                continue
            # nobody fits: preempt on behalf of the top candidate only,
            # then admit it straight away
            if not self._preempt_for(order[0]):
                return
            slot = next(s for s in range(self.batch_slots)
                        if self.slot_req[s] is None)
            if not self._try_admit(order[0], slot):
                return

    def _match_prefix(self, req: Request):
        """-> (shared full pages, copy-on-write source page or None,
        matched tokens). When the whole prompt is covered, its last token
        must run again for the first token's logits and would write into
        the last matched page: that page becomes a copy-on-write source
        instead, so matched tokens stay < len(prompt)."""
        keys = self._prompt_keys.get(req.rid)
        if keys is None:
            keys = self._prompt_keys[req.rid] = \
                self.pool.prompt_keys(req.prompt)
        cand = self.pool.match_prefix(req.prompt, keys=keys)
        if not cand:
            return [], None, 0
        matched = len(cand) * self.page_size
        if matched < len(req.prompt):
            return cand, None, matched
        return cand[:-1], cand[-1], len(req.prompt) - 1

    def _try_admit(self, req: Request, slot: int) -> bool:
        """Place ``req`` into the free ``slot``: fresh, with its matched
        prefix pages shared, or resumed from the host tier. False leaves
        queue, pool and slot untouched."""
        if req._resume is not None:
            return self._try_resume(req, slot)
        shared, cow_src, matched = [], None, 0
        if self.prefix_cache:
            shared, cow_src, matched = self._match_prefix(req)
        pages = self.pool.allocate(req.rid, self._worst_case_tokens(req),
                                   shared_prefix=shared)
        if pages is None:
            return False
        if cow_src is not None:
            # a private copy of the last matched page, before the re-run
            # final token writes its (identical) K/V into it
            lm_mod.paged_copy_page(self.caches, cow_src, pages[len(shared)])
            self._cow_copies += 1
        if matched:
            self._prefix_hits += 1
            self._prefill_skipped += matched
        self.queue.remove(req)
        self.slot_req[slot] = req
        self.slot_pos[slot] = matched
        self._fed[slot] = matched
        self._set_block_row(slot, req.rid)
        if self.spec_k:
            # the drafter indexes the whole prompt, shared prefix included
            self.drafter.start(req.rid, req.prompt)
        return True

    # -- preemption + resume (cb scheduler) ----------------------------------

    def _snapshot_pages(self, pages) -> list:
        """The written pages' bytes (codes and scales of a quantized pool),
        copied to host tensors (numpy has no bf16)."""
        idx = self._tensor(np.asarray(pages, np.int32))
        snap = lm_mod.paged_gather_pages(self.caches, idx)
        return tree_map(lambda _, leaf: leaf.cpu(), snap)

    def _restore_pages(self, pages: list[int], payload):
        n = tree_leaves(payload)[0].shape[1]
        idx = self._tensor(np.asarray(pages[:n], np.int32))
        lm_mod.paged_scatter_pages(self.caches, idx, payload)

    @staticmethod
    def _payload_bytes(payload) -> int:
        return sum(a.nbytes for a in tree_leaves(payload))

    def _clear_slot(self, slot: int):
        rid = self.slot_req[slot].rid
        self.slot_req[slot] = None
        self.slot_pos[slot] = 0
        if self.kv_layout == "paged":
            self.block_tables[slot] = 0
            self._fed[slot] = -1
            if self.spec_k:
                # rebuilt from prompt + output on resume
                self.drafter.drop(rid)

    def _release_slot(self, slot: int):
        """Clear the slot and give its pages back to the pool."""
        rid = self.slot_req[slot].rid
        self._clear_slot(slot)
        if self.kv_layout == "paged":
            self.pool.release(rid)

    def _preempt_slot(self, slot: int) -> bool:
        """Evict the resident request: snapshot the pages covering its
        write cursor to the host tier, release its device pages, and
        requeue it with resume state. False (state untouched) when the
        host tier cannot take the pages."""
        req = self.slot_req[slot]
        n_written = int(self.slot_pos[slot])
        fed = int(self._fed[slot])
        _, n_keep = planner.plan_resume_pages(
            n_written, self._worst_case_tokens(req), self.page_size)
        payload = (self._snapshot_pages(self.pool.seq_pages(req.rid)[:n_keep])
                   if n_keep else None)
        if self.pool.offload(req.rid, n_keep, payload) is None:
            return False                    # host tier full
        if payload is not None:
            self._offload_bytes += self._payload_bytes(payload)
        req._resume = (n_written, fed)
        req.preemptions += 1
        self._preemptions += 1
        self._clear_slot(slot)
        self.queue.append(req)
        return True

    def _try_resume(self, req: Request, slot: int) -> bool:
        """Bring a preempted request back at its exact (write cursor,
        prefill progress)."""
        n_written, fed = req._resume
        res = self.pool.onload(req.rid, self._worst_case_tokens(req))
        if res is None:
            return False
        pages, payload = res
        if payload is not None:
            self._restore_pages(pages, payload)
            self._onload_bytes += self._payload_bytes(payload)
        self.queue.remove(req)
        req._resume = None
        self._resumes += 1
        self.slot_req[slot] = req
        self.slot_pos[slot] = n_written
        self._fed[slot] = fed
        self._set_block_row(slot, req.rid)
        if self.spec_k:
            self.drafter.start(req.rid, req.prompt)
            for tok in req.output:
                self.drafter.extend(req.rid, int(tok))
        return True

    def _preempt_for(self, cand: Request) -> bool:
        """Preempt strictly-lower-priority residents (lowest priority,
        then youngest, first) until ``cand`` has a slot and enough free
        pages; prechecked against both tiers before any eviction."""
        need = planner.plan_seq_pages(self._worst_case_tokens(cand),
                                      self.page_size)
        victims = sorted(
            (s for s, r in enumerate(self.slot_req)
             if r is not None and r.priority < cand.priority),
            key=lambda s: (self.slot_req[s].priority,
                           -self.slot_req[s]._seq))
        free_slot = any(r is None for r in self.slot_req)
        gain = self.pool.free_pages()
        host_extra = 0
        chosen: list[int] = []
        for s in victims:
            if gain >= need and (free_slot or chosen):
                break
            _, n_keep = planner.plan_resume_pages(
                int(self.slot_pos[s]),
                self._worst_case_tokens(self.slot_req[s]), self.page_size)
            if (self.pool.host_pages is not None
                    and self.pool.stats.host_pages_in_use + host_extra
                    + n_keep > self.pool.host_pages):
                continue                    # host tier can't take this one
            chosen.append(s)
            gain += self.pool.releasable_pages(self.slot_req[s].rid)
            host_extra += n_keep
        if gain < need or not (free_slot or chosen):
            return False
        preempted = False
        for s in chosen:
            preempted |= self._preempt_slot(s)
        return preempted

    def preempt(self, rid: int):
        """Force-preempt a resident request (fault injection / tests)."""
        if self.kv_layout != "paged":
            raise ValueError("preempt() needs kv_layout='paged'")
        for slot, r in enumerate(self.slot_req):
            if r is not None and r.rid == rid:
                if not self._preempt_slot(slot):
                    raise RuntimeError(
                        f"request {rid}: host tier full "
                        f"({self.pool.stats.host_pages_in_use}/"
                        f"{self.pool.host_pages} pages)")
                return
        raise KeyError(f"request {rid} is not resident in any slot")

    # -- model ticks ---------------------------------------------------------

    def _prefill_tick(self):
        """Advance every prefilling slot by one prompt chunk in a single
        batched call; other rows ride along with n_valid = 0."""
        rows = [i for i in range(self.batch_slots)
                if self.slot_req[i] is not None and self._fed[i] >= 0]
        if not rows:
            return
        chunk = {i: min(self.prefill_chunk,
                        len(self.slot_req[i].prompt) - int(self._fed[i]))
                 for i in rows}
        c_pad = _pad_pow2(max(chunk.values()), self.prefill_chunk)
        tokens = np.zeros((self.batch_slots, c_pad), np.int32)
        ctx = np.zeros(self.batch_slots, np.int32)
        n_valid = np.zeros(self.batch_slots, np.int32)
        for i in rows:
            fed, c = int(self._fed[i]), chunk[i]
            tokens[i, :c] = self.slot_req[i].prompt[fed:fed + c]
            ctx[i] = fed
            n_valid[i] = c
        logits, self.caches = lm_mod.lm_paged_step(
            self.params, self._tensor(tokens), self._tensor(ctx),
            self._tensor(self.block_tables), self._tensor(n_valid),
            self.caches, self.cfg, self.rt)
        self._model_calls += 1
        logits = logits.cpu().numpy()
        for i in rows:
            req = self.slot_req[i]
            self._fed[i] += chunk[i]
            self.slot_pos[i] = self._fed[i]
            if self.prefix_cache:
                # index every prompt page this chunk completed: queued
                # requests with the same prefix share them from the next
                # admission on (before _maybe_finish: a released page
                # stays indexed)
                self.pool.register_prefix(
                    req.rid, req.prompt, int(self._fed[i]),
                    keys=self._prompt_keys.get(req.rid))
            if self._fed[i] == len(req.prompt):
                self._fed[i] = -1           # -> decoding
                first = self._pick_token(logits[i], req)
                req.output.append(first)
                self._tokens_out += 1
                if self.spec_k:
                    self.drafter.extend(req.rid, first)
                req.t_first_token = _now()
                self._maybe_finish(i)       # max_new_tokens == 1

    def _decode_step_paged(self):
        """One decode tick for every decoding slot, over a window of W
        tokens per row: the pending token plus up to spec_k drafts, padded
        past each row's ``n_valid``. Fused, W = spec_k + 1 (1 without
        speculation) and every layer's attention is one
        ``paged_decode_ragged`` launch for drafted and undrafted rows
        alike. Unfused, ``lm_paged_verify`` scores the K+1 windows, or, when
        no slot has a draft, runs the one-token step (``paged_attention``
        in every layer)."""
        active = [i for i, r in enumerate(self.slot_req)
                  if r is not None and self._fed[i] < 0]
        if not active:
            return
        drafts = {i: self._propose(i) for i in active}
        if self.fused_decode:
            w, step_fn = self.spec_k + 1, lm_mod.lm_paged_fused_step
        else:
            w = self.spec_k + 1 if any(drafts.values()) else 1
            step_fn = lm_mod.lm_paged_verify
        tokens = np.zeros((self.batch_slots, w), np.int32)
        n_valid = np.zeros(self.batch_slots, np.int32)
        ctx = np.zeros(self.batch_slots, np.int32)
        for i in active:
            d = drafts[i]
            tokens[i, 0] = self.slot_req[i].output[-1]
            tokens[i, 1:1 + len(d)] = d
            n_valid[i] = 1 + len(d)
            ctx[i] = self.slot_pos[i]
        logits, self.caches = step_fn(
            self.params, self._tensor(tokens), self._tensor(ctx),
            self._tensor(self.block_tables), self._tensor(n_valid),
            self.caches, self.cfg, self.rt)
        self._model_calls += 1
        logits = logits.cpu().numpy()                # (B, W, V)
        for i in active:
            req = self.slot_req[i]
            emitted = self._accept_tokens(req, drafts[i], logits[i])
            accepted = len(emitted) - 1
            for tok in emitted:
                req.output.append(tok)
                if self.spec_k:
                    self.drafter.extend(req.rid, tok)
            self._tokens_out += len(emitted)
            if drafts[i]:
                self._spec_windows += 1
            self._spec_proposed += len(drafts[i])
            self._spec_accepted += accepted
            # the pending token and the accepted drafts stay; a rejected
            # tail's positions are overwritten by the next window and
            # never attended
            self.slot_pos[i] = int(ctx[i]) + 1 + accepted
            self._maybe_finish(i)

    # -- speculative decoding (serving/spec.py has the drafter) --------------

    def _propose(self, slot: int) -> list[int]:
        """The drafts of this slot's next window. At most spec_k, and fewer
        near the end: the window emits up to d+1 tokens (never past
        max_new_tokens) and writes positions pos..pos+d (never past what a
        plain decode could reach, so the worst-case page reservation
        covers every write)."""
        if not self.spec_k:
            return []
        req = self.slot_req[slot]
        room = min(req.max_new_tokens - len(req.output),
                   self.max_seq - 1 - int(self.slot_pos[slot])) - 1
        return (self.drafter.propose(req.rid, min(self.spec_k, room))
                if room > 0 else [])

    def _accept_tokens(self, req: Request, drafts: list[int],
                       logits: np.ndarray) -> list[int]:
        """Tokens to emit for one scored window; ``logits`` (W, V), row j
        scored after window token j. Greedy: the longest prefix of drafts
        that matches argmax, then the correction (first mismatch) or the
        bonus token, exactly what plain greedy decode emits. Sampled: each
        draft is kept with probability p[t] (the drafter is a point mass)
        and a rejection draws from p with t removed, all from the
        request's own generator."""
        if req.temperature <= 0:
            out = []
            for j, t in enumerate(drafts):
                top = int(np.argmax(logits[j]))
                if top != t:
                    return out + [top]               # correction
                out.append(int(t))
            return out + [int(np.argmax(logits[len(drafts)]))]   # bonus
        out = []
        for j, t in enumerate(drafts):
            p = _softmax_np(logits[j], req.temperature)
            u = float(torch.rand((), dtype=torch.float64,
                                 generator=req.generator))
            if u < p[t]:
                out.append(int(t))
                continue
            res = p.copy()
            res[t] = 0.0
            z = res.sum()
            if z <= 0.0:                             # p was ~all at t
                return out + [int(np.argmax(logits[j]))]
            return out + [int(torch.multinomial(torch.as_tensor(res / z), 1,
                                                generator=req.generator))]
        return out + [self._pick_token(logits[len(drafts)], req)]

    def _maybe_finish(self, slot: int):
        req = self.slot_req[slot]
        if (len(req.output) >= req.max_new_tokens
                or self.slot_pos[slot] >= self.max_seq - 1):
            self._finish(slot)

    def _finish(self, slot: int):
        req = self.slot_req[slot]
        req.done = True
        req.t_done = _now()
        self.finished.append(req)
        st = self._streams.get(req.rid)
        if st is not None:
            st.finish()
        self._release_slot(slot)
        if self.kv_layout == "paged":
            self._prompt_keys.pop(req.rid, None)

    # -- dense layout ---------------------------------------------------------

    def _admit_dense(self):
        """FIFO: prefill each admitted prompt whole, straight into its
        slot's cache row (the reference prefills a one-row cache and
        splices it in; positions past the prompt are never attended)."""
        for slot in range(self.batch_slots):
            if self.slot_req[slot] is not None or not self.queue:
                continue
            req = self.queue.pop(0)
            self.slot_req[slot] = req
            row = tree_map(lambda _, leaf: leaf[:, slot:slot + 1],
                           self.caches)
            tok = self._tensor(np.asarray(req.prompt, np.int32)[None, :])
            logits, _ = lm_mod.lm_prefill(self.params, tok, row, self.cfg,
                                          self.rt)
            self._model_calls += 1
            self.slot_pos[slot] = len(req.prompt)
            req.output.append(self._pick_token(logits[0].cpu().numpy(), req))
            self._tokens_out += 1
            req.t_first_token = _now()
            self._maybe_finish(slot)        # max_new_tokens == 1

    def _decode_step_dense(self):
        """One decode tick of every slot, each at its own position."""
        active = [i for i, r in enumerate(self.slot_req) if r is not None]
        if not active:
            return
        tokens = np.zeros(self.batch_slots, np.int32)
        for i in active:
            tokens[i] = self.slot_req[i].output[-1]
        logits, self.caches = lm_mod.lm_decode_step(
            self.params, self._tensor(tokens),
            self._tensor(self.slot_pos.astype(np.int32)), self.caches,
            self.cfg, self.rt)
        self._model_calls += 1
        logits = logits.cpu().numpy()
        for i in active:
            req = self.slot_req[i]
            req.output.append(self._pick_token(logits[i], req))
            self._tokens_out += 1
            self.slot_pos[i] += 1
            self._maybe_finish(i)

    def _pick_token(self, row: np.ndarray, req: Request) -> int:
        if req.temperature <= 0:
            return int(np.argmax(row))
        # per-request generator: the draws depend on this request alone
        logits = torch.as_tensor(row, dtype=torch.float64) / req.temperature
        probs = torch.softmax(logits, dim=-1)
        return int(torch.multinomial(probs, 1, generator=req.generator))


def _softmax_np(row: np.ndarray, temperature: float) -> np.ndarray:
    """Stable f64 softmax of a logits row: the acceptance probabilities of
    speculative rejection sampling."""
    x = np.asarray(row, np.float64) / temperature
    p = np.exp(x - x.max())
    return p / p.sum()
