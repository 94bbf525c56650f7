"""One frozen config object for every serving knob.

``ServeConfig.resolve(cfg)`` is the only place env fallbacks are read and
cross-knob checks run, as in ``repro.serving.config``; it returns a fully
resolved copy. Same fields, env knobs and defaults as the reference.

This port serves every pattern of the reference (dense, MoE, recurrent,
hybrid, M-RoPE and the encoder-decoder) on two layouts:
the paged state cache under ``cb`` or ``fifo`` scheduling — the fused or
the unfused decode tick,
speculative decoding and the prefix cache included where the pattern
allows them — and the dense per-slot layout under ``fifo``; either in f32,
bf16 or f16 (``kv_cache_dtype``) or, with ``Runtime.kv_quant``, as SPx
codes; tensor-parallel (``shards``) on the paged layout and behind a
replica router (``replicas``), for every pattern.
``shards`` and ``replicas`` resolve as the reference's do, env fallbacks
(``REPRO_SHARDS``, ``REPRO_REPLICAS``) included. A knob the layout or the
pattern cannot have raises the reference's ``ValueError`` naming the
failing predicates, and its env default degrades silently, as in the
reference. A knob or a model that asks **explicitly** for something this
port lacks (another cache dtype) raises ``NotImplementedError`` naming
the ROADMAP.md item that ports it.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.serving.spec import DEFAULT_SPEC_K

__all__ = ["ServeConfig", "DEFAULT_PREFILL_CHUNK"]

#: chunk length for chunked prefill when the caller doesn't pass one;
#: REPRO_PREFILL_CHUNK=N overrides. Ragged final chunks pad up to the next
#: power of two.
DEFAULT_PREFILL_CHUNK = 32


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet (ROADMAP.md: {item})")


def _slab_mixers(cfg: ArchConfig) -> list[str]:
    """The recurrent mixer kinds present in the pattern."""
    return sorted({s.split("+")[0] for s in cfg.pattern}
                  & {"mamba", "mlstm", "slstm"})


def _torch_dtype(d) -> torch.dtype:
    if isinstance(d, torch.dtype):
        return d
    dt = getattr(torch, str(d), None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown kv_cache_dtype {d!r}")
    return dt


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Every ServeEngine knob, in one frozen object (the reference's
    fields). Construct with any subset and let ``resolve()`` fill the
    rest."""
    batch_slots: int = 4
    max_seq: int = 256
    quantize: Optional[str] = "sp2_4"
    seed: int = 0
    kv_layout: str = "auto"
    page_size: Optional[int] = None
    pool_pages: Optional[int] = None
    prefill_chunk: Optional[int] = None
    kv_cache_dtype: Any = "float32"
    prefix_cache: Optional[bool] = None
    spec_decode: Optional[bool] = None
    spec_k: Optional[int] = None
    fused_decode: Optional[bool] = None
    scheduler: Optional[str] = None
    host_pages: Optional[int] = None
    prefix_cache_pages: Optional[int] = None
    shards: Optional[int] = None
    replicas: Optional[int] = None
    resolved: bool = False

    def replace(self, **kw) -> "ServeConfig":
        """Keyword field replacement; the copy must be resolved again."""
        kw.setdefault("resolved", False)
        return dataclasses.replace(self, **kw)

    def resolve(self, cfg: ArchConfig) -> "ServeConfig":
        """A fully resolved copy for ``cfg``. Idempotent."""
        if self.resolved:
            return self
        has_slab = bool(_slab_mixers(cfg))
        has_cross = bool(cfg.enc_dec)
        if self.batch_slots < 1:
            raise ValueError(
                f"batch_slots must be >= 1, got {self.batch_slots}")
        if self.max_seq < 1:
            raise ValueError(f"max_seq must be >= 1, got {self.max_seq}")

        kv_layout = "paged" if self.kv_layout == "auto" else self.kv_layout
        if kv_layout not in ("paged", "dense"):
            raise ValueError(
                f"kv_layout must be 'paged', 'dense' or 'auto', "
                f"got {kv_layout!r}")
        paged = kv_layout == "paged"

        # shared-prefix KV page reuse (paged only). None = read the env
        # default; an env-enabled cache degrades silently on a dense
        # engine, an explicit True there is a caller error
        prefix_cache = self.prefix_cache
        if prefix_cache is None:
            prefix_cache = os.environ.get(
                "REPRO_PREFIX_CACHE", "").lower() in ("1", "true")
        prefix_gaps = []
        if not paged:
            prefix_gaps.append("kv_layout='dense' — per-slot rows, "
                               "nothing to share")
        if has_slab:
            prefix_gaps.append(
                f"recurrent mixer(s) {_slab_mixers(cfg)} in "
                f"pattern={cfg.pattern} — slab state is per-sequence, "
                "not per-page")
        if has_cross:
            prefix_gaps.append(
                "enc_dec=True — decoder KV depends on the encoder "
                "output, so prompt pages are not shareable by token "
                "content (the cross region already shares the encoder "
                "pass by frames)")
        if prefix_cache and prefix_gaps:
            if self.prefix_cache is not None:
                raise ValueError("prefix_cache=True is unsupported here: "
                                 + "; ".join(prefix_gaps))
            prefix_cache = False

        # speculative decoding (paged only — the verify window rides the
        # paged chunk path). REPRO_SPEC_K=N enables with window N; spec_k
        # alone also enables. Same explicit-raise / env-degrade contract.
        env_k = int(os.environ.get("REPRO_SPEC_K", "0") or 0)
        raw_k = self.spec_k
        if raw_k == 0 and self.spec_decode is False:
            # a resolved "off" config that was replace()d and re-resolved
            raw_k = None
        if raw_k is not None and raw_k < 1:
            raise ValueError(f"spec_k must be >= 1, got {raw_k}")
        if self.spec_decode is False and raw_k is not None:
            raise ValueError(
                f"spec_k={raw_k} with spec_decode=False — drop one")
        explicit_spec = self.spec_decode is not None or raw_k is not None
        spec_decode = self.spec_decode
        if spec_decode is None:
            spec_decode = env_k > 0 or raw_k is not None
        spec_gaps = []
        if not paged:
            spec_gaps.append("kv_layout='dense' — the verify step scores "
                             "the draft window through the paged chunk "
                             "path")
        if has_slab:
            spec_gaps.append(
                f"recurrent mixer(s) {_slab_mixers(cfg)} in "
                f"pattern={cfg.pattern} — slab updates are destructive, "
                "a rejected draft tail cannot roll back")
        if spec_decode and spec_gaps:
            if explicit_spec:
                raise ValueError("spec_decode is unsupported here: "
                                 + "; ".join(spec_gaps))
            spec_decode = False
        if spec_decode:
            spec_k = raw_k if raw_k is not None else (env_k or DEFAULT_SPEC_K)
            if spec_k < 1:
                raise ValueError(f"spec_k must be >= 1, got {spec_k} "
                                 "(check REPRO_SPEC_K)")
        else:
            spec_k = 0

        # the fused ragged-decode tick (paged only), on by default;
        # REPRO_FUSED_DECODE=0 opts out
        fused_decode = self.fused_decode
        if fused_decode is None:
            fused_decode = os.environ.get(
                "REPRO_FUSED_DECODE", "1").lower() not in ("0", "false")
        if fused_decode and not paged:
            if self.fused_decode is not None:
                raise ValueError(
                    "fused_decode=True needs kv_layout='paged' — the "
                    "megakernel decodes through the paged page pools")
            fused_decode = False

        scheduler = self.scheduler
        if scheduler is None:
            scheduler = (os.environ.get("REPRO_SCHEDULER", "")
                         or ("cb" if paged else "fifo"))
        if scheduler not in ("fifo", "cb"):
            raise ValueError(
                f"scheduler must be 'fifo' or 'cb', got {scheduler!r} "
                "(check REPRO_SCHEDULER)")
        if scheduler == "cb" and not paged:
            if self.scheduler is not None:
                raise ValueError(
                    "scheduler='cb' needs kv_layout='paged' — preemption "
                    "offloads KV pages and the dense layout has none")
            scheduler = "fifo"

        # two-tier pool knobs (paged only): host_pages bounds the host
        # offload tier, prefix_cache_pages the cached-free prefix index
        env_host = os.environ.get("REPRO_HOST_PAGES", "")
        env_cache = os.environ.get("REPRO_PREFIX_CACHE_PAGES", "")
        host_pages = self.host_pages
        prefix_cache_pages = self.prefix_cache_pages
        if not paged and (host_pages is not None
                          or prefix_cache_pages is not None):
            raise ValueError(
                "host_pages / prefix_cache_pages need kv_layout='paged' — "
                "the dense layout has no page pool")
        if host_pages is None and env_host and paged:
            host_pages = int(env_host)
        if prefix_cache_pages is None and env_cache and paged:
            prefix_cache_pages = int(env_cache)

        # chunked prefill is paged only: the dense layout prefills whole
        # prompts and keeps the knob as given
        prefill_chunk = self.prefill_chunk
        if paged:
            prefill_chunk = (prefill_chunk
                             or int(os.environ.get("REPRO_PREFILL_CHUNK", 0))
                             or DEFAULT_PREFILL_CHUNK)
            if prefill_chunk < 1:
                raise ValueError(
                    f"prefill_chunk must be >= 1, got {prefill_chunk} "
                    "(check REPRO_PREFILL_CHUNK)")

        # tensor-parallel width, as in the reference: REPRO_SHARDS on a
        # dense engine degrades to 1, an explicit shards= there is a caller
        # error (the sharded engine head-shards the paged pools). Every
        # pattern shards; a leaf the port's forward cannot cut raises when
        # the engine cuts the params (sharding.ShardingPolicy).
        explicit_shards = self.shards is not None
        shards = self.shards
        if shards is None:
            shards = int(os.environ.get("REPRO_SHARDS", "1") or 1)
        if shards < 1:
            raise ValueError(f"shards must be >= 1, got {shards} "
                             "(check REPRO_SHARDS)")
        if shards > 1 and not paged:
            if explicit_shards:
                raise ValueError(
                    f"shards={shards} needs kv_layout='paged' — the "
                    "sharded engine head-shards the paged KV/state pools "
                    "over the model axis")
            shards = 1

        # data-parallel replicas: a router knob (serving/router.py)
        replicas = self.replicas
        if replicas is None:
            replicas = int(os.environ.get("REPRO_REPLICAS", "1") or 1)
        if replicas < 1:
            raise ValueError(f"replicas must be >= 1, got {replicas} "
                             "(check REPRO_REPLICAS)")

        kv_cache_dtype = _torch_dtype(self.kv_cache_dtype)
        if kv_cache_dtype not in (torch.float32, torch.bfloat16,
                                  torch.float16):
            raise _not_ported(f"kv_cache_dtype={kv_cache_dtype}",
                              "the other KV cache dtypes")

        return dataclasses.replace(
            self, kv_layout=kv_layout, kv_cache_dtype=kv_cache_dtype,
            prefix_cache=bool(prefix_cache), spec_decode=bool(spec_decode),
            spec_k=spec_k, fused_decode=bool(fused_decode),
            scheduler=scheduler, host_pages=host_pages,
            prefix_cache_pages=prefix_cache_pages,
            prefill_chunk=prefill_chunk, shards=shards, replicas=replicas,
            resolved=True)
