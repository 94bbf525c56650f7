"""Data-parallel replica routing on top of the serving engine (the
reference's ``repro.serving.router``).

``ReplicaRouter`` owns N independent ``ServeEngine`` replicas of the same
model: the data-parallel tier above tensor parallelism. Each replica has
its own state cache with a **per-replica page budget** (an explicit
``pool_pages``/``host_pages``/``prefix_cache_pages`` total is split across
replicas; the defaults are already per-replica) and, when the config also
shards (``shards > 1``), its own **disjoint device slice**: replica i runs
on devices ``[i*shards, (i+1)*shards)`` of ``launch.hostdev.device_list()``.
With ``shards == 1`` the replicas share the runtime's one device.

Requests route at submit time to the least-loaded replica (queued +
resident, ties to the lowest index: deterministic, so a replayed request
wave lands identically). The router mirrors the engine's public surface
(``submit`` / ``step`` / ``run`` / ``has_work`` / ``stream`` / ``cancel``
/ ``metrics`` / ``reset_metrics``); per-rid calls route through the
submit-time map, and ``metrics()`` merges the fleet: summed counters,
latency/TTFT percentiles recomputed over the union of finished requests,
fleet-total peak bytes, and the untouched per-replica dicts under
``"per_replica"``.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.configs.base import ArchConfig
from repro_torch.launch import hostdev
from repro_torch.runtime import Runtime
from repro_torch.serving.config import ServeConfig
from repro_torch.serving.engine import Request, ServeEngine

__all__ = ["ReplicaRouter"]


def _split_budget(total: Optional[int], n: int) -> Optional[int]:
    """An explicit pool total split across n replicas (>= 1 each); None
    (engine-derived default) is already per-replica."""
    if total is None:
        return None
    return max(1, total // n)


class ReplicaRouter:
    def __init__(self, params, cfg: ArchConfig,
                 config: ServeConfig | None = None, *,
                 rt: Runtime | None = None, devices=None):
        sc = (config or ServeConfig()).resolve(cfg)
        self.cfg = cfg
        self.config = sc
        self.replicas = sc.replicas
        per_replica = sc.replace(
            replicas=1,
            pool_pages=_split_budget(sc.pool_pages, sc.replicas),
            host_pages=_split_budget(sc.host_pages, sc.replicas),
            prefix_cache_pages=_split_budget(sc.prefix_cache_pages,
                                             sc.replicas))
        self.engines: list[ServeEngine] = []
        devs = None
        if sc.shards > 1:
            devs = (list(devices) if devices is not None
                    else hostdev.device_list((rt or Runtime()).device))
            if sc.replicas * sc.shards > len(devs):
                raise ValueError(
                    f"replicas={sc.replicas} x shards={sc.shards} needs "
                    f"{sc.replicas * sc.shards} devices, have {len(devs)} "
                    f"— set {hostdev.FORCE_ENV}=N to run N shards on one "
                    "device (repro_torch.launch.hostdev)")
        for i in range(sc.replicas):
            # single-device replicas share the runtime's device
            slice_ = (None if devs is None
                      else devs[i * sc.shards:(i + 1) * sc.shards])
            self.engines.append(ServeEngine(params, cfg, per_replica,
                                            rt=rt, devices=slice_))
        self._rid_replica: dict[int, int] = {}

    # -- routing -------------------------------------------------------------

    def _load(self, eng: ServeEngine) -> int:
        return len(eng.queue) + sum(r is not None for r in eng.slot_req)

    def submit(self, req: Request) -> int:
        """Route to the least-loaded replica (deterministic tie-break).
        Returns the replica index the request landed on."""
        if req.rid in self._rid_replica:
            # each engine checks its own rids; the router catches the
            # cross-replica collision they cannot see
            raise ValueError(
                f"request id {req.rid} already routed to replica "
                f"{self._rid_replica[req.rid]}")
        idx = min(range(self.replicas),
                  key=lambda i: (self._load(self.engines[i]), i))
        self.engines[idx].submit(req)
        self._rid_replica[req.rid] = idx
        return idx

    def _engine_for(self, rid: int) -> ServeEngine:
        idx = self._rid_replica.get(rid)
        if idx is None:
            raise KeyError(f"request {rid}: unknown rid (never routed)")
        return self.engines[idx]

    # -- engine surface ------------------------------------------------------

    def has_work(self) -> bool:
        return any(e.has_work() for e in self.engines)

    def step(self):
        """One tick on every replica with live work (arrival-process
        drivers interleave this with submit())."""
        for e in self.engines:
            if e.has_work():
                e.step()

    @property
    def finished(self):
        """Merged finished list in completion-time order."""
        done = [r for e in self.engines for r in e.finished]
        done.sort(key=lambda r: r.t_done)
        return done

    def run(self, max_steps: int = 10_000, *, strict: bool = True):
        """Drain every replica; replicas are independent (no shared
        cache), so they drain one after another. Returns the merged
        finished list in completion-time order."""
        for e in self.engines:
            if e.has_work():
                e.run(max_steps, strict=strict)
        return self.finished

    def stream(self, rid: int):
        return self._engine_for(rid).stream(rid)

    def cancel(self, rid: int) -> bool:
        return self._engine_for(rid).cancel(rid)

    def reset_metrics(self):
        for e in self.engines:
            e.reset_metrics()
        # keep only rids still live somewhere (the engines prune their
        # stream state the same way), so stream()/cancel() stay routable
        self._rid_replica = {rid: i for rid, i in self._rid_replica.items()
                             if rid in self.engines[i]._streams}

    # -- merged metrics ------------------------------------------------------

    _SUM_KEYS = ("requests_finished", "requests_cancelled",
                 "tokens_generated", "engine_steps", "model_calls",
                 "wall_s", "undrained_runs", "peak_kv_bytes",
                 "peak_state_bytes")

    def metrics(self) -> dict:
        """Fleet view: summed counters, percentiles recomputed over the
        union of finished requests, per-replica dicts under
        ``per_replica``."""
        per = [e.metrics() for e in self.engines]
        out: dict = {"replicas": self.replicas,
                     "shards": self.config.shards,
                     "requests_per_replica":
                         [len(e.finished) for e in self.engines]}
        for k in self._SUM_KEYS:
            out[k] = type(per[0][k])(sum(m[k] for m in per))
        wall = out["wall_s"]
        out["tokens_per_s"] = (out["tokens_generated"] / wall
                               if wall else 0.0)
        fin = [r for e in self.engines for r in e.finished]
        lat = [r.t_done - r.t_enqueue for r in fin]
        ttft = [r.t_first_token - r.t_enqueue for r in fin]
        out["ttft_p50_ms"] = 1e3 * float(np.median(ttft)) if ttft else 0.0
        out["ttft_p95_ms"] = (1e3 * float(np.percentile(ttft, 95))
                              if ttft else 0.0)
        out["latency_p50_ms"] = 1e3 * float(np.median(lat)) if lat else 0.0
        out["latency_p95_ms"] = (1e3 * float(np.percentile(lat, 95))
                                 if lat else 0.0)
        out["per_replica"] = per
        return out
