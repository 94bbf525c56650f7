"""Single source of truth for the tier-1 CI test shards.

The CI workflow runs the tier-1 suite as three parallel shards. Sharding
is by ``--ignore`` lists rather than explicit file arguments, so pytest
still collects the ``tests/`` directory in every shard — ``conftest.py``'s
``collect_ignore`` (hypothesis-less environments) keeps working, and a
test file missing from every shard's map *runs everywhere* rather than
silently nowhere. This module owns the shard → test-file map; the
workflow derives each shard's pytest arguments from it and the ``checks``
job asserts the map is disjoint and exhaustive, so adding a test file
without assigning it here fails CI fast.

  python tools/ci_shards.py --check              # disjoint + exhaustive?
  python tools/ci_shards.py --ignore-args core   # pytest args for a shard
  python tools/ci_shards.py --list               # shard names

Keep shards time-balanced (each CI shard has a 30-minute budget;
``--durations=15`` in the workflow log shows the slowest tests per
shard) — rebalance by moving files between lists, nothing else to edit.
"""
from __future__ import annotations

import argparse
import glob
import os
import sys

REPO = os.path.normpath(os.path.join(os.path.dirname(__file__), ".."))

#: shard name -> test files it runs (paths relative to the repo root).
#: Every tests/test_*.py must appear in exactly one list (--check).
SHARDS: dict[str, list[str]] = {
    # kernels/runtime/quant math/docs — many small fast tests
    "core": [
        "tests/test_attention.py",
        "tests/test_ci_shards.py",
        "tests/test_docs.py",
        "tests/test_kernels.py",
        "tests/test_moe.py",
        "tests/test_runtime.py",
        "tests/test_spx_quant.py",
        "tests/test_ssm.py",
        "tests/test_torch_dense.py",
        "tests/test_torch_interop.py",
        "tests/test_torch_kernels.py",
        "tests/test_torch_mlp.py",
        "tests/test_torch_moe.py",
        "tests/test_torch_spx.py",
        "tests/test_torch_ssm.py",
    ],
    # serving engine + model-level serving paths
    "serving-models": [
        "tests/test_fused_decode.py",
        "tests/test_kv_quant.py",
        "tests/test_models_smoke.py",
        "tests/test_prefix_cache.py",
        "tests/test_scheduler.py",
        "tests/test_serving.py",
        "tests/test_spec_decode.py",
        "tests/test_state_cache.py",
        "tests/test_streaming.py",
        "tests/test_torch_kv_quant.py",
        "tests/test_torch_lm.py",
        "tests/test_torch_prefix.py",
        "tests/test_torch_serving.py",
        "tests/test_torch_encdec.py",
        "tests/test_torch_router.py",
        "tests/test_torch_sharding.py",
        "tests/test_torch_spec.py",
        "tests/test_torch_state_cache.py",
    ],
    # multi-device dry-runs + training loops — few long tests
    "system-training": [
        "tests/test_sharding.py",
        "tests/test_system.py",
        "tests/test_torch_dryrun.py",
        "tests/test_torch_training.py",
        "tests/test_training.py",
    ],
    # tensor-parallel serving: runs under forced host devices
    # (XLA_FLAGS=--xla_force_host_platform_device_count=8 in CI)
    "sharded": [
        "tests/test_sharded_serving.py",
    ],
}


def discovered_test_files(repo: str = REPO) -> list[str]:
    """The tier-1 test files on disk (what pytest would collect from)."""
    return sorted(os.path.relpath(p, repo).replace(os.sep, "/")
                  for p in glob.glob(os.path.join(repo, "tests",
                                                  "test_*.py")))


def check(shards: dict[str, list[str]] | None = None,
          test_files: list[str] | None = None) -> list[str]:
    """Failure messages (empty = the map is disjoint and exhaustive).

    ``shards``/``test_files`` default to the real map and the files on
    disk; tests inject broken maps to pin the failure modes.
    """
    shards = SHARDS if shards is None else shards
    test_files = (discovered_test_files() if test_files is None
                  else test_files)
    failures = []
    seen: dict[str, str] = {}
    for name, files in shards.items():
        for f in files:
            if f in seen:
                failures.append(
                    f"{f}: assigned to both '{seen[f]}' and '{name}' — "
                    f"shards must be disjoint")
            seen[f] = name
    on_disk = set(test_files)
    for f in sorted(set(seen) - on_disk):
        failures.append(
            f"{f}: in shard '{seen[f]}' but not on disk — remove the "
            f"stale entry")
    for f in sorted(on_disk - set(seen)):
        failures.append(
            f"{f}: not assigned to any shard — add it to exactly one "
            f"list in tools/ci_shards.py (until then it runs in EVERY "
            f"shard)")
    return failures


def ignore_args(shard: str,
                shards: dict[str, list[str]] | None = None) -> list[str]:
    """``--ignore=<file>`` pytest arguments selecting ``shard``: ignore
    every file the *other* shards own. Files missing from the whole map
    are deliberately not ignored anywhere (they run in every shard until
    ``--check`` makes someone assign them)."""
    shards = SHARDS if shards is None else shards
    if shard not in shards:
        raise KeyError(
            f"unknown shard {shard!r}; have {sorted(shards)}")
    others = sorted(f for name, files in shards.items()
                    if name != shard for f in files)
    return [f"--ignore={f}" for f in others]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    g = ap.add_mutually_exclusive_group(required=True)
    g.add_argument("--check", action="store_true",
                   help="assert shards are disjoint + exhaustive over "
                        "tests/test_*.py")
    g.add_argument("--ignore-args", metavar="SHARD",
                   help="print the pytest --ignore args for one shard")
    g.add_argument("--list", action="store_true",
                   help="print the shard names")
    args = ap.parse_args(argv)
    if args.list:
        print("\n".join(sorted(SHARDS)))
        return 0
    if args.check:
        failures = check()
        for msg in failures:
            print(f"[ci-shards] FAIL {msg}")
        if not failures:
            n = sum(len(v) for v in SHARDS.values())
            print(f"[ci-shards] OK ({len(SHARDS)} shards, {n} test files)")
        return 1 if failures else 0
    try:
        print(" ".join(ignore_args(args.ignore_args)))
    except KeyError as e:
        print(f"[ci-shards] {e.args[0]}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
