"""Local run ledger: dedup, resume, result store.

PyTorch port's counterpart of the JAX package's ``training/ledger.py``: a
JSON-lines file keyed by a stable hash of the config, with re-entrant
sweep semantics and no external service.  The format and ``config_hash``
are the JAX package's, so one ledger file serves both packages.
"""

from __future__ import annotations

import hashlib
import json
import os
import tempfile
from typing import Callable, List, Optional

__all__ = ["Ledger", "config_hash"]


def _canonical(obj):
    return json.dumps(obj, sort_keys=True, default=str)


def config_hash(config: dict) -> str:
    # best_params and other array-ish values never live in configs.
    return hashlib.sha256(_canonical(config).encode()).hexdigest()[:16]


class Ledger:
    """Append-only JSON-lines store; last entry per (hash, run_name) wins."""

    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)

    # -- IO ---------------------------------------------------------------

    def _read_all(self) -> List[dict]:
        if not os.path.exists(self.path):
            return []
        entries = {}
        with open(self.path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                entry = json.loads(line)
                entries[(entry["hash"], entry.get("run_name"))] = entry
        return list(entries.values())

    def _append(self, entry: dict):
        with open(self.path, "a") as f:
            f.write(json.dumps(entry, default=str) + "\n")

    # -- sweep semantics ---------------------------------------------------

    def check_if_run(self, config: dict, run_name: Optional[str] = None) -> bool:
        """True iff this config already completed (reference runs.py:53-57)."""
        h = config_hash(config)
        return any(
            e["hash"] == h and e.get("run_name") == run_name
            and e.get("status") == "completed"
            for e in self._read_all()
        )

    def mark_running(self, config: dict, run_name: Optional[str] = None) -> str:
        h = config_hash(config)
        self._append(
            {"hash": h, "run_name": run_name, "status": "running", "config": config}
        )
        return h

    def mark_failed(self, config: dict, run_name: Optional[str] = None,
                    error: str = "") -> str:
        """Failure sentinel (sweep watchdog / crash isolation): records WHY a
        config did not complete without counting as completed — dedup skips
        only ``completed`` entries and ``purge_incomplete_runs`` drops these,
        so a failed config is retried on the next sweep invocation (the
        reference's purge-and-retry contract, runs.py:45-57)."""
        h = config_hash(config)
        self._append(
            {"hash": h, "run_name": run_name, "status": "failed",
             "config": config, "error": error}
        )
        return h

    def save_result(self, config: dict, results: dict,
                    run_name: Optional[str] = None, info: Optional[dict] = None):
        results = {k: v for k, v in results.items() if k not in ("best_params",)}
        self._append(
            {
                "hash": config_hash(config),
                "run_name": run_name,
                "status": "completed",
                "config": config,
                "results": results,
                "info": info or {},
            }
        )

    def purge_incomplete_runs(self, run_name: Optional[str] = None) -> int:
        """Drop runs that never completed, making the sweep re-entrant after
        crashes (reference runs.py:50-52)."""
        entries = self._read_all()
        keep = [
            e for e in entries
            if e.get("status") == "completed" or e.get("run_name") != run_name
        ]
        dropped = len(entries) - len(keep)
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(os.path.abspath(self.path)))
        with os.fdopen(fd, "w") as f:
            for e in keep:
                f.write(json.dumps(e, default=str) + "\n")
        os.replace(tmp, self.path)
        return dropped

    def query(self, predicate: Callable[[dict], bool] = lambda e: True) -> List[dict]:
        return [e for e in self._read_all() if predicate(e)]
