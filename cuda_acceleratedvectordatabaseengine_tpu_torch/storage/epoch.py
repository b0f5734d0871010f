"""Epoch manager: versioned index snapshots with zero-downtime activation.

Mirror of ``EpochManager`` (F5, ``format/storage.h:175-209``,
``format/storage.cpp:305-579``): timestamp-ns epoch ids, create → activate
single-active switch, keep-last-N GC of inactive epochs, and crash recovery
from a persisted ``epochs.json`` registry. Registry writes are
atomic-rename, so a crash mid-update never corrupts state.

A copy of the JAX package's ``storage/epoch.py`` (the port imports
nothing of that package).
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time


class EpochManager:
    REGISTRY = "epochs.json"

    def __init__(self, base_dir: str, keep_epochs: int = 3):
        self.base_dir = base_dir
        self.keep_epochs = keep_epochs
        self._lock = threading.RLock()
        # {index_name: {"active": str | None, "epochs": {epoch_id: meta}}}
        self._state: dict = {}
        os.makedirs(base_dir, exist_ok=True)
        self._recover()

    # ------------------------------------------------------------------ #
    # registry persistence (``format/storage.cpp:481-579``)
    # ------------------------------------------------------------------ #

    def _registry_path(self) -> str:
        return os.path.join(self.base_dir, self.REGISTRY)

    def _persist(self) -> None:
        tmp = self._registry_path() + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self._state, f, indent=2)
        os.replace(tmp, self._registry_path())

    def _recover(self) -> None:
        path = self._registry_path()
        if os.path.exists(path):
            with open(path) as f:
                self._state = json.load(f)
        # Drop registry entries whose directories vanished.
        for name, st in list(self._state.items()):
            for eid in list(st["epochs"]):
                if not os.path.isdir(self.epoch_dir(name, eid)):
                    del st["epochs"][eid]
                    if st["active"] == eid:
                        st["active"] = None

    # ------------------------------------------------------------------ #
    # epoch lifecycle
    # ------------------------------------------------------------------ #

    def epoch_dir(self, index_name: str, epoch_id: str) -> str:
        return os.path.join(self.base_dir, index_name, "epochs", epoch_id)

    def create_epoch(self, index_name: str) -> tuple[str, str]:
        """Allocate a new (inactive) epoch directory; returns (id, dir).
        The caller writes the snapshot into it, then ``activate_epoch``."""
        with self._lock:
            epoch_id = str(time.time_ns())
            d = self.epoch_dir(index_name, epoch_id)
            os.makedirs(d, exist_ok=True)
            st = self._state.setdefault(
                index_name, {"active": None, "epochs": {}}
            )
            st["epochs"][epoch_id] = {
                "created_at_ns": time.time_ns(), "state": "inactive",
            }
            self._persist()
            return epoch_id, d

    def activate_epoch(self, index_name: str, epoch_id: str) -> str:
        """Single-active atomic switch (``format/storage.cpp:351-375``);
        returns the activated snapshot directory. The previously active
        epoch becomes inactive (and revertable until GC'd)."""
        with self._lock:
            st = self._state.get(index_name)
            if not st or epoch_id not in st["epochs"]:
                raise KeyError(
                    f"unknown epoch {epoch_id!r} for index {index_name!r}"
                )
            prev = st["active"]
            if prev and prev in st["epochs"]:
                st["epochs"][prev]["state"] = "inactive"
            st["epochs"][epoch_id]["state"] = "active"
            st["active"] = epoch_id
            self._persist()
            self.cleanup_old_epochs(index_name)
            return self.epoch_dir(index_name, epoch_id)

    def deactivate_epoch(self, index_name: str, epoch_id: str) -> None:
        with self._lock:
            st = self._state.get(index_name)
            if not st or epoch_id not in st["epochs"]:
                return
            st["epochs"][epoch_id]["state"] = "inactive"
            if st["active"] == epoch_id:
                st["active"] = None
            self._persist()

    def cleanup_old_epochs(self, index_name: str) -> int:
        """Delete oldest inactive epochs beyond ``keep_epochs``
        (``format/storage.cpp:430-462``). Returns number deleted."""
        with self._lock:
            st = self._state.get(index_name)
            if not st:
                return 0
            inactive = sorted(
                (e for e, m in st["epochs"].items() if m["state"] != "active"),
                key=lambda e: st["epochs"][e]["created_at_ns"],
            )
            doomed = inactive[: max(0, len(inactive) - self.keep_epochs)]
            for eid in doomed:
                shutil.rmtree(
                    self.epoch_dir(index_name, eid), ignore_errors=True
                )
                del st["epochs"][eid]
            if doomed:
                self._persist()
            return len(doomed)

    # ------------------------------------------------------------------ #
    # queries
    # ------------------------------------------------------------------ #

    def active_epoch(self, index_name: str) -> str | None:
        with self._lock:
            st = self._state.get(index_name)
            return st["active"] if st else None

    def active_dir(self, index_name: str) -> str | None:
        eid = self.active_epoch(index_name)
        return self.epoch_dir(index_name, eid) if eid else None

    def list_epochs(self, index_name: str) -> dict:
        with self._lock:
            st = self._state.get(index_name, {"active": None, "epochs": {}})
            return json.loads(json.dumps(st))  # deep copy

    def list_indices(self) -> list[str]:
        with self._lock:
            return sorted(self._state)
