"""Checkpoint / resume for long solves.

The reference has NO persistence across process restarts — its only
"restart" is the in-memory LinkedList init flag (warm restart between
chained cycles, linkedlist.h:38-41), and its only persisted artifact is the
final CSV dump (MG_solver_CPU.cpp:453-459; SURVEY.md §5). For long
multi-host runs the framework needs real checkpointing: this module
saves/loads solver state (solution words, RHS, cycle counter, schedule
fingerprint) as a plain ``.npz`` plus JSON metadata — dependency-free and
host-architecture portable. Orbax integration can layer on top later; the
file format is deliberately dumb.

Checkpoints are written atomically (tmp + rename) so a preempted write never
corrupts the previous checkpoint — the failure-tolerance property that
matters on preemptible machines.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import tempfile
from pathlib import Path
from typing import Any, Optional

import jax
import numpy as np

FORMAT_VERSION = 1


def schedule_fingerprint(program) -> str:
    """Stable hash of a CycleProgram (schedule + geometry), for resume
    compatibility checks."""
    from ..schedule import to_cycle_file

    return hashlib.sha256(to_cycle_file(program).encode()).hexdigest()[:16]


@dataclasses.dataclass
class SolverState:
    """Everything needed to resume an iterative solve."""

    u: np.ndarray                       # solution / high word, (n, n)
    f: np.ndarray                       # RHS (n, n)
    u_lo: Optional[np.ndarray] = None   # second word (df32/tw32 state)
    u_lo2: Optional[np.ndarray] = None  # third word (tw32 state)
    cycle: int = 0                      # cycles completed
    meta: Optional[dict[str, Any]] = None


def save_checkpoint(path: str | os.PathLike, state: SolverState) -> None:
    """Atomically write ``state`` to ``path`` (.npz)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    arrays = {"u": np.asarray(jax.device_get(state.u)),
              "f": np.asarray(jax.device_get(state.f))}
    if state.u_lo is not None:
        arrays["u_lo"] = np.asarray(jax.device_get(state.u_lo))
    if state.u_lo2 is not None:
        arrays["u_lo2"] = np.asarray(jax.device_get(state.u_lo2))
    meta = dict(state.meta or {})
    meta.update({"cycle": int(state.cycle), "format_version": FORMAT_VERSION})
    arrays["_meta_json"] = np.frombuffer(
        json.dumps(meta).encode(), dtype=np.uint8)

    fd, tmp = tempfile.mkstemp(dir=path.parent, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as fh:
            np.savez(fh, **arrays)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def load_checkpoint(path: str | os.PathLike) -> SolverState:
    with np.load(path) as z:
        meta = json.loads(bytes(z["_meta_json"]).decode())
        if meta.get("format_version") != FORMAT_VERSION:
            raise ValueError(
                f"checkpoint {path} has format_version "
                f"{meta.get('format_version')}; expected {FORMAT_VERSION}")
        return SolverState(
            u=z["u"], f=z["f"],
            u_lo=z["u_lo"] if "u_lo" in z.files else None,
            u_lo2=z["u_lo2"] if "u_lo2" in z.files else None,
            cycle=meta.pop("cycle", 0), meta=meta)


class CheckpointManager:
    """Rotating checkpoints: keep the last ``keep`` files, save every
    ``every`` cycles. ``latest()`` resolves the resume point."""

    def __init__(self, directory: str | os.PathLike, every: int = 1,
                 keep: int = 3, prefix: str = "mg"):
        self.dir = Path(directory)
        self.every = max(1, every)
        self.keep = max(1, keep)
        self.prefix = prefix

    def _path(self, cycle: int) -> Path:
        return self.dir / f"{self.prefix}-{cycle:08d}.npz"

    def existing(self) -> list[Path]:
        if not self.dir.is_dir():
            return []
        return sorted(self.dir.glob(f"{self.prefix}-*.npz"))

    def latest(self) -> Optional[SolverState]:
        for path in reversed(self.existing()):
            try:
                return load_checkpoint(path)
            except (ValueError, OSError, KeyError):
                continue  # half-written/incompatible: fall back to older
        return None

    def maybe_save(self, state: SolverState) -> bool:
        """Save if ``state.cycle`` is on the cadence; prune old files."""
        if state.cycle % self.every != 0:
            return False
        save_checkpoint(self._path(state.cycle), state)
        for old in self.existing()[:-self.keep]:
            old.unlink(missing_ok=True)
        return True
