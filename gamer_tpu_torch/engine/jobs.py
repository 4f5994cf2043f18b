"""Checkpointed dataset-generation jobs, the counterpart of
``gamer_tpu.engine.jobs``: many scenes rendered to .npy chunks through
``render_batch`` (K4), with a JSON manifest of finished chunks, so an
interrupted job restarts where it stopped. Each chunk is a pure function of
its scenes, so a resumed job writes the same bytes as one that ran through.
With ``mesh`` each chunk is one ``render_batch(..., mesh=...)`` call: its
frames over the mesh's batch axis (S2), as ``render_batch`` spreads them.
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Callable, Optional, Sequence

import numpy as np

from ..scene.schema import Scene
from ..utils.log import Messages
from .batch import render_batch


class DatasetJob:
    """Render many scenes to .npy chunks with manifest-based resume.

    out_dir/
      manifest.json      {chunk_size, n_scenes, done: [chunk indices]}
      chunk_00042.npy    (chunk_size, S, S, 3) uint8
    """

    def __init__(self, scenes: Sequence[Scene], out_dir: str,
                 chunk_size: int = 16, device="cuda", mesh=None):
        """``device`` renders the chunks; with ``mesh`` (a 1-D batch mesh or
        a ('batch', 'rows') one) each chunk is spread over the mesh and
        ``device`` is not consulted, as in ``render_batch``."""
        self.scenes = list(scenes)
        self.out_dir = Path(out_dir)
        self.chunk_size = chunk_size
        self.device = device
        self.mesh = mesh
        self.out_dir.mkdir(parents=True, exist_ok=True)
        self.manifest_path = self.out_dir / "manifest.json"
        self.manifest = self._load_manifest()

    def _load_manifest(self) -> dict:
        if self.manifest_path.exists():
            m = json.loads(self.manifest_path.read_text())
            if m.get("n_scenes") != len(self.scenes) or \
               m.get("chunk_size") != self.chunk_size:
                raise ValueError(
                    "manifest does not match this job "
                    f"({m.get('n_scenes')} scenes/chunk {m.get('chunk_size')} "
                    f"vs {len(self.scenes)}/{self.chunk_size}); use a fresh "
                    "out_dir or matching parameters"
                )
            return m
        return {"n_scenes": len(self.scenes), "chunk_size": self.chunk_size,
                "done": []}

    def _save_manifest(self) -> None:
        self.manifest_path.write_text(json.dumps(self.manifest))

    @property
    def n_chunks(self) -> int:
        return -(-len(self.scenes) // self.chunk_size)

    @property
    def remaining(self) -> list:
        done = set(self.manifest["done"])
        return [c for c in range(self.n_chunks) if c not in done]

    def run(self, on_chunk: Optional[Callable[[int, float], None]] = None) -> int:
        """Render all remaining chunks; returns the number rendered now."""
        rendered = 0
        for c in self.remaining:
            t0 = time.perf_counter()
            lo = c * self.chunk_size
            batch_scenes = self.scenes[lo:lo + self.chunk_size]
            frames = render_batch(batch_scenes, device=self.device,
                                  mesh=self.mesh)
            np.save(self.out_dir / f"chunk_{c:05d}.npy", frames)
            self.manifest["done"].append(c)
            self._save_manifest()
            rendered += 1
            dt = time.perf_counter() - t0
            Messages.message(
                f"dataset chunk {c + 1}/{self.n_chunks} "
                f"({len(batch_scenes)} frames, {dt:.1f}s)")
            if on_chunk is not None:
                on_chunk(c, dt)
        return rendered

    def load_all(self) -> np.ndarray:
        """Concatenate every finished chunk (must be complete)."""
        if self.remaining:
            raise RuntimeError(f"job incomplete: chunks {self.remaining} missing")
        parts = [np.load(self.out_dir / f"chunk_{c:05d}.npy")
                 for c in range(self.n_chunks)]
        return np.concatenate(parts, axis=0)
