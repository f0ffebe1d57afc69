"""Synthetic data pipeline: deterministic token streams, staged onto a
device from a background thread, with mid-epoch restore (the checkpointer
records the pipeline cursor so restarts are exactly-once) — the port of
``repro/data/pipeline.py``.  ``TokenPipeline`` is the reference's numpy
code, copied, so both packages draw the same batches bit for bit."""

from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional

import numpy as np
import torch

from ..core.placement import from_local, leading_spec, local_slice, placements

class TokenPipeline:
    """Deterministic synthetic LM batches.

    Yields {"tokens": [B, S], "labels": [B, S]} numpy batches; ``state()``
    returns the cursor for checkpointing, ``restore(cursor)`` resumes.
    Structure mirrors a real pipeline (file shards -> sample iterator ->
    batcher -> device placement) with the file layer replaced by a PRNG.
    """

    def __init__(self, vocab: int, batch: int, seq: int, seed: int = 0,
                 enc_seq: int = 0, d_model: int = 0):
        self.vocab, self.batch, self.seq = vocab, batch, seq
        self.enc_seq, self.d_model = enc_seq, d_model
        self.seed = seed
        self._cursor = 0

    def state(self) -> dict:
        return {"cursor": self._cursor, "seed": self.seed}

    def restore(self, state: dict):
        self._cursor = int(state["cursor"])
        self.seed = int(state["seed"])

    def _make(self, idx: int) -> dict:
        rng = np.random.default_rng((self.seed, idx))
        # zipf-ish marginal over the vocab — realistic logit scales
        z = rng.zipf(1.3, (self.batch, self.seq + 1))
        tokens = np.minimum(z - 1, self.vocab - 1).astype(np.int32)
        out = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
        if self.enc_seq:
            out["enc_embeddings"] = rng.normal(
                0, 1, (self.batch, self.enc_seq, self.d_model)
            ).astype(np.float32)
        return out

    def __iter__(self) -> Iterator[dict]:
        while True:
            b = self._make(self._cursor)
            self._cursor += 1
            yield b


class DevicePrefetcher:
    """A background thread that draws the next ``depth`` batches of
    ``pipeline`` and stages them on ``device``, so the step loop never
    waits for the host's draw or the copy.

    On a CUDA device each batch goes through pinned host buffers on a
    side stream; the thread waits for the copy to end before it lets the
    pinned buffers go, and ``__next__`` orders the caller's stream after
    the copy and marks the tensors used there (``record_stream``), so the
    allocator does not hand their memory to the next copy too early.
    ``state()`` is the pipeline's cursor after the last batch handed out
    (the thread runs ahead of it), the one to checkpoint.

    With ``mesh`` each batch is placed on the mesh's data axes: this rank
    stages only its own rows (``batch_spec`` for [B, S] leaves, the rows
    alone for the others) and gets DTensors of the global batch."""

    def __init__(self, pipeline: TokenPipeline, device, depth: int = 2,
                 mesh=None):
        self.mesh = mesh
        self.pipeline = pipeline
        self.device = torch.device(device)
        self._state = pipeline.state()
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device.type == "cuda" else None)
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="pop-prefetch")
        self._thread.start()

    def _places(self, ndim: int):
        return placements(leading_spec(self.mesh, ndim), self.mesh)

    def _rows(self, batch: dict) -> dict:
        """This rank's rows of each leaf (all of them without a mesh)."""
        out = {k: torch.from_numpy(np.ascontiguousarray(v))
               for k, v in batch.items()}
        if self.mesh is None:
            return out
        return {k: local_slice(t, self._places(t.ndim), self.mesh)
                .contiguous() for k, t in out.items()}

    def _as_global(self, out: dict, shapes: dict) -> dict:
        if self.mesh is None:
            return out
        return {k: from_local(t, self._places(t.ndim), self.mesh, shapes[k])
                for k, t in out.items()}

    def _place(self, batch: dict):
        rows = self._rows(batch)
        if self._stream is None:
            return {k: t.to(self.device) for k, t in rows.items()}, None
        with torch.cuda.stream(self._stream):
            pinned = [(k, t.pin_memory()) for k, t in rows.items()]
            out = {k: h.to(self.device, non_blocking=True)
                   for k, h in pinned}
            done = torch.cuda.Event()
            done.record(self._stream)
        done.synchronize()          # the pinned buffers may go now
        return out, done

    def _offer(self, item) -> bool:
        """Put ``item`` on the queue unless ``close()`` comes first."""
        while not self._stop.is_set():
            try:
                self.q.put(item, timeout=0.1)
                return True
            except queue.Full:
                pass
        return False

    def _run(self):
        try:
            it = iter(self.pipeline)
            while not self._stop.is_set():
                batch = next(it)
                staged = self._place(batch) + (
                    {k: v.shape for k, v in batch.items()},)
                if not self._offer((staged, self.pipeline.state())):
                    return
        except Exception as exc:     # handed to the consumer, not lost
            self._offer((exc, None))

    def __next__(self) -> dict:
        staged, state = self.q.get()
        if isinstance(staged, Exception):
            raise RuntimeError("the prefetch thread failed") from staged
        out, done, shapes = staged
        if done is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(done)
            for t in out.values():
                t.record_stream(stream)
        self._state = state
        return self._as_global(out, shapes)

    def state(self) -> dict:
        return dict(self._state)

    def close(self, timeout: float = 10.0):
        """Stop the thread (it never blocks on a full queue) and drop what
        it staged."""
        self._stop.set()
        try:
            while True:
                self.q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout)
