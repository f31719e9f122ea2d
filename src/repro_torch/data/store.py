"""Host-resident chunked example store: the dataset that does not fit
next to the master (the port's copy of ``src/repro/data/store.py``).

Examples live in host memory as fixed-size chunks with a stable global
index space

    global index g  ->  chunk g // chunk_size, offset g % chunk_size

and shard d of D owns the contiguous chunk range [d·K, (d+1)·K),
K = num_chunks // D.  One device's store holds every chunk; a rank of a
data group's (``from_arrays(..., shard=(rank, world))``) holds only its
own range, under the same global indices, and a read or write of a
foreign chunk raises ``ForeignChunkError``: no process keeps the whole
dataset.  Chunks are CPU tensors; with ``pin_memory`` each one is its
own page-locked allocation of PyTorch's caching host allocator, so that
host→device copies from it can be asynchronous.  ``data/streaming.py``
keeps a bounded window of chunks on the device and fetches the rest
from here.

A device copy that is still reading a chunk is guarded: the plane
registers the copy's event with ``guard_reads``, and ``write_rows``
waits for it before it writes that chunk, so a copy always sees the
chunk as it was when the copy was enqueued.  ``write_rows`` also counts
the writes to each chunk (``write_count``), so that the plane can tell a
resident chunk whose device copy is still current from one written since.
"""
from __future__ import annotations

from typing import Iterator, Mapping

import numpy as np
import torch

from repro_torch.core.sampler import index_to_chunk


def _host(v) -> torch.Tensor:
    """A CPU tensor of ``v`` (a tensor on any device, or an array)."""
    if isinstance(v, torch.Tensor):
        return v.detach().cpu()
    return torch.from_numpy(np.ascontiguousarray(v))


def _is_run(a: np.ndarray) -> bool:
    """Whether ``a`` counts up by one from its first entry."""
    return a.size > 0 and a[-1] - a[0] == a.size - 1 and \
        bool(np.all(np.diff(a) == 1))


def _index(gidx) -> np.ndarray:
    return np.asarray(gidx.cpu() if isinstance(gidx, torch.Tensor)
                      else gidx).reshape(-1).astype(np.int64)


class ForeignChunkError(IndexError):
    """A read or write of a chunk that another rank's store holds."""


class ChunkedExampleStore:
    """Fixed-size host chunks of an example-axis dict of tensors: every
    chunk, or with ``shard=(rank, world)`` rank ``rank``'s contiguous
    range of ``num_chunks`` chunks, starting at global chunk
    ``shard_chunks(rank, world).start``."""

    def __init__(self, chunks: list[dict[str, torch.Tensor]],
                 chunk_size: int, pin_memory: bool = False,
                 shard: tuple[int, int] = (0, 1)):
        if not chunks:
            raise ValueError("need at least one chunk")
        rank, world = shard
        if not 0 <= rank < world:
            raise ValueError(f"shard {shard}: rank out of range({world})")
        self.chunk_size = int(chunk_size)
        self.pin_memory = bool(pin_memory)
        self.shard = (int(rank), int(world))
        self._first = rank * len(chunks)
        self._chunks = chunks
        self._guards: dict[int, object] = {}
        self._writes = [0] * len(chunks)
        for c, chunk in enumerate(chunks):
            for k, v in chunk.items():
                if v.shape[0] != self.chunk_size:
                    raise ValueError(
                        f"chunk {self._first + c} array {k!r} has "
                        f"{v.shape[0]} rows, expected "
                        f"chunk_size={self.chunk_size}")

    @classmethod
    def from_arrays(cls, arrays: Mapping, chunk_size: int,
                    pin_memory: bool = False,
                    shard: tuple[int, int] = (0, 1),
                    reserve_chunks: int = 0) -> "ChunkedExampleStore":
        """Chunk a dict of tensors (on any device) or numpy arrays into
        host memory, each chunk its own allocation (pinned with
        ``pin_memory``); nothing references the inputs afterwards.
        ``reserve_chunks`` zero chunks follow the data in the global index
        space (the serving loop's traffic capacity), laid out before the
        split.  With ``shard=(rank, world)`` only that rank's chunk range
        is copied."""
        n = next(iter(arrays.values())).shape[0]
        for k, v in arrays.items():
            if v.shape[0] != n:
                raise ValueError(f"array {k!r} has {v.shape[0]} rows, "
                                 f"others have {n}")
        if chunk_size <= 0 or n % chunk_size:
            raise ValueError(f"chunk_size={chunk_size} must divide the "
                             f"example count {n}")
        rank, world = shard
        n_data = n // chunk_size
        total = n_data + reserve_chunks
        if total % world:
            raise ValueError(f"{total} chunks of {chunk_size} rows do not "
                             f"split over {world} ranks: a chunk may not "
                             f"straddle ranks")
        per = total // world
        chunks = []
        for c in range(rank * per, (rank + 1) * per):
            rows = slice(c * chunk_size, (c + 1) * chunk_size)
            chunk = {}
            for k, v in arrays.items():
                if c >= n_data:
                    chunk[k] = torch.zeros(
                        (chunk_size,) + tuple(v.shape[1:]),
                        dtype=_host(v[:1]).dtype, pin_memory=pin_memory)
                    continue
                part = v[rows]
                if not isinstance(part, torch.Tensor):
                    part = torch.from_numpy(np.ascontiguousarray(part))
                out = torch.empty(part.shape, dtype=part.dtype,
                                  pin_memory=pin_memory)
                out.copy_(part)
                chunk[k] = out
            chunks.append(chunk)
        return cls(chunks, chunk_size, pin_memory=pin_memory, shard=shard)

    # ---- shape / layout ---------------------------------------------------

    @property
    def num_chunks(self) -> int:
        """Chunks of the global index space (chunks x chunk_size rows),
        those of other ranks included."""
        return len(self._chunks) * self.shard[1]

    @property
    def held_chunks(self) -> range:
        """The global ids of the chunks this store holds."""
        return range(self._first, self._first + len(self._chunks))

    def _local(self, c: int) -> int:
        """Chunk ``c``'s position in this store, or ForeignChunkError."""
        i = int(c) - self._first
        if not 0 <= i < len(self._chunks):
            held = self.held_chunks
            raise ForeignChunkError(
                f"chunk {int(c)} is not held by this store: rank "
                f"{self.shard[0]} of {self.shard[1]} holds chunks "
                f"[{held.start}, {held.stop})")
        return i

    @property
    def num_examples(self) -> int:
        """Total examples across all chunks."""
        return self.num_chunks * self.chunk_size

    @property
    def keys(self) -> tuple[str, ...]:
        """The per-example array names."""
        return tuple(self._chunks[0].keys())

    def row_shape(self, key: str) -> tuple:
        """Trailing (per-row) shape of array ``key``."""
        return tuple(self._chunks[0][key].shape[1:])

    def dtype(self, key: str) -> torch.dtype:
        """Dtype of array ``key``."""
        return self._chunks[0][key].dtype

    def nbytes(self) -> int:
        """Host bytes of the chunks this store holds."""
        return sum(v.numel() * v.element_size()
                   for c in self._chunks for v in c.values())

    def shard_chunks(self, shard: int, n_shards: int) -> range:
        """The contiguous chunk range shard ``shard`` of ``n_shards``
        owns."""
        if self.num_chunks % n_shards:
            raise ValueError(f"num_chunks={self.num_chunks} not divisible "
                             f"by {n_shards} shards")
        per = self.num_chunks // n_shards
        if not 0 <= shard < n_shards:
            raise ValueError(f"shard {shard} out of range({n_shards})")
        return range(shard * per, (shard + 1) * per)

    def owner_shard(self, chunk, n_shards: int):
        """Which shard owns a chunk (vectorized over arrays)."""
        return chunk // (self.num_chunks // n_shards)

    # ---- growth (serving-loop traffic ingest) -----------------------------

    def _alloc(self, shape, dtype) -> torch.Tensor:
        return torch.zeros(shape, dtype=dtype, pin_memory=self.pin_memory)

    def zeros_chunk(self) -> dict[str, torch.Tensor]:
        """A fresh all-zero chunk of this store's schema."""
        return {k: self._alloc((self.chunk_size,) + self.row_shape(k),
                               self.dtype(k)) for k in self.keys}

    def append_chunk(self, chunk: Mapping | None = None) -> int:
        """Append one chunk (default: zeros) and return its chunk id.
        Existing rows keep their indices; the serving loop reserves its
        traffic capacity this way and fills it with ``write_rows``.  A
        rank's store of a larger world refuses: growth would move every
        rank's contiguous chunk range."""
        if self.shard[1] > 1:
            raise ValueError(
                f"a store of rank {self.shard[0]} of {self.shard[1]} cannot "
                f"grow: chunk ownership is laid out as contiguous ranges; "
                f"append reserve chunks before sharding the store")
        if chunk is None:
            chunk = self.zeros_chunk()
        if set(chunk.keys()) != set(self.keys):
            raise ValueError(f"chunk keys {sorted(chunk)} != store keys "
                             f"{sorted(self.keys)}")
        owned = {}
        for k, v in chunk.items():
            v = _host(v)
            want = (self.chunk_size,) + self.row_shape(k)
            if tuple(v.shape) != want or v.dtype != self.dtype(k):
                raise ValueError(
                    f"chunk array {k!r} is {tuple(v.shape)}/{v.dtype}, "
                    f"expected {want}/{self.dtype(k)}")
            owned[k] = self._alloc(want, v.dtype).copy_(v)
        self._chunks.append(owned)
        self._writes.append(0)
        return self.num_chunks - 1

    def guard_reads(self, chunk_ids, event) -> None:
        """Register a device copy (its ``torch.cuda.Event``) that reads
        the chunks ``chunk_ids``: ``write_rows`` waits for it."""
        for c in np.asarray(chunk_ids).reshape(-1):
            self._guards[int(c)] = event

    def write_count(self, c: int) -> int:
        """How many ``write_rows`` calls have written chunk ``c``."""
        return self._writes[self._local(c)]

    def _check(self, gidx: np.ndarray) -> None:
        if gidx.size and (gidx.min() < 0 or gidx.max() >= self.num_examples):
            bad = gidx[(gidx < 0) | (gidx >= self.num_examples)]
            raise IndexError(f"indices out of range [0, {self.num_examples})"
                             f": {bad[:8]}")

    def write_rows(self, global_idx, rows: Mapping) -> None:
        """Host write at arbitrary global indices, chunk-grouped (the
        scatter mirror of ``fetch_rows``): the traffic-ingest path."""
        gidx = _index(global_idx)
        self._check(gidx)
        cidx, off = index_to_chunk(gidx, self.chunk_size)
        rows = {k: _host(v) for k, v in rows.items()}
        for c in np.unique(cidx):
            i = self._local(c)
            guard = self._guards.pop(int(c), None)
            if guard is not None:
                guard.synchronize()
            sel = torch.from_numpy(cidx == c)
            at = torch.from_numpy(off[cidx == c])
            chunk = self._chunks[i]
            for k in self.keys:
                chunk[k][at] = rows[k][sel].to(chunk[k].dtype)
            self._writes[i] += 1

    # ---- reads ------------------------------------------------------------

    def chunk(self, c: int) -> dict[str, torch.Tensor]:
        """One chunk's tensors (no copy)."""
        return self._chunks[self._local(c)]

    def iter_chunks(self, chunks: range | None = None
                    ) -> Iterator[tuple[int, dict[str, torch.Tensor]]]:
        """Yield (chunk_id, chunk) over ``chunks`` (default: every chunk
        this store holds)."""
        for c in (chunks if chunks is not None else self.held_chunks):
            yield c, self.chunk(c)

    def fetch_rows(self, global_idx) -> dict[str, torch.Tensor]:
        """Host read at arbitrary global indices, grouped by chunk so each
        chunk is touched once; rows in the order of ``global_idx``, in
        fresh (pinned with ``pin_memory``) tensors."""
        gidx = _index(global_idx)
        self._check(gidx)
        cidx, off = index_to_chunk(gidx, self.chunk_size)
        out = {k: torch.empty((gidx.size,) + self.row_shape(k),
                              dtype=self.dtype(k),
                              pin_memory=self.pin_memory)
               for k in self.keys}
        for c in np.unique(cidx):
            sel = np.flatnonzero(cidx == c)
            at = off[sel]
            chunk = self.chunk(c)
            if _is_run(sel) and _is_run(at):
                # a contiguous run (the scoring stream's slices): one copy
                for k in self.keys:
                    out[k][sel[0]:sel[-1] + 1].copy_(
                        chunk[k][at[0]:at[-1] + 1])
                continue
            sel_t, at_t = torch.from_numpy(sel), torch.from_numpy(at)
            for k in self.keys:
                out[k][sel_t] = chunk[k][at_t]
        return out

    def stack_chunks(self, chunks) -> dict[str, torch.Tensor]:
        """Whole chunks concatenated in the given order."""
        ids = [int(c) for c in np.asarray(chunks).reshape(-1)]
        return {k: torch.cat([self.chunk(c)[k] for c in ids], dim=0)
                for k in self.keys}
