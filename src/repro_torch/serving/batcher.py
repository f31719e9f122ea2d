"""Continuous batching: slot-based request scheduling over the decode engine.

Mirrors ``src/repro/serving/batcher.py`` on one device.  A fixed pool of
``num_slots`` cache slots; arriving requests are prefilled into free slots
(one in-place copy per cache buffer), all active slots decode in
lock-step, and a slot is evicted on EOS or max-tokens.  Per-slot
``lengths`` drive the attention masking, so slots at different positions
share one batched decode step.

Prompts are right-padded to power-of-two buckets (``min_bucket`` floor)
and prefilled with ``true_len``.  The reference jits the prefill once per
bucket; the port runs eagerly, and ``prefill_traces`` counts the distinct
padded prompt shapes that reached ``prefill``, which is what that jit
would have traced.  Decode passes an explicit ``active`` mask so evicted
slots advance neither their lengths nor their caches, and a request is
finished before its next token would write past ``max_len`` when the
model has no sliding window (the "reject" half of ring-or-reject).

It serves every stack the engine does: the splice copies each cache
buffer by name (ring caches, MLA latents, mamba conv windows and f32
states alike), and the reject rule applies to any stack without a
sliding window, as the reference applies it (a pure-mamba stack too).
``attn_impl`` picks the prefill attention ("ref" as in the reference, or
"pallas", the flash-attention kernel; an MLA stack takes "ref" whatever
is asked, ``engine.prefill_attn_impl``); ``decode_kernel`` the decode
attention.  ``sample`` maps logits to tokens (greedy argmax by default);
finished requests also queue on ``completed`` until ``drain_completed``
(the serving loop's ingest, ``serving/loop.py``).

With ``model_group=`` (the reference's ``mesh=``, in the port's group
convention) the batcher drives ``sharded_decode.make_mesh_serving``:
``params`` are the rank's shards (``dist/sharding.py::shard_tree``), the
caches live at the rank's local shapes (``decode_cache_specs``) and the
splice copies local cache rows.  Every rank of the group, and every data
rank serving the same requests, computes the same logits and tokens.
Decode stays eager on every device: a step that issues collectives is
not captured in a CUDA graph.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch.dist import DataGroup
from repro_torch.models.config import ModelConfig
from repro_torch.serving.engine import init_serve_state, prefill_attn_impl
from repro_torch.serving.sharded_decode import make_mesh_serving


@dataclasses.dataclass
class Request:
    """One generation request: prompt tokens plus stop conditions."""
    uid: int
    prompt: torch.Tensor         # (S,) integer tokens
    max_new_tokens: int = 32
    eos_id: int = -1             # -1 = never


@dataclasses.dataclass
class _Slot:
    """Per-slot bookkeeping: the resident request and its tokens so far."""
    request: Optional[Request] = None
    generated: list = dataclasses.field(default_factory=list)
    prompt_len: int = 0

    @property
    def free(self) -> bool:
        """Whether this slot can admit a new request."""
        return self.request is None


def _bucket(n: int, min_bucket: int) -> int:
    """Smallest power of two ≥ max(n, min_bucket)."""
    b = max(min_bucket, 1)
    while b < n:
        b *= 2
    return b


class ContinuousBatcher:
    """Drive a params+config pair as a multi-tenant decode server on the
    device that holds the params (this rank's shards on a
    ``model_group``)."""

    def __init__(self, params, cfg: ModelConfig, num_slots: int,
                 max_len: int, decode_kernel: str = "ref",
                 sample: Optional[Callable] = None,
                 prefill_buckets: bool = True, min_bucket: int = 8,
                 attn_impl: str = "ref",
                 model_group: Optional[DataGroup] = None):
        self.params = params
        self.cfg = cfg
        self.num_slots = num_slots
        self.max_len = max_len
        self.decode_kernel = decode_kernel
        self.attn_impl = prefill_attn_impl(cfg, attn_impl)
        self.model_group = model_group
        self._prefill, self._decode = make_mesh_serving(
            cfg, max_len, model_group, decode_kernel=decode_kernel,
            attn_impl=self.attn_impl)
        self.device = params["embed"]["tokens"].device
        self.state = init_serve_state(cfg, num_slots, max_len, self.device,
                                      model_group)
        self.slots = [_Slot() for _ in range(num_slots)]
        self._next_tok = torch.zeros(num_slots, dtype=torch.int32,
                                     device=self.device)
        self.sample = sample or (lambda logits: torch.argmax(logits, -1))
        self.prefill_buckets = prefill_buckets
        self.min_bucket = min_bucket
        self._prefill_shapes: set = set()
        self.finished: dict[int, list[int]] = {}
        self.completed: list[tuple[Request, list[int]]] = []

    @property
    def prefill_traces(self) -> int:
        """Distinct padded prompt shapes prefilled so far."""
        return len(self._prefill_shapes)

    def _active_mask(self) -> torch.Tensor:
        """(num_slots,) bool: which slots currently hold a request."""
        return torch.tensor([not s.free for s in self.slots],
                            device=self.device)

    # ------------------------------------------------------------- admission
    def try_insert(self, req: Request) -> bool:
        """Prefill ``req`` into a free slot. Returns False if none free."""
        slot_id = next((i for i, s in enumerate(self.slots) if s.free), None)
        if slot_id is None:
            return False
        prompt = torch.as_tensor(req.prompt).to(self.device, torch.int32)
        s = int(prompt.shape[0])
        b = _bucket(s, self.min_bucket) if self.prefill_buckets else s
        padded = torch.nn.functional.pad(prompt, (0, b - s))[None]
        self._prefill_shapes.add(tuple(padded.shape))
        logits, st1 = self._prefill(self.params, padded, s)
        # splice the single-sequence caches (this rank's local rows) and
        # the length into the batch state
        for name, buf in self.state.caches.items():
            buf[:, slot_id] = st1.caches[name][:, 0].to(buf.dtype)
        self.state.lengths[slot_id] = st1.lengths[0]
        tok = self.sample(logits)[0].to(torch.int32)
        self._next_tok[slot_id] = tok
        self.slots[slot_id] = _Slot(request=req, generated=[int(tok)],
                                    prompt_len=s)
        return True

    # ----------------------------------------------------------------- step
    def step(self) -> int:
        """One lock-step decode over all slots. Returns #active slots."""
        active = [i for i, s in enumerate(self.slots) if not s.free]
        if not active:
            return 0
        logits, self.state = self._decode(self.params, self._next_tok,
                                          self.state, self._active_mask())
        toks = self.sample(logits).to(torch.int32)
        self._next_tok = toks
        host = toks.tolist()
        for i in active:
            slot = self.slots[i]
            tok = host[i]
            slot.generated.append(tok)
            total = slot.prompt_len + len(slot.generated)
            done = (len(slot.generated) >= slot.request.max_new_tokens or
                    tok == slot.request.eos_id or
                    # reject: a full-attention cache must not wrap its ring
                    (self.cfg.sliding_window <= 0 and total >= self.max_len))
            if done:
                self.finished[slot.request.uid] = slot.generated
                self.completed.append((slot.request, list(slot.generated)))
                self.slots[i] = _Slot()
                # freeze the freed slot: the active mask keeps decode from
                # touching its cache rows until the next insert
                self.state.lengths[i] = 0
        return len([s for s in self.slots if not s.free])

    def drain_completed(self) -> list[tuple[Request, list[int]]]:
        """Return and clear the finished (request, generated) pairs, in
        the order they finished."""
        out, self.completed = self.completed, []
        return out

    def run(self, requests: list[Request], max_steps: int = 10_000) -> dict:
        """Serve a request list to completion (greedy admission)."""
        pending = list(requests)
        for _ in range(max_steps):
            while pending and self.try_insert(pending[0]):
                pending.pop(0)
            if self.step() == 0 and not pending:
                break
        return self.finished
