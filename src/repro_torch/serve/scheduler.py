"""Continuous-batching scheduler for multi-tenant decode.

Host-side bookkeeping only -- numpy, no torch in this module (a copy of
``repro.serve.scheduler``).  The engine owns a fixed grid of ``n_slots``
batch slots.  Requests flow through four states:

    QUEUED  -- submitted, waiting for a free slot (FIFO)
    PREFILL -- admitted to a slot this tick; the engine must prefill it
    DECODE  -- generating, one token per engine tick
    DONE    -- retired (EOS / token budget); the slot is free again

Continuous batching means retirement frees the slot IMMEDIATELY: the
next queued request is admitted on the following tick instead of
waiting for the whole batch to drain, so short requests never pin slots
for long ones and finished requests stop burning decode compute.

Invariants (asserted, not hoped): a request is admitted at most once,
only to a free slot; tokens are only recorded for the slot's current
occupant while it is live; retirement only happens on an occupied slot.
"""

from __future__ import annotations

import dataclasses
from collections import deque

import numpy as np

__all__ = ["Request", "Scheduler", "QUEUED", "PREFILL", "DECODE", "DONE"]

QUEUED = "queued"
PREFILL = "prefill"
DECODE = "decode"
DONE = "done"


@dataclasses.dataclass
class Request:
    """One generation request.  ``adapter_id=None`` serves the base
    model; otherwise the engine personalizes the slot's parameters from
    the registry before prefill."""

    rid: int
    prompt: np.ndarray
    max_new_tokens: int
    adapter_id: str | None = None
    temperature: float = 0.0
    seed: int = 0
    eos_id: int | None = None

    state: str = dataclasses.field(default=QUEUED, init=False)
    tokens: list = dataclasses.field(default_factory=list, init=False)

    def __post_init__(self):
        self.prompt = np.asarray(self.prompt, np.int32).reshape(-1)
        if self.prompt.size == 0:
            raise ValueError(f"request {self.rid}: empty prompt")
        if self.max_new_tokens < 1:
            raise ValueError(f"request {self.rid}: max_new_tokens < 1")


class Scheduler:
    def __init__(self, n_slots: int):
        if n_slots < 1:
            raise ValueError("n_slots must be >= 1")
        self.n_slots = n_slots
        self.slots: list[Request | None] = [None] * n_slots
        self._queue: deque[Request] = deque()
        self._requests: dict[int, Request] = {}
        self._next_rid = 0
        # counters for the serving log / bench
        self.n_admitted = 0
        self.n_retired = 0

    # -- submission ---------------------------------------------------

    def submit(
        self,
        prompt,
        max_new_tokens: int,
        *,
        adapter_id: str | None = None,
        temperature: float = 0.0,
        seed: int = 0,
        eos_id: int | None = None,
    ) -> int:
        rid = self._next_rid
        self._next_rid += 1
        req = Request(
            rid=rid,
            prompt=prompt,
            max_new_tokens=max_new_tokens,
            adapter_id=adapter_id,
            temperature=temperature,
            seed=seed,
            eos_id=eos_id,
        )
        self._requests[rid] = req
        self._queue.append(req)
        return rid

    def request(self, rid: int) -> Request:
        return self._requests[rid]

    # -- admission ----------------------------------------------------

    def free_slots(self) -> list[int]:
        return [i for i, r in enumerate(self.slots) if r is None]

    def admit(self) -> list[tuple[int, Request]]:
        """Fill free slots FIFO from the queue.  Returns the
        (slot, request) pairs admitted this tick; each needs a prefill
        before the next decode launch."""
        admitted = []
        for slot in self.free_slots():
            if not self._queue:
                break
            req = self._queue.popleft()
            assert req.state == QUEUED, f"request {req.rid} admitted twice"
            req.state = PREFILL
            self.slots[slot] = req
            self.n_admitted += 1
            admitted.append((slot, req))
        return admitted

    def mark_prefilled(self, slot: int) -> None:
        req = self.slots[slot]
        assert req is not None and req.state == PREFILL, f"slot {slot} not in prefill"
        req.state = DECODE

    # -- decode loop --------------------------------------------------

    def active(self) -> list[tuple[int, Request]]:
        """Slots currently decoding (occupied and live)."""
        return [
            (i, r)
            for i, r in enumerate(self.slots)
            if r is not None and r.state == DECODE
        ]

    def record_token(self, slot: int, token: int) -> bool:
        """Append one generated token to the slot's occupant; returns
        True when the request just finished (EOS emitted or token
        budget reached).  The EOS token itself is kept in the output --
        padding past it is the engine's job."""
        req = self.slots[slot]
        assert req is not None and req.state == DECODE, f"slot {slot} has no request"
        req.tokens.append(int(token))
        if req.eos_id is not None and int(token) == req.eos_id:
            return True
        return len(req.tokens) >= req.max_new_tokens

    def retire(self, slot: int) -> Request:
        """Free the slot; its occupant is DONE.  The slot is available
        to ``admit`` on the very next tick (continuous batching)."""
        req = self.slots[slot]
        assert req is not None, f"retire on empty slot {slot}"
        req.state = DONE
        self.slots[slot] = None
        self.n_retired += 1
        return req

    # -- progress -----------------------------------------------------

    def pending(self) -> int:
        return len(self._queue)

    def all_done(self) -> bool:
        return not self._queue and all(r is None for r in self.slots)

    def results(self) -> dict[int, np.ndarray]:
        """rid -> generated tokens for every finished request."""
        return {
            rid: np.asarray(r.tokens, np.int32)
            for rid, r in self._requests.items()
            if r.state == DONE
        }
