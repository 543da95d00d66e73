"""Request queue with KV-block admission control (counterpart of
``deepspeed_tpu/inference/serving/queue.py``).

A request joins a slot only when the block pool can reserve its worst-case
KV footprint (prompt + max_new tokens, block-rounded), so an admitted
request never dies mid-flight and blocks never leak (reserve on admit, free
on retire). Strict FIFO: nothing overtakes the head of the queue, so no
request starves.
"""

from collections import deque
from typing import Callable, List, Optional

from deepspeed_tpu_torch.inference.serving.blocks import BlockPool
from deepspeed_tpu_torch.inference.serving.request import QUEUED, REFUSED, Request


class RequestQueue:
    """FIFO queue + admission control against a :class:`BlockPool`."""

    def __init__(self, pool: BlockPool, max_queue: int = 1024,
                 max_total_tokens: Optional[int] = None,
                 clock: Optional[Callable[[], float]] = None):
        self.pool = pool
        self.max_queue = int(max_queue)
        #: hard per-request cap (model context length)
        self.max_total_tokens = max_total_tokens
        self._clock = clock or (lambda: 0.0)
        self._queue: deque = deque()
        self.submitted = 0
        self.refused = 0

    def __len__(self) -> int:
        return len(self._queue)

    @property
    def pending(self) -> List[Request]:
        return list(self._queue)

    def submit(self, request: Request) -> Request:
        """Enqueue (stamps arrival via the injected clock). Refuses, with a
        reason, on queue overflow or a request that could never fit."""
        if request.arrival_time is None:
            request.arrival_time = self._clock()
        self.submitted += 1
        if len(self._queue) >= self.max_queue:
            return self._refuse(request, f"queue full ({self.max_queue})")
        if self.max_total_tokens is not None and request.total_tokens > self.max_total_tokens:
            return self._refuse(request, f"prompt + max_new ({request.total_tokens}) exceeds "
                                         f"context capacity {self.max_total_tokens}")
        if self.pool.blocks_for(request.total_tokens) > self.pool.num_blocks:
            return self._refuse(request, "worst-case KV footprint exceeds the whole pool")
        request.state = QUEUED
        self._queue.append(request)
        return request

    def _refuse(self, request: Request, reason: str) -> Request:
        request.state = REFUSED
        request.refuse_reason = reason
        self.refused += 1
        return request

    def admit(self, free_slots: int) -> List[Request]:
        """Admit head-of-queue requests while a slot is free and the pool
        can reserve their worst-case footprint (blocks are reserved here;
        the scheduler frees them when it retires the request)."""
        admitted: List[Request] = []
        while self._queue and len(admitted) < free_slots:
            head = self._queue[0]
            if not self.pool.can_allocate(head.total_tokens):
                break  # strict FIFO: nothing overtakes the head
            self._queue.popleft()
            self.pool.reserve(head.request_id, head.total_tokens)
            admitted.append(head)
        return admitted

    def refuse_all(self, reason: str) -> List[Request]:
        """Terminally refuse everything still queued."""
        refused = []
        while self._queue:
            refused.append(self._refuse(self._queue.popleft(), reason))
        return refused
