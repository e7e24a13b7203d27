"""Continuous-batching scheduler: admits queued requests into free engine
slots between decode steps, runs until the queue drains."""
from __future__ import annotations

from collections import deque
from typing import Dict, List

from repro_torch.serving.engine import Engine
from repro_torch.serving.requests import Request, Response


class ContinuousBatcher:
    def __init__(self, engine: Engine):
        self.engine = engine
        self.queue: deque[Request] = deque()
        self.finished: Dict[int, Response] = {}

    def submit(self, req: Request) -> None:
        self.queue.append(req)

    def run(self, requests: List[Request] | None = None,
            max_steps: int = 100_000) -> Dict[int, Response]:
        for r in requests or []:
            self.submit(r)
        steps = 0
        while (self.queue or self.engine.slot_active.any()) and steps < max_steps:
            # admit as many queued requests as there are free slots
            while self.queue and self.engine.has_free_slot:
                self.engine.admit(self.queue.popleft())
            for resp in self.engine.step():
                self.finished[resp.request_id] = resp
            steps += 1
        return self.finished

    def utilization(self) -> float:
        st = self.engine.stats
        if st["decode_steps"] == 0:
            return 0.0
        return st["tokens_out"] / (st["decode_steps"] * self.engine.slots)
