"""Best-effort ducts for the discrete-event runtime (paper-faithful).

Semantics mirror Conduit's MPI backend (paper §II-F2):
  - bounded send buffer: a send is DROPPED iff the buffer is full
    (messages that make it into the buffer are guaranteed delivery);
  - messages become pullable after a (jittered) link latency;
  - pulls bulk-drain everything available (MPI_Testsome semantics), which
    interrupts the producer-consumer feedback spiral the paper describes.

Counters feed the QoS metric suite (core/qos.py).
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Any, List, Optional, Tuple

from repro_torch.core.qos import Counters


@dataclasses.dataclass
class Message:
    payload: Any
    send_time: float
    avail_time: float
    touch: int


class Duct:
    """Unidirectional best-effort channel sender -> receiver."""

    def __init__(self, capacity: int, latency_fn, name: str = ""):
        self.capacity = capacity
        self.latency_fn = latency_fn  # (send_time) -> latency seconds
        self.name = name
        self.queue: deque = deque()
        self.inlet = Counters()   # sender-side counters
        self.outlet = Counters()  # receiver-side counters

    # -- sender side --------------------------------------------------------
    def try_send(self, payload, now: float, touch: int) -> bool:
        self.inlet.attempted_send_count += 1
        if len(self.queue) >= self.capacity:
            self.inlet.dropped_send_count += 1
            return False  # best-effort: drop, no retry
        self.inlet.successful_send_count += 1
        lat = self.latency_fn(now)
        self.queue.append(Message(payload, now, now + lat, touch))
        return True

    # -- receiver side ------------------------------------------------------
    def pull(self, now: float) -> List[Message]:
        """Bulk-drain all messages available by ``now``."""
        self.outlet.pull_attempt_count += 1
        out = []
        while self.queue and self.queue[0].avail_time <= now:
            out.append(self.queue.popleft())
        if out:
            self.outlet.laden_pull_count += 1
            self.outlet.message_count += len(out)
        return out

    def latest(self, now: float) -> Tuple[Optional[Message], int]:
        """Drain and return only the freshest message (+ count drained).

        Hot-path form of :meth:`pull`: identical counter semantics, but no
        intermediate list — the empty/nothing-arrived case is a single
        comparison.
        """
        self.outlet.pull_attempt_count += 1
        q = self.queue
        if not q or q[0].avail_time > now:
            return None, 0
        popleft = q.popleft
        msg = popleft()
        drained = 1
        while q and q[0].avail_time <= now:
            msg = popleft()
            drained += 1
        self.outlet.laden_pull_count += 1
        self.outlet.message_count += drained
        return msg, drained

    @property
    def backlog(self) -> int:
        return len(self.queue)
