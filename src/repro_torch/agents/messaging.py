"""In-process message bus — the Kafka stand-in (DESIGN.md §7).

Same pub/sub + header-propagation semantics the paper uses Kafka for:
topics per agent, messages carry the Kairos system identifiers in headers
(msg_id, upstream, app, application-level start time) and are delivered
in publish order by the workflow driver.
"""
from __future__ import annotations

import collections
import dataclasses
import itertools
import time
from typing import Callable, Dict, List, Optional

_msg_counter = itertools.count()


@dataclasses.dataclass
class Headers:
    """Transparently propagated system identifiers (§4.1)."""
    msg_id: str
    app_name: str
    upstream_name: Optional[str]
    app_start_time: float


@dataclasses.dataclass
class Message:
    topic: str
    payload: dict
    headers: Headers


class MessageBus:
    """Synchronous topic queue with subscriber callbacks (drained by the
    workflow driver loop — swap-in point for a real Kafka client)."""

    def __init__(self):
        self._queues: Dict[str, collections.deque] = collections.defaultdict(collections.deque)
        self._subs: Dict[str, List[Callable[[Message], None]]] = collections.defaultdict(list)

    def subscribe(self, topic: str, fn: Callable[[Message], None]):
        self._subs[topic].append(fn)

    def publish(self, topic: str, payload: dict, headers: Headers):
        self._queues[topic].append(Message(topic, payload, headers))

    def drain(self, max_messages: int = 256) -> int:
        n = 0
        for topic, q in list(self._queues.items()):
            while q and n < max_messages:
                msg = q.popleft()
                for fn in self._subs.get(topic, ()):
                    fn(msg)
                n += 1
        return n

    @staticmethod
    def new_msg_id(app: str) -> str:
        return f"{app}-{next(_msg_counter)}-{int(time.time()*1e3) % 100000}"
