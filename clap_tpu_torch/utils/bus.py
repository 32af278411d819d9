"""Host-side message bus (counterpart of clap_tpu/utils/bus.py;
reference: core/messagebus.{c,h}).

Synchronous pub-sub over typed messages (MT_RENDER/MT_INPUT/MT_COMMAND/
MT_LOG/MT_DEBUG_DRAW, messagebus.h:16-24). In this engine the device
compute path is pure — the bus is the impure host rim connecting input
sources, telemetry, debug draw consumers, and tools, exactly the role
it plays around the reference's frame loop.
"""
from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field
from enum import IntEnum
from typing import Any, Callable


class MT(IntEnum):
    RENDER = 0
    INPUT = 1
    COMMAND = 2
    LOG = 3
    DEBUG_DRAW = 4


@dataclass
class Message:
    type: MT
    source: Any = None
    data: dict = field(default_factory=dict)


class MessageBus:
    def __init__(self):
        self._subs: dict[MT, list[Callable[[Message], int]]] = defaultdict(list)

    def subscribe(self, mtype: MT, handler: Callable[[Message], int]) -> None:
        self._subs[mtype].append(handler)

    def unsubscribe(self, mtype: MT, handler) -> None:
        self._subs[mtype].remove(handler)

    def send(self, msg: Message) -> int:
        """Synchronous dispatch (message_send, messagebus.c); returns the
        number of handlers that consumed the message."""
        n = 0
        for h in list(self._subs.get(msg.type, ())):
            if h(msg) >= 0:
                n += 1
        return n
