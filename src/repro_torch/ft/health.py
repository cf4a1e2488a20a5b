"""Fleet health tracking via heartbeats.

On real deployments each slice's host agent posts heartbeats; here the
controller is driven programmatically (tests inject failures).  A slice
that misses ``timeout`` seconds of heartbeats is declared DOWN, which
triggers the elastic re-plan.
"""

from __future__ import annotations

import dataclasses
import enum
import time

__all__ = ["SliceState", "FleetHealth"]


class SliceState(enum.Enum):
    UP = "up"
    SUSPECT = "suspect"
    DOWN = "down"


@dataclasses.dataclass
class _Slice:
    last_beat: float
    state: SliceState = SliceState.UP


class FleetHealth:
    """Heartbeat book-keeping for ``n_f`` slices."""

    def __init__(self, n_slices: int, *, timeout: float = 30.0, suspect: float = 10.0,
                 clock=time.monotonic) -> None:
        self.timeout = timeout
        self.suspect = suspect
        self._clock = clock
        now = clock()
        self._slices = {j: _Slice(last_beat=now) for j in range(n_slices)}

    def heartbeat(self, slice_id: int) -> None:
        s = self._slices[slice_id]
        s.last_beat = self._clock()
        if s.state != SliceState.DOWN:  # DOWN requires explicit revive
            s.state = SliceState.UP

    def mark_down(self, slice_id: int) -> None:
        self._slices[slice_id].state = SliceState.DOWN

    def revive(self, slice_id: int) -> None:
        s = self._slices[slice_id]
        s.state = SliceState.UP
        s.last_beat = self._clock()

    def poll(self) -> dict[int, SliceState]:
        """Advance state machine from heartbeat ages."""
        now = self._clock()
        for s in self._slices.values():
            if s.state == SliceState.DOWN:
                continue
            age = now - s.last_beat
            if age >= self.timeout:
                s.state = SliceState.DOWN
            elif age >= self.suspect:
                s.state = SliceState.SUSPECT
            else:
                s.state = SliceState.UP
        return {j: s.state for j, s in self._slices.items()}

    def up_slices(self) -> list[int]:
        return [j for j, s in self._slices.items() if s.state == SliceState.UP]

    @property
    def n_up(self) -> int:
        return len(self.up_slices())
