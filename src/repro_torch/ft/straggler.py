"""Straggler mitigation: per-slice step-time EMA vs variant prediction.

Each job variant carries a predicted throughput (from the roofline
model or the paper's measured tables).  A slice whose observed step
time drifts ``threshold``x above prediction for ``patience``
consecutive windows is flagged; the controller's response is a re-plan
that avoids the slow slice (same PADPS-FR mechanism as failures —
a straggler is a slice whose *effective* throughput degraded, so its
task's variant table no longer holds there).
"""

from __future__ import annotations

import dataclasses

__all__ = ["StragglerDetector"]


@dataclasses.dataclass
class _Track:
    ema: float = 0.0
    n: int = 0
    strikes: int = 0


class StragglerDetector:
    def __init__(self, *, alpha: float = 0.2, threshold: float = 1.5,
                 patience: int = 3) -> None:
        self.alpha = alpha
        self.threshold = threshold
        self.patience = patience
        self._tracks: dict[int, _Track] = {}

    def observe(self, slice_id: int, step_time: float, predicted: float) -> bool:
        """Record one step; returns True if the slice is now a straggler."""
        tr = self._tracks.setdefault(slice_id, _Track())
        tr.ema = step_time if tr.n == 0 else (1 - self.alpha) * tr.ema + self.alpha * step_time
        tr.n += 1
        if tr.n >= 3 and tr.ema > self.threshold * predicted:
            tr.strikes += 1
        else:
            tr.strikes = 0
        return tr.strikes >= self.patience

    def stragglers(self) -> list[int]:
        return [j for j, t in self._tracks.items() if t.strikes >= self.patience]

    def reset(self, slice_id: int) -> None:
        self._tracks.pop(slice_id, None)
