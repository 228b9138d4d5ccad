"""Heartbeat and step-time telemetry for the serving engine, and
checkpoint-restart for training.

Observed per-slot step times are converted into the C_j(τ) availability
estimates Algorithm 1 consumes; slots flagged as stragglers get their
heads migrated away exactly like an overloaded edge device.  Copy of the
JAX package's ``runtime/fault_tolerance.HeartbeatMonitor`` and
``RestartPolicy``.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Callable, Deque, Dict, List, Optional

import numpy as np


@dataclasses.dataclass
class SlotTelemetry:
    step_times: Deque[float]
    last_heartbeat: float
    alive: bool = True


class HeartbeatMonitor:
    """Tracks per-slot liveness + step-time EWMA; estimates effective
    compute availability for the controller.

    ``clock`` injects the time source (default wall clock): the async
    serving runtime's tests drive hang detection on a virtual clock, so
    "worker silent past the timeout" is provable without real sleeps."""

    def __init__(self, n_slots: int, *, window: int = 16,
                 straggler_factor: float = 1.5,
                 heartbeat_timeout: float = 60.0,
                 clock: Callable[[], float] = time.monotonic):
        self._clock = clock
        self.slots: Dict[int, SlotTelemetry] = {
            j: SlotTelemetry(deque(maxlen=window), self._clock())
            for j in range(n_slots)}
        self.straggler_factor = straggler_factor
        self.heartbeat_timeout = heartbeat_timeout
        # event log: faults/recoveries with their cause, bounded like the
        # engine's sample_key_log (a long-running monitor must not grow)
        self.events: Deque[dict] = deque(maxlen=4096)

    def record_event(self, kind: str, **info):
        self.events.append({"kind": kind, "t": self._clock(), **info})

    def record_step(self, slot: int, seconds: float):
        t = self.slots[slot]
        t.step_times.append(seconds)
        t.last_heartbeat = self._clock()
        t.alive = True

    def record_heartbeat(self, slot: int):
        t = self.slots[slot]
        t.last_heartbeat = self._clock()
        t.alive = True      # a heartbeat revives a hang-flagged slot

    # ------------------------------------------------------------- queries
    def median_step(self) -> float:
        times = [np.mean(t.step_times) for t in self.slots.values()
                 if t.step_times]
        return float(np.median(times)) if times else 0.0

    def stragglers(self) -> List[int]:
        med = self.median_step()
        if med <= 0:
            return []
        return [j for j, t in self.slots.items()
                if t.step_times and np.mean(t.step_times)
                > self.straggler_factor * med]

    def dead(self) -> List[int]:
        now = self._clock()
        return [j for j, t in self.slots.items()
                if now - t.last_heartbeat > self.heartbeat_timeout]

    def sweep_hung(self, on_hung: Optional[Callable[[int], None]] = None
                   ) -> List[int]:
        """One-shot hang sweep (the async runtime's worker watchdog):
        slots silent past ``heartbeat_timeout`` transition to dead exactly
        once — the transition (not every poll) lands in the event log, and
        ``availability`` zeroes the slot until a heartbeat revives it.
        Returns the slots that newly transitioned this sweep.

        ``on_hung(slot)`` is the recovery escalation hook, invoked once
        per newly-hung slot AFTER the transition is logged (default None:
        the original log-only behavior).  Detection and recovery stay
        separable — the callback's own events land in the log too, so an
        escalation that raises is still attributable."""
        now = self._clock()
        newly: List[int] = []
        for j, t in self.slots.items():
            silent = now - t.last_heartbeat
            if silent > self.heartbeat_timeout and t.alive:
                t.alive = False
                newly.append(j)
                self.record_event("worker_hung", slot=j,
                                  silent_s=float(silent))
        if on_hung is not None:
            for j in newly:
                self.record_event("recovery_escalated", slot=j)
                on_hung(j)
        return newly

    def availability(self, peak_flops) -> np.ndarray:
        """C_j(τ) estimates for Algorithm 1: peak scaled by the inverse of
        the slot's slowdown relative to the median step time.  Dead slots
        estimate to 0.0.  ``peak_flops`` may be a scalar or a per-slot
        array (heterogeneous devices).  The estimate is monotone
        non-increasing in a slot's observed mean step time."""
        peak = np.broadcast_to(np.asarray(peak_flops, float),
                               (len(self.slots),)).astype(float).copy()
        med = self.median_step()
        out = peak.copy()
        for j, t in self.slots.items():
            if not t.alive:
                out[j] = 0.0
            elif med > 0 and t.step_times:
                out[j] = peak[j] * min(1.0,
                                       med / float(np.mean(t.step_times)))
        return out

    def mark_failed(self, slot: int):
        self.slots[slot].alive = False


class RestartPolicy:
    """Checkpoint-restart orchestration: on failure, roll back to the last
    committed step and re-enter the train loop; bounded retries with
    exponential backoff (production default 3 retries)."""

    def __init__(self, checkpointer, *, max_retries: int = 3,
                 backoff_s: float = 5.0,
                 monitor: Optional[HeartbeatMonitor] = None):
        self.ckpt = checkpointer
        self.max_retries = max_retries
        self.backoff_s = backoff_s
        self.failures = 0
        self.monitor = monitor
        self.events: Deque[dict] = deque(maxlen=4096)

    def _record_fault(self, e: BaseException, resume_step):
        """What failed, not just that something failed: the exception
        type/message lands in the policy's (and the monitor's) event log
        so a swallowed retry is still attributable post-mortem."""
        ev = {"kind": "worker_fault", "error_type": type(e).__name__,
              "error": str(e), "failures": self.failures,
              "resume_step": resume_step, "t": time.monotonic()}
        self.events.append(ev)
        if self.monitor is not None:
            self.monitor.record_event(**ev)

    def run(self, train_fn: Callable[[Optional[int]], None]):
        """train_fn(resume_step) runs until completion or raises."""
        while True:
            resume = self.ckpt.latest_step()
            try:
                train_fn(resume)
                return
            except Exception as e:  # noqa: BLE001 — any worker fault
                self.failures += 1
                self._record_fault(e, resume)
                if self.failures > self.max_retries:
                    raise
                time.sleep(self.backoff_s * 2 ** (self.failures - 1))
