"""Deterministic seeded workload generator: arrival processes + mixed
length distributions + a virtual-clock load loop.

Everything the tail-latency benchmarks measure is generated here, from
ONE ``np.random.default_rng(seed)`` stream per workload — the same seed
always yields the same arrival times, prompts, and token budgets, so the
percentile metrics ``drive_virtual`` reports are bit-reproducible and a
check can hold them exactly (a wall-clock load test could only ever be
held loosely).

Arrival processes (all return sorted arrival times on ``[0, horizon)``):

``poisson``   homogeneous Poisson — exponential inter-arrival gaps at
              ``rate`` requests per time unit (the M/·/· baseline).
``bursty``    2-state MMPP (Markov-modulated Poisson): dwell times are
              exponential with mean ``mean_dwell`` and the instantaneous
              rate flips between ``rate`` and ``rate_hi`` — the classic
              burst model; same mean-ish load as Poisson but a heavier
              inter-arrival tail.
``diurnal``   nonhomogeneous Poisson via thinning against ``rate_hi``:
              the rate ramps ``rate → rate_hi → rate`` sinusoidally with
              ``period`` — the daily-traffic shape, so a run crosses
              under- and over-provisioned regimes in one sweep.

Clocks: ``VirtualClock`` is the test/bench time source — one scheduler
step costs ``step_dt`` and idle gaps jump to the next arrival, so a load
sweep is deterministic and takes no wall time beyond the model math.
``WallClock`` is the same interface read from ``time.monotonic`` for the
async runtime's real-traffic path (it cannot be advanced).

``drive_virtual(engine, requests)`` is the load loop itself: submit
arrivals as virtual time passes, step the engine, and timestamp every
generated token through the engine's ``token_sink`` stream hook.  It
reports p50/p95/p99 TTFT (arrival -> first token, queue wait included)
and inter-token latency, plus goodput (finished tokens per time unit).

Copy of the JAX package's ``serving/workload.py`` (plain numpy): equal
seeds draw the reference's numbers, so a port engine under
``drive_virtual`` reproduces the reference's virtual-clock metrics.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

# (weight, lo, hi) mixture components: mostly short chat-style prompts
# with a heavy tail of long ones — the mixed-length regime continuous
# batching exists for (benchmarks/serving_throughput.py's motivation).
DEFAULT_PROMPT_MIX: Tuple[Tuple[float, int, int], ...] = (
    (0.75, 4, 12), (0.25, 16, 32))
DEFAULT_OUT_MIX: Tuple[Tuple[float, int, int], ...] = (
    (0.7, 4, 10), (0.3, 12, 24))


@dataclasses.dataclass(frozen=True)
class TimedRequest:
    """One workload arrival: submit ``prompt`` at ``t_arrival``."""
    t_arrival: float
    prompt: np.ndarray            # (L0,) int32
    max_new_tokens: int


class VirtualClock:
    """Deterministic simulated time: ``advance`` moves it, nothing else
    does.  ``now`` is also usable as a ``HeartbeatMonitor`` clock."""

    def __init__(self, t0: float = 0.0):
        self._t = float(t0)

    def now(self) -> float:
        return self._t

    def advance(self, dt: float):
        if dt < 0:
            raise ValueError(f"virtual time cannot go backwards (dt={dt})")
        self._t += dt

    def advance_to(self, t: float):
        self._t = max(self._t, float(t))


class WallClock:
    """The real-time source with the VirtualClock interface; ``advance``
    is a no-op because wall time advances itself."""

    def now(self) -> float:
        return time.monotonic()

    def advance(self, dt: float):
        pass

    def advance_to(self, t: float):
        pass


# --------------------------------------------------------------- processes
def poisson_arrivals(rate: float, horizon: float,
                     rng: np.random.Generator) -> np.ndarray:
    """Homogeneous Poisson: exponential gaps at ``rate``."""
    if rate <= 0:
        raise ValueError(f"rate must be positive, got {rate}")
    out, t = [], 0.0
    while True:
        t += rng.exponential(1.0 / rate)
        if t >= horizon:
            return np.asarray(out, float)
        out.append(t)


def mmpp_arrivals(rate: float, rate_hi: float, mean_dwell: float,
                  horizon: float, rng: np.random.Generator) -> np.ndarray:
    """2-state MMPP: exponential dwells alternate the instantaneous rate
    between ``rate`` (quiet) and ``rate_hi`` (burst)."""
    if min(rate, rate_hi, mean_dwell) <= 0:
        raise ValueError("rate, rate_hi, mean_dwell must be positive")
    out: List[float] = []
    t, burst = 0.0, False
    while t < horizon:
        end = min(t + rng.exponential(mean_dwell), horizon)
        r = rate_hi if burst else rate
        tt = t
        while True:
            tt += rng.exponential(1.0 / r)
            if tt >= end:
                break
            out.append(tt)
        t, burst = end, not burst
    return np.asarray(out, float)


def diurnal_arrivals(rate: float, rate_hi: float, period: float,
                     horizon: float, rng: np.random.Generator) -> np.ndarray:
    """Nonhomogeneous Poisson by thinning: sinusoidal ramp
    ``rate -> rate_hi -> rate`` over each ``period`` (trough at t=0)."""
    if not rate_hi >= rate > 0:
        raise ValueError(f"need rate_hi >= rate > 0, got {rate}, {rate_hi}")
    out, t = [], 0.0
    while True:
        t += rng.exponential(1.0 / rate_hi)
        if t >= horizon:
            return np.asarray(out, float)
        lam = rate + (rate_hi - rate) * 0.5 * (
            1.0 - np.cos(2.0 * np.pi * t / period))
        if rng.uniform() * rate_hi < lam:
            out.append(t)


def _sample_mix(rng: np.random.Generator,
                mix: Sequence[Tuple[float, int, int]]) -> int:
    w = np.asarray([m[0] for m in mix], float)
    i = int(rng.choice(len(mix), p=w / w.sum()))
    _, lo, hi = mix[i]
    return int(rng.integers(lo, hi + 1))


def make_workload(process: str = "poisson", *, rate: float,
                  horizon: float, seed: int = 0, vocab: int = 97,
                  prompt_mix: Sequence[Tuple[float, int, int]]
                  = DEFAULT_PROMPT_MIX,
                  out_mix: Sequence[Tuple[float, int, int]]
                  = DEFAULT_OUT_MIX,
                  rate_hi: Optional[float] = None,
                  mean_dwell: Optional[float] = None,
                  period: Optional[float] = None) -> List[TimedRequest]:
    """Seeded workload: arrivals from ``process``, prompt/output lengths
    from (weight, lo, hi) mixtures, tokens uniform over ``vocab``.  One
    rng drives everything, so equal seeds give equal workloads."""
    rng = np.random.default_rng(seed)
    if process == "poisson":
        times = poisson_arrivals(rate, horizon, rng)
    elif process == "bursty":
        times = mmpp_arrivals(rate, rate_hi or 4.0 * rate,
                              mean_dwell or horizon / 8.0, horizon, rng)
    elif process == "diurnal":
        times = diurnal_arrivals(rate, rate_hi or 3.0 * rate,
                                 period or horizon / 2.0, horizon, rng)
    else:
        raise ValueError(f"unknown arrival process {process!r} "
                         f"(poisson | bursty | diurnal)")
    out = []
    for t in times:
        L0 = _sample_mix(rng, prompt_mix)
        prompt = rng.integers(0, vocab, size=L0).astype(np.int32)
        out.append(TimedRequest(float(t), prompt,
                                _sample_mix(rng, out_mix)))
    return out


def offered_load(reqs: Sequence[TimedRequest], horizon: float) -> dict:
    """What the workload asks of the engine, per time unit."""
    toks = sum(len(r.prompt) + r.max_new_tokens for r in reqs)
    return {"req_rate": len(reqs) / horizon, "tok_rate": toks / horizon}


# --------------------------------------------------------------- load loop
def _pctls(xs: Sequence[float], prefix: str) -> Dict[str, float]:
    if not len(xs):
        return {f"p{p}_{prefix}": 0.0 for p in (50, 95, 99)}
    return {f"p{p}_{prefix}": float(np.percentile(xs, p))
            for p in (50, 95, 99)}


def drive_virtual(eng, reqs: Sequence[TimedRequest], *,
                  step_dt: float = 1.0,
                  max_steps: int = 200_000,
                  price_by_model: bool = False,
                  events: Optional[Sequence[tuple]] = None) -> dict:
    """Run ``reqs`` through a (synchronous) serving engine on a virtual
    clock: each scheduler step costs ``step_dt`` (pipeline bubbles
    included — an empty due group still burns time), idle gaps jump to
    the next arrival.  Tokens are timestamped via the engine's
    ``token_sink`` hook, so TTFT includes the queueing delay between a
    request's *arrival* and its first emitted token — the tail the
    offered-load sweep exists to expose.

    ``price_by_model`` prices each step by the controller's own modeled
    per-token pipeline delay instead of the flat ``step_dt``: the most
    recent interval's ``d_pipe_est`` (falling back to ``step_dt`` until
    the first interval fires, or while the estimate is non-finite).  The
    reported percentiles then reflect the placement the controller chose
    — a device slowdown or evacuation shows up in the latency tail
    instead of being flattened by the uniform step price.  Off by
    default: the flat pricing (and its committed baselines) stays
    bit-identical.

    ``events`` is a sequence of ``(t, fn)`` pairs: at the first loop
    iteration where virtual time has reached ``t``, ``fn(eng)`` runs —
    the churn injection hook (kill/slow/rejoin a device mid-decode).
    Events fire in time order, before arrivals are submitted.

    Deterministic: same engine seed + same workload (and same events) =>
    identical streams AND identical latency percentiles,
    machine-independent."""
    clock = VirtualClock()
    pending = collections.deque(sorted(reqs, key=lambda r: r.t_arrival))
    due = collections.deque(
        sorted(events or (), key=lambda e: e[0]))
    arrival: Dict[int, float] = {}
    first: Dict[int, float] = {}
    last: Dict[int, float] = {}
    itl: List[float] = []
    prev_sink = eng.token_sink

    def sink(req, tok, done):
        if done:
            return
        now = clock.now()
        if req.rid in first:
            itl.append(now - last[req.rid])
        else:
            first[req.rid] = now
        last[req.rid] = now

    def _step_price() -> float:
        if not price_by_model:
            return step_dt
        log = getattr(eng, "migration_log", None)
        if log:
            d = log[-1].get("d_pipe_est")
            if d is not None and np.isfinite(d) and d > 0:
                return float(d)
        return step_dt

    eng.token_sink = sink
    try:
        while True:
            while due and due[0][0] <= clock.now():
                due.popleft()[1](eng)
            while pending and pending[0].t_arrival <= clock.now():
                tr = pending.popleft()
                rid = eng.submit(tr.prompt,
                                 max_new_tokens=tr.max_new_tokens)
                arrival[rid] = tr.t_arrival
            if eng.step():
                clock.advance(_step_price())
            elif pending or due:
                # idle: jump to whichever comes first, the next arrival
                # or the next churn event (events must fire even in gaps)
                nxt = []
                if pending:
                    nxt.append(pending[0].t_arrival)
                if due:
                    nxt.append(due[0][0])
                clock.advance_to(min(nxt))
            elif eng.queue:
                raise RuntimeError(
                    "engine idle with a queued head-of-line request it "
                    "can never admit (pool smaller than one request?)")
            else:
                break
            if eng.decode_steps >= max_steps:
                break
    finally:
        eng.token_sink = prev_sink
    ttft = [first[rid] - arrival[rid] for rid in sorted(first)]
    elapsed = max(clock.now(), step_dt)
    done_toks = sum(len(r.out_tokens) for r in eng.finished)
    out = {"n_submitted": len(arrival), "n_finished": len(eng.finished),
           "steps": eng.decode_steps, "t_end": clock.now(),
           "goodput": done_toks / elapsed,
           "streams": {r.rid: list(r.out_tokens) for r in eng.finished},
           "ttft": ttft, "itl": itl}
    out.update(_pctls(ttft, "ttft"))
    out.update(_pctls(itl, "itl"))
    return out
