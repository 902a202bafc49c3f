"""Open-system arrival processes: deterministic, seed-keyed task releases.

Every result before this module was *closed-system*: the whole task graph
is eligible at t=0 and the headline number is makespan.  The paper's
motivating regime — "millions of users, heavy traffic" — is *open-system*:
work arrives continuously and the numbers that matter are tail latency
(p50/p90/p99 of completion − release) and sustained throughput under a
given offered load.  This module defines the arrival side of that mode:

* :class:`ArrivalProcess` — a host-side, hashable description of one
  arrival process: Poisson (memoryless), lognormal (long-tail), or bursty
  on-off (alternating dense bursts and idle gaps), all parameterized by an
  offered load ``rate`` in tasks per microsecond of virtual time.  It
  rides beside a topology in a case's identity: sortable,
  JSON-able, and cache-keyable.
* :func:`release_times` — the deterministic expansion of a process to
  per-task release stamps (int64 ns, sorted, ``release[0] == 0`` so the
  root task is immediately runnable).  The generator is a counter-based
  splitmix64 keyed on ``(seed, stream, index)`` — no global RNG state, so
  the same ``(process, n_tasks, seed)`` triple produces bitwise-identical
  schedules on every host, executor, and backend.
* :func:`slo_metrics` — the NumPy reduction from per-task completion
  stamps to the SLO record: nearest-rank p50/p90/p99 latency and
  sustained throughput over the busy span.

The traced side lives in ``state.make_case(release_ns=...)`` (a padded
``(R,)`` int32 vector plus a ``closed`` flag in ``SweepCase``) and
``phases.spawn_phase`` (the ``clock >= release_ns`` injection gate);
``closed=True`` routes every no-arrival case through arithmetic bitwise
identical to the pre-arrival engine — the same compatibility pattern as
``topology.flat``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

KINDS = ("poisson", "lognormal", "bursty")

#: release stamps must fit the simulator's int32 virtual clocks
_MAX_RELEASE = 2**31 - 1


@dataclasses.dataclass(frozen=True)
class ArrivalProcess:
    """One open-system arrival process (host-side identity).

    ``rate`` is the offered load in tasks per *microsecond* of virtual
    time (the simulator clock is ns), so the mean inter-arrival gap is
    ``1000 / rate`` ns.  ``sigma`` is the lognormal shape (long-tail
    heaviness; dead elsewhere), ``burst_len``/``duty`` shape the bursty
    on-off pattern: bursts of ``burst_len`` tasks whose intra-burst gaps
    are compressed by ``duty`` (< 1), separated by idle gaps sized so the
    *overall* mean gap still matches ``rate``.  Unused knobs normalize to
    canonical values so equal processes hash and cache-key equal.
    """
    kind: str = "poisson"
    rate: float = 1.0
    sigma: float = 0.0
    burst_len: int = 1
    duty: float = 1.0

    def __post_init__(self):
        assert self.kind in KINDS, (self.kind, KINDS)
        assert self.rate > 0, self
        set_ = object.__setattr__
        set_(self, "rate", float(self.rate))
        if self.kind == "lognormal":
            assert self.sigma > 0, self
            set_(self, "sigma", float(self.sigma))
        else:
            set_(self, "sigma", 0.0)
        if self.kind == "bursty":
            assert self.burst_len >= 2, self
            assert 0 < self.duty <= 1.0, self
            set_(self, "burst_len", int(self.burst_len))
            set_(self, "duty", float(self.duty))
        else:
            set_(self, "burst_len", 1)
            set_(self, "duty", 1.0)

    @property
    def mean_gap_ns(self) -> float:
        return 1000.0 / self.rate

    # --- identity (cache keys, plan sort, artifact slots) ---
    def label(self) -> str:
        """Axis/row/filename label, e.g. ``poisson@2``, ``lognormal@2s1.5``,
        ``bursty@2b8d0.25`` (``closed`` is the no-process label)."""
        base = f"{self.kind}@{self.rate:g}"
        if self.kind == "lognormal":
            return base + f"s{self.sigma:g}"
        if self.kind == "bursty":
            return base + f"b{self.burst_len}d{self.duty:g}"
        return base

    @property
    def sort_key(self) -> str:
        return self.label()

    def cache_key(self) -> dict:
        """JSON-able identity for the result-cache key — every knob that
        changes release schedules, floats via repr (exact)."""
        return dict(kind=self.kind, rate=repr(self.rate),
                    sigma=repr(self.sigma), burst_len=self.burst_len,
                    duty=repr(self.duty))

    def asdict(self) -> dict:
        return dataclasses.asdict(self)


def poisson(rate: float) -> ArrivalProcess:
    """Memoryless arrivals: exponential inter-arrival gaps."""
    return ArrivalProcess("poisson", rate)


def lognormal(rate: float, sigma: float = 1.5) -> ArrivalProcess:
    """Long-tail arrivals: lognormal gaps with mean ``1000/rate`` ns."""
    return ArrivalProcess("lognormal", rate, sigma=sigma)


def bursty(rate: float, burst_len: int = 8,
           duty: float = 0.25) -> ArrivalProcess:
    """On-off arrivals: dense bursts separated by idle gaps, same mean."""
    return ArrivalProcess("bursty", rate, burst_len=burst_len, duty=duty)


def resolve(arrivals) -> Optional[ArrivalProcess]:
    """Normalize an ``arrivals=`` argument: ``None`` (closed system), an
    :class:`ArrivalProcess`, or a compact string spec —
    ``"poisson:RATE"`` / ``"lognormal:RATE[:SIGMA]"`` /
    ``"bursty:RATE[:BURST_LEN[:DUTY]]"``."""
    if arrivals is None or isinstance(arrivals, ArrivalProcess):
        return arrivals
    assert isinstance(arrivals, str), arrivals
    parts = arrivals.split(":")
    kind = parts[0]
    if kind not in KINDS:
        raise ValueError(
            f"unknown arrival process {arrivals!r}; expected one of "
            f"{KINDS} as 'kind:rate[:...]'")
    assert len(parts) >= 2, f"{arrivals!r} needs a rate, e.g. 'poisson:2'"
    rate = float(parts[1])
    if kind == "poisson":
        assert len(parts) == 2, arrivals
        return poisson(rate)
    if kind == "lognormal":
        assert len(parts) <= 3, arrivals
        return lognormal(rate, *(float(p) for p in parts[2:]))
    assert len(parts) <= 4, arrivals
    burst = int(parts[2]) if len(parts) > 2 else 8
    duty = float(parts[3]) if len(parts) > 3 else 0.25
    return bursty(rate, burst, duty)


def label(arrivals) -> str:
    """Axis/row label: the process label, or ``closed`` for no process."""
    a = resolve(arrivals)
    return "closed" if a is None else a.label()


# ---------------- deterministic uniforms (counter-based splitmix64) -------
_GOLDEN = np.uint64(0x9E3779B97F4A7C15)


def _mix64(x: np.ndarray) -> np.ndarray:
    """splitmix64 finalizer — a bijective avalanche on uint64."""
    x = x ^ (x >> np.uint64(30))
    x = x * np.uint64(0xBF58476D1CE4E5B9)
    x = x ^ (x >> np.uint64(27))
    x = x * np.uint64(0x94D049BB133111EB)
    return x ^ (x >> np.uint64(31))


def _uniform01(seed: int, stream: int, n: int) -> np.ndarray:
    """n doubles in [0, 1), keyed on (seed, stream, index) — stateless, so
    identical on every host/executor/backend by construction."""
    with np.errstate(over="ignore"):
        base = (np.uint64(int(seed) & 0xFFFFFFFF)
                * np.uint64(0x632BE59BD9B4E019)
                + np.uint64(int(stream)) * np.uint64(0xD6E8FEB86659FD93))
        ctr = (np.arange(1, n + 1, dtype=np.uint64) * _GOLDEN) + base
        bits = _mix64(ctr)
    # top 53 bits -> [0, 1) at full double precision
    return (bits >> np.uint64(11)).astype(np.float64) * (2.0 ** -53)


def _gaps_ns(process: ArrivalProcess, n: int, seed: int) -> np.ndarray:
    """``n`` float inter-arrival gaps with mean ``process.mean_gap_ns``."""
    if n <= 0:
        return np.zeros(0, np.float64)
    mean = process.mean_gap_ns
    if process.kind == "poisson":
        u = _uniform01(seed, 1, n)
        return -np.log1p(-u) * mean
    if process.kind == "lognormal":
        # Box-Muller on two independent streams; mu chosen so the
        # *mean* (not the median) of the gap distribution is `mean`
        u1 = _uniform01(seed, 1, n)
        u2 = _uniform01(seed, 2, n)
        z = np.sqrt(-2.0 * np.log1p(-u1)) * np.cos(2.0 * np.pi * u2)
        mu = np.log(mean) - 0.5 * process.sigma ** 2
        return np.exp(mu + process.sigma * z)
    # bursty on-off: every burst_len-th gap is the long off-gap, the rest
    # are duty-compressed; the weights average to exactly `mean`, and the
    # exponential jitter (mean 1) preserves it
    u = _uniform01(seed, 3, n)
    on_gap = mean * process.duty
    off_gap = process.burst_len * mean - (process.burst_len - 1) * on_gap
    pos = (np.arange(1, n + 1, dtype=np.int64)) % process.burst_len
    base = np.where(pos == 0, off_gap, on_gap)
    return base * (-np.log1p(-u))


def release_times(process: ArrivalProcess, n_tasks: int,
                  seed: int = 0) -> np.ndarray:
    """Per-task release stamps: ``(n_tasks,)`` int64 ns, non-negative and
    sorted, with ``release[0] == 0`` (the root is immediately runnable).
    Deterministic in ``(process, n_tasks, seed)`` — bitwise identical
    across hosts, executors, and backends."""
    assert n_tasks >= 1, n_tasks
    gaps = np.maximum(np.rint(_gaps_ns(process, n_tasks - 1, seed)), 0.0)
    rel = np.zeros(n_tasks, np.int64)
    rel[1:] = np.cumsum(gaps.astype(np.int64))
    assert rel[-1] <= _MAX_RELEASE, \
        ("arrival schedule overflows the int32 virtual clock "
         f"({process.label()}, n_tasks={n_tasks}, last={rel[-1]})")
    return rel


def padded_release(process: Optional[ArrivalProcess], n_tasks: int,
                   seed: int, pad_to: int) -> np.ndarray:
    """The traced ``(pad_to,)`` int32 vector ``SweepCase`` carries: real
    release stamps for the first ``n_tasks`` entries, the last stamp
    repeated beyond (padding tasks are never spawned, so the fill is
    unread — it only keeps shapes uniform across a stacked chunk).
    ``process=None`` is the closed system's all-zero vector."""
    pad_to = max(pad_to, n_tasks)
    if process is None:
        return np.zeros(pad_to, np.int32)
    rel = release_times(process, n_tasks, seed)
    out = np.full(pad_to, rel[-1], np.int64)
    out[:n_tasks] = rel
    return out.astype(np.int32)


# ---------------- SLO reduction ----------------
def slo_metrics(done_ns, release_ns, n_tasks: int) -> dict:
    """Tail-latency/throughput record from per-task completion stamps.

    ``done_ns`` holds per-task completion clocks (−1 = never completed),
    ``release_ns`` the matching release stamps; only the first ``n_tasks``
    entries of either are real (the rest is lane padding).  Percentiles
    are *nearest-rank* over completed tasks (exact order statistics on
    integers — no interpolation, so results are bitwise-comparable);
    throughput is completions over the busy span ``max(done) −
    min(release)`` among completed tasks.
    """
    done = np.asarray(done_ns, np.int64)[:n_tasks]
    rel = np.asarray(release_ns, np.int64)[:n_tasks]
    ok = done >= 0
    n_completed = int(ok.sum())
    if n_completed == 0:
        return dict(n_completed=0, p50_ns=-1, p90_ns=-1, p99_ns=-1,
                    span_ns=0, throughput_tasks_per_s=0.0)
    lat = np.sort(done[ok] - rel[ok])

    def pct(q: float) -> int:
        # nearest-rank: the ceil(q/100 * n)-th smallest, 1-indexed
        idx = max(int(np.ceil(q / 100.0 * n_completed)) - 1, 0)
        return int(lat[idx])

    span = max(int(done[ok].max() - rel[ok].min()), 1)
    return dict(n_completed=n_completed, p50_ns=pct(50.0), p90_ns=pct(90.0),
                p99_ns=pct(99.0), span_ns=span,
                throughput_tasks_per_s=n_completed * 1e9 / span)


#: the per-case SLO arrays a sweep result carries (see sweep.SweepResult)
SLO_FIELDS = ("p50_ns", "p90_ns", "p99_ns", "throughput_tasks_per_s")

