"""graftsurge load model: the Python twin of the C++ client's
multi-user open-loop generator (native/src/node/rate_pacer.hpp
``UserLoadModel``); the port's copy of hotstuff_tpu/harness/loadgen.py,
unchanged but for this line.

The C++ model drives live benches; this one drives everything that
cannot boot a committee — the bench ``surge`` headline probe, the
scheduler overload tests, and any harness experiment that needs a
seeded heavy-tailed arrival stream on a virtual clock.  The two share
one model (not one implementation): N users, each with mean-1
heavy-tailed inter-arrival multipliers (lognormal ``exp(sigma Z -
sigma^2/2)`` or Pareto ``xm U^(-1/alpha)``, ``xm = (alpha-1)/alpha``)
on a per-user mean gap of ``users / rate`` seconds, an optional
sinusoidal diurnal profile with mean exactly 1 over its period, and
per-user jittered exponential backoff on BUSY.  Aggregate mean rate ==
``rate`` by construction.

Everything is deterministic in the seed, and all time is
caller-supplied seconds — no wall clock anywhere (the graftlint timing
rules stay quiet because there is nothing to fence)."""

from __future__ import annotations

import heapq
import math
import random

LOGNORMAL = "lognormal"
PARETO = "pareto"


class UserLoad:
    def __init__(self, rate: float, users: int, seed: int = 1,
                 dist: str = LOGNORMAL, sigma: float = 1.5,
                 alpha: float = 2.5, diurnal_amp: float = 0.0,
                 diurnal_period_s: float = 600.0,
                 busy_base_s: float = 0.05):
        if dist not in (LOGNORMAL, PARETO):
            raise ValueError(f"unknown arrival dist {dist!r}")
        if rate <= 0 or users < 1:
            raise ValueError("rate must be > 0 and users >= 1")
        self.rate = float(rate)
        self.users = int(users)
        self.dist = dist
        self.sigma = float(sigma)
        self.alpha = max(1.05, float(alpha))
        self.diurnal_amp = float(diurnal_amp)
        self.diurnal_period_s = float(diurnal_period_s)
        self.busy_base_s = float(busy_base_s)
        self._rng = random.Random(seed)
        self._mean_gap = self.users / self.rate
        # (next_arrival_t, user) min-heap; random start phase keeps the
        # aggregate at its mean rate from t=0.
        self._heap = [(self._rng.uniform(0.0, self._mean_gap), u)
                      for u in range(self.users)]
        heapq.heapify(self._heap)
        self._attempts = [0] * self.users
        self._busy_until = -1.0
        self._busy_hint_s = 0.0
        self.sent = 0
        self.deferred = 0
        self.busy_events = 0

    def profile(self, t: float) -> float:
        """Diurnal rate multiplier at t (mean exactly 1 per period)."""
        if self.diurnal_amp <= 0.0:
            return 1.0
        return 1.0 + self.diurnal_amp * math.sin(
            2.0 * math.pi * t / self.diurnal_period_s)

    def sample_gap(self, t: float) -> float:
        """One inter-arrival gap for a user at time t (test hook; drawn
        from the generator's own rng stream)."""
        if self.dist == PARETO:
            u = max(1e-12, self._rng.random())
            x = (self.alpha - 1.0) / self.alpha * u ** (-1.0 / self.alpha)
        else:
            z = self._rng.gauss(0.0, 1.0)
            x = math.exp(self.sigma * z - 0.5 * self.sigma * self.sigma)
        return max(self._mean_gap * x / self.profile(t), 1e-9)

    def arrivals(self, now: float, out_users: list | None = None) -> int:
        """Transactions due at `now` (monotonic calls).  Arrivals inside
        a busy window defer per-user with jittered exponential backoff —
        deferred, never dropped (this is an open loop).  graftingress:
        ``out_users`` (optional) receives the user index of each due
        arrival in order — the signed-ingress probe derives the per-user
        keypair from it (same contract as the C++ UserLoadModel)."""
        due = 0
        while self._heap and self._heap[0][0] <= now:
            t, user = heapq.heappop(self._heap)
            if t < self._busy_until:
                self._attempts[user] = min(self._attempts[user] + 1, 6)
                base = max(self._busy_hint_s, self.busy_base_s)
                delay = base * (2 ** self._attempts[user]) * \
                    self._rng.uniform(0.5, 1.5)
                heapq.heappush(self._heap,
                               (self._busy_until + delay, user))
                self.deferred += 1
                continue
            self._attempts[user] = 0
            due += 1
            self.sent += 1
            if out_users is not None:
                out_users.append(user)
            heapq.heappush(self._heap, (t + self.sample_gap(t), user))
        return due

    def busy(self, now: float, hint_s: float = 0.0):
        """A BUSY reply observed at `now` with a retry-after hint."""
        self._busy_hint_s = max(0.0, float(hint_s))
        self._busy_until = max(
            self._busy_until,
            now + max(self._busy_hint_s, self.busy_base_s))
        self.busy_events += 1
