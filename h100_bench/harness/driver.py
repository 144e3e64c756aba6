"""The measured window: the engine's own serving loop (``add_request`` and
``run``), fed by a closed or an open loop.

* **Closed loop**: ``clients`` users, each sending its next request the
  moment its last one finishes (no think time).  A client's next request
  is added from the engine's ``on_token`` hook, on the engine's thread.
  When the window closes every request still in flight is cancelled (its
  tokens after the close count for nothing).
* **Open loop**: arrivals on the mix's schedule from one feeder thread,
  each request stamped with its *due* time, whenever the engine gets to
  it; the engine's loop is kept alive between arrivals (``run([])`` again
  while the window is open), and after the close the requests due in the
  window are drained, for at most ``drain_s``.

Every token's delivery is stamped by the hook, on the host's monotonic
clock, as are the engine's own request stamps.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional

from harness import program
from harness.traffic import Traffic


class Window:
    """What one window saw: the requests issued (with their due times), the
    tokens delivered inside it, the engine's stats at its open and close,
    the feeder's lateness and the queue's length over time."""

    def __init__(self, eng, seconds: float):
        self.eng = eng
        self.seconds = seconds
        self.t0 = 0.0
        self.t_end = 0.0
        self.requests: List[Any] = []
        self.due: List[float] = []
        self.tokens_in_window = 0
        self.stats0: Dict[str, Any] = {}
        self.stats1: Optional[Dict[str, Any]] = None
        self.closed_at: Optional[float] = None
        self.lateness: List[float] = []
        self.queue: List[tuple] = []  # (seconds since open, outstanding)
        self.unfinished = 0
        self._last_q = -1.0

    def open(self, on_open: Optional[Callable[[float], None]]) -> None:
        self.stats0 = program.stats_snapshot(self.eng)
        self.t0 = time.monotonic()
        self.t_end = self.t0 + self.seconds
        if on_open is not None:
            on_open(self.t0)

    def close(self, now: float) -> bool:
        """Close at the first boundary past the end; True the first time."""
        if self.stats1 is None and now >= self.t_end:
            self.stats1 = program.stats_snapshot(self.eng)
            self.closed_at = now
            return True
        return False

    def _sample_queue(self, now: float) -> None:
        if now - self._last_q >= 0.05 and now <= self.t_end:
            self._last_q = now
            done = sum(1 for r in self.requests if r.done)
            self.queue.append((now - self.t0, len(self.requests) - done))


def closed_loop(eng, traffic: Traffic, clients: int, seconds: float,
                on_open: Optional[Callable[[float], None]] = None) -> Window:
    """``clients`` users without think time, for ``seconds``;
    ``on_open(t0)`` is called as the window opens."""
    w = Window(eng, seconds)
    nxt = [0]

    def issue(now: float) -> None:
        prompt, out = traffic.request(nxt[0])
        nxt[0] += 1
        r = program.request(prompt, out)
        r.t_enqueue = now
        w.requests.append(r)
        w.due.append(now)
        eng.add_request(r)

    def on_token(req, tok) -> None:
        now = time.monotonic()
        if now <= w.t_end:
            w.tokens_in_window += 1
        elif w.close(now):
            for r in w.requests:
                if not r.done:
                    eng.cancel(r)
        if req.done and w.stats1 is None:
            issue(now)

    eng.on_token = on_token
    w.open(on_open)
    for _ in range(clients):
        issue(w.t0)
    while w.stats1 is None:
        eng.run([])
        if w.stats1 is None:
            w.close(time.monotonic())
    eng.run([])  # the cancelled requests leave their slots
    eng.on_token = None
    return w


def open_loop(eng, traffic: Traffic, seconds: float, drain_s: float = 60.0,
              on_open: Optional[Callable[[float], None]] = None) -> Window:
    """Arrivals at the mix's rate for ``seconds``, then the drain;
    ``on_open(t0)`` is called as the window opens."""
    w = Window(eng, seconds)
    offsets = traffic.arrivals(seconds)
    reqs = []
    for i in range(len(offsets)):
        prompt, out = traffic.request(i)
        reqs.append(program.request(prompt, out))
    stop = threading.Event()

    def feed() -> None:
        for off, r in zip(offsets, reqs):
            due = w.t0 + off
            while not stop.is_set():
                left = due - time.monotonic()
                if left <= 0:
                    break
                stop.wait(min(left, 0.05))
            if stop.is_set():
                return
            r.t_enqueue = due
            w.requests.append(r)
            w.due.append(due)
            eng.add_request(r)
            w.lateness.append(time.monotonic() - due)

    def on_token(req, tok) -> None:
        now = time.monotonic()
        if now <= w.t_end:
            w.tokens_in_window += 1
            w._sample_queue(now)
        else:
            w.close(now)

    eng.on_token = on_token
    feeder = threading.Thread(target=feed, name="h100_bench-feeder")
    w.open(on_open)
    feeder.start()
    deadline = w.t_end + drain_s
    try:
        while True:
            eng.run([])
            now = time.monotonic()
            w.close(now)
            w._sample_queue(now)
            if (not feeder.is_alive() and len(w.requests) == len(reqs)
                    and all(r.done for r in reqs)):
                break
            if now > deadline:
                break
            time.sleep(0.0002)
    finally:
        stop.set()
        feeder.join(timeout=10)
    late = [r for r in w.requests if not r.done]
    w.unfinished = len(late) + (len(reqs) - len(w.requests))
    for r in late:
        eng.cancel(r)
    eng.run([])
    eng.on_token = None
    return w
