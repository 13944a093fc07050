"""The closed loop, driving a session on the wall clock.

It submits through ``Session.submit`` and observes completions through
``Session.run(on_complete=...)``; every time it records is the host's
``perf_counter``, taken by the benchmark. ``hooks.open()`` runs as the
window opens and ``hooks.close()`` at the first completion at or past its
close (counter snapshots, the traced run's spans and profiler). The loop
stops the session's run by raising ``WindowDone`` from the completion
callback, after which the caller closes the session, which cancels
whatever is still running.

Closed loop (the paper's §6.3): ``clients`` queries outstanding, each
completion sends the next instance of the mix. The clients start
``stagger_s`` apart: a client's next query starts where its last one ended
in the shared scans' cycle, so clients started together would stay in
step and complete in waves. The window opens at the completion that gives
every client its first (the warm phase before it is set-up) and closes
``seconds`` later. The window's queries are those sent before the close
and running in the window at any time: each counts with the share of its
time from sending to completion that lies inside the window, so a rate
over the window counts all of its work, and none twice. After the close
the clients go on sending, so the window's queries finish under the
window's load; those later queries only keep the load and are not the
window's. The loop ends when the last window query completes; one not
done ``drain_s`` after the close has failed.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional


class WindowDone(Exception):
    """Raised from the completion callback to end the session's run."""


@dataclass
class Request:
    template: str
    params: Dict
    arrival: float  # host seconds of submission
    future: object = None
    done_at: Optional[float] = None


#: every query's deadline, from its arrival: a stalled query is cut
#: there, and the run ends instead of hanging
LAST_RESORT_S = 300.0


@dataclass
class Window:
    open_at: Optional[float] = None
    close_at: Optional[float] = None
    closing: bool = False  # past the close: the window's queries drain
    requests: List[Request] = field(default_factory=list)  # the window's own
    completed_before: int = 0  # completions in the warm phase

    @property
    def seconds(self) -> float:
        return self.close_at - self.open_at


def closed_loop(session, build, stream, clients: int, stagger_s: float, seconds: float,
                drain_s: float, hooks) -> Window:
    """``build(template, params, arrival)`` makes a query; ``stream``
    yields (template, params). Client c sends its first query
    ``c * stagger_s`` after the loop starts."""
    win = Window()
    outstanding: Dict[int, Request] = {}  # qid -> request
    client_of: Dict[int, int] = {}
    waiting = set(range(clients))  # clients without a completion yet
    draining = set()  # qids of the window's queries running at the close
    offset = time.perf_counter() - session.now  # session clock -> host clock
    sent: List[Request] = []  # before the close

    def send(client: int, delay: float = 0.0) -> None:
        t, p = next(stream)
        arrival = session.now + delay
        req = Request(t, p, arrival + offset)
        req.future = session.submit(build(t, p, arrival), deadline=arrival + LAST_RESORT_S)
        outstanding[req.future.qid] = req
        client_of[req.future.qid] = client
        if not win.closing:
            sent.append(req)

    def completed(qid: int, now: float) -> None:
        req = outstanding.pop(qid)
        req.done_at = now
        client = client_of.pop(qid)
        if win.open_at is None:
            waiting.discard(client)
            if not waiting:
                hooks.open()
                win.open_at = time.perf_counter()
                win.close_at = win.open_at + seconds
        elif now >= win.close_at and not win.closing:
            win.closing = True
            hooks.close()
            draining.update(outstanding)
        if win.closing:
            draining.discard(qid)
            if not draining or now > win.close_at + drain_s:
                raise WindowDone  # the rest is cut; a window query among it has failed
        send(client)

    def sweep(now: float) -> None:
        # a query can complete as it is admitted (an aggregate it attaches
        # to is already done), without a callback of its own
        while True:
            done = [qid for qid, r in outstanding.items() if r.future.done]
            if not done:
                return
            for qid in done:
                completed(qid, now)

    def on_complete(fut):
        now = time.perf_counter()
        if fut.qid in outstanding:
            completed(fut.qid, now)
        sweep(now)
        return None

    for c in range(clients):
        send(c, c * stagger_s)
    try:
        sweep(time.perf_counter())
        session.run(on_complete=on_complete)
    except WindowDone:
        pass
    if not win.closing:
        raise RuntimeError("the closed loop ran dry before its window closed")
    win.requests = [r for r in sent if r.done_at is None or r.done_at > win.open_at]
    win.completed_before = len(sent) - len(win.requests)
    return win
