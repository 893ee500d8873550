"""Multi-host serving: replicated-control scheduler driving.

BASELINE config 5 (70B over >=2 hosts) runs the schedulers under JAX's
multi-controller model: one Python process per host, every process
executing the SAME jitted computations in the SAME order.  The
schedulers (runtime/scheduler.py, runtime/paged_scheduler.py) are
host-driven — admission, page tables, slot bookkeeping are plain Python
over numpy — so multi-host correctness reduces to one invariant:

    every process must make IDENTICAL control decisions.

Everything a scheduler decides from device results already satisfies
this (device results are replicated outputs of replicated programs) —
the only non-deterministic inputs are the EXTERNAL ones: which requests
arrive, in what order, and when they are cancelled.  This module makes
those explicit: process 0 (the coordinator) owns the external world
(HTTP frontend, request queue, cancellations) and broadcasts a control
packet each step; followers replay the packet into their local
scheduler and step in lockstep.  Packets ride
`jax.experimental.multihost_utils.broadcast_one_to_all` (two-phase:
fixed-shape length, then the payload), i.e. the same device collectives
as the model — no side channel to configure.

The reference has no multi-process anything (SURVEY.md §2.6); this is
the JAX multi-controller design for its serving capability at the
70B scale.
Exercised in CI via an in-process fake transport pair
(tests/test_multihost_serving.py); the broadcast path is the standard
multihost_utils idiom and activates under a real per-host launcher.
"""

from __future__ import annotations

import base64
import json
from typing import Callable, List, Optional

import numpy as np

from tokenhawk_tpu.config import SamplingConfig
from tokenhawk_tpu.runtime.scheduler import Request


def _jax_broadcast(payload: Optional[bytes]) -> bytes:
    """Two-phase broadcast_one_to_all: length (fixed shape), then data."""
    import jax
    from jax.experimental import multihost_utils

    if jax.process_count() == 1:
        return payload or b""
    buf = np.frombuffer(payload or b"", np.uint8)
    n = multihost_utils.broadcast_one_to_all(
        np.asarray([buf.size], np.int32))
    data = multihost_utils.broadcast_one_to_all(
        np.zeros((int(n[0]),), np.uint8) if buf.size != int(n[0]) else buf)
    return bytes(np.asarray(data, np.uint8))


def encode_packet(reqs: List[Request], cancels: List[int],
                  stop: bool = False) -> bytes:
    """Admissions + cancellations + loop control -> deterministic wire
    bytes.

    EVERYTHING a scheduler uses to make control decisions must travel
    here: prompt, budget, sampling, stop sequences (they retire slots),
    and the session id (it pins/evicts slots).  Callbacks and detok do
    NOT travel — callbacks are external-world effects, and detok is a
    pure tokenizer mapping every process reconstructs locally from the
    same model file (the driver's `detok` argument)."""
    def sp(r):
        if r.sampling is None:
            return None
        s = r.sampling
        return [s.temperature, s.top_k, s.top_p, s.repeat_penalty,
                s.repeat_last_n, s.seed]

    return json.dumps({
        "reqs": [
            [list(r.prompt), r.max_new_tokens, sp(r),
             [base64.b64encode(s).decode() for s in r.stop]
             if r.stop else None,
             r.session]
            for r in reqs
        ],
        "cancel": list(cancels),
        "stop": bool(stop),
    }).encode()


def decode_packet(data: bytes):
    if not data:
        return [], [], False
    obj = json.loads(data.decode())
    reqs = []
    for prompt, mnt, sp, stop_seqs, session in obj["reqs"]:
        sampling = None
        if sp is not None:
            sampling = SamplingConfig(
                temperature=sp[0], top_k=int(sp[1]), top_p=sp[2],
                repeat_penalty=sp[3], repeat_last_n=int(sp[4]),
                seed=int(sp[5]))
        reqs.append(Request(
            prompt=prompt, max_new_tokens=mnt, sampling=sampling,
            stop=[base64.b64decode(s) for s in stop_seqs]
            if stop_seqs is not None else None,
            session=session))
    return reqs, obj["cancel"], obj.get("stop", False)


class MultihostServingDriver:
    """Lockstep scheduler driver for one process of a multi-host slice.

    Coordinator (process 0): call `submit()` with externally-arriving
    requests (they queue locally, NOT in the scheduler), then `step()`
    in a loop.  Followers: construct with their own scheduler over the
    same sharded weights and call `step()` in the same loop — admissions
    arrive via the broadcast.  Callbacks (`on_token` / streaming) only
    fire with data on the coordinator's request objects; follower
    schedulers compute the identical tokens (replicated jit outputs) and
    discard them.
    """

    def __init__(self, sched, is_coordinator: Optional[bool] = None,
                 broadcast: Callable[[Optional[bytes]], bytes] = _jax_broadcast,
                 detok: Optional[Callable[[int], bytes]] = None):
        import jax

        self.sched = sched
        self.is_coordinator = (jax.process_index() == 0
                               if is_coordinator is None else is_coordinator)
        self._bcast = broadcast
        # Local token->bytes mapping for requests reconstructed from the
        # packet.  Stop-sequence retirement is a CONTROL decision, so
        # every process must run the same detok; it's a pure function of
        # the (shared) model file, so each process builds its own from
        # its tokenizer rather than shipping it on the wire.
        self._detok = detok
        self._queue: List[Request] = []
        self._cancels: List[int] = []
        # replay_id -> submitted Request, maintained in REPLAY ORDER on
        # every process, so a coordinator cancel(replay_id) resolves to
        # the same logical request everywhere (schedulers cancel by
        # object identity).
        self._replay: dict = {}
        self._next_replay_id = 0

    # -- coordinator-side external API ----------------------------------

    def submit(self, req: Request) -> int:
        """Queue a request; returns its replay id (pass to cancel()).

        Replay ids are assigned in queue order, which is packet order,
        which is follower submit order — the same numbering everywhere.
        """
        if not self.is_coordinator:
            raise RuntimeError("submit() is coordinator-only; followers "
                               "receive admissions via the broadcast")
        if req.stop and req.detok is None:
            req.detok = self._detok
        if req.stop and req.detok is None:
            raise ValueError(
                "request has stop sequences but no detok: stop matching "
                "is a control decision and would never fire (pass detok "
                "on the request or to the driver)")
        rid = self._next_replay_id
        self._next_replay_id += 1
        self._replay[rid] = req
        self._queue.append(req)
        return rid

    def cancel(self, replay_id: int) -> None:
        if not self.is_coordinator:
            raise RuntimeError("cancel() is coordinator-only")
        self._cancels.append(replay_id)

    # -- lockstep loop ----------------------------------------------------

    def step(self, stop: bool = False) -> bool:
        """One replicated control round: broadcast external decisions,
        replay them into the local scheduler, advance one step.

        Returns True while the loop should continue; False after a stop
        round (no scheduler step runs on a stop round).  EVERY control
        decision — admissions, cancellations, and loop termination — is
        the coordinator's and travels in the packet, so followers never
        consult local state to decide control flow."""
        if self.is_coordinator:
            packet = encode_packet(self._queue, self._cancels, stop=stop)
            pending, self._queue = self._queue, []
            self._cancels = []
        else:
            packet, pending = None, []
        data = self._bcast(packet)
        reqs, cancels, stopped = decode_packet(data)
        if stopped:
            return False
        if self.is_coordinator:
            # Submit the coordinator's ORIGINAL objects (callbacks and
            # all); the packet is what followers reconstruct from.
            for r in pending:
                self.sched.submit(r)
        else:
            for r in reqs:
                if r.stop:
                    if self._detok is None:
                        raise RuntimeError(
                            "packet request carries stop sequences but "
                            "this follower has no detok — stop matching "
                            "would diverge from the coordinator")
                    r.detok = self._detok
                rid = self._next_replay_id
                self._next_replay_id += 1
                self._replay[rid] = r
                self.sched.submit(r)
        for rid in cancels:
            # Schedulers cancel by Request object identity; resolve the
            # wire id through the replay map (an id for an already-
            # finished request resolves but no-ops in the scheduler).
            req = self._replay.get(rid)
            if req is not None and hasattr(self.sched, "cancel"):
                self.sched.cancel(req)
        self.sched.step()
        # Prune finished entries so long-lived serving doesn't leak one
        # Request per admission forever.
        if self._replay:
            self._replay = {i: r for i, r in self._replay.items()
                            if r.done_at is None}
        return True

    @property
    def has_work(self) -> bool:
        """Coordinator-side view (local queue + scheduler).  Followers
        never consult this for control flow — they obey the packet."""
        return bool(self._queue) or self.sched.has_work

    def run(self) -> None:
        """Drain to idle in lockstep.

        Coordinator: rounds while it has work, then one stop round.
        Follower: rounds until the stop packet arrives — it never looks
        at local state to terminate (its has_work may flip a round
        before/after the coordinator's due to callback-only effects)."""
        if self.is_coordinator:
            while self.has_work:
                self.step()
            self.step(stop=True)
        else:
            while self.step():
                pass
