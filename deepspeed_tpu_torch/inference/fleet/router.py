"""The fleet router: least-loaded dispatch and at-most-once completion
accounting over N replicas (counterpart of
``deepspeed_tpu/inference/fleet/router.py``).

The router owns the fleet-wide request ids (``rid``) and three tables:

* ``pending``: rid -> record (the wire message and the replica holding it).
  A request is pending from submit until its first ``done``; a replica's
  death or refusal sends it back through ``dispatch`` (a fresh choice of
  replica) without losing it.
* ``completed``: rid -> done message, the first completion wins. A migrated
  or re-admitted request can finish twice (a SIGTERM'd replica's ack raced
  its death; a re-admission after SIGKILL re-ran work whose ``done`` was
  never flushed): duplicates are counted (``duplicate_completions``), never
  delivered twice. That is the at-most-once half; re-admission after a
  death is the at-least-once half.
* ``replicas``: name -> handle (``LocalReplica`` or ``SubprocessReplica``;
  the router never tells them apart).

Dispatch is least-loaded with prefix affinity: a replica's tick signals
advertise the ``prefix_key`` of its indexed position-0 KV blocks
(``prefix_hot``) and its block size; a request whose prompt's first block
matches an advertised key goes to the least-loaded matching replica, whose
prefix cache already holds that KV, unless that replica has more than
``affinity_load_gap`` requests more outstanding than the least-loaded
replica (affinity never defeats balancing under pressure). Between ticks
the router's own ``_affinity_recent`` map remembers where each prefix key
last went, so a burst of one prefix lands together before the target's
next tick advertises the block. Liveness is ``alive`` (the exit code) and,
for subprocess replicas, the heartbeat's age; a dead replica's pending
rids are re-dispatched, and its bundle (a SIGTERM that died before a peer
took it) is re-admitted from disk.
"""

import itertools
import logging
import os
import time
from typing import Dict, List, Optional

from deepspeed_tpu_torch.inference.fleet import protocol
from deepspeed_tpu_torch.inference.fleet.migrate import bundle_rids, load_bundle
from deepspeed_tpu_torch.inference.serving.blocks import prefix_key
from deepspeed_tpu_torch.inference.serving.scheduler import MigrationError

logger = logging.getLogger(__name__)


class FleetRouter:
    """Load-balance requests across replicas; survive their deaths."""

    def __init__(self, telemetry=None, heartbeat_timeout: float = 30.0,
                 affinity: bool = True, affinity_load_gap: float = 8.0):
        self.replicas: Dict[str, object] = {}
        self.telemetry = telemetry
        self.heartbeat_timeout = float(heartbeat_timeout)
        #: prefix-affinity dispatch (the A/B control arm sets False to
        #: measure pure least-loaded on the same trace)
        self.affinity = bool(affinity)
        self.affinity_load_gap = float(affinity_load_gap)
        self._rid_counter = itertools.count()
        #: rid -> {"msg": wire request, "replica": name|None}
        self.pending: Dict[str, dict] = {}
        #: rid -> first done message (at-most-once delivery table)
        self.completed: Dict[str, dict] = {}
        #: rid -> terminal refusal (no alive replica could take it)
        self.failed: Dict[str, str] = {}
        self.duplicate_completions = 0
        self.readmitted = 0  # re-dispatches after death/refusal/migration
        #: replica name -> completions it delivered (balance evidence)
        self.completed_by: Dict[str, int] = {}
        #: prefix key -> replica name of the last dispatch (covers the
        #: advertisement lag of pipe-borne tick signals)
        self._affinity_recent: Dict[str, str] = {}
        self.affinity_hits = 0      # dispatches routed by prefix match
        self.affinity_overruled = 0  # matches dropped by the load-gap guard

    # -- fleet membership ----------------------------------------------
    def add_replica(self, name: str, replica) -> None:
        if name in self.replicas:
            raise ValueError(f"duplicate replica name {name!r}")
        self.replicas[name] = replica

    def remove_replica(self, name: str) -> None:
        self.replicas.pop(name, None)

    def alive_replicas(self) -> Dict[str, object]:
        return {n: r for n, r in self.replicas.items() if self._is_alive(r)}

    def _is_alive(self, replica) -> bool:
        if not replica.alive:
            return False
        age_fn = getattr(replica, "heartbeat_age", None)
        if age_fn is not None:
            age = age_fn()
            if age is not None and age > self.heartbeat_timeout:
                return False  # wedged inside a dispatch: exit never fires
        return True

    # -- submission ----------------------------------------------------
    def submit(self, prompt, max_new_tokens: int,
               eos_token_id: Optional[int] = None) -> str:
        """Admit one request to the fleet; returns its fleet-wide rid."""
        rid = f"r{next(self._rid_counter)}"
        msg = protocol.request_msg(rid, prompt, max_new_tokens, eos_token_id)
        self.pending[rid] = {"msg": msg, "replica": None}
        self.dispatch(rid)
        return rid

    def dispatch(self, rid: str) -> Optional[str]:
        """Send a pending rid to the least-loaded alive replica; returns
        the chosen name (None = no alive replica, stays queued with the
        router until one appears)."""
        rec = self.pending.get(rid)
        if rec is None:
            return None
        alive = self.alive_replicas()
        if not alive:
            rec["replica"] = None
            return None
        name = self._pick_replica(alive, rec["msg"].get("prompt"))
        rec["replica"] = name
        alive[name].send(rec["msg"])
        return name

    def _pick_replica(self, alive: Dict[str, object], prompt) -> str:
        """Least-loaded, upgraded by prefix affinity: prefer the least-
        loaded replica whose advertised ``prefix_hot`` set (or the
        router's own recent-dispatch memory) covers the prompt's first
        block, unless it is ``affinity_load_gap`` busier than the global
        least-loaded pick."""
        base = min(sorted(alive), key=lambda n: alive[n].load())
        if not self.affinity or prompt is None:
            return base
        keys, cands = set(), []
        for n in sorted(alive):
            sig = getattr(alive[n], "signals", lambda: None)() or {}
            bs = sig.get("prefix_block_size")
            if not bs or len(prompt) < bs:
                continue  # < one full block can never match a hot key
            key = prefix_key(prompt[:bs])
            keys.add(key)
            if key in (sig.get("prefix_hot") or ()):
                cands.append(n)
        for key in keys:
            n = self._affinity_recent.get(key)
            if n in alive and n not in cands:
                cands.append(n)
        if not cands:
            for key in keys:
                self._affinity_recent[key] = base
            return base
        best = min(sorted(cands), key=lambda n: alive[n].load())
        if alive[best].load() - alive[base].load() > self.affinity_load_gap:
            self.affinity_overruled += 1
            choice = base
        else:
            self.affinity_hits += 1
            choice = best
        for key in keys:
            self._affinity_recent[key] = choice
        return choice

    # -- event pump ----------------------------------------------------
    def poll(self) -> List[dict]:
        """Drain every replica's outbox, update the accounting tables,
        recover from deaths. Returns the raw messages (tests inspect)."""
        seen: List[dict] = []
        for name, replica in list(self.replicas.items()):
            for msg in replica.poll():
                seen.append(msg)
                self._handle(name, msg)
        for name, replica in list(self.replicas.items()):
            if not self._is_alive(replica):
                self._handle_death(name, replica)
        return seen

    def _handle(self, name: str, msg: dict) -> None:
        kind = msg["type"]
        if kind == "done":
            rid = msg.get("rid")
            self.pending.pop(rid, None)
            if rid in self.completed:
                self.duplicate_completions += 1
                logger.info(f"fleet: duplicate completion for {rid} "
                         f"(from {name}) — first delivery wins")
            else:
                self.completed[rid] = msg
                self.completed_by[name] = self.completed_by.get(name, 0) + 1
        elif kind == "refused":
            rid = msg.get("rid")
            rec = self.pending.get(rid)
            if rec is not None:
                # a drain refusal or admission refusal on one replica is
                # not terminal for the fleet: re-dispatch anywhere else.
                # A request EVERY replica refuses (oversized prompt) is —
                # bounded retries keep it from ping-ponging forever.
                rec["retries"] = rec.get("retries", 0) + 1
                if rec["retries"] > len(self.replicas) + 1:
                    self.failed[rid] = msg.get("reason", "refused")
                    self.pending.pop(rid, None)
                    return
                self.readmitted += 1
                if self.dispatch(rid) is None:
                    self.failed[rid] = msg.get("reason", "refused")
                    self.pending.pop(rid, None)
        elif kind == "migrated_out":
            self._place_bundle(name, msg["bundle"], msg.get("rids") or [])
        elif kind == "migrated_in":
            for rid in msg.get("rids") or []:
                if rid in self.pending:
                    self.pending[rid]["replica"] = name
            for rid in msg.get("refused_rids") or []:
                if rid in self.pending:
                    self.readmitted += 1
                    self.dispatch(rid)
        # 'ready' / 'tick' / 'bye' need no table updates (tick signals are
        # cached by the replica handle itself for load())

    def _place_bundle(self, origin: str, bundle: str, rids: List) -> None:
        """Hand a SIGTERM'd replica's bundle to a peer (migrate_in). With
        no alive peer the bundle stays on disk; the rids stay pending and
        a later re-dispatch re-runs them from the prompt."""
        peers = {n: r for n, r in self.alive_replicas().items() if n != origin}
        if not peers:
            logger.info(f"fleet: no peer for bundle {bundle} — "
                     f"{len(rids)} requests will re-run from scratch")
            for rid in rids:
                if rid in self.pending:
                    self.pending[rid]["replica"] = None
            return
        peer = min(sorted(peers), key=lambda n: peers[n].load())
        for rid in rids:
            if rid in self.pending:
                self.pending[rid]["replica"] = peer
        peers[peer].send({"type": "migrate_in", "bundle": bundle})
        if self.telemetry is not None:
            self.telemetry.emit("fleet_migrate_route", origin=origin,
                                peer=peer, bundle=bundle, rids=len(rids))

    def _handle_death(self, name: str, replica) -> None:
        """A dead replica's pending rids are re-dispatched (at-least-once
        re-admission; the ``completed`` table keeps delivery at-most-once)
        and its on-disk bundle, if any was published but never routed, is
        recovered."""
        self.remove_replica(name)
        orphaned = [rid for rid, rec in self.pending.items()
                    if rec["replica"] == name]
        bundle = getattr(replica, "bundle_dir", None)
        if orphaned:
            logger.info(f"fleet: replica {name} died "
                     f"(exit {getattr(replica, 'exit_code', None)}) with "
                     f"{len(orphaned)} requests outstanding — re-admitting")
        if orphaned and bundle and os.path.isdir(bundle):
            # SIGTERM published a bundle but died before a peer took it
            # (orphaned empty ⇒ the migrated_out message already routed
            # it — re-admitting from disk would duplicate the work)
            try:
                rids = self._readmit_bundle(bundle)
                orphaned = [r for r in orphaned if r not in rids]
            except MigrationError as e:
                logger.info(f"fleet: bundle {bundle} unusable ({e}); "
                         f"falling back to re-run")
        for rid in orphaned:
            self.readmitted += 1
            self.pending[rid]["replica"] = None
            self.dispatch(rid)
        if self.telemetry is not None:
            self.telemetry.emit("fleet_replica_death", replica=name,
                                readmitted=len(orphaned))

    def _readmit_bundle(self, bundle: str) -> List:
        payloads = load_bundle(bundle)
        rids = bundle_rids(payloads)
        peers = self.alive_replicas()
        if not peers:
            raise MigrationError("no alive replica to receive the bundle")
        peer = min(sorted(peers), key=lambda n: peers[n].load())
        for rid in rids:
            if rid in self.pending:
                self.pending[rid]["replica"] = peer
        peers[peer].send({"type": "migrate_in", "bundle": bundle})
        return [r for r in rids if r is not None]

    # -- driving (local fleets) ----------------------------------------
    def step(self, ticks: int = 1) -> List[dict]:
        """Advance every LocalReplica ``ticks`` scheduler ticks, then
        poll. Subprocess replicas advance themselves; their messages are
        picked up by the same poll."""
        for replica in self.replicas.values():
            pump = getattr(replica, "pump", None)
            if pump is not None and replica.alive:
                pump(ticks)
        return self.poll()

    def run_until_complete(self, max_rounds: int = 100000,
                           idle_sleep: float = 0.0) -> int:
        """Pump/poll until nothing is pending; returns rounds used."""
        rounds = 0
        while self.pending and rounds < max_rounds:
            self.step()
            rounds += 1
            if idle_sleep:
                time.sleep(idle_sleep)
        return rounds

    # -- evidence ------------------------------------------------------
    def stats(self) -> dict:
        return {
            "replicas": len(self.replicas),
            "alive": len(self.alive_replicas()),
            "pending": len(self.pending),
            "completed": len(self.completed),
            "failed": len(self.failed),
            "duplicate_completions": self.duplicate_completions,
            "readmitted": self.readmitted,
            "completed_by": dict(self.completed_by),
            "affinity": self.affinity,
            "affinity_hits": self.affinity_hits,
            "affinity_overruled": self.affinity_overruled,
        }
