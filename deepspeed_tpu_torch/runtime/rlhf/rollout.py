"""In-flight RLHF rollouts on the continuous scheduler (counterpart of
``deepspeed_tpu/runtime/rlhf/rollout.py``).

:class:`RolloutLoop` streams prompts into a
:class:`~deepspeed_tpu_torch.inference.serving.ContinuousBatchingScheduler`
built over the hybrid engine's inference view and interleaves the
learner's ``train_batch`` at decode-tick granularity; every
``sync_every`` learner steps the live weights are hot-swapped into the
scheduler between ticks (``runtime/rlhf/sync.py``), digest-verified on fp
weights. On one card the learner and the ticks take turns on it.

Determinism: experience is consumed in rollout-index order, never
completion order (learner batch ``k`` is rollouts ``[k*B, (k+1)*B)``), and
the prompt stream is an indexed pure function. A preemption (the guard
given to :meth:`RolloutLoop.run`) drains the in-flight rollouts through
the scheduler's drain (none dropped: each is banked as experience),
rewinds the prompt cursor over refused queue entries, and checkpoints the
learner once with the loop's cursors and unconsumed experience in
``client_state["rlhf"]``; :meth:`RolloutLoop.restore` reads them back.
With ``align_cohorts`` a resumed run finishes with the uninterrupted run's
losses bit for bit. Spans ``rlhf_rollout`` (on the scheduler's telemetry),
``rlhf_learner`` and ``weight_sync`` (on the engine's ``telemetry``, when
set) time the three phases.
"""

import contextlib
import dataclasses
import logging
import time
from typing import Callable, Dict, List, Optional

from deepspeed_tpu_torch.runtime.resilience.signals import DEFAULT_PREEMPT_EXIT_CODE

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class Experience:
    """One completed rollout: the experience unit the learner consumes."""

    index: int                    # position in the prompt stream
    prompt: List[int]
    output: List[int]
    weight_generation: int        # scheduler weight-sync generation at completion

    @property
    def tokens(self) -> List[int]:
        return list(self.prompt) + list(self.output)

    def to_state(self) -> list:
        return [self.index, list(self.prompt), list(self.output),
                self.weight_generation]

    @classmethod
    def from_state(cls, row) -> "Experience":
        return cls(index=int(row[0]), prompt=[int(t) for t in row[1]],
                   output=[int(t) for t in row[2]],
                   weight_generation=int(row[3]))


@dataclasses.dataclass
class RolloutConfig:
    """Knobs of the in-flight rollout loop."""

    train_batch_size: int               # experiences per learner batch
    total_rollouts: int                 # prompt-trace length
    sync_every: int = 1                 # learner steps per weight sync (0 = never)
    overlap: bool = True                # interleave learner at decode-tick granularity
    #: emulated per-tick device time: a host-bound test sleeps this long
    #: per tick to reproduce a device-bound regime. Under ``overlap`` the
    #: learner's measured wall time is credited against these sleeps (a
    #: learner on other devices would run concurrently with the tick).
    tick_sleep_ms: float = 0.0
    checkpoint_dir: Optional[str] = None
    #: feed cohort k+1 only after learner batch k trains. Forfeits the
    #: cross-cohort overlap (a freed slot otherwise re-admits immediately)
    #: but pins every request's ENTIRE decode to one weight generation —
    #: without it a request admitted early can span a sync boundary in the
    #: uninterrupted run that a preemption-drained run completes under the
    #: pre-sync weights, so the stitched curve is only rtol-close, not
    #: bit-exact. The fault scenario runs aligned; the bench runs free.
    align_cohorts: bool = False

    def __post_init__(self):
        assert self.train_batch_size >= 1
        assert self.total_rollouts % self.train_batch_size == 0, (
            f"total_rollouts {self.total_rollouts} must be a multiple of "
            f"train_batch_size {self.train_batch_size} (index-ordered "
            f"batches — the determinism contract)")


class RolloutLoop:
    """Drives one hybrid engine + one rollout scheduler to a learner-step
    target. Build AFTER ``engine.resume()`` (the serve view snapshots the
    live weights at construction), then :meth:`restore` the loop cursors
    from the checkpoint's ``client_state`` before :meth:`run`."""

    CLIENT_STATE_KEY = "rlhf"

    def __init__(self, engine, prompt_fn: Callable[[int], "object"],
                 make_batch: Callable[[List[Experience]], dict],
                 config: RolloutConfig, serving_config=None,
                 telemetry=None, learner_telemetry=None, seed: int = 0):
        self.engine = engine
        self.prompt_fn = prompt_fn
        self.make_batch = make_batch
        self.config = config
        self.learner_telemetry = learner_telemetry
        self.scheduler = engine.rollout_scheduler(
            serving_config, telemetry=telemetry, seed=seed)
        self.total_batches = config.total_rollouts // config.train_batch_size
        # feed-ahead bound: keep the queue shallow enough that a drain
        # rewinds few prompts, deep enough that admission never starves
        self.feed_depth = max(2, 2 * self.scheduler.slots)

        self.next_prompt = 0           # prompt-stream cursor
        self.consumed = 0              # experiences consumed into batches
        self.learner_steps = 0
        self.experience: Dict[int, Experience] = {}   # unconsumed, by index
        self.losses: List[dict] = []
        self.sync_evidence: List[dict] = []
        self._fin_cursor = 0
        self._sleep_credit = 0.0       # learner seconds hidden under device ticks

    # -- checkpoint/resume ---------------------------------------------
    def state_dict(self) -> dict:
        return {"next_prompt": self.next_prompt,
                "consumed": self.consumed,
                "learner_steps": self.learner_steps,
                "weight_sync_generation": self.engine.weight_sync_generation,
                "experience": [self.experience[i].to_state()
                               for i in sorted(self.experience)]}

    def restore(self, client_state: Optional[dict]) -> bool:
        """Restore loop cursors + unconsumed experience from a resumed
        checkpoint's ``client_state`` (no-op on a fresh start)."""
        state = (client_state or {}).get(self.CLIENT_STATE_KEY)
        if not state:
            return False
        self.next_prompt = int(state["next_prompt"])
        self.consumed = int(state["consumed"])
        self.learner_steps = int(state["learner_steps"])
        gen = int(state.get("weight_sync_generation", 0))
        self.engine.weight_sync_generation = gen
        self.scheduler.weight_sync_generation = gen
        self.experience = {e.index: e for e in
                           (Experience.from_state(r)
                            for r in state.get("experience", []))}
        logger.info(f"rlhf: restored loop at learner_step "
                 f"{self.learner_steps} prompt {self.next_prompt} "
                 f"({len(self.experience)} banked experience, sync gen {gen})")
        return True

    # -- the loop ------------------------------------------------------
    def run(self, guard=None, max_ticks: int = 10**9) -> dict:
        """Run to the learner-step target (``total_rollouts /
        train_batch_size``). Returns the result row; exit_code 143 when a
        :class:`PreemptionGuard` fired (drained + checkpointed)."""
        ticks = 0
        while self.learner_steps < self.total_batches:
            if guard is not None and guard.requested:
                return self._preempt(guard.consume())
            self._collect()
            # train BEFORE the next tick: batch k's weight sync must land
            # before cohort k+1 prefills, so a resumed run (which restores
            # batch k as banked experience and trains it here, ahead of its
            # first tick) serves cohort k+1 under the same generation the
            # uninterrupted run did — the stitched-loss-curve contract
            if self.config.overlap:
                self._train_ready(limit=1)
            elif not self.scheduler.in_flight and not len(self.scheduler.queue):
                self._train_ready(limit=10**9)
            if self.learner_steps >= self.total_batches:
                break
            self._feed()
            with self._span(self.scheduler.telemetry, "rlhf_rollout"):
                self._tick()
            ticks += 1
            if ticks > max_ticks:
                raise RuntimeError(f"rollout loop exceeded {max_ticks} ticks "
                                   f"at learner_step {self.learner_steps}")
            self._tick_sleep()
        return self._result(0)

    def _tick(self) -> str:
        return self.scheduler.step()

    def _feed(self) -> None:
        sched = self.scheduler
        bound = self.config.total_rollouts
        if self.config.align_cohorts:
            bound = min(bound, self.consumed + self.config.train_batch_size)
        while (self.next_prompt < bound
               and len(sched.queue) < self.feed_depth):
            req = self.prompt_fn(self.next_prompt)
            req.meta["rlhf_idx"] = self.next_prompt
            sched.submit(req)
            if req.state == "refused":
                break          # queue full: same index retries next tick
            self.next_prompt += 1

    def _collect(self) -> None:
        fin = self.scheduler.finished
        while self._fin_cursor < len(fin):
            req = fin[self._fin_cursor]
            self._fin_cursor += 1
            idx = req.meta.get("rlhf_idx")
            if idx is None:
                continue        # foreign request (e.g. a warmup probe)
            self.experience[idx] = Experience(
                index=idx, prompt=[int(t) for t in req.prompt],
                output=[int(t) for t in req.output],
                weight_generation=self.scheduler.weight_sync_generation)
            self.scheduler.rollout_experience += 1

    def _train_ready(self, limit: int) -> None:
        B = self.config.train_batch_size
        done = 0
        while done < limit and self.learner_steps < self.total_batches:
            idxs = list(range(self.consumed, self.consumed + B))
            if not all(i in self.experience for i in idxs):
                return
            exps = [self.experience.pop(i) for i in idxs]
            self.consumed += B
            overlapped = bool(self.scheduler.in_flight
                              or len(self.scheduler.queue))
            step_no = self.learner_steps + 1
            t0 = time.perf_counter()
            if self.learner_telemetry is not None:
                self.learner_telemetry.begin_step(step_no)
            with self._span(self.engine.telemetry, "rlhf_learner"):
                loss = float(self.engine.train_batch(self.make_batch(exps)))
            if self.learner_telemetry is not None:
                self.learner_telemetry.end_step(step_no)
            self._sleep_credit += time.perf_counter() - t0
            self.losses.append({"step": int(self.engine.global_steps),
                                "loss": loss})
            self.learner_steps += 1
            if overlapped:
                self.scheduler.learner_steps_overlapped += 1
            if (self.config.sync_every
                    and self.learner_steps % self.config.sync_every == 0):
                self.sync_weights()
            done += 1

    def sync_weights(self) -> dict:
        """Planner-priced weight sync: relayout the live training params
        into the serve placement and hot-swap them into the scheduler
        between decode ticks (digest-verified)."""
        with self._span(self.engine.telemetry, "weight_sync"):
            evidence = self.engine.sync_rollout_weights(self.scheduler)
        self.sync_evidence.append(evidence)
        return evidence

    def _tick_sleep(self) -> None:
        t = self.config.tick_sleep_ms / 1e3
        if t <= 0:
            return
        if self.config.overlap:
            # a concurrent learner would run during this device tick: spend
            # banked learner wall time before sleeping
            hide = min(self._sleep_credit, t)
            self._sleep_credit -= hide
            t -= hide
        if t > 0:
            time.sleep(t)

    # -- preemption (the scheduler's drain + one boundary checkpoint) -----
    def _preempt(self, signal_name: str) -> dict:
        sched = self.scheduler
        refused = sched.queue.refuse_all(f"draining on {signal_name}")
        rewind = min([r.meta.get("rlhf_idx", self.next_prompt)
                      for r in refused] + [self.next_prompt])
        in_flight = len(sched.in_flight)
        logger.info(f"rlhf: {signal_name}: draining {in_flight} in-flight "
                 f"rollouts, refused {len(refused)} queued (cursor rewinds "
                 f"{self.next_prompt} -> {rewind})")
        if sched.telemetry is not None:
            sched.telemetry.emit("serve_drain", signal=signal_name,
                                 in_flight=in_flight, refused=len(refused))
        sched.run_until_drained(admit=False)
        self._collect()
        dropped = len(sched.in_flight)    # must be 0: drained to budget
        self.next_prompt = rewind
        engine_guard = getattr(self.engine, "_preemption", None)
        if engine_guard is not None and engine_guard.requested:
            # the same signal reached the engine's own armed guard: this
            # checkpoint answers it, so no second save at a later boundary
            engine_guard.consume()
        tag = None
        if self.config.checkpoint_dir:
            tag = f"global_step{self.engine.global_steps}"
            self.engine.save_checkpoint(
                self.config.checkpoint_dir, tag=tag,
                client_state={self.CLIENT_STATE_KEY: self.state_dict()})
        return self._result(DEFAULT_PREEMPT_EXIT_CODE, preempted=signal_name,
                            drained=in_flight, dropped=dropped,
                            refused_queued=len(refused), checkpoint_tag=tag)

    # -- plumbing ------------------------------------------------------
    def _span(self, telemetry, name: str):
        if telemetry is not None:
            return telemetry.span(name)
        return contextlib.nullcontext()

    def _result(self, exit_code: int, **extra) -> dict:
        out = {"exit_code": exit_code,
               "learner_steps": self.learner_steps,
               "losses": list(self.losses),
               "experience_consumed": self.consumed,
               "experience_banked": len(self.experience),
               "dropped": extra.pop("dropped", 0),
               "weight_sync_generation": self.engine.weight_sync_generation,
               "sync_evidence": list(self.sync_evidence),
               "scheduler_stats": self.scheduler.stats()}
        out.update(extra)
        return out
