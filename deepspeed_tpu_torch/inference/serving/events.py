"""Schema'd telemetry events of the serving path (counterpart of
``deepspeed_tpu/inference/serving/events.py``).

A replica's ``serve_tick`` line carries ``scheduler.signals()``, the
per-tick load signals a fleet router and autoscaler read. Adding fields is
free (readers ignore unknown keys); removing or renaming one bumps
``TELEMETRY_SCHEMA_VERSION``. ``validate_event`` holds producers to each
kind's documented field set. The schemas are the JAX package's, fleet and
RLHF kinds included, so one reader serves both packages' files.
"""

from typing import Dict, Iterable, Optional

from deepspeed_tpu_torch.runtime.telemetry.sink import iter_events

#: required fields per serving event kind (the documented schema: each
#: producer must supply at least these; ``t`` and ``event`` are stamped
#: by the sink itself)
SERVE_EVENT_SCHEMAS: Dict[str, frozenset] = {
    # one per scheduler tick (cadence: ServingConfig.tick_telemetry_every):
    # scheduler.signals(), the router's and autoscaler's input; with the
    # prefix cache's hit rate (None until a prompt went through admission)
    # and its cached-free blocks, and the rollout counters (0 until an RLHF
    # loop serves through the scheduler)
    "serve_tick": frozenset({
        "tick", "kind", "queue_depth", "in_flight", "slots", "free_slots",
        "ttft_p50", "ttft_p99", "pool_free_blocks",
        "pool_fragmentation_tokens", "achieved_tok_s",
        "prefix_cache_hit_rate", "cached_blocks",
        "rollout_experience", "learner_steps_overlapped",
        "weight_sync_generation",
    }),
    # terminal accounting of a preemption drain
    "serve_drain": frozenset({"signal", "in_flight", "refused"}),
    # one per retired request (cached_prefix_tokens: prompt tokens restored
    # from the prefix cache instead of prefilled, 0 on a miss)
    "serve_request": frozenset({"request_id", "state", "prompt_len",
                                "new_tokens", "cached_prefix_tokens"}),
    # live KV migration out of a preempted replica, and into a peer
    "serve_migrate_out": frozenset({"signal", "migrated", "bundle"}),
    "serve_migrate_in": frozenset({"migrated", "refused", "bundle"}),
    # one per restored request on the receiving replica
    "serve_admit_migrated": frozenset({"request_id", "migrated_from",
                                       "state", "length"}),
    # one per RLHF weight hot-swap
    "rlhf_weight_sync": frozenset({"generation", "gather_bytes",
                                   "total_bytes", "digest_verified",
                                   "in_flight"}),
}


def validate_event(record: Dict, kind: Optional[str] = None) -> None:
    """Raise ``ValueError`` when ``record`` does not carry the documented
    field set for its serving event kind. Unknown kinds pass (schema
    covers serving events only; readers must ignore foreign events)."""
    k = kind or record.get("event")
    want = SERVE_EVENT_SCHEMAS.get(k)
    if want is None:
        return
    missing = sorted(want - set(record))
    if missing:
        raise ValueError(f"serving event {k!r} missing fields {missing} "
                         f"(got {sorted(record)})")


def iter_serve_events(path: str, kinds: Optional[Iterable[str]] = None):
    """Yield serving events from a telemetry JSONL run file (torn tails
    skipped — same contract as ``sink.iter_events``)."""
    want = set(kinds) if kinds is not None else set(SERVE_EVENT_SCHEMAS)
    for rec in iter_events(path):
        if rec.get("event") in want:
            yield rec


def last_tick_signals(path: str) -> Optional[Dict]:
    """The newest ``serve_tick`` event in a replica's telemetry JSONL —
    what a file-tailing autoscaler (no pipe to the replica) reads."""
    last = None
    for rec in iter_serve_events(path, kinds=("serve_tick",)):
        last = rec
    return last
