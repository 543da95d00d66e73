"""The fleet's wire protocol: line-delimited JSON over pipes (the port's
copy of ``deepspeed_tpu/inference/fleet/protocol.py``; the bytes on the
wire are the same).

One replica worker (``fleet/worker.py``) speaks to the router over its
stdin/stdout: every message is one JSON object on one line, ``type``
names the kind. The framing is deliberately the dumbest thing that
works: a torn line (SIGKILL mid-write) or a stray non-JSON print from
a library is SKIPPED by the parser, never fatal, the same torn-tail
contract as ``runtime/telemetry/sink.iter_events``. Logs go to stderr; stdout
belongs to the protocol.

Router → worker::

    {"type": "request", "rid": "<fleet id>", "prompt": [ints],
     "max_new_tokens": N, "eos_token_id": null}
    {"type": "migrate_in", "bundle": "<dir>"}   # restore a peer's bundle
    {"type": "stop"}                            # clean shutdown

Worker → router::

    {"type": "ready", "pid": N, "slots": S, "capacity": C}
    {"type": "tick", "signals": {...scheduler.signals()...}}
    {"type": "done", "rid": "...", "output": [ints], "stats": {...}}
    {"type": "refused", "rid": "...", "reason": "..."}
    {"type": "migrated_out", "bundle": "<dir>", "rids": [...]}
    {"type": "migrated_in", "rids": [...], "refused_rids": [...]}
    {"type": "bye", "exit": code}

``rid`` is the ROUTER's fleet-wide id (a string), carried through the
scheduler in ``Request.meta["fleet_rid"]``: worker-local integer
request ids never cross the wire, because every worker counts from 0.
"""

import json
from typing import IO, Iterable, List, Optional

# worker -> router message kinds
WORKER_KINDS = ("ready", "tick", "done", "refused", "migrated_out",
                "migrated_in", "bye")
# router -> worker message kinds
ROUTER_KINDS = ("request", "migrate_in", "stop")


def encode(msg: dict) -> str:
    """One protocol message as one newline-terminated JSON line."""
    if "type" not in msg:
        raise ValueError(f"protocol message needs a 'type': {msg!r}")
    return json.dumps(msg, separators=(",", ":")) + "\n"


def send(stream: IO, msg: dict) -> None:
    """Write + flush one message (pipes buffer; an unflushed 'done' is a
    request the router re-admits after a kill — at-most-once accounting
    absorbs that, but it need not be made for nothing)."""
    stream.write(encode(msg))
    stream.flush()


def parse_line(line: str) -> Optional[dict]:
    """One wire line → message dict, or None for noise: blank lines,
    non-JSON prints a worker's libraries leaked onto stdout, torn tails
    from a SIGKILL mid-write, or JSON without a ``type``."""
    line = line.strip()
    if not line or not line.startswith("{"):
        return None
    try:
        msg = json.loads(line)
    except json.JSONDecodeError:
        return None
    if not isinstance(msg, dict) or "type" not in msg:
        return None
    return msg


def parse_lines(lines: Iterable[str]) -> List[dict]:
    out = []
    for line in lines:
        msg = parse_line(line)
        if msg is not None:
            out.append(msg)
    return out


def request_msg(rid: str, prompt, max_new_tokens: int,
                eos_token_id: Optional[int] = None) -> dict:
    return {"type": "request", "rid": str(rid),
            "prompt": [int(t) for t in prompt],
            "max_new_tokens": int(max_new_tokens),
            "eos_token_id": eos_token_id}
