"""Host-side KV block pool behind the scheduler's admission control
(counterpart of ``deepspeed_tpu/inference/serving/blocks.py``).

Block granularity makes admission truthful: a request is admitted only
when ``blocks_for(prompt + max_new)`` blocks are free, so the decode loop
never hits pool exhaustion mid-flight. The counters are what the
scheduler's no-leak check reads.

With ``prefix_cache=True`` the pool is ref-counted and content-addressed.
Every full block a sequence commits can be ``publish``ed under a rolling
hash of ``(parent_block_hash, token_ids, envelope)``: two blocks share a
hash only when their whole token prefix from position 0 is identical, so a
hash hit is a safe KV reuse. Freed blocks whose hash is live park on an LRU
cached-free list: reclaimable (``free_blocks`` counts them; eviction pops
the least recently freed when the free list runs dry) but matchable until
then. A new prompt is matched block by block at reservation: matched full
blocks attach by reference, a partially matching last block is
copy-on-write (the match says how many rows to copy into a fresh private
block; the shared block is never attached nor written), and at least one
prompt token always stays uncached so the tail prefill yields the
first-token logits.

The pool is host-only accounting and never touches device KV. The opaque
per-block ``payload`` (host KV rows, stored by the scheduler at publish) is
what makes a hit restorable: a block published without one is not
matchable.
"""

import hashlib
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence

#: chain seed for position-0 blocks (the hash "parent" of the first block)
_ROOT = "root"


def prefix_key(tokens: Sequence[int]) -> str:
    """Envelope-free content key of one block's token ids: what a router,
    which knows no pool envelope, computes from a raw prompt's first block
    to compare with a replica's advertised hot set."""
    h = hashlib.sha256()
    for t in tokens:
        h.update(int(t).to_bytes(4, "little", signed=True))
    return h.hexdigest()[:16]


def chain_hash(parent: str, tokens: Sequence[int], envelope: str = "") -> str:
    """Rolling content hash of one full block: ``(parent_block_hash,
    token_ids, envelope)``. The envelope folds in what makes KV bytes
    non-interchangeable (int8 KV, served weight dtype, speculation), so a
    pool never serves a block made under other numerics."""
    h = hashlib.sha256()
    h.update(parent.encode("utf-8"))
    h.update(b"|")
    h.update(envelope.encode("utf-8"))
    h.update(b"|")
    for t in tokens:
        h.update(int(t).to_bytes(4, "little", signed=True))
    return h.hexdigest()


@dataclass
class PrefixMatch:
    """What :meth:`BlockPool.reserve` attached for a prompt, and what the
    scheduler restores into the slot before prefilling the tail.

    ``payloads`` has one entry per matched full block; ``partial_payload``
    (when ``partial_tokens > 0``) is the shared source block's payload,
    whose first ``partial_tokens`` rows the consumer copies into the fresh
    private block ``reserve`` charged."""

    cached_tokens: int = 0
    full_hashes: List[str] = field(default_factory=list)
    payloads: List[object] = field(default_factory=list)
    partial_payload: Optional[object] = None
    partial_tokens: int = 0


class BlockPool:
    """Fixed pool of ``num_blocks`` blocks of ``block_size`` tokens.

    ``prefix_cache=False``: blocks are private, freed blocks return to a
    LIFO free list, nothing is hashed. ``prefix_cache=True`` adds the
    content index and the cached-free LRU described in the module doc."""

    def __init__(self, num_blocks: int, block_size: int, prefix_cache: bool = False,
                 envelope: str = ""):
        if num_blocks < 1 or block_size < 1:
            raise ValueError(f"need num_blocks >= 1 and block_size >= 1, got "
                             f"({num_blocks}, {block_size})")
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        self.prefix_cache = bool(prefix_cache)
        self.envelope = str(envelope)
        self._free: List[int] = list(range(num_blocks - 1, -1, -1))
        self._tables: Dict[int, List[int]] = {}   # seq id -> block list
        self._lengths: Dict[int, int] = {}        # seq id -> tokens used
        # content index: a block is hashed once its full content is
        # published, cached once every reference dropped but the hash lives
        self._refs: Dict[int, int] = {}           # block id -> live refs
        self._hash_of: Dict[int, str] = {}        # block id -> chain hash
        self._block_of: Dict[str, int] = {}       # chain hash -> block id
        self._tokens_of: Dict[str, tuple] = {}    # chain hash -> block tokens
        self._parent_of: Dict[str, str] = {}      # chain hash -> parent hash
        self._children: Dict[str, set] = {}       # parent hash -> child hashes
        self._payload: Dict[str, object] = {}     # chain hash -> opaque payload
        self._envelope_of: Dict[str, str] = {}    # chain hash -> envelope it was made under
        self._cached: "OrderedDict[str, int]" = OrderedDict()  # LRU: hash -> block
        self._matches: Dict[int, PrefixMatch] = {}  # seq id -> pending match
        self.total_allocs = 0
        self.total_frees = 0
        self.peak_used_blocks = 0
        self.prefix_hits = 0           # reservations that reused >= 1 token
        self.prefix_misses = 0         # prompt-bearing reservations that did not
        self.cached_tokens_served = 0  # prompt tokens skipped through matches
        self.prefix_evictions = 0      # cached-free blocks reclaimed under pressure
        self.published_blocks = 0      # blocks ever entered into the index

    # -- capacity ----------------------------------------------------------
    def blocks_for(self, tokens: int) -> int:
        return -(-max(int(tokens), 0) // self.block_size)

    @property
    def free_blocks(self) -> int:
        """Reclaimable blocks: truly free plus cached-free."""
        return len(self._free) + len(self._cached)

    @property
    def used_blocks(self) -> int:
        return self.num_blocks - self.free_blocks

    @property
    def cached_blocks(self) -> int:
        """Cached-free blocks (no live reference, hash live, evictable)."""
        return len(self._cached)

    def can_allocate(self, tokens: int, prompt=None) -> bool:
        """Side-effect-free admission probe. With a ``prompt`` and the
        prefix cache on, matched full blocks another sequence holds cost
        nothing; matched cached-free blocks still count, since reviving one
        takes it from the reclaimable pool."""
        need = self.blocks_for(tokens)
        if prompt is not None and self.prefix_cache:
            m = self.match_prefix(prompt)
            need -= sum(1 for h in m.full_hashes if h not in self._cached)
        return need <= self.free_blocks

    def utilization(self) -> float:
        return self.used_blocks / self.num_blocks

    def fragmentation_tokens(self) -> int:
        """Allocated-but-unused token slots (block rounding plus capacity
        reserved ahead), clamped at zero: shared blocks make the sum of
        sequence lengths exceed the distinct blocks behind them."""
        return max(0, self.used_blocks * self.block_size - sum(self._lengths.values()))

    # -- content index -----------------------------------------------------
    def match_prefix(self, prompt) -> PrefixMatch:
        """Walk ``prompt`` block by block down the hash chain to the first
        unindexed block, then take the longest common prefix among the last
        matched block's children as a copy-on-write partial block. Leaves at
        least one prompt token uncached. Read-only: :meth:`reserve`
        attaches."""
        m = PrefixMatch()
        if not self.prefix_cache:
            return m
        toks = [int(t) for t in prompt]
        limit = len(toks) - 1
        pos, parent = 0, _ROOT
        while pos + self.block_size <= limit:
            h = chain_hash(parent, toks[pos:pos + self.block_size], self.envelope)
            if h not in self._block_of or self._payload.get(h) is None:
                break
            m.full_hashes.append(h)
            m.payloads.append(self._payload[h])
            parent = h
            pos += self.block_size
        best_k, best_h = 0, None
        for h in self._children.get(parent, ()):
            if h not in self._block_of or self._payload.get(h) is None:
                continue
            if self._envelope_of.get(h) != self.envelope:
                continue  # the root's children span every envelope the pool served under
            t = self._tokens_of.get(h, ())
            cap = min(len(t), limit - pos)
            k = 0
            while k < cap and toks[pos + k] == t[k]:
                k += 1
            if k > best_k:
                best_k, best_h = k, h
        if best_k > 0:
            m.partial_tokens = best_k
            m.partial_payload = self._payload.get(best_h)
        m.cached_tokens = pos + best_k
        return m

    def take_match(self, seq_id: int) -> Optional[PrefixMatch]:
        """Pop the :class:`PrefixMatch` a prompt-bearing :meth:`reserve`
        stashed: the consumer restores its rows once, at admission."""
        return self._matches.pop(seq_id, None)

    def publish(self, seq_id: int, tokens,
                fetch: Optional[Callable[[int, int], object]] = None) -> int:
        """Enter ``seq_id``'s committed full blocks into the index.
        ``tokens`` is the content behind the table (the committed prompt, or
        prompt + output at retirement); only whole blocks index.
        ``fetch(start, stop)`` supplies the payload of a newly indexed block
        and is called only for blocks not hashed yet. Returns the number of
        blocks newly indexed; 0 with the prefix cache off."""
        if not self.prefix_cache:
            return 0
        table = self._tables[seq_id]
        toks = [int(t) for t in tokens]
        n_full = min(len(toks) // self.block_size, len(table))
        parent, added = _ROOT, 0
        for i in range(n_full):
            blk = toks[i * self.block_size:(i + 1) * self.block_size]
            b = table[i]
            have = self._hash_of.get(b)
            if have is not None:
                # attached through a match: same content, the chain goes on
                parent = have
                continue
            h = chain_hash(parent, blk, self.envelope)
            if h in self._block_of:
                # the same content in another block (two same-prefix requests
                # prefilled together): the first copy stays canonical
                parent = h
                continue
            self._hash_of[b] = h
            self._block_of[h] = b
            self._tokens_of[h] = tuple(blk)
            self._envelope_of[h] = self.envelope
            self._parent_of[h] = parent
            self._children.setdefault(parent, set()).add(h)
            self._payload[h] = (fetch(i * self.block_size, (i + 1) * self.block_size)
                                if fetch is not None else None)
            self.published_blocks += 1
            added += 1
            parent = h
        return added

    def hot_prefixes(self, limit: int = 16) -> List[str]:
        """:func:`prefix_key` of the indexed position-0 blocks: what a
        replica advertises in its tick signals."""
        out: List[str] = []
        for h in self._children.get(_ROOT, ()):
            t = self._tokens_of.get(h)
            if t:
                out.append(prefix_key(t))
            if len(out) >= limit:
                break
        return out

    def _drop_hash(self, h: str) -> None:
        """Unindex one hash. Its children stay indexed but unreachable from
        the match walk; the LRU reclaims them in their own time."""
        b = self._block_of.pop(h, None)
        if b is not None:
            self._hash_of.pop(b, None)
        self._tokens_of.pop(h, None)
        self._envelope_of.pop(h, None)
        self._payload.pop(h, None)
        parent = self._parent_of.pop(h, None)
        kids = self._children.get(parent)
        if kids is not None:
            kids.discard(h)
            if not kids:
                del self._children[parent]

    def _take_block(self) -> int:
        """One free block: the free list first, then the least recently
        freed cached block (never one with live references: those are not on
        the cached list). ``RuntimeError`` on exhaustion."""
        if self._free:
            return self._free.pop()
        if self._cached:
            h, b = next(iter(self._cached.items()))
            del self._cached[h]
            self._drop_hash(h)
            self.prefix_evictions += 1
            return b
        raise RuntimeError(f"KV block pool exhausted ({self.num_blocks} blocks of "
                           f"{self.block_size}); free finished sequences first")

    # -- per sequence ------------------------------------------------------
    def allocate(self, seq_id: int) -> None:
        if seq_id in self._tables:
            raise KeyError(f"BlockPool.allocate: sequence {seq_id!r} already allocated")
        self._tables[seq_id] = []
        self._lengths[seq_id] = 0
        self.total_allocs += 1

    def ensure(self, seq_id: int, new_tokens: int) -> None:
        """Grow ``seq_id``'s table to cover ``new_tokens`` more tokens;
        raises ``RuntimeError`` on exhaustion."""
        need = self._lengths[seq_id] + int(new_tokens)
        table = self._tables[seq_id]
        while len(table) * self.block_size < need:
            b = self._take_block()
            self._refs[b] = 1
            table.append(b)
            self.peak_used_blocks = max(self.peak_used_blocks, self.used_blocks)

    def reserve(self, seq_id: int, tokens: int, prompt=None) -> None:
        """Allocate and pre-grow in one step (admission-time reservation).
        With a ``prompt`` and the prefix cache on, the indexed prefix
        attaches first (cached-free blocks revive off the LRU), a partial
        match charges one fresh private block, and only the uncached tail
        grows new blocks; the sequence's length starts at ``cached_tokens``
        and :meth:`take_match` hands the match to the consumer."""
        self.allocate(seq_id)
        table = self._tables[seq_id]
        cached = 0
        try:
            if prompt is not None and self.prefix_cache:
                match = self.match_prefix(prompt)
                for h in match.full_hashes:
                    b = self._block_of[h]
                    self._cached.pop(h, None)
                    self._refs[b] = self._refs.get(b, 0) + 1
                    table.append(b)
                if match.partial_tokens:
                    b = self._take_block()
                    self._refs[b] = 1
                    table.append(b)
                self.peak_used_blocks = max(self.peak_used_blocks, self.used_blocks)
                cached = match.cached_tokens
                self._lengths[seq_id] = cached
                if cached > 0:
                    self.prefix_hits += 1
                    self.cached_tokens_served += cached
                    self._matches[seq_id] = match
                else:
                    self.prefix_misses += 1
            self.ensure(seq_id, int(tokens) - cached)
        except RuntimeError:
            self.free(seq_id)
            raise

    def advance(self, seq_id: int, tokens: int) -> None:
        """Account ``tokens`` consumed (grows the table if not reserved)."""
        self.ensure(seq_id, tokens)
        self._lengths[seq_id] += int(tokens)

    def free(self, seq_id: int) -> None:
        """Drop one reference on each of ``seq_id``'s blocks. A block left
        with none returns to the free list, or parks on the cached-free LRU
        if its hash is live. An unknown or already freed ``seq_id`` raises:
        with shared blocks a double free would hand another sequence's live
        blocks to the free list."""
        table = self._tables.pop(seq_id, None)
        if table is None:
            raise KeyError(f"BlockPool.free: unknown or already-freed sequence {seq_id!r}; "
                           f"free exactly once per allocate/reserve")
        for b in table:
            refs = self._refs.get(b, 1) - 1
            if refs > 0:
                self._refs[b] = refs
                continue
            self._refs.pop(b, None)
            h = self._hash_of.get(b)
            if h is not None and self.prefix_cache:
                self._cached[h] = b
                self._cached.move_to_end(h)
            else:
                if h is not None:
                    self._drop_hash(h)
                self._free.append(b)
        del self._lengths[seq_id]
        self._matches.pop(seq_id, None)
        self.total_frees += 1

    def seq_len(self, seq_id: int) -> int:
        return self._lengths[seq_id]

    def block_table(self, seq_id: int) -> List[int]:
        return list(self._tables[seq_id])

    def live_sequences(self) -> List[int]:
        return list(self._tables)

    def counters(self) -> dict:
        return {"num_blocks": self.num_blocks, "block_size": self.block_size,
                "free_blocks": self.free_blocks, "used_blocks": self.used_blocks,
                "peak_used_blocks": self.peak_used_blocks,
                "total_allocs": self.total_allocs, "total_frees": self.total_frees,
                "fragmentation_tokens": self.fragmentation_tokens(),
                "prefix_cache": self.prefix_cache,
                "cached_blocks": self.cached_blocks,
                "prefix_hits": self.prefix_hits,
                "prefix_misses": self.prefix_misses,
                "cached_tokens_served": self.cached_tokens_served,
                "prefix_evictions": self.prefix_evictions,
                "published_blocks": self.published_blocks,
                "prefix_hit_rate": self.prefix_hit_rate()}

    def prefix_hit_rate(self) -> Optional[float]:
        """Share of prompt-bearing reservations that reused cached tokens;
        ``None`` before any prompt went through admission."""
        total = self.prefix_hits + self.prefix_misses
        return self.prefix_hits / total if total else None
