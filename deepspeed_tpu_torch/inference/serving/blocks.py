"""Host-side KV block pool behind the scheduler's admission control
(counterpart of ``deepspeed_tpu/inference/serving/blocks.py`` with its
prefix cache off: blocks are private, freed blocks return to a LIFO free
list, nothing is hashed). Content-hashed prefix caching is a later slice.

Block granularity makes admission truthful: a request is admitted only
when ``blocks_for(prompt + max_new)`` blocks are free, so the decode loop
never hits pool exhaustion mid-flight. The counters are what the
scheduler's no-leak check reads."""

from typing import Dict, List


class BlockPool:
    """Fixed pool of ``num_blocks`` blocks of ``block_size`` tokens."""

    def __init__(self, num_blocks: int, block_size: int):
        if num_blocks < 1 or block_size < 1:
            raise ValueError(f"need num_blocks >= 1 and block_size >= 1, got "
                             f"({num_blocks}, {block_size})")
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        self._free: List[int] = list(range(num_blocks - 1, -1, -1))
        self._tables: Dict[int, List[int]] = {}   # seq id -> block list
        self._lengths: Dict[int, int] = {}        # seq id -> tokens used
        self.total_allocs = 0
        self.total_frees = 0
        self.peak_used_blocks = 0

    def blocks_for(self, tokens: int) -> int:
        return -(-max(int(tokens), 0) // self.block_size)

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def used_blocks(self) -> int:
        return self.num_blocks - self.free_blocks

    def can_allocate(self, tokens: int) -> bool:
        return self.blocks_for(tokens) <= self.free_blocks

    def utilization(self) -> float:
        return self.used_blocks / self.num_blocks

    def fragmentation_tokens(self) -> int:
        """Allocated-but-unused token slots (block rounding plus capacity
        reserved ahead)."""
        return max(0, self.used_blocks * self.block_size - sum(self._lengths.values()))

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
            if not self._free:
                raise RuntimeError(f"KV block pool exhausted ({self.num_blocks} blocks of "
                                   f"{self.block_size}); free finished sequences first")
            table.append(self._free.pop())
            self.peak_used_blocks = max(self.peak_used_blocks, self.used_blocks)

    def reserve(self, seq_id: int, tokens: int) -> None:
        """Allocate + pre-grow in one step (admission-time reservation)."""
        self.allocate(seq_id)
        try:
            self.ensure(seq_id, tokens)
        except RuntimeError:
            self.free(seq_id)
            raise

    def advance(self, seq_id: int, tokens: int) -> None:
        """Account ``tokens`` consumed (grows the table if not reserved)."""
        self.ensure(seq_id, tokens)
        self._lengths[seq_id] += int(tokens)

    def free(self, seq_id: int) -> None:
        """Return ``seq_id``'s blocks; an unknown or already-freed id raises."""
        table = self._tables.pop(seq_id, None)
        if table is None:
            raise KeyError(f"BlockPool.free: unknown or already-freed sequence {seq_id!r}")
        self._free.extend(table)
        del self._lengths[seq_id]
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
                "fragmentation_tokens": self.fragmentation_tokens()}
