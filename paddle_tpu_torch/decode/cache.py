"""Paged KV cache: fixed-size device blocks + a host-side allocator.

The port of ``paddle_tpu/decode/cache.py``.

The device half (:class:`PagedKVCache`) is two preallocated tensors
``[num_layers, num_blocks, block_tokens, n_head, head_dim]`` (keys and
values), resident on the device for the engine's whole life.  Every
prefill and decode dispatch writes into them IN PLACE — the port's
stand-in for the reference's donated state — so the tensors handed out
by :meth:`PagedKVCache.state` stay the pool for good.

The host half (:class:`BlockAllocator`) is a refcounted free list over
block ids.  Block 0 is RESERVED as the trash block: padded prompt
positions and idle decode slots write their (garbage) K/V there, which
keeps every dispatch a fixed-shape scatter with no branching.

Every allocated block carries a refcount.  With the legacy reservation
policy each block has exactly one owner, so ``alloc``/``release`` behave
(and order the free list) exactly as a single-owner free list does.
Prefix sharing and beam forking raise refcounts above one: a block
referenced by several streams is immutable to all of them — writers
must fork it (copy-on-write) first.  A zero-refcount block either
returns to the free list or, when a :class:`PrefixCache` claims it, is
*parked* in the cache's LRU so a later prompt with the same content can
revive it without re-prefilling.

Sizing: under the legacy policy a request admitted with prompt length
P and output budget M reserves ``ceil((P + M) / block_tokens)`` blocks
up front — admission is the only point that can fail for lack of
memory.  Under ``FLAGS_decode_overcommit`` admission reserves only
``ceil((P + 1) / block_tokens)`` and grows one block per boundary; a
failed growth preempts (engine doc).
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch

from ..core import flags as _flags
from ..platform import get_device


def blocks_for(tokens: int, block_tokens: int) -> int:
    """Blocks needed to hold ``tokens`` tokens."""
    return max(1, -(-int(tokens) // int(block_tokens)))


_FNV_OFFSET = 0xCBF29CE484222325
_FNV_PRIME = 0x100000001B3
_MASK64 = (1 << 64) - 1


def _fnv1a64(data: bytes, h: int = _FNV_OFFSET) -> int:
    for byte in data:
        h = ((h ^ byte) * _FNV_PRIME) & _MASK64
    return h


def _fold_token(h: int, token: int) -> int:
    return _fnv1a64(int(token).to_bytes(4, "little", signed=True), h)


class BlockAllocator:
    """Refcounted free-list allocator over cache block ids
    1..num_blocks-1 (block 0 is the reserved trash block — module doc).

    ``alloc`` hands out blocks at refcount 1; ``incref`` adds sharers;
    ``decref``/``release`` drop references.  A block whose refcount
    reaches zero goes back on the free list *in drop order* — with
    single-owner usage this is the legacy free-list order.  If a
    :class:`PrefixCache` is attached, zero-ref blocks it has registered
    are parked in its LRU instead of freed."""

    def __init__(self, num_blocks: int):
        if num_blocks < 2:
            raise ValueError(
                f"need >= 2 blocks (1 usable + trash), got {num_blocks}")
        self.num_blocks = int(num_blocks)
        self._free: List[int] = list(range(1, self.num_blocks))
        self._ref: Dict[int, int] = {}
        self._prefix_cache: Optional["PrefixCache"] = None

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def referenced_blocks(self) -> int:
        """Blocks with refcount >= 1 (held by at least one stream)."""
        return len(self._ref)

    def refcount(self, block: int) -> int:
        return self._ref.get(block, 0)

    def leaked(self, parked: int = 0) -> int:
        """Pool invariant: usable blocks not free, not referenced and
        not parked in a prefix cache.  Must be zero at all times."""
        return (self.num_blocks - 1 - len(self._free)
                - len(self._ref) - int(parked))

    def alloc(self, n: int) -> Optional[List[int]]:
        """``n`` block ids at refcount 1, or None (caller queues /
        reclaims / preempts) when short — never a partial grant."""
        if n > len(self._free):
            return None
        out, self._free = self._free[:n], self._free[n:]
        for b in out:
            self._ref[b] = 1
        return out

    def incref(self, block: int) -> None:
        if block not in self._ref:
            raise ValueError(f"incref of unreferenced block {block}")
        self._ref[block] += 1

    def decref(self, block: int) -> None:
        """Drop one reference; at zero the block is parked in the
        attached prefix cache (if it registered the block) or freed."""
        n = self._ref.get(block, 0)
        if n <= 0:
            raise ValueError(f"decref of unreferenced block {block}")
        if n > 1:
            self._ref[block] = n - 1
            return
        del self._ref[block]
        if self._prefix_cache is not None and self._prefix_cache._park(block):
            return
        self._free.append(block)

    def release(self, blocks: Sequence[int]) -> None:
        for b in blocks:
            if not 1 <= b < self.num_blocks:
                raise ValueError(f"bad block id {b}")
        for b in blocks:
            self.decref(b)


class PrefixCache:
    """Content-addressed registry of full, immutable prompt blocks.

    A block is cacheable once prefill has written all ``block_tokens``
    of its positions from the prompt — from then on its K/V content is
    a pure function of (model identity, token ids up to the block
    boundary), captured by a rolling FNV-1a chain hash.  Admission
    walks the new prompt's block-aligned prefix against the registry
    and adopts hits (incref / revive), so a shared system prompt
    prefills once.

    Entries whose block is still referenced by live streams cost
    nothing; when the last reference drops the allocator *parks* the
    block here (LRU order) instead of freeing it.  ``reclaim`` evicts
    parked blocks back to the free list under pool pressure — a cached
    block is only ever a loan from the free pool.

    Hash hits are verified against the stored token ids before reuse:
    a 64-bit collision can alias two prefixes, and serving another
    stream's K/V would silently corrupt output, so a colliding entry
    is treated as a miss (and counted)."""

    def __init__(self, allocator: BlockAllocator, block_tokens: int,
                 model_key: str = ""):
        self.allocator = allocator
        self.block_tokens = int(block_tokens)
        self._seed = _fnv1a64(str(model_key).encode("utf-8"))
        # key -> (block id, token ids covered by this block)
        self._entries: Dict[int, Tuple[int, Tuple[int, ...]]] = {}
        self._block_key: Dict[int, int] = {}
        # zero-refcount cached blocks, oldest-parked first
        self._lru: "OrderedDict[int, int]" = OrderedDict()
        self.collisions = 0
        allocator._prefix_cache = self

    def __len__(self) -> int:
        return len(self._entries)

    @property
    def parked_blocks(self) -> int:
        return len(self._lru)

    def chain_keys(self, tokens: Sequence[int]) -> List[int]:
        """Rolling hash keyed at each full block boundary of
        ``tokens``: key[i] covers tokens[: (i + 1) * block_tokens]."""
        bs = self.block_tokens
        keys: List[int] = []
        h = self._seed
        for i in range(len(tokens) // bs):
            for t in tokens[i * bs:(i + 1) * bs]:
                h = _fold_token(h, int(t))
            keys.append(h)
        return keys

    def match(self, tokens: Sequence[int], max_blocks: int
              ) -> List[Tuple[int, int]]:
        """Longest cached block-aligned prefix of ``tokens``, capped at
        ``max_blocks`` blocks.  Returns [(key, block)] per hit; stops
        at the first miss (a later block is only valid on top of all
        earlier ones).  Token ids are verified on every hash hit."""
        hits: List[Tuple[int, int]] = []
        bs = self.block_tokens
        toks = [int(t) for t in tokens]
        for i, key in enumerate(self.chain_keys(toks)):
            if len(hits) >= max_blocks:
                break
            ent = self._entries.get(key)
            if ent is None:
                break
            block, covered = ent
            if tuple(toks[:(i + 1) * bs]) != covered:
                self.collisions += 1
                break
            hits.append((key, block))
        return hits

    def acquire(self, key: int) -> int:
        """Take a reference on a matched entry's block (revives it from
        the LRU if parked)."""
        block, _ = self._entries[key]
        if block in self._lru:
            del self._lru[block]
            self.allocator._ref[block] = 1
        else:
            self.allocator.incref(block)
        return block

    def insert(self, key: int, tokens: Sequence[int], block: int) -> bool:
        """Register a freshly prefilled full block under ``key``.  The
        block stays owned by its stream (no extra ref); it parks here
        when the last stream drops it.  First writer wins — an existing
        live entry is kept."""
        if key in self._entries:
            return False
        if block in self._block_key:
            return False
        self._entries[key] = (block, tuple(int(t) for t in tokens))
        self._block_key[block] = key
        return True

    def holds(self, block: int) -> bool:
        """True if writing into ``block`` must fork it (its content is
        advertised to future admissions)."""
        return block in self._block_key

    def _park(self, block: int) -> bool:
        """Allocator callback: keep this zero-ref block cached (LRU)
        instead of freeing it.  False if the block is not registered."""
        if block not in self._block_key:
            return False
        self._lru[block] = block
        self._lru.move_to_end(block)
        return True

    def _drop_entry(self, block: int) -> None:
        key = self._block_key.pop(block)
        del self._entries[key]

    def reclaim(self, n_blocks: int) -> int:
        """Evict up to ``n_blocks`` parked blocks (oldest first) back
        to the free list.  Returns how many were freed."""
        freed = 0
        while freed < n_blocks and self._lru:
            block, _ = self._lru.popitem(last=False)
            self._drop_entry(block)
            self.allocator._free.append(block)
            freed += 1
        return freed

    def snapshot(self) -> dict:
        return {
            "entries": len(self._entries),
            "parked_blocks": len(self._lru),
            "collisions": self.collisions,
        }


class PagedKVCache:
    """The device tensors (module doc).  ``state()`` hands the pool
    list to ``Executor.run_callable``, whose dispatches write it in
    place; ``update()`` accepts only those same tensors back.

    ``dtype="int8"`` (``FLAGS_decode_kv_dtype``) stores blocks
    quantized: k/v pools become int8 and two parallel f32 scale pools
    ``[num_layers, num_blocks, n_head]`` carry one abs-max scale per
    (block, head) (``x ~= q * s / 127``, ``kernels/quant.py``).
    ``state()`` then gives ``[k, v, k_scale, v_scale]``; every pool,
    scales included, keeps its block axis at dim 1, so a copy-on-write
    block copy forks a block's scales with its codes."""

    def __init__(self, num_layers: int, num_heads: int, head_dim: int,
                 num_blocks: int, block_tokens: Optional[int] = None,
                 dtype="float32",
                 device: Optional[Union[str, torch.device]] = None):
        self.num_layers = int(num_layers)
        self.num_heads = int(num_heads)
        self.head_dim = int(head_dim)
        self.num_blocks = int(num_blocks)
        self.block_tokens = int(
            _flags.get_flags("decode_block_tokens")
            if block_tokens is None else block_tokens)
        if self.block_tokens < 1:
            raise ValueError(f"block_tokens must be >= 1, got "
                             f"{self.block_tokens}")
        self.dtype = str(dtype)
        if self.dtype not in ("float32", "int8"):
            raise ValueError(f"cache dtype must be float32 or int8, got "
                             f"{self.dtype!r}")
        self.quantized = self.dtype == "int8"
        self.device = get_device(device)
        shape = (self.num_layers, self.num_blocks, self.block_tokens,
                 self.num_heads, self.head_dim)
        store = torch.int8 if self.quantized else torch.float32
        self.k = torch.zeros(shape, dtype=store, device=self.device)
        self.v = torch.zeros(shape, dtype=store, device=self.device)
        if self.quantized:
            sshape = (self.num_layers, self.num_blocks, self.num_heads)
            self.k_scale = torch.zeros(sshape, dtype=torch.float32,
                                       device=self.device)
            self.v_scale = torch.zeros(sshape, dtype=torch.float32,
                                       device=self.device)
        else:
            self.k_scale = None
            self.v_scale = None
        self.allocator = BlockAllocator(self.num_blocks)

    @property
    def nbytes(self) -> int:
        """ACTUAL pool bytes: dtype-aware block storage plus the scale
        pools when quantized — what the MemoryLedger pool and the
        per-tenant resident_kv_bytes attribute."""
        return sum(t.numel() * t.element_size() for t in self.state())

    def state(self) -> list:
        if self.quantized:
            return [self.k, self.v, self.k_scale, self.v_scale]
        return [self.k, self.v]

    def update(self, new_state: list) -> None:
        """Dispatches write the pool in place: the returned state must
        be the pool's own tensors (a copy would silently fork it)."""
        mine = self.state()
        if len(new_state) != len(mine) or any(
                a is not b for a, b in zip(new_state, mine)):
            raise ValueError("cache state must be updated in place")

    def max_context(self, max_blocks_per_seq: int) -> int:
        return max_blocks_per_seq * self.block_tokens

    def snapshot(self) -> dict:
        snap = {
            "num_blocks": self.num_blocks,
            "block_tokens": self.block_tokens,
            "free_blocks": self.allocator.free_blocks,
            "bytes": self.nbytes,
        }
        if self.quantized:
            snap["dtype"] = self.dtype
            snap["scale_bytes"] = 2 * (self.k_scale.numel()
                                       * self.k_scale.element_size())
        return snap


__all__ = ["BlockAllocator", "PagedKVCache", "PrefixCache", "blocks_for"]
