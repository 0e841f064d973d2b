"""Beam search over the paged KV cache via copy-on-write block forking.

The port of ``paddle_tpu/decode/beam.py``.
:class:`~paddle_tpu_torch.contrib.decoder.IncrementalBeamDecoder`
carries the beam-search selection state (``pre_ids``/``pre_scores``/
per-step parents) across dispatches but leaves the MODEL state to the
caller: after every step the carried state must be gathered by the
returned parent pointers.  For a transformer that state is the whole KV
cache, and a dense gather would copy ``O(beam x context)`` K/V a step.

:class:`PagedBeamDecoder` makes the gather a BLOCK-TABLE operation on
the refcounted allocator instead:

- the prompt prefills ONCE; every beam lane starts as a reference to
  the same prompt blocks (refcount = beam width);
- the parent gather after each selection re-points lane tables at the
  parent's blocks (incref the adopted, decref the abandoned): zero
  device copies;
- a lane only pays a device block copy when it WRITES into a block
  another lane still references (copy-on-write): exactly the frontier
  block where hypotheses diverge.

Several lanes' block tables then name the same blocks, which the paged
decode-attention kernel (K4) only reads; the step's K/V write
(``TransformerLM._scatter_kv``) never sees two lanes' targets in one
block, because :meth:`PagedBeamDecoder._ensure_writable` forks every
shared write target first.  ``share_prefix=False`` keeps every lane's
blocks private with eager device copies at fork points, the
program-level-copy baseline.  Both modes read and write bit-identical
K/V (a block copy is exact), so their ids and scores are bit-equal.

Candidates are ranked on the host, in numpy (softmax and a stable
argsort), as the reference does, so both packages rank the same logits
identically.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from ..core import flags as _flags
from ..core.executor import Executor
from .cache import PagedKVCache, blocks_for
from .model import TransformerLM


class PagedBeamDecoder:
    """Beam-search session: one model + private paged cache + an
    :class:`IncrementalBeamDecoder` for selection/backtrack.

    ``decode(prompt, max_steps)`` returns the contrib decoder's
    ``BeamDecodeResult`` (ids [beam, T], scores, cand_len, src_len).
    The cache, and the executor made by default, live on the model's
    device.
    """

    def __init__(self, model: TransformerLM, beam_size: int, end_id: int,
                 topk_size: Optional[int] = None,
                 name: str = "beam",
                 block_tokens: Optional[int] = None,
                 num_blocks: Optional[int] = None,
                 executor: Optional[Executor] = None,
                 share_prefix: bool = True):
        from ..contrib.decoder import IncrementalBeamDecoder

        self.model = model
        self.name = name
        cfg = model.config
        self.beam_size = int(beam_size)
        self.end_id = int(end_id)
        self.topk_size = int(topk_size if topk_size is not None
                             else max(self.beam_size, 2))
        self.share_prefix = bool(share_prefix)
        bs = int(_flags.get_flags("decode_block_tokens")
                 if block_tokens is None else block_tokens)
        self.max_blocks_per_seq = blocks_for(cfg.max_seq_len, bs)
        if num_blocks is None:
            # unshared lanes transiently hold old + adopted copies
            # during the parent gather: double the worst case
            factor = 1 if self.share_prefix else 2
            num_blocks = 1 + factor * self.beam_size * self.max_blocks_per_seq
        self.cache = PagedKVCache(cfg.n_layer, cfg.n_head, cfg.head_dim,
                                  num_blocks, bs, dtype="float32",
                                  device=model.device)
        self._exe = executor if executor is not None \
            else Executor(model.device, training=False)
        self._ibd = IncrementalBeamDecoder(self.beam_size, self.end_id,
                                           self.topk_size,
                                           executor=self._exe)
        self._lanes: List[List[int]] = []
        # plain session counters (a beam session is a library object,
        # not a serving plane)
        self.cow_forks = 0
        self.block_copies = 0

    # -- pool helpers ------------------------------------------------------
    def _alloc1(self) -> int:
        got = self.cache.allocator.alloc(1)
        if got is None:
            raise RuntimeError(
                f"beam session {self.name!r}: block pool exhausted "
                f"({self.cache.num_blocks} blocks, beam {self.beam_size})")
        return got[0]

    def _copy_block(self, src: int, dst: int) -> None:
        def build():
            def fn(feed, state, const):
                s, d = (x.reshape(1).long() for x in feed)
                for pool in state:
                    pool.index_copy_(1, d, pool.index_select(1, s))
                return []
            return fn

        self._exe.run_callable(
            f"decode/{self.name}/blkcopy", build,
            [np.int64(src), np.int64(dst)], state=self.cache.state())
        self.block_copies += 1

    def _private_copy(self, src_blocks: List[int]) -> List[int]:
        out = []
        for b in src_blocks:
            nb = self._alloc1()
            self._copy_block(b, nb)
            out.append(nb)
        return out

    def _free_lanes(self) -> None:
        for lane in self._lanes:
            self.cache.allocator.release(lane)
        self._lanes = []

    def leaked(self) -> int:
        return self.cache.allocator.leaked()

    # -- the session -------------------------------------------------------
    def _table(self) -> np.ndarray:
        t = np.zeros((self.beam_size, self.max_blocks_per_seq), np.int32)
        for l, lane in enumerate(self._lanes):
            t[l, :len(lane)] = lane
        return t

    def _ensure_writable(self, pos: int) -> None:
        """Growth + copy-on-write for every lane's write-target block
        at sequence position ``pos`` (the step about to dispatch
        scatters each lane's K/V there)."""
        bs = self.cache.block_tokens
        alloc = self.cache.allocator
        j = pos // bs
        for lane in self._lanes:
            while j >= len(lane):
                lane.append(self._alloc1())
            b = lane[j]
            if alloc.refcount(b) > 1:
                nb = self._alloc1()
                self._copy_block(b, nb)
                lane[j] = nb
                alloc.decref(b)
                self.cow_forks += 1

    def _adopt_parents(self, parent: np.ndarray) -> None:
        """The beam gather as a block-table operation: each lane's
        table becomes its parent's.  incref every adopted block FIRST,
        then drop the old references: correct under any parent
        permutation (self-adoption, swaps, one parent taken by all)."""
        old = self._lanes
        alloc = self.cache.allocator
        if self.share_prefix:
            new = []
            for l in range(self.beam_size):
                src = old[int(parent[l])]
                for b in src:
                    alloc.incref(b)
                new.append(list(src))
            for lane in old:
                for b in lane:
                    alloc.decref(b)
        else:
            # program-level-copy baseline: every lane materializes a
            # private copy of its parent's blocks, every step
            new = [self._private_copy(old[int(parent[l])])
                   for l in range(self.beam_size)]
            for lane in old:
                alloc.release(lane)
        self._lanes = new

    def _candidates(self, logits: np.ndarray):
        """[bw, V] logits -> ([bw, topk] ids int64, [bw, topk] softmax
        probs): the fc(softmax) + topk half of the whole-sequence
        decoder's loop body, on the host (deterministic stable
        argsort)."""
        x = logits.astype(np.float32)
        x = x - x.max(axis=-1, keepdims=True)
        p = np.exp(x)
        p /= p.sum(axis=-1, keepdims=True)
        idx = np.argsort(-p, axis=-1, kind="stable")[:, :self.topk_size]
        return idx.astype(np.int64), np.take_along_axis(p, idx, axis=-1)

    def decode(self, prompt, max_steps: int):
        """Beam-decode ``max_steps`` tokens after ``prompt``.  Returns
        the backtracked ``BeamDecodeResult``."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        P = int(prompt.size)
        bw = self.beam_size
        cfg = self.model.config
        if P < 1:
            raise ValueError("empty prompt")
        if P + max_steps > min(cfg.max_seq_len,
                               self.cache.max_context(
                                   self.max_blocks_per_seq)):
            raise ValueError(f"prompt {P} + steps {max_steps} exceeds "
                             f"the session context bound")
        self._free_lanes()
        model = self.model

        # prefill ONCE; lane 0 owns the prompt blocks
        base = self.cache.allocator.alloc(blocks_for(P, self.cache.block_tokens))
        if base is None:
            raise RuntimeError("beam session: pool too small for prompt")
        self._lanes = [base]
        table = np.zeros((self.max_blocks_per_seq,), np.int32)
        table[:len(base)] = base
        tokens = prompt.reshape(1, P)

        def build_prefill():
            def fn(feed, state, const):
                _, logits = model.prefill(state[0], state[1], *feed)
                return [logits]
            return fn

        (logits0,), _ = self._exe.run_callable(
            f"decode/{self.name}/beam_prefill/{P}", build_prefill,
            [tokens, np.int32(P), table, np.int64(0),
             np.float32(0.0), np.int32(0)],
            state=self.cache.state())
        logits0 = logits0.float().cpu().numpy()

        # fan lane 0 out to the full beam: COW references, or private
        # copies in the unshared baseline
        if self.share_prefix:
            for _ in range(1, bw):
                for b in base:
                    self.cache.allocator.incref(b)
                self._lanes.append(list(base))
        else:
            for _ in range(1, bw):
                self._lanes.append(self._private_copy(base))

        self._ibd.start()
        cand_ids, cand_probs = self._candidates(
            np.broadcast_to(logits0, (bw, logits0.shape[-1])))
        sel_ids, parent = self._ibd.step(cand_ids, cand_probs)
        self._adopt_parents(parent)

        def build_step():
            def fn(feed, state, const):
                return [model.decode_logits(state[0], state[1], *feed)]
            return fn

        for s in range(2, max_steps + 1):
            pos = P + s - 2              # where the last selected token's
            self._ensure_writable(pos)   # K/V lands this dispatch
            last = sel_ids[:, 0].astype(np.int32)
            (logits,), _ = self._exe.run_callable(
                f"decode/{self.name}/beam_step", build_step,
                [last, np.full((bw,), pos, np.int32), self._table()],
                state=self.cache.state())
            cand_ids, cand_probs = self._candidates(
                logits.float().cpu().numpy())
            sel_ids, parent = self._ibd.step(cand_ids, cand_probs)
            self._adopt_parents(parent)
        result = self._ibd.finalize()
        self._free_lanes()
        return result

    def close(self) -> None:
        self._free_lanes()


__all__ = ["PagedBeamDecoder"]
