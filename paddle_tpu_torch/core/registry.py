"""Op registry: op type → PyTorch rule (+ optional custom grad rule).

The port of ``paddle_tpu/core/registry.py``.  Each op type registers a
*rule*, a function ``(ctx, ins, attrs) -> {slot: [tensor]}`` over torch
tensors, and the executor runs a block's ops through their rules one by
one (``core/lowering.py``).  Hot ops call a hand-written kernel from
inside their rule (``ops/attention_ops.py`` → ``kernels/attention.py``).

Gradients: a grad op ``<type>_grad`` with no custom rule is computed by
``torch.autograd`` on the graph its forward op recorded when it ran
(the executor pairs the two once per program, see ``core/lowering.py``).
Ops whose forward consumes randomness register an explicit ``grad``
rule, as in the reference (dropout reuses its saved Mask).

Randomness: ``LowerContext`` hands out ``torch.Generator`` objects on
the executor's device.  ``prng()`` is the run's stream, seeded from
``program.random_seed``; ``named_prng(name)`` is a generator seeded from
``(seed, zlib.crc32(name))``, so an initializer's values depend only on
the seed and the variable's name, not on op order — the reference's
property, though not threefry's bits.
"""
from __future__ import annotations

import zlib
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch

GRAD_OP_SUFFIX = "_grad"

# in/out values passed to rules: dict slot -> list[torch.Tensor]
SlotVals = Dict[str, List[Any]]

_SEED_MIX = 0x9E3779B97F4A7C15
_SEED_MASK = (1 << 63) - 1


def derive_seed(seed: int, name: str) -> int:
    """Generator seed for ``(seed, name)``: a fixed mix of the base seed
    and the name's CRC-32."""
    return (int(seed) * _SEED_MIX + zlib.crc32(name.encode("utf-8"))) \
        & _SEED_MASK


class LowerContext:
    """Per-run context handed to every rule: the device, the random
    streams (module doc), the executor's device constants,
    ``training``: False for an inference executor (the Predictor's),
    whose rules take their test branch (dropout an identity, no
    attention dropout) with or without ``is_test`` attrs, and ``mesh``:
    the ``ParallelExecutor``'s device mesh (None for an ``Executor``),
    which ``fused_attention impl="ring"`` reads."""

    def __init__(self, block=None, device=None, base_seed: int = 0,
                 generator: Optional[torch.Generator] = None,
                 consts: Optional[dict] = None, training: bool = True,
                 mesh=None):
        self.block = block
        self.mesh = mesh
        self.training = bool(training)
        self.device = torch.device("cpu") if device is None else device
        self.base_seed = int(base_seed or 0)
        self._generator = generator
        # constants a rule makes once on the device and reuses across
        # runs (owned by the executor): a fresh host-to-device copy per
        # op and step would stall the stream
        self.consts = {} if consts is None else consts
        # values one rule derives and another rule of the same run may
        # reuse (the sparse updates' sort of one id batch,
        # ``kernels/sparse.py``); dropped with the context after the run
        self.run_memo = {}

    def _new_generator(self, seed: int) -> torch.Generator:
        g = torch.Generator(device=self.device)
        g.manual_seed(seed)
        return g

    def named_prng(self, name: str, seed: int = 0) -> torch.Generator:
        """Order-independent generator for ``(seed or the program's
        seed, name)`` (initializer ops, attr ``seed_name``)."""
        return self._new_generator(derive_seed(seed or self.base_seed, name))

    def prng(self) -> torch.Generator:
        """The run's random stream (advances with every draw)."""
        if self._generator is None:
            raise RuntimeError("op requires randomness but no rng state "
                               "was provided")
        return self._generator

    def seeded_prng(self, seed: int) -> torch.Generator:
        """A fresh generator for an op's explicit ``seed`` attr."""
        return self._new_generator(int(seed))


class OpDef:
    def __init__(
        self,
        type: str,
        lower: Callable[[LowerContext, SlotVals, dict], SlotVals],
        grad: Optional[Callable] = None,
        stateful: bool = False,
        input_slots: Optional[Sequence[str]] = None,
        output_slots: Optional[Sequence[str]] = None,
        no_grad_slots: Sequence[str] = (),
    ):
        self.type = type
        self.lower = lower
        self.grad = grad            # custom grad rule, else autograd
        self.stateful = stateful    # consumes rng → needs a custom grad
        self.input_slots = list(input_slots) if input_slots else None
        self.output_slots = list(output_slots) if output_slots else None
        self.no_grad_slots = set(no_grad_slots)  # never differentiated


_REGISTRY: Dict[str, OpDef] = {}


def register(type: str, *, grad=None, stateful: bool = False,
             input_slots=None, output_slots=None, no_grad_slots=()):
    """Decorator: register a rule for ``type``."""

    def deco(fn):
        _REGISTRY[type] = OpDef(type, fn, grad=grad, stateful=stateful,
                                input_slots=input_slots,
                                output_slots=output_slots,
                                no_grad_slots=no_grad_slots)
        return fn

    return deco


def register_grad(type: str):
    """Decorator: attach a custom grad rule to an already-registered op.

    Signature: ``grad(ctx, ins, attrs) -> {in_slot + '@GRAD': [vals]}``
    where ``ins`` holds the forward ins, forward outs and ``slot@GRAD``
    entries."""

    def deco(fn):
        _REGISTRY[type].grad = fn
        return fn

    return deco


def get(type: str) -> OpDef:
    if type not in _REGISTRY:
        raise KeyError(f"no lowering registered for op type {type!r}")
    return _REGISTRY[type]


def has(type: str) -> bool:
    return type in _REGISTRY


def all_ops() -> List[str]:
    return sorted(_REGISTRY)


def is_float_tensor(v) -> bool:
    return isinstance(v, torch.Tensor) and v.is_floating_point()


__all__ = ["GRAD_OP_SUFFIX", "LowerContext", "OpDef", "all_ops",
           "derive_seed", "get", "has", "is_float_tensor", "register",
           "register_grad"]
