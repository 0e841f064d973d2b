"""Program IR: Variable / Operator / Block / Program.

This is the framework's serialized-program contract, the TPU-native
re-design of the reference's ProgramDesc stack
(``paddle/fluid/framework/framework.proto:42-190`` and
``python/paddle/fluid/framework.py:204,494,920,1404``).  The essential idea
is preserved: Python layer calls append typed OpDescs to nested BlockDescs,
autodiff and transpilers rewrite the program as more graph, and a runtime
executes it.  What changes for TPU: the runtime does NOT interpret ops
one-by-one against device memory — whole blocks are lowered to a single pure
JAX function and JIT-compiled by XLA (see ``core/lowering.py``), so the IR
here carries exactly what that lowering needs (static shapes, dtypes,
persistability, stop-gradient sets, sub-block references for control flow).

Serialization is JSON (``Program.to_dict``/``from_dict``) rather than
protobuf; the structure mirrors the reference proto field-for-concept.
"""
from __future__ import annotations

import contextlib
import copy
import itertools
import json
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from . import unique_name
from .types import VarType, normalize_dtype

GRAD_SUFFIX = "@GRAD"
TEMP_VAR_PREFIX = "_generated_var"
EMPTY_VAR = "@EMPTY@"  # positional placeholder for absent optional args

# Op-role attribute: lets program rewrites (backward, transpilers, parallel
# lowering) classify ops without pattern matching (reference:
# paddle/fluid/framework/op_proto_maker.cc, op_role/op_role_var attrs).
OP_ROLE_ATTR = "op_role"
OP_ROLE_VAR_ATTR = "op_role_var"


class OpRole:
    Forward = 0
    Backward = 1
    Optimize = 2
    RPC = 3
    Dist = 4
    LRSched = 16
    Loss = 256


def grad_var_name(name: str) -> str:
    return name + GRAD_SUFFIX


class Variable:
    """A typed slot in a Block (reference VarDesc, framework.proto:164 +
    python Variable, framework.py:204).

    Shapes use -1 for the batch dimension only; everything else is static so
    blocks lower to fixed-shape XLA programs (the reference's
    runtime-InferShape model does not translate to XLA).
    """

    def __init__(
        self,
        block: "Block",
        name: str,
        shape: Optional[Sequence[int]] = None,
        dtype: Any = "float32",
        type: VarType = VarType.DENSE_TENSOR,
        persistable: bool = False,
        stop_gradient: bool = False,
        lod_level: int = 0,
        is_parameter: bool = False,
        trainable: bool = True,
        initializer: Optional[dict] = None,
        regularizer=None,
    ):
        self.block = block
        self.name = name
        self.shape = tuple(int(s) for s in shape) if shape is not None else None
        self.dtype = normalize_dtype(dtype) if dtype is not None else None
        self.type = VarType(type)
        self.persistable = persistable
        self.stop_gradient = stop_gradient
        self.lod_level = lod_level
        self.is_parameter = is_parameter
        self.trainable = trainable
        self.initializer = initializer
        self.regularizer = regularizer

    # -- convenience -------------------------------------------------------
    @property
    def ndim(self) -> int:
        return len(self.shape) if self.shape is not None else 0

    def astype_shape(self, batch: int) -> tuple:
        return tuple(batch if s == -1 else s for s in self.shape)

    def __repr__(self):
        return (
            f"Variable(name={self.name!r}, shape={self.shape}, dtype={self.dtype},"
            f" persistable={self.persistable})"
        )

    # grad var helpers
    @property
    def grad_name(self) -> str:
        return grad_var_name(self.name)

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "shape": list(self.shape) if self.shape is not None else None,
            "dtype": self.dtype,
            "type": int(self.type),
            "persistable": self.persistable,
            "stop_gradient": self.stop_gradient,
            "lod_level": self.lod_level,
            "is_parameter": self.is_parameter,
            "trainable": self.trainable,
            "initializer": self.initializer,
        }

    @staticmethod
    def from_dict(block: "Block", d: dict) -> "Variable":
        return Variable(
            block,
            d["name"],
            shape=d.get("shape"),
            dtype=d.get("dtype") or "float32",
            type=VarType(d.get("type", 0)),
            persistable=d.get("persistable", False),
            stop_gradient=d.get("stop_gradient", False),
            lod_level=d.get("lod_level", 0),
            is_parameter=d.get("is_parameter", False),
            trainable=d.get("trainable", True),
            initializer=d.get("initializer"),
        )


class _NameScope:
    """Hierarchical debug-name prefixes with sibling dedup (reference
    framework.py:53 NameScope — second ``with name_scope("fc")`` at the
    same level becomes ``fc_1``)."""

    def __init__(self, name: str = "", parent: "_NameScope" = None):
        self._children: Dict[str, int] = {}
        self._name = name
        self._parent = parent

    def child(self, prefix: str) -> "_NameScope":
        n = self._children.get(prefix, 0)
        self._children[prefix] = n + 1
        return _NameScope(prefix if n == 0 else f"{prefix}_{n}", self)


_name_scope = _NameScope()

# current pipeline stage for ops created under ``pipeline_stage_guard``
# (None = unmarked).  The pipeline transpiler reads the stamped
# ``pipeline_stage`` attr as a user-chosen cut assignment; unmarked ops
# inherit the previous op's stage (see paddle_tpu/pipeline/transpiler.py).
_pipeline_stage: Optional[int] = None


@contextlib.contextmanager
def pipeline_stage_guard(stage: int):
    """Stamp ops created in this block with ``pipeline_stage=stage``
    (the user-marked cut-point API of the pipeline transpiler; the
    reference's layer-placement precedent is ParallelNeuralNetwork's
    per-layer device assignment, legacy/gserver §2.7).  Stages must be
    used in non-decreasing program order — the transpiler validates
    that dataflow never crosses a stage boundary backwards."""
    global _pipeline_stage
    saved = _pipeline_stage
    _pipeline_stage = int(stage)
    try:
        yield
    finally:
        _pipeline_stage = saved


@contextlib.contextmanager
def name_scope(prefix: str):
    """Prefix ops created in this block with a hierarchical debug name
    (reference framework.py:80 — visualization/debugging only; carried
    on each op as the ``op_namescope`` attr)."""
    assert prefix, "name_scope prefix cannot be empty"
    global _name_scope
    _name_scope = _name_scope.child(prefix)
    try:
        yield
    finally:
        _name_scope = _name_scope._parent


def _full_name_scope() -> str:
    parts = []
    s = _name_scope
    while s is not None and s._name:
        parts.append(s._name)
        s = s._parent
    return "/".join(reversed(parts))


class Operator:
    """One node: type + name-keyed input/output var-name lists + typed attrs
    (reference OpDesc, framework.proto:42; python Operator, framework.py:494).

    Attr values are JSON-able scalars/lists; ``blocks``-typed attrs hold
    sub-block indices (control flow) as ints under attr names ending in
    ``_block`` by convention.
    """

    def __init__(
        self,
        block: "Block",
        type: str,
        inputs: Optional[Dict[str, List[str]]] = None,
        outputs: Optional[Dict[str, List[str]]] = None,
        attrs: Optional[Dict[str, Any]] = None,
    ):
        self.block = block
        self.type = type
        self.inputs = {k: list(v) for k, v in (inputs or {}).items()}
        self.outputs = {k: list(v) for k, v in (outputs or {}).items()}
        self.attrs = dict(attrs or {})
        self.attrs.setdefault(OP_ROLE_ATTR, OpRole.Forward)

    # -- access ------------------------------------------------------------
    def input(self, slot: str) -> List[str]:
        return self.inputs.get(slot, [])

    def output(self, slot: str) -> List[str]:
        return self.outputs.get(slot, [])

    def input_arg_names(self) -> List[str]:
        return [n for vs in self.inputs.values() for n in vs]

    def output_arg_names(self) -> List[str]:
        return [n for vs in self.outputs.values() for n in vs]

    def attr(self, name: str, default=None):
        return self.attrs.get(name, default)

    def set_attr(self, name: str, val):
        self.attrs[name] = val

    def has_attr(self, name: str) -> bool:
        return name in self.attrs

    @property
    def sub_block_ids(self) -> List[int]:
        """Indices of sub-blocks referenced by this op's attrs."""
        out = []
        for k, v in self.attrs.items():
            if k.endswith("sub_block") and isinstance(v, int):
                out.append(v)
            elif k.endswith("sub_blocks") and isinstance(v, list):
                out.extend(int(x) for x in v)
        return out

    def __repr__(self):
        ins = {k: v for k, v in self.inputs.items()}
        outs = {k: v for k, v in self.outputs.items()}
        return f"{self.type}({ins} -> {outs})"

    def to_dict(self) -> dict:
        return {
            "type": self.type,
            "inputs": self.inputs,
            "outputs": self.outputs,
            "attrs": _jsonable_attrs(self.attrs),
        }

    @staticmethod
    def from_dict(block: "Block", d: dict) -> "Operator":
        return Operator(block, d["type"], d["inputs"], d["outputs"], d["attrs"])


def _jsonable_attrs(attrs: dict) -> dict:
    out = {}
    for k, v in attrs.items():
        if isinstance(v, np.ndarray):
            out[k] = {"__ndarray__": v.tolist(), "dtype": str(v.dtype)}
        elif isinstance(v, (np.integer,)):
            out[k] = int(v)
        elif isinstance(v, (np.floating,)):
            out[k] = float(v)
        else:
            out[k] = v
    return out


class Block:
    """Ordered op list + var table, with parent lookup for control-flow
    sub-blocks (reference BlockDesc, framework.proto:170; Block,
    framework.py:920)."""

    def __init__(self, program: "Program", idx: int, parent_idx: int = -1):
        self.program = program
        self.idx = idx
        self.parent_idx = parent_idx
        self.vars: Dict[str, Variable] = {}
        self.ops: List[Operator] = []
        # forward_block_idx used by grad-of-control-flow (framework.proto:175)
        self.forward_block_idx = -1
        # padded-sequence bookkeeping: var name -> companion length var name
        # (the LoDTensor-offsets redesign; see layers/nn.py module docstring)
        self.seq_len_map: Dict[str, str] = {}
        # nested (lod_level 2) inner lengths: var name -> [B, S] companion
        self.seq_len2_map: Dict[str, str] = {}

    # -- vars --------------------------------------------------------------
    def create_var(self, name: Optional[str] = None, **kwargs) -> Variable:
        if name is None:
            name = unique_name.generate(TEMP_VAR_PREFIX)
        if name in self.vars:
            return self.vars[name]
        v = Variable(self, name, **kwargs)
        self.vars[name] = v
        return v

    def create_parameter(self, name, shape, dtype, **kwargs) -> Variable:
        kwargs.setdefault("persistable", True)
        kwargs["is_parameter"] = True
        v = self.create_var(name=name, shape=shape, dtype=dtype, **kwargs)
        return v

    def has_var(self, name: str) -> bool:
        return name in self.vars

    def var(self, name: str) -> Variable:
        """Lookup with parent-block fallback (reference Scope-like chain for
        descs: framework.py `_var_recursive`)."""
        b: Optional[Block] = self
        while b is not None:
            if name in b.vars:
                return b.vars[name]
            b = self.program.blocks[b.parent_idx] if b.parent_idx >= 0 else None
        raise KeyError(f"variable {name!r} not found in block {self.idx} or ancestors")

    def var_or_none(self, name: str) -> Optional[Variable]:
        try:
            return self.var(name)
        except KeyError:
            return None

    # -- ops ---------------------------------------------------------------
    def append_op(self, type: str, inputs=None, outputs=None, attrs=None) -> Operator:
        op = Operator(self, type, inputs, outputs, attrs)
        # stamp the debug name_scope at CREATION time only — never in
        # Operator.__init__, which from_dict/clone also route through
        # (deserialization must restore attrs verbatim)
        ns = _full_name_scope()
        if ns:
            op.attrs.setdefault("op_namescope", f"/{ns}/")
        if _pipeline_stage is not None:
            op.attrs.setdefault("pipeline_stage", _pipeline_stage)
        self.ops.append(op)
        self.program._version += 1
        return op

    def prepend_op(self, type: str, inputs=None, outputs=None, attrs=None) -> Operator:
        op = Operator(self, type, inputs, outputs, attrs)
        ns = _full_name_scope()
        if ns:
            op.attrs.setdefault("op_namescope", f"/{ns}/")
        self.ops.insert(0, op)
        self.program._version += 1
        return op

    def insert_op(self, index: int, type: str, inputs=None, outputs=None, attrs=None) -> Operator:
        op = Operator(self, type, inputs, outputs, attrs)
        self.ops.insert(index, op)
        self.program._version += 1
        return op

    def remove_op(self, index: int) -> None:
        del self.ops[index]
        self.program._version += 1

    @property
    def parent_block(self) -> Optional["Block"]:
        return self.program.blocks[self.parent_idx] if self.parent_idx >= 0 else None

    def all_parameters(self) -> List[Variable]:
        return [v for v in self.vars.values() if v.is_parameter]

    def to_dict(self) -> dict:
        return {
            "idx": self.idx,
            "parent_idx": self.parent_idx,
            "forward_block_idx": self.forward_block_idx,
            "seq_len_map": dict(self.seq_len_map),
            "seq_len2_map": dict(self.seq_len2_map),
            "vars": [v.to_dict() for v in self.vars.values()],
            "ops": [op.to_dict() for op in self.ops],
        }


class Program:
    """A whole trainable/runnable program: a list of blocks, block 0 global
    (reference ProgramDesc, framework.proto:183; Program, framework.py:1404).
    """

    # process-monotonic identity for executor cache keys: id(program) is
    # REUSED by CPython after GC, and a fresh program landing on a dead
    # one's address (with an equal _version) silently hit the dead
    # program's cached executable — the root cause of the intermittently
    # "zero" numeric gradients in long test runs
    _uid_counter = itertools.count()

    def __init__(self):
        self.blocks: List[Block] = [Block(self, 0)]
        self._current_block_idx = 0
        self._version = 0  # bumped on mutation → invalidates executor caches
        self._uid = next(Program._uid_counter)
        self.random_seed = 0
        self._op_role = OpRole.Forward
        self._op_role_vars: List[str] = []
        # model-health scalars the executor should stamp into StepStats
        # when fetched: var name -> short stat key (e.g. switch_moe's
        # aux-loss / dropped-token fraction under "moe.<prefix>.*");
        # serialized with the program so transpiled clones keep it
        self.step_stat_vars: Dict[str, str] = {}

    # -- block management --------------------------------------------------
    @property
    def global_block(self) -> Block:
        return self.blocks[0]

    def current_block(self) -> Block:
        return self.blocks[self._current_block_idx]

    def _create_block(self, parent_idx: Optional[int] = None) -> Block:
        parent = self._current_block_idx if parent_idx is None else parent_idx
        b = Block(self, len(self.blocks), parent)
        self.blocks.append(b)
        self._current_block_idx = b.idx
        self._version += 1
        return b

    def _rollback(self) -> None:
        self._current_block_idx = self.current_block().parent_idx

    @contextlib.contextmanager
    def block_guard(self, parent_idx: Optional[int] = None):
        b = self._create_block(parent_idx)
        try:
            yield b
        finally:
            self._rollback()

    # -- op role guards (reference framework.py:1448-1484) -----------------
    @contextlib.contextmanager
    def op_role_guard(self, role: int, role_vars: Sequence[str] = ()):
        saved, saved_vars = self._op_role, self._op_role_vars
        self._op_role, self._op_role_vars = role, list(role_vars)
        try:
            yield
        finally:
            self._op_role, self._op_role_vars = saved, saved_vars

    @property
    def op_role(self):
        return self._op_role

    @property
    def op_role_vars(self):
        return list(self._op_role_vars)

    # -- queries -----------------------------------------------------------
    def all_parameters(self) -> List[Variable]:
        return self.global_block.all_parameters()

    def list_vars(self):
        for b in self.blocks:
            yield from b.vars.values()

    # -- clone / prune (reference framework.py:1545,1634) ------------------
    def clone(self) -> "Program":
        p = Program.from_dict(self.to_dict())
        p.random_seed = self.random_seed
        return p

    def prune(self, targets: Sequence[str]) -> "Program":
        """Dead-op elimination given fetch targets (reference
        framework/prune.cc).  Keeps ops whose outputs are (transitively)
        needed, preserving program order."""
        p = self.clone()
        blk = p.global_block
        needed = set(targets)
        keep: List[Operator] = []
        for op in reversed(blk.ops):
            if needed & set(op.output_arg_names()) or op.type in ("feed", "fetch"):
                keep.append(op)
                needed |= set(op.input_arg_names())
        keep.reverse()
        blk.ops = keep
        used = set()
        for op in blk.ops:
            used |= set(op.input_arg_names()) | set(op.output_arg_names())
        blk.vars = {n: v for n, v in blk.vars.items() if n in used}
        p._version += 1
        return p

    # -- serialization -----------------------------------------------------
    def to_dict(self) -> dict:
        d = {"version": 1, "blocks": [b.to_dict() for b in self.blocks]}
        if self.step_stat_vars:
            d["step_stat_vars"] = dict(self.step_stat_vars)
        return d

    @staticmethod
    def from_dict(d: dict) -> "Program":
        p = Program()
        p.blocks = []
        for bd in d["blocks"]:
            b = Block(p, bd["idx"], bd.get("parent_idx", -1))
            b.forward_block_idx = bd.get("forward_block_idx", -1)
            b.seq_len_map = dict(bd.get("seq_len_map", {}))
            b.seq_len2_map = dict(bd.get("seq_len2_map", {}))
            for vd in bd["vars"]:
                b.vars[vd["name"]] = Variable.from_dict(b, vd)
            for od in bd["ops"]:
                b.ops.append(Operator.from_dict(b, od))
            p.blocks.append(b)
        p._current_block_idx = 0
        p.step_stat_vars = dict(d.get("step_stat_vars", {}))
        return p

    def to_string(self) -> str:
        lines = []
        for b in self.blocks:
            lines.append(f"-- block {b.idx} (parent {b.parent_idx}) --")
            for v in b.vars.values():
                tag = "param" if v.is_parameter else ("persist" if v.persistable else "var")
                lines.append(f"  {tag} {v.name}: {v.dtype}{list(v.shape) if v.shape else []}")
            for i, op in enumerate(b.ops):
                lines.append(f"  [{i}] {op!r}")
        return "\n".join(lines)

    def serialize(self) -> bytes:
        return json.dumps(self.to_dict()).encode("utf-8")

    @staticmethod
    def deserialize(data: bytes) -> "Program":
        return Program.from_dict(json.loads(data.decode("utf-8")))


# ---------------------------------------------------------------------------
# Default program singletons + guards (reference framework.py:2052-2120)
# ---------------------------------------------------------------------------

_main_program = Program()
_startup_program = Program()


def default_main_program() -> Program:
    return _main_program


def default_startup_program() -> Program:
    return _startup_program


@contextlib.contextmanager
def program_guard(main_program: Program, startup_program: Optional[Program] = None):
    global _main_program, _startup_program
    saved_main, saved_startup = _main_program, _startup_program
    _main_program = main_program
    if startup_program is not None:
        _startup_program = startup_program
    try:
        yield
    finally:
        _main_program = saved_main
        _startup_program = saved_startup


def switch_main_program(program: Program) -> Program:
    global _main_program
    prev, _main_program = _main_program, program
    return prev
