"""Static-graph IR: Program / Block / OpDesc / VarDesc.

Port of ``paddle_tpu/static/ir.py``. The IR is the same thin,
serializable description: a Program is a list of blocks, a block an
ordered op list and a var table, an op a type with named input and
output slots and attrs. The executor of the port interprets it op by op
(``executor.py``). Serialization is the same versioned JSON
(``IR_VERSION = 1``, attrs through ``_attrs_to_json``), byte for byte,
so a Program serialized by either package parses in the other.

Shape inference runs each op's kernel on ``torch.device("meta")``
tensors (``layers._infer_outputs``), substituting ``_DYN_SENTINEL`` for
a dynamic dimension, as the JAX package does under ``jax.eval_shape``.
"""
from __future__ import annotations

import copy
import json
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from ..framework import dtype as dtype_mod

IR_VERSION = 1

# Sentinel substituted for -1 (dynamic batch) during meta-device shape
# inference; inferred dims divisible by it map back to -1 (covers
# reshape-merged dims like batch*seq). A large prime keeps collisions with
# real layer sizes out of practical range; meta tensors hold no storage,
# so the size costs nothing.
_DYN_SENTINEL = 1000003


class VarDesc:
    """Variable metadata in a block (reference framework.proto:164)."""

    def __init__(self, name, shape=None, dtype="float32", persistable=False,
                 stop_gradient=True, is_data=False, lod_level=0):
        self.name = name
        self.shape = tuple(shape) if shape is not None else None
        # tensor_array is a container type, not an element dtype
        # (framework.proto:151 LOD_TENSOR_ARRAY)
        self.dtype = dtype if dtype == "tensor_array" else \
            dtype_mod.dtype_name(dtype_mod.convert_dtype(dtype))
        self.persistable = persistable
        self.stop_gradient = stop_gradient
        self.is_data = is_data
        self.lod_level = lod_level
        # pass-stamped annotations (e.g. __sharding_spec from the
        # shard_propagation pass) — serialized only when present, so
        # un-stamped programs keep their exact dict/content-hash shape
        self.attrs: Dict[str, Any] = {}

    def to_dict(self):
        out = {
            "name": self.name,
            "shape": list(self.shape) if self.shape is not None else None,
            "dtype": self.dtype,
            "persistable": self.persistable,
            "stop_gradient": self.stop_gradient,
            "is_data": self.is_data,
            "lod_level": self.lod_level,
        }
        if self.attrs:
            out["attrs"] = dict(self.attrs)
        return out

    @staticmethod
    def from_dict(d):
        v = VarDesc(
            d["name"], d["shape"], d["dtype"], d["persistable"],
            d["stop_gradient"], d["is_data"], d.get("lod_level", 0))
        v.attrs = dict(d.get("attrs") or {})
        return v

    def __repr__(self):
        return (f"VarDesc(name={self.name!r}, shape={self.shape}, "
                f"dtype={self.dtype}, persistable={self.persistable})")


class OpDesc:
    """One op node: type + named input/output slots + attrs
    (reference framework.proto:42)."""

    def __init__(self, op_type: str,
                 inputs: Optional[Dict[str, List[str]]] = None,
                 outputs: Optional[Dict[str, List[str]]] = None,
                 attrs: Optional[Dict[str, Any]] = None):
        self.type = op_type
        self.inputs = {k: list(v) for k, v in (inputs or {}).items()}
        self.outputs = {k: list(v) for k, v in (outputs or {}).items()}
        self.attrs = dict(attrs or {})

    def input_names(self) -> List[str]:
        return [n for vs in self.inputs.values() for n in vs]

    def output_names(self) -> List[str]:
        return [n for vs in self.outputs.values() for n in vs]

    def to_dict(self):
        return {"type": self.type, "inputs": self.inputs,
                "outputs": self.outputs, "attrs": _attrs_to_json(self.attrs)}

    @staticmethod
    def from_dict(d):
        return OpDesc(d["type"], d["inputs"], d["outputs"],
                      _attrs_from_json(d["attrs"]))

    def __repr__(self):
        return f"OpDesc({self.type}: {self.inputs} -> {self.outputs})"


def _attrs_to_json(attrs):
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


def _attrs_from_json(attrs):
    out = {}
    for k, v in attrs.items():
        if isinstance(v, dict) and "__ndarray__" in v:
            out[k] = np.asarray(v["__ndarray__"], dtype=v["dtype"])
        else:
            out[k] = v
    return out


class Block:
    """Ordered op list + var table (reference framework.proto:173).

    Sub-blocks (control flow) reference their parent by index like the
    reference's BlockDesc.parent_idx.
    """

    def __init__(self, program: "Program", idx: int, parent_idx: int = -1):
        self.program = program
        self.idx = idx
        self.parent_idx = parent_idx
        self.vars: Dict[str, VarDesc] = {}
        self.ops: List[OpDesc] = []

    # -- var management ---------------------------------------------------
    def create_var(self, name=None, shape=None, dtype="float32",
                   persistable=False, stop_gradient=True, is_data=False,
                   **kwargs) -> "Variable":
        if name is None:
            from ..utils import unique_name
            name = unique_name.generate("tmp")
        desc = VarDesc(name, shape, dtype, persistable, stop_gradient,
                       is_data)
        self.vars[name] = desc
        return Variable(self, desc)

    def var(self, name: str) -> "Variable":
        desc = self._find_var_recursive(name)
        if desc is None:
            raise KeyError(f"Variable {name!r} not found in block {self.idx}")
        return Variable(self, desc)

    def has_var(self, name: str) -> bool:
        return self._find_var_recursive(name) is not None

    def _find_var_recursive(self, name) -> Optional[VarDesc]:
        blk = self
        while blk is not None:
            if name in blk.vars:
                return blk.vars[name]
            blk = (self.program.blocks[blk.parent_idx]
                   if blk.parent_idx >= 0 else None)
        return None

    def all_parameters(self) -> List["Variable"]:
        return [Variable(self, v) for v in self.vars.values()
                if isinstance(v, ParamDesc)]

    # -- op management ----------------------------------------------------
    def append_op(self, type: str, inputs=None, outputs=None, attrs=None):
        op = OpDesc(type, _normalize_slots(inputs), _normalize_slots(outputs),
                    attrs)
        self.ops.append(op)
        self.program._version += 1
        return op

    def prepend_op(self, type: str, inputs=None, outputs=None, attrs=None):
        op = OpDesc(type, _normalize_slots(inputs), _normalize_slots(outputs),
                    attrs)
        self.ops.insert(0, op)
        self.program._version += 1
        return op

    def to_dict(self):
        return {
            "idx": self.idx,
            "parent_idx": self.parent_idx,
            "vars": [v.to_dict() | (
                {"is_parameter": True,
                 "trainable": v.trainable,
                 "initializer": v.initializer_desc}
                if isinstance(v, ParamDesc) else {})
                for v in self.vars.values()],
            "ops": [o.to_dict() for o in self.ops],
        }

    def _load_dict(self, d):
        for vd in d["vars"]:
            if vd.get("is_parameter"):
                desc = ParamDesc(vd["name"], vd["shape"], vd["dtype"],
                                 trainable=vd.get("trainable", True))
                desc.initializer_desc = vd.get("initializer")
                desc.attrs = dict(vd.get("attrs") or {})
            else:
                desc = VarDesc.from_dict(vd)
            self.vars[desc.name] = desc
        self.ops = [OpDesc.from_dict(od) for od in d["ops"]]


class ParamDesc(VarDesc):
    """A persistable, trainable var (reference framework.py:5036 Parameter)."""

    def __init__(self, name, shape, dtype="float32", trainable=True):
        super().__init__(name, shape, dtype, persistable=True,
                         stop_gradient=not trainable)
        self.trainable = trainable
        self.initializer_desc = None  # (op_type, attrs) recorded for startup


def _normalize_slots(slots):
    """Accept {'X': var|name|[vars...]} and normalize to {'X': [names]}."""
    if slots is None:
        return {}
    out = {}
    for k, v in slots.items():
        if v is None:
            continue
        if not isinstance(v, (list, tuple)):
            v = [v]
        names = []
        for item in v:
            if isinstance(item, Variable):
                names.append(item.name)
            elif isinstance(item, VarDesc):
                names.append(item.name)
            else:
                names.append(str(item))
        out[k] = names
    return out


class Variable:
    """User-facing handle to a VarDesc in a block (reference
    framework.py:869 Variable). Supports python operators by appending
    elementwise ops to the block (math_op_patch parity)."""

    def __init__(self, block: Block, desc: VarDesc):
        self.block = block
        self.desc = desc

    # descriptor passthroughs
    name = property(lambda self: self.desc.name)
    shape = property(lambda self: self.desc.shape)
    dtype = property(lambda self: self.desc.dtype)
    persistable = property(lambda self: self.desc.persistable)

    @property
    def stop_gradient(self):
        return self.desc.stop_gradient

    @stop_gradient.setter
    def stop_gradient(self, v):
        self.desc.stop_gradient = v

    @property
    def grad_name(self):
        return grad_var_name(self.name)

    def astype(self, dtype):
        from .layers import cast
        return cast(self, dtype)

    def __repr__(self):
        return (f"static.Variable(name={self.name!r}, shape={self.shape}, "
                f"dtype={self.dtype})")

    # -- operator overloads (appended as graph ops) -----------------------
    def _binary(self, other, op_type, reverse=False):
        from .layers import _elementwise_binary
        return _elementwise_binary(self, other, op_type, reverse)

    def __add__(self, o):
        return self._binary(o, "elementwise_add")

    __radd__ = __add__

    def __sub__(self, o):
        return self._binary(o, "elementwise_sub")

    def __rsub__(self, o):
        return self._binary(o, "elementwise_sub", reverse=True)

    def __mul__(self, o):
        return self._binary(o, "elementwise_mul")

    __rmul__ = __mul__

    def __truediv__(self, o):
        return self._binary(o, "elementwise_div")

    def __rtruediv__(self, o):
        return self._binary(o, "elementwise_div", reverse=True)

    def __pow__(self, o):
        return self._binary(o, "elementwise_pow")

    def __neg__(self):
        from .layers import scale
        return scale(self, -1.0)

    def __matmul__(self, o):
        from .layers import matmul
        return matmul(self, o)


def grad_var_name(name: str) -> str:
    """Reference framework grad suffix (operators append @GRAD)."""
    return name + "@GRAD"


class Program:
    """A whole computation: list of blocks (reference framework.proto:211
    ProgramDesc / framework.py:3917 Program)."""

    def __init__(self):
        self.blocks: List[Block] = [Block(self, 0)]
        self._version = 0
        self._seed: Optional[int] = None
        self.random_seed = 0

    # -- structure --------------------------------------------------------
    @property
    def global_block(self) -> Block:
        return self.blocks[0]

    def current_block(self) -> Block:
        return self.blocks[_current_block_idx(self)]

    def create_block(self, parent_idx: Optional[int] = None) -> Block:
        parent = _current_block_idx(self) if parent_idx is None else parent_idx
        blk = Block(self, len(self.blocks), parent)
        self.blocks.append(blk)
        return blk

    def list_vars(self):
        for blk in self.blocks:
            for v in blk.vars.values():
                yield Variable(blk, v)

    def all_parameters(self):
        out = []
        for blk in self.blocks:
            out.extend(blk.all_parameters())
        return out

    def clone(self, for_test: bool = False) -> "Program":
        """Deep copy; for_test strips optimizer/backward ops and freezes
        dropout/bn to inference behavior (reference Program.clone)."""
        p = Program.from_dict(self.to_dict())
        if for_test:
            from .backward import BACKWARD_OP_TYPES
            from .optimizer import OPTIMIZER_OP_TYPES
            drop = BACKWARD_OP_TYPES | OPTIMIZER_OP_TYPES
            for blk in p.blocks:
                blk.ops = [op for op in blk.ops if op.type not in drop]
                for op in blk.ops:
                    if "is_test" in _TEST_MODE_OPS.get(op.type, ()):
                        op.attrs["is_test"] = True
        return p

    # -- serialization ----------------------------------------------------
    def to_dict(self):
        return {"ir_version": IR_VERSION,
                "random_seed": self.random_seed,
                "blocks": [b.to_dict() for b in self.blocks]}

    @staticmethod
    def from_dict(d) -> "Program":
        assert d["ir_version"] == IR_VERSION, "incompatible IR version"
        p = Program()
        p.random_seed = d.get("random_seed", 0)
        p.blocks = []
        for bd in d["blocks"]:
            blk = Block(p, bd["idx"], bd["parent_idx"])
            blk._load_dict(bd)
            p.blocks.append(blk)
        return p

    def serialize_to_string(self) -> bytes:
        return json.dumps(self.to_dict()).encode("utf-8")

    @staticmethod
    def parse_from_string(s: bytes) -> "Program":
        return Program.from_dict(json.loads(s.decode("utf-8")))

    def __repr__(self):
        n_ops = sum(len(b.ops) for b in self.blocks)
        return f"static.Program({len(self.blocks)} blocks, {n_ops} ops)"

    # pruning (save_inference_model path)
    def prune(self, feed_names: Sequence[str], fetch_names: Sequence[str]):
        """Keep only ops needed to compute fetches from feeds + persistables
        (reference Program._prune, inference/analysis ir_graph_build).

        VarDescs no surviving op references are dropped, and sub-blocks
        reachable only from pruned control-flow ops are emptied (their
        indices stay stable so surviving sub_block attrs keep resolving)
        — save_inference_model blobs carry no dead weight."""
        blk = self.global_block
        needed = set(fetch_names)
        kept = []
        for op in reversed(blk.ops):
            if set(op.output_names()) & needed:
                kept.append(op)
                needed |= set(op.input_names())
        kept.reverse()
        p = Program.from_dict(self.to_dict())
        nb = p.global_block
        nb.ops = [OpDesc.from_dict(o.to_dict()) for o in kept]
        # drop sub-blocks only pruned ops referenced (dead While/cond
        # branches used to ride along whole into the inference blob)
        reachable = {0}
        frontier = [nb]
        while frontier:
            b = frontier.pop()
            for op in b.ops:
                for key in ("sub_block", "sub_block_t", "sub_block_f"):
                    idx = op.attrs.get(key)
                    if isinstance(idx, int) and idx not in reachable:
                        reachable.add(idx)
                        frontier.append(p.blocks[idx])
        for b in p.blocks:
            if b.idx not in reachable:
                b.ops = []
                b.vars = {}
        used = set(feed_names) | set(fetch_names)
        for b in p.blocks:
            for op in b.ops:
                used |= set(op.input_names()) | set(op.output_names())
        nb.vars = {k: v for k, v in nb.vars.items() if k in used}
        return p


# ops whose behavior flips under clone(for_test=True)
_TEST_MODE_OPS = {
    "dropout": ("is_test",),
    "batch_norm": ("is_test",),
}

# -- default program / guard stacks (reference framework.py default_main_
# program etc.) -----------------------------------------------------------
_main_program = Program()
_startup_program = Program()
_block_stack: Dict[int, List[int]] = {}


def _current_block_idx(program: Program) -> int:
    stack = _block_stack.get(id(program))
    return stack[-1] if stack else 0


class _BlockGuard:
    def __init__(self, program: Program, block: Block):
        self.program, self.block = program, block

    def __enter__(self):
        _block_stack.setdefault(id(self.program), []).append(self.block.idx)
        return self.block

    def __exit__(self, *exc):
        _block_stack[id(self.program)].pop()


def default_main_program() -> Program:
    return _main_program


def default_startup_program() -> Program:
    return _startup_program


class program_guard:
    """with program_guard(main, startup): layer calls build into `main`."""

    def __init__(self, main_program: Program,
                 startup_program: Optional[Program] = None):
        self.main = main_program
        self.startup = startup_program

    def __enter__(self):
        global _main_program, _startup_program
        self._saved = (_main_program, _startup_program)
        _main_program = self.main
        if self.startup is not None:
            _startup_program = self.startup
        return self.main

    def __exit__(self, *exc):
        global _main_program, _startup_program
        _main_program, _startup_program = self._saved
