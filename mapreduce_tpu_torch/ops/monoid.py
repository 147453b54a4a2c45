"""A user's reduce monoid, lowered into the segmented-reduce kernel's combine.

The JAX package traces any associative ``op(a, b)`` into its Pallas
kernel body (``ops/segscan.py``'s ``_segreduce_kernel``: "what lets the
device path accept any user monoid").  The port's kernel is CUDA C++,
built by ``nvcc``, so a callable ``reduce_op`` on torch tensors is
lowered once into a small integer IR and emitted as C++:

* :func:`lower` runs ``torch.fx`` symbolic tracing on ``op(a, b)`` and
  turns the graph into straight-line code over int32 lanes.  The nodes
  it takes, and nothing else: lane reads ``x[..., i]`` (and the whole
  value); ``+ - *`` and unary ``-`` with int32 wraparound; ``& | ^ ~``;
  ``<<`` and ``>>`` (arithmetic, as torch's) by a constant from 0 to
  31; ``torch.minimum`` / ``torch.maximum``; the six comparisons and
  ``torch.where``; Python int constants in int32 range; and
  ``torch.stack([...], dim=-1)`` (or ``axis=-1``) as the result.
  Anything else — division, floats, casts, data-dependent Python
  control flow — raises ``NotImplementedError`` naming the node and its
  source line.  The result must be int32 lanes (the port's counterpart
  of the JAX wrapper's ``eval_shape`` probe).
* An op that stacks D lane results is a *D-lane* monoid; one that never
  reads a lane (``torch.bitwise_xor``, ``lambda a, b: a + b``) is
  *lane-wise* and takes any lane count, applying its one-lane program to
  every lane, as torch applies it elementwise.  The kernel takes 1 to
  :data:`MAX_LANES` lanes.
* :func:`evaluate` is the IR's plain PyTorch evaluation, :func:`ir_hash`
  its canonical key (two callables with one body share it; a lambda's
  name never enters it), and :func:`emit_cuda` the text of the C++
  combine that ``ops/kernel_compat.py`` builds with
  ``csrc/segreduce.cuh`` into a library of its own.

:func:`lower` caches its IR per callable, so a callable is traced
once, not once per wave.  This module imports torch only.
"""

from __future__ import annotations

import hashlib
import json
import operator
import os
import traceback
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import torch
import torch.fx as fx

#: the most value lanes the monoid kernel takes (csrc/segreduce.cuh's
#: staging: 2,048 rows x 8 lanes x 4 B, within the card's shared memory)
MAX_LANES = 8

_INT32_MIN, _INT32_MAX = -(2 ** 31), 2 ** 31 - 1

# IR node kinds: ("in", side, lane) reads lane `lane` of a (side 0) or b
# (side 1), or, in a lane-wise IR, the current lane (lane 0);
# ("const", value); (op, *operand indices) below; ("shl" | "shr", x, k)
# with k a shift count.  Every node is int32 ("i") or bool ("b").
_ARITH = {"add", "sub", "mul"}
_BITWISE = {"and", "or", "xor"}
_MINMAX = {"min", "max"}
_COMPARE = {"lt", "le", "gt", "ge", "eq", "ne"}

#: call targets (operator.*, torch.*) and tensor methods -> IR op
_TARGETS: Dict[object, str] = {
    operator.add: "add", operator.sub: "sub", operator.mul: "mul",
    operator.neg: "neg", operator.and_: "and", operator.or_: "or",
    operator.xor: "xor", operator.invert: "not",
    operator.lshift: "shl", operator.rshift: "shr",
    operator.lt: "lt", operator.le: "le", operator.gt: "gt",
    operator.ge: "ge", operator.eq: "eq", operator.ne: "ne",
    torch.add: "add", torch.sub: "sub", torch.subtract: "sub",
    torch.mul: "mul", torch.multiply: "mul", torch.neg: "neg",
    torch.negative: "neg", torch.bitwise_and: "and",
    torch.bitwise_or: "or", torch.bitwise_xor: "xor",
    torch.bitwise_not: "not", torch.bitwise_left_shift: "shl",
    torch.bitwise_right_shift: "shr", torch.minimum: "min",
    torch.maximum: "max", torch.lt: "lt", torch.le: "le",
    torch.gt: "gt", torch.ge: "ge", torch.eq: "eq", torch.ne: "ne",
    torch.where: "where",
}
_METHODS = {
    "add": "add", "sub": "sub", "subtract": "sub", "mul": "mul",
    "multiply": "mul", "neg": "neg", "negative": "neg",
    "bitwise_and": "and", "bitwise_or": "or", "bitwise_xor": "xor",
    "bitwise_not": "not", "bitwise_left_shift": "shl",
    "bitwise_right_shift": "shr", "minimum": "min", "maximum": "max",
    "lt": "lt", "le": "le", "gt": "gt", "ge": "ge", "eq": "eq", "ne": "ne",
    "__and__": "and", "__or__": "or", "__xor__": "xor",
}


class MonoidIR(NamedTuple):
    """A lowered monoid: straight-line int32 code over lanes."""

    #: D for a D-lane monoid; None for a lane-wise one (any lane count)
    lanes: Optional[int]
    #: SSA nodes, operands before their users, no duplicates, each
    #: reached by a result (made from the results, on demand)
    nodes: Tuple[tuple, ...]
    #: each node's type: "i" int32 or "b" bool
    types: Tuple[str, ...]
    #: the node of each result lane (one for a lane-wise monoid)
    out: Tuple[int, ...]
    #: the callable's name, for messages only (not in the hash)
    name: str


_PKG_DIRS = (os.path.dirname(torch.__file__), os.path.dirname(__file__))


def _user_line(frames) -> str:
    """``file:line: code`` of the innermost frame outside torch and this
    module, or a note that there is none (a builtin op)."""
    for f in reversed(list(frames)):
        if not f.filename.startswith(_PKG_DIRS):
            code = (f.line or "").strip()
            return f"{f.filename}:{f.lineno}: {code}"
    return "no Python source line (a builtin op)"


def _node_line(node) -> str:
    """The source line that made fx *node* (recorded by :class:`_Tracer`)."""
    return node.meta.get("mr_line", "an unknown line")


def _name(op: Callable) -> str:
    return getattr(op, "__qualname__", None) or repr(op)


class _Tracer(fx.Tracer):
    """``fx.Tracer`` that keeps the user's source line of each node (fx's
    own ``record_stack_traces`` imports ``torch``'s symbolic-shape
    machinery, seconds in a fresh process)."""

    def create_proxy(self, *args, **kwargs):
        proxy = super().create_proxy(*args, **kwargs)
        proxy.node.meta["mr_line"] = _user_line(traceback.extract_stack())
        return proxy


def _trace(op: Callable) -> fx.Graph:
    def combine(a, b):
        return op(a, b)

    try:
        return _Tracer().trace(combine)
    except NotImplementedError:
        raise
    except Exception as exc:  # control flow on a traced value, and such
        where = _user_line(traceback.extract_tb(exc.__traceback__))
        raise NotImplementedError(
            f"reduce_op {_name(op)}: cannot be lowered to the monoid "
            f"kernel: {type(exc).__name__}: {exc} (at {where}); the "
            "kernel takes straight-line int32 code, no data-dependent "
            "Python control flow") from exc


class _Lowering:
    """The fx graph of one callable, lowered lazily from its result: the
    result's form fixes D first (a ``torch.stack`` of D lanes, or a
    whole value: lane-wise), then each result lane's SSA nodes are made
    on demand, so a whole value becomes lanes only where it is read and
    nodes no result reaches are never visited."""

    def __init__(self, op: Callable, graph: fx.Graph) -> None:
        self.op = op
        self.nodes: List[tuple] = []
        self.types: List[str] = []
        self.index: Dict[tuple, int] = {}
        self.sides: Dict[object, int] = {}
        #: (fx node, lane or None) -> SSA index
        self.memo: Dict[Tuple[object, Optional[int]], int] = {}
        self.kinds: Dict[object, str] = {}
        self.out = None
        for node in graph.nodes:
            if node.op == "placeholder":
                self.sides[node] = len(self.sides)
            elif node.op == "output":
                self.out = node
        #: D, or None for a lane-wise monoid
        self.D: Optional[int] = None

    def fail(self, node, what: str):
        target = getattr(node.target, "__name__", node.target)
        raise NotImplementedError(
            f"reduce_op {_name(self.op)}: {what} (node {node.name!r}: "
            f"{node.op} {target}, at {_node_line(node)}); the monoid "
            "kernel takes lane reads x[..., i], + - * and unary -, & | ^ "
            "~, << >> by a constant 0-31, torch.minimum/maximum, "
            "comparisons, torch.where, int32 constants and "
            "torch.stack(..., dim=-1)")

    def emit(self, key: tuple, typ: str) -> int:
        got = self.index.get(key)
        if got is None:
            self.nodes.append(key)
            self.types.append(typ)
            got = self.index[key] = len(self.nodes) - 1
        return got

    # -- what each fx node is ---------------------------------------------

    def op_name(self, node) -> Optional[str]:
        if node.op == "call_method":
            return _METHODS.get(node.target)
        if node.op == "call_function":
            return _TARGETS.get(node.target)
        return None

    def kind(self, node) -> str:
        """"whole" (every lane at once), "lane" (one lane) or a
        refusal, for a value-producing fx node."""
        got = self.kinds.get(node)
        if got is not None:
            return got
        if node in self.sides:
            got = "whole"
        elif node.op == "call_function" and node.target is operator.getitem:
            src, idx = node.args
            if not (isinstance(src, fx.Node) and self.kind(src) == "whole"):
                self.fail(node, "indexing of something other than a "
                          "whole value")
            got = "lane"
        elif node.op == "call_function" and node.target is torch.stack:
            self.fail(node, "torch.stack other than as the result")
        elif node.op in ("call_function", "call_method"):
            if self.op_name(node) is None:
                self.fail(node, "an operation outside the lowering's "
                          "node set")
            if node.kwargs:
                self.fail(node, f"keyword arguments {sorted(node.kwargs)}")
            kinds = {self.kind(a) for a in node.args
                     if isinstance(a, fx.Node)}
            if kinds == {"whole", "lane"}:
                self.fail(node, "a whole value combined with one lane of "
                          "a value (shapes [N, D] and [N])")
            if not kinds:
                self.fail(node, "an operation on constants alone")
            got = kinds.pop()
        else:  # get_attr: a tensor or module captured from outside
            self.fail(node, "a captured tensor or module attribute")
        self.kinds[node] = got
        return got

    # -- SSA nodes ----------------------------------------------------------

    def lane(self, node, k: Optional[int]) -> int:
        """The SSA node of *node*'s lane *k* (a whole value's; ignored
        for a one-lane value)."""
        kind = self.kind(node)
        key = (node, k if kind == "whole" else None)
        got = self.memo.get(key)
        if got is not None:
            return got
        if node in self.sides:
            got = self.emit(("in", self.sides[node], k), "i")
        elif node.target is operator.getitem:
            got = self.read(node)
        else:
            got = self.apply(node, k)
        self.memo[key] = got
        return got

    def read(self, node) -> int:
        src, idx = node.args
        if self.D is None:
            self.fail(node, "a lane read in a monoid whose result is not "
                      "torch.stack of its lanes")
        ok = (isinstance(idx, tuple) and len(idx) == 2
              and (idx[0] is Ellipsis or idx[0] == slice(None))
              and isinstance(idx[1], int) and not isinstance(idx[1], bool))
        if not ok:
            self.fail(node, f"index {idx!r}; a lane read is x[..., i]")
        if not -self.D <= idx[1] < self.D:
            self.fail(node, f"lane {idx[1]} of a {self.D}-lane value")
        return self.lane(src, idx[1] % self.D)

    def apply(self, node, k: Optional[int]) -> int:
        name = self.op_name(node)
        arity = 3 if name == "where" else (
            1 if name in ("neg", "not") else 2)
        if len(node.args) != arity:
            self.fail(node, f"{name} with {len(node.args)} operands")
        kinds, refs = [], []
        for a in node.args:
            if isinstance(a, fx.Node):
                r = self.lane(a, k)
                kinds.append(self.types[r])
                refs.append(r)
            elif isinstance(a, int) and not isinstance(a, bool):
                kinds.append("c")
                refs.append(a)
            else:
                self.fail(node, f"operand {a!r}: not a traced value or a "
                          "Python int")
        t = self.result_type(node, name, kinds)
        if name in ("shl", "shr"):
            if not 0 <= refs[1] <= 31:
                self.fail(node, f"a shift by {refs[1]}; the kernel takes "
                          "0-31")
            return self.emit((name, refs[0], refs[1]), t)
        ops = []
        for kind, r in zip(kinds, refs):
            if kind == "c":
                if not _INT32_MIN <= r <= _INT32_MAX:
                    self.fail(node, f"constant {r} outside int32")
                r = self.emit(("const", r), "i")
            ops.append(r)
        return self.emit((name,) + tuple(ops), t)

    def result_type(self, node, name: str, kinds: List[str]) -> str:
        """The type of *name* over operand types *kinds* ("i" int32, "b"
        bool, "c" Python int): torch's promotion, where it stays int32
        or bool; anything else is refused."""
        ints = all(k in ("i", "c") for k in kinds)
        t = None
        if name in _ARITH and ints:
            t = "i"
        elif name in _BITWISE:
            t = "i" if ints else ("b" if kinds == ["b", "b"] else None)
        elif name in _MINMAX and kinds == ["i", "i"]:
            t = "i"
        elif name in _COMPARE and ints:
            t = "b"
        elif name == "neg" and kinds == ["i"]:
            t = "i"
        elif name == "not" and kinds[0] in ("i", "b"):
            t = kinds[0]
        elif name in ("shl", "shr") and kinds == ["i", "c"]:
            t = "i"
        elif (name == "where" and kinds[0] == "b"
              and all(k in ("i", "c") for k in kinds[1:])
              and "i" in kinds[1:]):
            t = "i"
        if t is None:
            self.fail(node, f"{name} over operand types {kinds} (int32 "
                      "'i', bool 'b', Python int 'c'), which torch does "
                      "not keep int32 or bool")
        return t

    # -- the result ---------------------------------------------------------

    def run(self) -> MonoidIR:
        (res,) = self.out.args
        if not isinstance(res, fx.Node):
            self.fail(self.out, f"a result {res!r} that is not a traced "
                      "value")
        if res.op == "call_function" and res.target is torch.stack:
            items, *rest = res.args
            dim = rest[0] if rest else res.kwargs.get(
                "dim", res.kwargs.get("axis", 0))
            if (set(res.kwargs) - {"dim", "axis"} or len(rest) > 1
                    or dim not in (-1, 1)):
                self.fail(res, "torch.stack other than over the last "
                          "axis (dim=-1)")
            self.D = len(items)
            if self.D < 2:
                self.fail(res, "a stack of one lane: a one-lane monoid "
                          "takes and returns the whole value")
            if self.D > MAX_LANES:
                raise NotImplementedError(
                    f"reduce_op {_name(self.op)}: {self.D} lanes; the "
                    f"monoid kernel takes at most {MAX_LANES}")
            outs = []
            for it in items:
                if not isinstance(it, fx.Node) or self.kind(it) != "lane":
                    self.fail(res, f"a stacked element {it!r} that is not "
                              "one lane of a value")
                outs.append(self.lane(it, None))
        else:
            if self.kind(res) != "whole":
                self.fail(res, "a result of one lane: the monoid returns "
                          "the whole value or torch.stack of its lanes")
            outs = [self.lane(res, 0)]
        for o in outs:
            if self.types[o] != "i":
                self.fail(res, "a result lane that is bool, not int32")
        return MonoidIR(self.D, tuple(self.nodes), tuple(self.types),
                        tuple(outs), _name(self.op))


#: the lowering of each callable this process has lowered, by the
#: callable's id (the callable kept beside it, so that its id is not
#: reused)
_LOWERED: Dict[int, Tuple[Callable, MonoidIR]] = {}


def lower(op: Callable) -> MonoidIR:
    """The IR of *op*, an associative ``op(a, b)`` on int32 tensors
    (``[N]`` values for one lane, ``[N, D]`` for D).  Cached per
    callable; raises ``NotImplementedError`` naming the first node
    outside the lowering's set."""
    got = _LOWERED.get(id(op))
    if got is not None:
        return got[1]
    ir = _Lowering(op, _trace(op)).run()
    _LOWERED[id(op)] = (op, ir)
    return ir


def check_lanes(ir: MonoidIR, lanes: int) -> None:
    """Raise unless the kernel of *ir* takes values of *lanes* lanes."""
    if not 1 <= lanes <= MAX_LANES:
        raise NotImplementedError(
            f"reduce_op {ir.name}: {lanes} value lanes; the monoid kernel "
            f"takes 1 to {MAX_LANES}")
    if ir.lanes is not None and ir.lanes != lanes:
        raise ValueError(f"reduce_op {ir.name} returns {ir.lanes} lanes, "
                         f"the values have {lanes}")


# -- plain evaluation ------------------------------------------------------------

_TORCH_BINARY = {
    "add": operator.add, "sub": operator.sub, "mul": operator.mul,
    "and": operator.and_, "or": operator.or_, "xor": operator.xor,
    "min": torch.minimum, "max": torch.maximum, "lt": operator.lt,
    "le": operator.le, "gt": operator.gt, "ge": operator.ge,
    "eq": operator.eq, "ne": operator.ne,
}


def evaluate(ir: MonoidIR, a: torch.Tensor, b: torch.Tensor
             ) -> torch.Tensor:
    """``op(a, b)`` from the IR, in plain PyTorch: ``[..., D]`` int32
    values for a D-lane monoid, any shape for a lane-wise one."""
    v: List[object] = []
    for n in ir.nodes:
        k = n[0]
        if k == "in":
            x = (a, b)[n[1]]
            v.append(x if ir.lanes is None else x[..., n[2]])
        elif k == "const":
            v.append(n[1])
        elif k == "neg":
            v.append(-v[n[1]])
        elif k == "not":
            v.append(~v[n[1]])
        elif k == "shl":
            v.append(v[n[1]] << n[2])
        elif k == "shr":
            v.append(v[n[1]] >> n[2])
        elif k == "where":
            v.append(torch.where(v[n[1]], v[n[2]], v[n[3]]))
        else:
            x, y = v[n[1]], v[n[2]]
            if not isinstance(x, torch.Tensor):  # a constant on the left
                x = torch.full_like(y, x)
            v.append(_TORCH_BINARY[k](x, y))
    outs = [v[o] for o in ir.out]
    return outs[0] if ir.lanes is None else torch.stack(outs, dim=-1)


# -- the key and the C++ ---------------------------------------------------------

def ir_hash(ir: MonoidIR) -> str:
    """The canonical key of *ir*: a sha256 of its lanes, nodes and
    results (not of the callable's name)."""
    doc = json.dumps([ir.lanes, [list(n) for n in ir.nodes], list(ir.out)],
                     separators=(",", ":"))
    return hashlib.sha256(doc.encode()).hexdigest()


def _lit(v: int) -> str:
    return f"static_cast<int32_t>(0x{v & 0xFFFFFFFF:08x}u)"


_CXX_BINARY = {"and": "&", "or": "|", "xor": "^", "lt": "<", "le": "<=",
               "gt": ">", "ge": ">=", "eq": "==", "ne": "!="}
_CXX_WRAP = {"add": "+", "sub": "-", "mul": "*"}


def emit_cuda(ir: MonoidIR) -> str:
    """The C++ text of the combine: a struct ``MrUserCombine`` with
    ``kLanes`` (0: lane-wise) and ``template <int D> apply(a, b, o)``
    over ``int32_t[D]``.  ``+ - *`` and unary ``-`` go through
    ``uint32_t`` (signed overflow is undefined in C++ and wraps in torch
    and XLA); ``>>`` on ``int32_t`` is arithmetic, as torch's."""
    types = ir.types
    idx = "d" if ir.lanes is None else None
    body = []
    for i, n in enumerate(ir.nodes):
        k = n[0]
        cty = "bool" if types[i] == "b" else "int32_t"
        if k == "in":
            lane = idx if idx is not None else str(n[2])
            e = f"{'ab'[n[1]]}[{lane}]"
        elif k == "const":
            e = _lit(n[1])
        elif k in _CXX_WRAP:
            e = (f"static_cast<int32_t>(static_cast<uint32_t>(t{n[1]}) "
                 f"{_CXX_WRAP[k]} static_cast<uint32_t>(t{n[2]}))")
        elif k == "neg":
            e = f"static_cast<int32_t>(0u - static_cast<uint32_t>(t{n[1]}))"
        elif k == "not":
            e = f"!t{n[1]}" if types[i] == "b" else f"~t{n[1]}"
        elif k == "shl":
            e = (f"static_cast<int32_t>(static_cast<uint32_t>(t{n[1]}) "
                 f"<< {n[2]})")
        elif k == "shr":
            e = f"t{n[1]} >> {n[2]}"
        elif k in _MINMAX:
            e = f"{k}(t{n[1]}, t{n[2]})"
        elif k == "where":
            e = f"t{n[1]} ? t{n[2]} : t{n[3]}"
        elif types[i] == "b" and k in _BITWISE:
            e = f"static_cast<bool>(t{n[1]} {_CXX_BINARY[k]} t{n[2]})"
        else:
            e = f"t{n[1]} {_CXX_BINARY[k]} t{n[2]}"
        body.append(f"const {cty} t{i} = {e};")
    if ir.lanes is None:
        lines = ["#pragma unroll", "for (int d = 0; d < D; ++d) {"]
        lines += ["  " + s for s in body]
        lines += [f"  o[d] = t{ir.out[0]};", "}"]
    else:
        lines = [f"static_assert(D == {ir.lanes}, \"a {ir.lanes}-lane "
                 "monoid\");"] + body
        lines += [f"o[{j}] = t{o};" for j, o in enumerate(ir.out)]
    text = "\n".join("    " + s for s in lines)
    kind = "lane-wise" if ir.lanes is None else f"{ir.lanes} lanes"
    return (f"// user monoid {ir_hash(ir)[:16]} ({kind})\n"
            "struct MrUserCombine {\n"
            f"  static constexpr int kLanes = {ir.lanes or 0};\n"
            "  template <int D>\n"
            "  static __device__ __forceinline__ void apply(\n"
            "      const int32_t* a, const int32_t* b, int32_t* o) {\n"
            f"{text}\n"
            "  }\n"
            "};\n")
