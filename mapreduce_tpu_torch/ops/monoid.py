"""A user's reduce monoid, lowered into the segmented-reduce kernel's combine.

The JAX package traces any associative ``op(a, b)`` into its Pallas
kernel body (``ops/segscan.py``'s ``_segreduce_kernel``: "what lets the
device path accept any user monoid").  The port's kernel is CUDA C++,
built by ``nvcc``, so a callable ``reduce_op`` on torch tensors is
lowered once into a small typed IR and emitted as C++:

* :func:`lower` runs ``torch.fx`` symbolic tracing on ``op(a, b)`` over
  lanes of one dtype, int32 or float32, and turns the graph into
  straight-line code.  Each node is int32 ``"i"``, float32 ``"f"`` or
  bool ``"b"``, typed by torch's promotion rules (an int32 lane times
  ``0.5`` is float32).  The nodes it takes, and nothing else: lane
  reads ``x[..., i]`` (and the whole value); ``+ - *`` and unary ``-``
  (int32 with wraparound, or float32); true division ``/``; int32
  ``//`` and ``%``, ``torch.div(rounding_mode="floor"|"trunc")``,
  ``torch.remainder`` and ``torch.fmod``; ``& | ^ ~``; ``<<`` and ``>>``
  (arithmetic, as torch's) by a constant from 0 to 31; ``torch.abs``,
  ``torch.clamp`` with constant bounds, ``torch.exp``, ``torch.log``,
  ``torch.sqrt``; ``torch.minimum`` / ``torch.maximum``; the six
  comparisons and ``torch.where``; Python int constants in int32 range
  and Python float constants; casts between int32 and float32
  (``.float()``, ``.int()``, ``.to(torch.float32 | torch.int32)``); and
  ``torch.stack([...], dim=-1)`` (or ``axis=-1``) as the result.
  Anything else — ``torch.gcd``, a reduction inside the op, a cast to
  another dtype, data-dependent Python control flow — raises
  ``NotImplementedError`` naming the node and its source line.  The
  result lanes share one dtype (``torch.stack`` promotes, as the JAX
  wrapper's one ``out_dtype`` does).  When the op turns lanes of one
  dtype into the other (int32 lanes summed as float32), the kernel runs
  on the result dtype and the lanes are cast up front, as the JAX
  wrapper's ``eval_shape`` probe does; the IR is the op's over that
  dtype.
* The rules where torch leaves a value open follow XLA, as the JAX
  twin of the op computes it: ``x // 0`` and ``x % 0`` as
  ``jnp.floor_divide`` / ``jnp.remainder`` (``-1`` or ``-2``, and
  ``0``), ``torch.fmod(x, 0)`` ``0``, a truncating division by 0 ``-1``
  (``lax.div``), ``INT32_MIN // -1`` ``INT32_MIN``; a float32 cast to
  int32 truncates and saturates, NaN to 0; a float ``torch.minimum`` /
  ``maximum`` (and ``clamp``) propagates NaN and orders -0.0 below
  +0.0, as ``jnp.minimum`` (torch's own tie of -0.0 and +0.0 keeps the
  right operand in its vectorized loop and the left in its scalar one).
  torch's CPU raises on an integer division by zero (and traps on
  ``INT32_MIN // -1``); the kernel and :func:`evaluate` never do, so
  the rows a run's result never reads (past its end, invalid rows that
  trail the last run) may hold any value.
* An op that stacks D lane results is a *D-lane* monoid; one that never
  reads a lane (``torch.bitwise_xor``, ``lambda a, b: a + b``) is
  *lane-wise* and takes any lane count, applying its one-lane program to
  every lane, as torch applies it elementwise.  The kernel takes 1 to
  :data:`MAX_LANES` lanes.
* :func:`evaluate` is the IR's plain PyTorch evaluation, :func:`ir_hash`
  its canonical key (the types in it: an int32 body and a float32 body
  never share a library; two callables with one body share it; a
  lambda's name never enters it), and :func:`emit_cuda` the text of the
  C++ combine that ``ops/kernel_compat.py`` builds with
  ``csrc/segreduce.cuh`` into a library of its own.  Float ``+ - * /``
  and ``sqrt`` are emitted as the correctly rounded intrinsics (never
  contracted into a fused multiply-add): ``+ - * /`` give torch's bits,
  ``sqrt`` IEEE's, as :func:`evaluate`'s does (torch's CPU ``sqrt`` is
  1 ulp off it on some inputs); ``expf`` and ``logf`` are CUDA's (within
  2 ulp, not torch's bits).

:func:`lower` caches its IR per callable and dtype, so a callable is
traced once, not once per wave.  This module imports torch only.
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

#: the lane dtypes the kernel takes, by IR type
_DTYPES = {"i": torch.int32, "f": torch.float32}
_TYPES = {v: k for k, v in _DTYPES.items()}

# IR node kinds: ("in", side, lane) reads lane `lane` of a (side 0) or b
# (side 1), or, in a lane-wise IR, the current lane (lane 0);
# ("const", value) an int32 constant; ("fconst", bits) a float32 constant
# by its bit pattern; ("tof" | "toi", x) a cast to float32 / int32; (op,
# *operand indices) below; ("shl" | "shr", x, k) with k a shift count.
# Operands of a node share one type (promotion inserts the casts).
_ARITH = {"add", "sub", "mul"}
_BITWISE = {"and", "or", "xor"}
_MINMAX = {"min", "max"}
_COMPARE = {"lt", "le", "gt", "ge", "eq", "ne"}
#: int32 division: floor (``//``), the remainder with the divisor's sign
#: (``%``), truncation (``rounding_mode="trunc"``) and ``fmod``
_INTDIV = {"floordiv", "mod", "tdiv", "fmod"}
#: float32 functions of one operand (an int32 operand is cast first)
_FLOATFN = {"exp", "log", "sqrt"}
_UNARY = {"neg", "not", "abs", "tof", "toi"} | _FLOATFN

#: call targets (operator.*, torch.*) and tensor methods -> IR op ("div"
#: with a ``rounding_mode`` becomes "floordiv" or "tdiv"; "to" is a cast)
_TARGETS: Dict[object, str] = {
    operator.add: "add", operator.sub: "sub", operator.mul: "mul",
    operator.neg: "neg", operator.and_: "and", operator.or_: "or",
    operator.xor: "xor", operator.invert: "not",
    operator.lshift: "shl", operator.rshift: "shr",
    operator.lt: "lt", operator.le: "le", operator.gt: "gt",
    operator.ge: "ge", operator.eq: "eq", operator.ne: "ne",
    operator.truediv: "div", operator.floordiv: "floordiv",
    operator.mod: "mod", operator.abs: "abs",
    torch.add: "add", torch.sub: "sub", torch.subtract: "sub",
    torch.mul: "mul", torch.multiply: "mul", torch.neg: "neg",
    torch.negative: "neg", torch.bitwise_and: "and",
    torch.bitwise_or: "or", torch.bitwise_xor: "xor",
    torch.bitwise_not: "not", torch.bitwise_left_shift: "shl",
    torch.bitwise_right_shift: "shr", torch.minimum: "min",
    torch.maximum: "max", torch.lt: "lt", torch.le: "le",
    torch.gt: "gt", torch.ge: "ge", torch.eq: "eq", torch.ne: "ne",
    torch.where: "where", torch.div: "div", torch.divide: "div",
    torch.true_divide: "div", torch.floor_divide: "floordiv",
    torch.remainder: "mod", torch.fmod: "fmod", torch.abs: "abs",
    torch.absolute: "abs", torch.exp: "exp", torch.log: "log",
    torch.sqrt: "sqrt", torch.clamp: "clamp", torch.clip: "clamp",
}
_METHODS = {
    "add": "add", "sub": "sub", "subtract": "sub", "mul": "mul",
    "multiply": "mul", "neg": "neg", "negative": "neg",
    "bitwise_and": "and", "bitwise_or": "or", "bitwise_xor": "xor",
    "bitwise_not": "not", "bitwise_left_shift": "shl",
    "bitwise_right_shift": "shr", "minimum": "min", "maximum": "max",
    "lt": "lt", "le": "le", "gt": "gt", "ge": "ge", "eq": "eq", "ne": "ne",
    "__and__": "and", "__or__": "or", "__xor__": "xor",
    "div": "div", "divide": "div", "true_divide": "div",
    "floor_divide": "floordiv", "remainder": "mod", "fmod": "fmod",
    "abs": "abs", "absolute": "abs", "exp": "exp", "log": "log",
    "sqrt": "sqrt", "clamp": "clamp", "clip": "clamp",
    "float": "tof", "int": "toi", "to": "to",
}
#: the keyword arguments each op takes
_KWARGS = {"div": {"rounding_mode"}, "clamp": {"min", "max"},
           "to": {"dtype"}}
_ROUNDING = {None: "div", "floor": "floordiv", "trunc": "tdiv"}


class MonoidIR(NamedTuple):
    """A lowered monoid: straight-line typed code over lanes."""

    #: D for a D-lane monoid; None for a lane-wise one (any lane count)
    lanes: Optional[int]
    #: SSA nodes, operands before their users, no duplicates, each
    #: reached by a result (made from the results, on demand)
    nodes: Tuple[tuple, ...]
    #: each node's type: "i" int32, "f" float32 or "b" bool
    types: Tuple[str, ...]
    #: the node of each result lane (one for a lane-wise monoid)
    out: Tuple[int, ...]
    #: the type of the lanes, in and out: "i" or "f"
    dtype: str
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


def _f32_bits(x: float) -> int:
    """The float32 bit pattern of Python float *x* (rounded to nearest,
    as torch converts a Python scalar for a float32 tensor)."""
    return torch.tensor(x, dtype=torch.float32).view(torch.int32).item() \
        & 0xFFFFFFFF


def _f32_value(bits: int) -> float:
    return torch.tensor(bits - ((bits & 0x80000000) << 1),
                        dtype=torch.int32).view(torch.float32).item()


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
            "kernel takes straight-line int32 or float32 code, no "
            "data-dependent Python control flow") from exc


class _Lowering:
    """The fx graph of one callable over lanes of type *in_type*,
    lowered lazily from its result: the result's form fixes D first (a
    ``torch.stack`` of D lanes, or a whole value: lane-wise), then each
    result lane's SSA nodes are made on demand, so a whole value becomes
    lanes only where it is read and nodes no result reaches are never
    visited."""

    def __init__(self, op: Callable, graph: fx.Graph,
                 in_type: str = "i") -> None:
        self.op = op
        self.in_type = in_type
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
            "kernel takes lane reads x[..., i], + - * / and unary -, "
            "int32 // and % (torch.div with a rounding_mode, "
            "torch.remainder, torch.fmod), & | ^ ~, << >> by a constant "
            "0-31, torch.abs/clamp/exp/log/sqrt, torch.minimum/maximum, "
            "comparisons, torch.where, int32 and float constants, casts "
            "between int32 and float32 and torch.stack(..., dim=-1)")

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
            name = self.op_name(node)
            if name is None:
                self.fail(node, "an operation outside the lowering's "
                          "node set")
            extra = set(node.kwargs) - _KWARGS.get(name, set())
            if extra:
                self.fail(node, f"keyword arguments {sorted(extra)}")
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
            got = self.emit(("in", self.sides[node], k), self.in_type)
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

    def operand(self, node, a, k: Optional[int]) -> Tuple[str, object]:
        """``(type, ref)`` of an argument: a traced value's ``(type, SSA
        index)``, a Python int's ``("c", value)``, a float's ``("d",
        value)``."""
        if isinstance(a, fx.Node):
            r = self.lane(a, k)
            return self.types[r], r
        if isinstance(a, bool) or not isinstance(a, (int, float)):
            self.fail(node, f"operand {a!r}: not a traced value or a "
                      "Python int or float")
        return ("c" if isinstance(a, int) else "d"), a

    def apply(self, node, k: Optional[int]) -> int:
        name = self.op_name(node)
        args, kw = list(node.args), dict(node.kwargs)
        if name == "div":
            mode = kw.pop("rounding_mode", None)
            if mode not in _ROUNDING:
                self.fail(node, f"rounding_mode {mode!r}")
            name = _ROUNDING[mode]
        if name == "clamp":
            bounds = args[1:] + [None] * (3 - len(args))
            lo, hi = kw.get("min", bounds[0]), kw.get("max", bounds[1])
            if len(args) > 3 or any(
                    isinstance(b, fx.Node) for b in (lo, hi)):
                self.fail(node, "torch.clamp other than with constant "
                          "bounds")
            return self.clamp(node, self.operand(node, args[0], k), lo, hi)
        if name == "to":
            dtype = kw.get("dtype", args[1] if len(args) > 1 else None)
            if len(args) > 2 or dtype not in _TYPES:
                self.fail(node, f"a cast to {dtype}, outside the lowering "
                          "(it casts between int32 and float32 only)")
            name, args = ("tof" if dtype == torch.float32 else "toi"), [
                args[0]]
        arity = 3 if name == "where" else (1 if name in _UNARY else 2)
        if len(args) != arity:
            self.fail(node, f"{name} with {len(args)} operands")
        return self.build(node, name,
                          [self.operand(node, a, k) for a in args])

    # -- types --------------------------------------------------------------

    def promote(self, node, name: str, ops) -> str:
        """The common type of *ops* under torch's promotion: float32 if
        a float value or a Python float takes part, else int32 if an
        int32 value does; refused for bool operands and constants
        alone."""
        kinds = [t for t, _ in ops]
        if "b" not in kinds and ("f" in kinds or (
                "d" in kinds and "i" in kinds)):
            return "f"
        if "b" not in kinds and "i" in kinds and "d" not in kinds:
            return "i"
        self.fail(node, f"{name} over operand types {kinds} (int32 'i', "
                  "float32 'f', bool 'b', Python int 'c' and float 'd'), "
                  "which torch does not keep int32 or float32")

    def cast(self, node, op, typ: str) -> int:
        """The SSA node of operand *op* as type *typ*: a constant made
        one, an int32 value cast up."""
        t, r = op
        if t == typ:
            return r
        if t == "c" and typ == "i":
            if not _INT32_MIN <= r <= _INT32_MAX:
                self.fail(node, f"constant {r} outside int32")
            return self.emit(("const", r), "i")
        if t in ("c", "d") and typ == "f":
            return self.emit(("fconst", _f32_bits(float(r))), "f")
        if t in ("i", "b") and typ == "f":
            return self.emit(("tof", r), "f")
        self.fail(node, f"an operand of type {t} where {typ} is needed")

    def clamp(self, node, x, lo, hi) -> int:
        """``torch.clamp(x, lo, hi)``: ``min(max(x, lo), hi)``."""
        consts = [b for b in (lo, hi) if b is not None]
        if not consts or not all(isinstance(b, (int, float))
                                 and not isinstance(b, bool)
                                 for b in consts):
            self.fail(node, f"clamp bounds {lo!r}, {hi!r}: Python ints or "
                      "floats, at least one")
        ops = [x] + [("c" if isinstance(b, int) else "d", b) for b in consts]
        typ = self.promote(node, "clamp", ops)
        r = self.cast(node, x, typ)
        for name, b in (("max", lo), ("min", hi)):
            if b is not None:
                bt = "c" if isinstance(b, int) else "d"
                r = self.emit((name, r, self.cast(node, (bt, b), typ)), typ)
        return r

    def build(self, node, name: str, ops) -> int:
        """The SSA node of *name* over typed operands *ops*, the operands
        cast to the type torch computes it in."""
        kinds = [t for t, _ in ops]
        if name in ("shl", "shr"):
            if kinds != ["i", "c"]:
                self.fail(node, f"{name} over operand types {kinds}; the "
                          "kernel shifts int32 by a constant")
            if not 0 <= ops[1][1] <= 31:
                self.fail(node, f"a shift by {ops[1][1]}; the kernel takes "
                          "0-31")
            return self.emit((name, ops[0][1], ops[1][1]), "i")
        if name in ("tof", "toi"):
            t, r = ops[0]
            if t not in ("i", "f", "b"):
                self.fail(node, f"a cast of {t}")
            want = "f" if name == "tof" else "i"
            return r if t == want else self.emit((name, r), want)
        if name == "not":
            if kinds[0] not in ("i", "b"):
                self.fail(node, f"not over operand types {kinds}")
            return self.emit((name, ops[0][1]), kinds[0])
        if name in ("neg", "abs"):
            if kinds[0] not in ("i", "f"):
                self.fail(node, f"{name} over operand types {kinds}")
            return self.emit((name, ops[0][1]), kinds[0])
        if name in _FLOATFN:
            if kinds[0] not in ("i", "f"):
                self.fail(node, f"{name} over operand types {kinds}")
            return self.emit((name, self.cast(node, ops[0], "f")), "f")
        if name in _BITWISE:
            if kinds == ["b", "b"]:
                return self.emit((name, ops[0][1], ops[1][1]), "b")
            if not set(kinds) <= {"i", "c"} or "i" not in kinds:
                self.fail(node, f"{name} over operand types {kinds}, "
                          "which the kernel takes for int32 and bool only")
            typ = "i"
        elif name == "where":
            if kinds[0] != "b":
                self.fail(node, f"where over operand types {kinds}: its "
                          "condition is not bool")
            typ = self.promote(node, name, ops[1:])
            return self.emit(("where", ops[0][1]) + tuple(
                self.cast(node, o, typ) for o in ops[1:]), typ)
        else:
            typ = "f" if name == "div" else self.promote(node, name, ops)
            if name in _INTDIV and typ != "i":
                self.fail(node, f"{name} over operand types {kinds}: the "
                          "kernel takes int32 division and remainder only")
        refs = tuple(self.cast(node, o, typ) for o in ops)
        return self.emit((name,) + refs, "b" if name in _COMPARE else typ)

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
        types = {self.types[o] for o in outs}
        if "b" in types:
            self.fail(res, "a result lane that is bool, not int32 or "
                      "float32")
        # torch.stack promotes: one float32 lane makes every lane float32
        typ = "f" if "f" in types else "i"
        outs = [self.cast(res, (self.types[o], o), typ) for o in outs]
        return MonoidIR(self.D, tuple(self.nodes), tuple(self.types),
                        tuple(outs), typ, _name(self.op))


#: the lowering of each callable this process has lowered, or its
#: refusal, by the callable's id and the lanes' type (the callable kept
#: beside it, so that its id is not reused)
_LOWERED: Dict[Tuple[int, str], Tuple[Callable, object]] = {}


def _lower(op: Callable, typ: str) -> MonoidIR:
    got = _LOWERED.get((id(op), typ))
    if got is None:
        try:
            got = (op, _Lowering(op, _trace(op), typ).run())
        except NotImplementedError as exc:
            got = (op, str(exc))
        _LOWERED[(id(op), typ)] = got
    if isinstance(got[1], str):
        raise NotImplementedError(got[1])
    return got[1]


def lower(op: Callable, dtype: torch.dtype = torch.int32) -> MonoidIR:
    """The kernel IR of *op*, an associative ``op(a, b)`` on torch
    tensors of *dtype* (int32 or float32; ``[N]`` values for one lane,
    ``[N, D]`` for D).  Where *op* returns the other dtype, the IR is
    *op*'s over that one (its lanes are cast up front).  Cached per
    callable and dtype; raises ``NotImplementedError`` naming the first
    node outside the lowering's set, and ``ValueError`` for another
    lane dtype."""
    typ = _TYPES.get(dtype)
    if typ is None:
        raise ValueError(f"reduce_op {_name(op)}: the monoid kernel takes "
                         f"int32 or float32 value lanes, got {dtype}")
    ir = _lower(op, typ)
    if ir.dtype != typ:
        ir = _lower(op, ir.dtype)
        if ir.dtype != _lower(op, typ).dtype:
            raise NotImplementedError(
                f"reduce_op {_name(op)}: returns {_DTYPES[ir.dtype]} over "
                f"its own results of {_DTYPES[_lower(op, typ).dtype]}; "
                "the kernel needs one lane dtype")
    return ir


def check_lowers(op: Callable) -> None:
    """Raise :func:`lower`'s int32 error where *op* lowers over neither
    int32 nor float32 lanes: the check an engine makes when it is built,
    before its map has said which lanes it emits."""
    try:
        lower(op, torch.int32)
    except NotImplementedError:
        try:
            lower(op, torch.float32)
        except NotImplementedError:
            pass
        else:
            return
        raise


def plain_combine(op: Callable, v: torch.Tensor
                  ) -> Tuple[Callable, torch.dtype]:
    """The combine the plain ladder applies to values like *v* (``[N]``
    or ``[N, D]``), and the dtype it reduces them in: :func:`evaluate`
    of *op*'s IR where *op* lowers for them (XLA's rules where torch's
    CPU raises or leaves a value open, so the rows a run's result never
    reads cannot raise, and the kernel's), else *op* itself over the
    dtype it returns on two rows of ones (the port's ``jax.eval_shape``
    probe)."""
    try:
        ir = lower(op, v.dtype)
    except (NotImplementedError, ValueError):
        ir = None
    if ir is not None and (ir.lanes is None or tuple(v.shape[1:]) == (
            ir.lanes,)):
        return (lambda a, b: evaluate(ir, a, b)), torch_dtype(ir)
    probe = torch.ones((2,) + tuple(v.shape[1:]), dtype=v.dtype)
    return op, op(probe, probe).dtype


def torch_dtype(ir: MonoidIR) -> torch.dtype:
    """The lanes' torch dtype of *ir*'s kernel."""
    return _DTYPES[ir.dtype]


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

def fmin(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``jnp.minimum`` of float lanes: NaN propagates and -0.0 is below
    +0.0 (``torch.minimum`` leaves the tie of -0.0 and +0.0 open)."""
    return torch.where((a < b) | ((a == b) & torch.signbit(a))
                       | torch.isnan(a), a, b)


def fmax(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``jnp.maximum`` of float lanes: NaN propagates, +0.0 above -0.0."""
    return torch.where((a > b) | ((a == b) & ~torch.signbit(a))
                       | torch.isnan(a), a, b)


def _tdiv(a, b):
    """``lax.div`` of int32: truncating, ``x / 0`` is -1, ``INT32_MIN /
    -1`` wraps (never a trap)."""
    safe = torch.where((b == 0) | (b == -1), 1, b)
    q = torch.where(b == -1, -a, torch.div(a, safe, rounding_mode="trunc"))
    return torch.where(b == 0, -1, q)


def _trem(a, b):
    """``lax.rem`` of int32: the dividend's sign, ``x % 0`` is x."""
    safe = torch.where((b == 0) | (b == -1), 1, b)
    return torch.where(b == 0, a, torch.where(b == -1, 0,
                                              torch.fmod(a, safe)))


def _floordiv(a, b):
    """``jnp.floor_divide`` of int32."""
    down = (torch.sign(a) != torch.sign(b)) & (_trem(a, b) != 0)
    return _tdiv(a, b) - down.to(torch.int32)


def _mod(a, b):
    """``jnp.remainder`` of int32: the divisor's sign, ``x % 0`` is 0."""
    b = torch.where(b == 0, 1, b)
    r = _trem(a, b)
    fix = (r != 0) & (torch.sign(r) != torch.sign(b))
    return torch.where(fix, r + b, r)


def _fmod(a, b):
    """``jnp.fmod`` of int32: the dividend's sign, ``fmod(x, 0)`` is 0."""
    return _trem(a, torch.where(b == 0, 1, b))


def _toi(x):
    """float32 -> int32 as XLA converts: truncated, saturated, NaN 0."""
    t = torch.trunc(x)
    hi, lo = t >= 2.0 ** 31, t < -2.0 ** 31
    safe = torch.where(hi | lo | torch.isnan(t), 0.0, t).to(torch.int32)
    return torch.where(hi, _INT32_MAX, torch.where(lo, _INT32_MIN, safe))


_TORCH_BINARY = {
    "add": operator.add, "sub": operator.sub, "mul": operator.mul,
    "and": operator.and_, "or": operator.or_, "xor": operator.xor,
    "lt": operator.lt, "le": operator.le, "gt": operator.gt,
    "ge": operator.ge, "eq": operator.eq, "ne": operator.ne,
    "div": operator.truediv, "floordiv": _floordiv, "mod": _mod,
    "tdiv": _tdiv, "fmod": _fmod,
}
def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded float32 square root (IEEE's, the kernel's
    ``__fsqrt_rn``): through float64, whose root rounds to float32
    exactly (53 >= 2 * 24 + 2 bits), since torch's CPU ``sqrt`` is 1 ulp
    off it on some inputs."""
    return x.double().sqrt().float()


_TORCH_UNARY = {"neg": operator.neg, "not": operator.invert,
                "abs": torch.abs, "exp": torch.exp, "log": torch.log,
                "sqrt": sqrt_rn, "toi": lambda x: (
                    x.to(torch.int32) if x.dtype == torch.bool else _toi(x)),
                "tof": lambda x: x.to(torch.float32)}


def evaluate(ir: MonoidIR, a: torch.Tensor, b: torch.Tensor
             ) -> torch.Tensor:
    """``op(a, b)`` from the IR, in plain PyTorch (*a*, *b* cast to the
    IR's dtype first): ``[..., D]`` values for a D-lane monoid, any
    shape for a lane-wise one."""
    a, b = a.to(torch_dtype(ir)), b.to(torch_dtype(ir))
    v: List[object] = []
    for n, typ in zip(ir.nodes, ir.types):
        k = n[0]
        if k == "in":
            x = (a, b)[n[1]]
            v.append(x if ir.lanes is None else x[..., n[2]])
        elif k == "const":
            v.append(n[1])
        elif k == "fconst":
            v.append(_f32_value(n[1]))
        elif k in _TORCH_UNARY:
            v.append(_TORCH_UNARY[k](v[n[1]]))
        elif k == "shl":
            v.append(v[n[1]] << n[2])
        elif k == "shr":
            v.append(v[n[1]] >> n[2])
        elif k == "where":
            v.append(torch.where(v[n[1]], v[n[2]], v[n[3]]))
        else:
            x, y = v[n[1]], v[n[2]]
            like = x if isinstance(x, torch.Tensor) else y
            # a constant operand as a tensor of the node's operand type
            x, y = [t if isinstance(t, torch.Tensor)
                    else torch.full_like(like, t) for t in (x, y)]
            if k in _MINMAX:
                fn = ((fmin if k == "min" else fmax) if typ == "f" else
                      (torch.minimum if k == "min" else torch.maximum))
                v.append(fn(x, y))
            else:
                v.append(_TORCH_BINARY[k](x, y))
    outs = [v[o] for o in ir.out]
    return outs[0] if ir.lanes is None else torch.stack(outs, dim=-1)


# -- the key and the C++ ---------------------------------------------------------

def ir_hash(ir: MonoidIR) -> str:
    """The canonical key of *ir*: a sha256 of its lane type, lanes,
    nodes, node types and results (not of the callable's name)."""
    doc = json.dumps([ir.dtype, ir.lanes, [list(n) for n in ir.nodes],
                      list(ir.types), list(ir.out)], separators=(",", ":"))
    return hashlib.sha256(doc.encode()).hexdigest()


def _lit(v: int) -> str:
    return f"static_cast<int32_t>(0x{v & 0xFFFFFFFF:08x}u)"


_CXX_TYPES = {"i": "int32_t", "f": "float", "b": "bool"}
_CXX_BINARY = {"and": "&", "or": "|", "xor": "^", "lt": "<", "le": "<=",
               "gt": ">", "ge": ">=", "eq": "==", "ne": "!="}
_CXX_WRAP = {"add": "+", "sub": "-", "mul": "*"}
#: float32 arithmetic as the correctly rounded intrinsics (never
#: contracted into a fused multiply-add)
_CXX_FLOAT = {"add": "__fadd_rn", "sub": "__fsub_rn", "mul": "__fmul_rn",
              "div": "__fdiv_rn", "min": "mr_fmin", "max": "mr_fmax"}
#: int32 division with XLA's rules (csrc/segreduce.cuh)
_CXX_INTDIV = {"floordiv": "mr_floordiv", "mod": "mr_mod",
               "tdiv": "mr_tdiv", "fmod": "mr_fmod"}
_CXX_FLOATFN = {"exp": "expf", "log": "logf", "sqrt": "__fsqrt_rn"}


def _cxx(n: tuple, typ: str, types, idx: Optional[str]) -> str:
    """The C++ expression of node *n* of type *typ*."""
    k = n[0]
    if k == "in":
        return f"{'ab'[n[1]]}[{idx if idx is not None else n[2]}]"
    if k == "const":
        return _lit(n[1])
    if k == "fconst":
        return f"__uint_as_float(0x{n[1]:08x}u)"
    x = f"t{n[1]}" if len(n) > 1 else None
    src = types[n[1]] if len(n) > 1 and k not in ("shl", "shr") else None
    if k == "tof":
        return (f"({x} ? 1.0f : 0.0f)" if src == "b"
                else f"__int2float_rn({x})")
    if k == "toi":
        # XLA's conversion: truncated, saturated, NaN to 0 (cvt.rzi)
        return (f"static_cast<int32_t>({x})" if src == "b"
                else f"__float2int_rz({x})")
    if k == "neg":
        return (f"-{x}" if typ == "f"
                else f"static_cast<int32_t>(0u - static_cast<uint32_t>({x}))")
    if k == "abs":
        return f"fabsf({x})" if typ == "f" else f"mr_iabs({x})"
    if k == "not":
        return f"!{x}" if typ == "b" else f"~{x}"
    if k in _CXX_FLOATFN:
        return f"{_CXX_FLOATFN[k]}({x})"
    if k == "shl":
        return f"static_cast<int32_t>(static_cast<uint32_t>({x}) << {n[2]})"
    if k == "shr":
        return f"{x} >> {n[2]}"
    if k == "where":
        return f"t{n[1]} ? t{n[2]} : t{n[3]}"
    y = f"t{n[2]}"
    if k in _CXX_INTDIV:
        return f"{_CXX_INTDIV[k]}({x}, {y})"
    if src == "f" and k in _CXX_FLOAT:
        return f"{_CXX_FLOAT[k]}({x}, {y})"
    if k in _CXX_WRAP:
        return (f"static_cast<int32_t>(static_cast<uint32_t>({x}) "
                f"{_CXX_WRAP[k]} static_cast<uint32_t>({y}))")
    if k in _MINMAX:
        return f"{k}({x}, {y})"
    if typ == "b" and k in _BITWISE:
        return f"static_cast<bool>({x} {_CXX_BINARY[k]} {y})"
    return f"{x} {_CXX_BINARY[k]} {y}"


def emit_cuda(ir: MonoidIR) -> str:
    """The C++ text of the combine: a struct ``MrUserCombine`` with the
    lanes' type ``T`` (``int32_t`` or ``float``), ``kLanes`` (0:
    lane-wise) and ``template <int D> apply(a, b, o)`` over ``T[D]``.
    int32 ``+ - *`` and unary ``-`` go through ``uint32_t`` (signed
    overflow is undefined in C++ and wraps in torch and XLA); ``>>`` on
    ``int32_t`` is arithmetic, as torch's; float32 arithmetic uses the
    ``_rn`` intrinsics."""
    idx = "d" if ir.lanes is None else None
    body = [f"const {_CXX_TYPES[t]} t{i} = {_cxx(n, t, ir.types, idx)};"
            for i, (n, t) in enumerate(zip(ir.nodes, ir.types))]
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
    cty = _CXX_TYPES[ir.dtype]
    return (f"// user monoid {ir_hash(ir)[:16]} ({kind}, {cty})\n"
            "struct MrUserCombine {\n"
            f"  using T = {cty};\n"
            f"  static constexpr int kLanes = {ir.lanes or 0};\n"
            "  template <int D>\n"
            "  static __device__ __forceinline__ void apply(\n"
            "      const T* a, const T* b, T* o) {\n"
            f"{text}\n"
            "  }\n"
            "};\n")
