"""Column expressions: a small analyzable AST for the lazy query planner.

Counterpart of ``radix_sort_tpu/expr.py``: the same tree, the same
``columns`` / ``rename`` / ``repr`` and the same NULL semantics, evaluated
with torch tensor ops on the table's device.

``col("v") * 2 > col("lo")`` builds an :class:`Expr` tree instead of
computing anything. The tree knows two things a raw lambda cannot tell us:

  - ``columns``: exactly which columns it reads, which is what makes
    projection pruning through the logical plan (``plan.py``) possible
    (every relational operator is one sort whose cost is proportional to
    the number of operand words it carries);
  - ``evaluate(table)``: how to compute it, elementwise tensor ops over the
    named columns.

The surface is deliberately closed (literals, columns, arithmetic,
comparisons, boolean algebra, ``where``, ``cast``, scalar math
(``abs/floor/ceil/round/sign/sqrt/exp/log*/pow``), ``like`` and the string
functions over string columns, date functions, NULL handling (``is_null`` /
``coalesce`` / ``nullif`` / the ``null()`` literal), and an explicit ``udf``
escape hatch that still declares its column reads) so every node stays
analyzable and printable by ``LazyTable.explain()``.

NULL semantics (nulls.py): every node evaluates through
:meth:`Expr.evaluate_masked`, returning ``(values, null_mask_or_None)``.
Arithmetic, comparisons and scalar functions are null-propagating (any NULL
operand makes the result NULL, the SQL rule); ``&`` and ``|`` follow Kleene
three-valued logic (``TRUE OR NULL`` is TRUE, ``FALSE AND NULL`` is FALSE);
``where``/CASE treats a NULL condition as false (SQL CASE).
``Table.filter`` keeps a row only when the predicate is known TRUE. Masked
values are canonicalized to 0 for boolean results.

Result dtypes follow the JAX package's rules with 64-bit types enabled, not
torch's: a Python ``int`` or ``float`` literal is *weak* (it takes the
column's type when the kinds agree: ``int32 * 2`` is int32, ``float32 *
2.5`` is float32, but ``int32 * 2.5`` is float64), a numpy scalar is
*strong* (``float32 * np.float64(2)`` is float64), two columns promote on
JAX's lattice (``uint32`` with ``int32`` is int64, ``uint64`` with any
signed type float64), and ``/`` and the transcendental functions give
float32 for integer types up to 32 bits and float64 for 64-bit ones.
Unsigned arithmetic runs on widened or signed views (torch has no unsigned
arithmetic kernels) and wraps as the unsigned type does. Float ``//``,
``%``, ``min``, ``max`` and ``sign`` follow the reference bit for bit
(signed zeros and NaN included). Literals become Python scalars or 0-dim
tensors made on the table's device: no node copies from the host or waits
for the device, except the host vocabulary lookups of string nodes.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["Expr", "col", "lit", "where", "udf", "coalesce", "nullif",
           "null", "concat"]

# binary op name -> (callable on Python / numpy scalars, printable symbol);
# min, max and pow have no Python operator and always take the tensor path
_BINOPS = {
    "add": (lambda a, b: a + b, "+"),
    "sub": (lambda a, b: a - b, "-"),
    "mul": (lambda a, b: a * b, "*"),
    "truediv": (lambda a, b: a / b, "/"),
    "floordiv": (lambda a, b: a // b, "//"),
    "mod": (lambda a, b: a % b, "%"),
    "eq": (lambda a, b: a == b, "=="),
    "ne": (lambda a, b: a != b, "!="),
    "lt": (lambda a, b: a < b, "<"),
    "le": (lambda a, b: a <= b, "<="),
    "gt": (lambda a, b: a > b, ">"),
    "ge": (lambda a, b: a >= b, ">="),
    "and": (lambda a, b: a & b, "&"),
    "or": (lambda a, b: a | b, "|"),
    "xor": (lambda a, b: a ^ b, "^"),
    "lshift": (lambda a, b: a << b, "<<"),
    "rshift": (lambda a, b: a >> b, ">>"),
    "min": (None, "min"),
    "max": (None, "max"),
    "pow": (None, "pow"),
}

# unary op name -> printable symbol (evaluation: _unop)
_UNOPS = {
    "neg": "-",
    "invert": "~",
    "abs": "abs",
    "floor": "floor",
    "ceil": "ceil",
    # round-half-to-even (IEEE default), like np.round; SQL dialects vary
    "round": "round",
    "sign": "sign",
    "sqrt": "sqrt",
    "exp": "exp",
    "log": "log",
    "log10": "log10",
    "log2": "log2",
}
_INEXACT_UNOPS = ("sqrt", "exp", "log", "log10", "log2")

# ---------------------------------------------------------------------------
# dtypes: the JAX package's promotion rules (64-bit types enabled)
# ---------------------------------------------------------------------------

_UNSIGNED = (torch.uint8, torch.uint16, torch.uint32, torch.uint64)
_SIGNED_OF_BITS = {8: torch.int8, 16: torch.int16, 32: torch.int32, 64: torch.int64}
_SIGNED_VIEW = {torch.uint16: torch.int16, torch.uint32: torch.int32,
                torch.uint64: torch.int64}
_COMPARES = frozenset(("eq", "ne", "lt", "le", "gt", "ge"))
# mirrored comparison for swapping operand order: lit OP col == col OP' lit
_MIRROR = {"eq": "eq", "ne": "ne", "lt": "gt", "le": "ge",
           "gt": "lt", "ge": "le"}


def torch_dtype(dt) -> torch.dtype:
    """A numpy dtype (or anything ``np.dtype`` takes) as a torch dtype."""
    if isinstance(dt, torch.dtype):
        return dt
    return torch.from_numpy(np.empty(0, np.dtype(dt))).dtype


def promote_types(a: torch.dtype, b: torch.dtype) -> torch.dtype:
    """JAX's ``promote_types`` on torch dtypes: bool is the bottom; signed
    and unsigned integers join at the signed type twice the unsigned width
    (``uint64`` with a signed type gives float64); an integer with a float
    gives the float; float16 with bfloat16 gives float32."""
    if a == b:
        return a
    if a == torch.bool:
        return b
    if b == torch.bool:
        return a
    fa, fb = a.is_floating_point, b.is_floating_point
    if fa and fb:
        if {a, b} == {torch.float16, torch.bfloat16}:
            return torch.float32
        return a if a.itemsize >= b.itemsize else b
    if fa or fb:
        return a if fa else b
    ua, ub = a in _UNSIGNED, b in _UNSIGNED
    if ua == ub:
        return a if a.itemsize >= b.itemsize else b
    u, s = (a, b) if ua else (b, a)
    if u == torch.uint64:
        return torch.float64
    return _SIGNED_OF_BITS[8 * max(2 * u.itemsize, s.itemsize)]


def _inexact(dt: torch.dtype) -> torch.dtype:
    """The float type ``/`` and ``sqrt``-like functions compute in."""
    if dt.is_floating_point:
        return dt
    return torch.float64 if dt.itemsize == 8 else torch.float32


def _jtype(v, weak=False):
    """``(dtype, weak)`` of an operand: a tensor's own dtype (``weak`` as
    tracked), a numpy scalar's (strong), a Python bool (strong bool), a
    Python int or float (weak int64 / float64)."""
    if torch.is_tensor(v):
        return v.dtype, weak
    if isinstance(v, (np.generic, np.ndarray)):
        return torch_dtype(v.dtype), False
    if isinstance(v, bool):
        return torch.bool, False
    if isinstance(v, int):
        return torch.int64, True
    if isinstance(v, float):
        return torch.float64, True
    raise TypeError(f"unsupported expression operand {v!r}")


def result_type(*typed):
    """JAX's result type of ``(dtype, weak)`` operands -> ``(dtype, weak)``.
    Weak operands take the strong operands' type when the kinds agree; a
    weak float with an integer or bool gives a weak float64, a weak int with
    a bool a weak int64."""
    strong = [d for d, w in typed if not w]
    weak = [d for d, w in typed if w]
    if not strong:
        return (torch.float64 if any(d.is_floating_point for d in weak)
                else torch.int64), True
    s = strong[0]
    for d in strong[1:]:
        s = promote_types(s, d)
    if not weak:
        return s, False
    if any(d.is_floating_point for d in weak):
        return (s, False) if s.is_floating_point else (torch.float64, True)
    return (torch.int64, True) if s == torch.bool else (s, False)


def _is_value(v):
    """True for a tensor or numpy array operand (not a scalar)."""
    return torch.is_tensor(v) or (isinstance(v, np.ndarray) and v.ndim > 0)


def _device_of(table):
    return getattr(table, "device", None) or torch.device("cpu")


def _host_to(a: np.ndarray, dev) -> torch.Tensor:
    """A host array on ``dev`` (pinned and asynchronous on a GPU);
    unsigned arrays move as their signed view."""
    a = np.ascontiguousarray(a)
    if a.dtype.kind == "u" and a.dtype.itemsize > 1:
        t = torch.from_numpy(a.view(f"i{a.dtype.itemsize}"))
        dt = torch_dtype(a.dtype)
    else:
        t, dt = torch.from_numpy(a), None
    dev = torch.device(dev)
    if dev.type == "cuda":
        t = t.pin_memory().to(dev, non_blocking=True)
    else:
        t = t.to(dev)
    return t if dt is None else t.view(dt)


def _gather(host: np.ndarray, codes, dev) -> torch.Tensor:
    """``host[codes]`` on the device for a host lookup table and uint32
    code(s); unsigned tables gather as their signed view."""
    t = _host_to(host, dev)
    idx = codes.view(torch.int32) if codes.dtype == torch.uint32 else codes
    sdt = _SIGNED_VIEW.get(t.dtype)
    if sdt is None:
        return t[idx]
    return t.view(sdt)[idx].view(t.dtype)


def _full(value, dt, dev) -> torch.Tensor:
    """A 0-dim tensor of ``dt`` on ``dev`` holding the Python scalar
    ``value`` (already in ``dt``'s range; unsigned through the signed
    view). A fill kernel, not a copy from the host."""
    sdt = _SIGNED_VIEW.get(dt)
    if sdt is None:
        return torch.full((), value, dtype=dt, device=dev)
    return torch.full((), _wrap_int(value, sdt), dtype=sdt, device=dev).view(dt)


def _wrap_int(value, dt):
    """Python int ``value`` wrapped into integer type ``dt``'s range."""
    bits = 8 * dt.itemsize
    v = int(value) & ((1 << bits) - 1)
    if dt not in _UNSIGNED and v >> (bits - 1):
        v -= 1 << bits
    return v


def _scalar_in(value, dt):
    """A Python or numpy scalar converted to ``dt`` (as JAX converts it) and
    returned as a Python scalar that ``dt`` holds exactly."""
    if dt == torch.bool:
        return bool(value)
    if dt.is_floating_point:
        return float(torch.tensor(float(value), dtype=dt))
    return _wrap_int(value, dt)


def _as_tensor(v, dt, dev) -> torch.Tensor:
    """An operand converted to dtype ``dt`` as a tensor (scalars become
    0-dim tensors on ``dev``; numpy arrays are copied there)."""
    if torch.is_tensor(v):
        return v if v.dtype == dt else v.to(dt)
    if isinstance(v, np.ndarray) and v.ndim > 0:
        return _host_to(v, dev).to(dt)
    return _full(_scalar_in(v, dt), dt, dev)


# ---- the work representation: unsigned types as signed tensors -----------
#
# uint8/16/32 widen to int64 (every result is then exact or wraps mod 2^64,
# whose low bits are the unsigned type's); uint64 works on its int64 view,
# where +, -, *, ~, &, |, ^ and << are the same bits, and comparisons,
# min/max, >>, // and % are rebuilt below. Scalars stay Python ints.


def _to_work(v, dt):
    if dt not in _UNSIGNED:
        return v
    if not torch.is_tensor(v):
        return _wrap_int(v, torch.int64) if dt == torch.uint64 else int(v)
    if dt == torch.uint64:
        return v.view(torch.int64)
    if dt == torch.uint8:
        return v.to(torch.int64)
    return v.view(_SIGNED_VIEW[dt]).to(torch.int64) & ((1 << (8 * dt.itemsize)) - 1)


def _from_work(v, dt):
    """Work values back to unsigned ``dt``, wrapping (signed conversions and
    views only)."""
    if dt not in _UNSIGNED or not torch.is_tensor(v):
        return v
    if dt == torch.uint64:
        return v.view(torch.uint64)
    if dt == torch.uint8:
        return v.to(torch.uint8)
    return v.to(_SIGNED_VIEW[dt]).view(dt)


def _t(v, like):
    """A scalar operand as a 0-dim tensor beside tensor ``like``."""
    if torch.is_tensor(v):
        return v
    return torch.full((), v, dtype=like.dtype, device=like.device)


def _pair(a, b):
    """Both operands as tensors of one dtype (at least one is a tensor)."""
    like = a if torch.is_tensor(a) else b
    return _t(a, like), _t(b, like)


_I64_MIN = -(1 << 63)


def _u64_key(x):
    """An int64 view of uint64 values whose signed order is the unsigned
    order."""
    return x ^ _I64_MIN


def _u64_rshift(a, s):
    """Logical right shift of int64-viewed uint64 values."""
    a, s = _pair(a, s)
    s1 = torch.clamp(s - 1, min=0)
    shifted = ((a >> 1) & ~_I64_MIN) >> s1
    return torch.where(s == 0, a, shifted)


def _u64_divmod(a, b):
    """Unsigned 64-bit ``(a // b, a % b)`` on int64 views: halve the
    dividend so the signed division is exact, then fix the quotient up by
    one; divisors of 2^63 and above give a quotient of 0 or 1."""
    a, b = _pair(a, b)
    q = torch.div(_u64_rshift(a, 1), b, rounding_mode="trunc") << 1
    r = a - q * b
    fix = _u64_key(r) >= _u64_key(b)
    q = q + fix.to(torch.int64)
    r = torch.where(fix, r - b, r)
    big = b < 0  # divisor >= 2^63
    ge = _u64_key(a) >= _u64_key(b)
    q = torch.where(big, ge.to(torch.int64), q)
    r = torch.where(big, torch.where(ge, a - b, a), r)
    return q, r


def _round_away(x):
    """Round half away from zero (C ``round``; XLA's default rounding)."""
    r = torch.trunc(x)
    frac = torch.abs(x - r)
    return torch.where(frac >= 0.5, r + torch.sign(x), r)


def _float_divmod(a, b):
    """The JAX package's float floor division and remainder: ``fmod``, then
    adjust toward the divisor's sign (NaN for a zero divisor, the sign of
    zero kept)."""
    a, b = _pair(a, b)
    mod = torch.fmod(a, b)
    div = (a - mod) / b
    ind = (mod != 0) & (torch.sign(b) != torch.sign(mod))
    mod = torch.where(ind, mod + b, mod)
    div = torch.where(ind, div - 1, div)
    return _round_away(div), mod


def _float_minmax(op, a, b):
    """``jnp.minimum`` / ``jnp.maximum``: NaN propagates, and -0.0 is below
    +0.0."""
    a, b = _pair(a, b)
    if op == "min":
        pick_a = (a < b) | ((a == b) & torch.signbit(a))
    else:
        pick_a = (a > b) | ((a == b) & ~torch.signbit(a))
    out = torch.where(pick_a, a, b)
    nan = torch.isnan(a) | torch.isnan(b)
    return torch.where(nan, a + b, out)


def _compare(op, a, b, dt):
    """``a op b`` for operands already in ``dt``: unsigned types of 16 bits
    and more compare as signed views (with the sign bit flipped for an
    ordering), bools as int8."""
    sdt = _SIGNED_VIEW.get(dt)
    if sdt is not None:
        flip = 0 if op in ("eq", "ne") else -(1 << (8 * dt.itemsize - 1))

        def key(x):
            return (x.view(sdt) if torch.is_tensor(x) else _wrap_int(x, sdt)) ^ flip

        a, b = key(a), key(b)
    elif dt == torch.bool and op not in ("eq", "ne"):
        a, b = _pair(a, b)
        a, b = a.to(torch.int8), b.to(torch.int8)
    return _BINOPS[op][0](a, b)


def _arith_work(op, a, b, dt):
    """``a op b`` on work values of result type ``dt``."""
    if dt == torch.bool:
        if op in ("add", "or", "max"):
            return a | b
        if op in ("mul", "and", "min"):
            return a & b
        if op == "xor":
            return a ^ b
        raise TypeError(f"operator {op!r} is not defined on bool operands")
    if dt.is_floating_point:
        if op in ("and", "or", "xor", "lshift", "rshift"):
            raise TypeError(f"operator {op!r} is not defined on {dt}")
        if op == "floordiv":
            return _float_divmod(a, b)[0]
        if op == "mod":
            return _float_divmod(a, b)[1]
        if op in ("min", "max"):
            return _float_minmax(op, a, b)
        if op in ("pow", "truediv"):
            # a 0-dim device tensor, not a Python scalar: CUDA divides by a
            # scalar as a multiply by its reciprocal, which rounds twice
            a, b = _pair(a, b)
            return torch.pow(a, b) if op == "pow" else a / b
        return _BINOPS[op][0](a, b)
    if dt == torch.uint64:
        if op in ("floordiv", "mod"):
            a, b = _pair(a, b)
            b = torch.where(b == 0, 1, b)  # undefined in the reference; no trap
            return _u64_divmod(a, b)[0 if op == "floordiv" else 1]
        if op == "rshift":
            return _u64_rshift(a, b)
        if op in ("min", "max"):
            a, b = _pair(a, b)
            lt = _u64_key(a) < _u64_key(b)
            return torch.where(lt if op == "min" else ~lt, a, b)
    if op in ("floordiv", "mod"):
        a, b = _pair(a, b)
        b = torch.where(b == 0, 1, b)  # undefined in the reference; no trap
        if op == "mod":
            return torch.remainder(a, b)
        return torch.div(a, b, rounding_mode="floor")
    if op == "min":
        return torch.minimum(*_pair(a, b))
    if op == "max":
        return torch.maximum(*_pair(a, b))
    if op == "pow":
        return torch.pow(*_pair(a, b))
    return _BINOPS[op][0](a, b)


def _binop(op, a, wa, b, wb, dev):
    """``a op b`` under the JAX package's semantics -> ``(value, weak)``.

    Two Python / numpy scalars compute as the reference does (Python's own
    operators). Otherwise both operands convert to the JAX result type and
    the op runs on tensors; scalars stay Python numbers in that type."""
    if not _is_value(a) and not _is_value(b) and _BINOPS[op][0] is not None:
        v = _BINOPS[op][0](a, b)
        return v, _jtype(v)[1] if not torch.is_tensor(v) else False
    (da, wa), (db, wb) = _jtype(a, wa), _jtype(b, wb)
    dt, weak = result_type((da, wa), (db, wb))
    if op == "truediv":
        dt = _inexact(dt)
    if not _is_value(a) and not _is_value(b):
        a = _as_tensor(a, dt, dev)  # min/max/pow of two scalars
    a = _as_tensor(a, dt, dev) if _is_value(a) else _scalar_in(a, dt)
    b = _as_tensor(b, dt, dev) if _is_value(b) else _scalar_in(b, dt)
    if op in _COMPARES:
        return _compare(op, a, b, dt), False
    return _from_work(_arith_work(op, _to_work(a, dt), _to_work(b, dt), dt), dt), weak


def _unop(op, a, weak, dev):
    """``op(a)`` under the JAX package's semantics -> ``(value, weak)``."""
    if op in ("neg", "invert") and not _is_value(a):
        v = -a if op == "neg" else ~a  # Python's operators, as the reference
        return v, _jtype(v)[1]
    dt, weak = _jtype(a, weak)
    a = _as_tensor(a, dt, dev)
    if op in _INEXACT_UNOPS:
        x = a.to(_inexact(dt))
        if op == "sqrt" and x.device.type == "cpu" and x.dtype in (torch.float32,
                                                                   torch.float64):
            # correctly rounded, as XLA's and CUDA's are; torch's vectorized
            # CPU sqrt can be 1 ULP off (float64 0.5)
            with np.errstate(invalid="ignore"):  # sqrt(-1) is NaN, as on the card
                return torch.from_numpy(np.sqrt(x.numpy())), weak
        return getattr(torch, op)(x), weak
    if op == "invert":
        if dt == torch.bool:
            return ~a, weak
        sdt = _SIGNED_VIEW.get(dt)
        return (~a if sdt is None else (~a.view(sdt)).view(dt)), weak
    if op == "neg":
        return _from_work(-_to_work(a, dt), dt), weak
    if dt.is_floating_point:
        if op == "sign":
            one = torch.ones((), dtype=dt, device=a.device)
            return torch.where(a > 0, one, torch.where(a < 0, -one, a)), weak
        return getattr(torch, op)(a), weak
    if dt == torch.bool:
        raise TypeError(f"{op} is not defined on bool operands")
    if op in ("floor", "ceil", "round"):
        return a.clone(), weak
    if dt in _UNSIGNED:
        if op == "abs":
            return a.clone(), weak
        return _from_work(_compare("ne", a, 0, dt).to(torch.int64), dt), weak
    return getattr(torch, op)(a), weak


def _where_typed(cond, a, wa, b, wb, dev):
    """``jnp.where(cond, a, b)`` -> ``(value, weak)`` in the JAX result type
    of ``a`` and ``b``; unsigned values select through their signed view."""
    dt, weak = result_type(_jtype(a, wa), _jtype(b, wb))
    a = _as_tensor(a, dt, dev)
    b = _as_tensor(b, dt, dev)
    cond = _bool_tensor(cond, dev)
    sdt = _SIGNED_VIEW.get(dt)
    if sdt is None:
        return torch.where(cond, a, b), weak
    return torch.where(cond, a.view(sdt), b.view(sdt)).view(dt), weak


def _bool_tensor(v, dev):
    """A condition or mask as a bool tensor (Python bools as 0-dim)."""
    if torch.is_tensor(v):
        return v if v.dtype == torch.bool else v != 0
    return torch.full((), bool(v), dtype=torch.bool, device=dev)


def _zero_like(v):
    """A zero of ``v``'s dtype (a weak Python 0 for a Python scalar)."""
    if torch.is_tensor(v):
        return _full(0, v.dtype, v.device)
    if isinstance(v, (np.generic, np.ndarray)):
        return np.zeros((), v.dtype)[()]
    return 0


def _u32(value, dev):
    return _full(int(value), torch.uint32, dev)


def _shape(v):
    return tuple(v.shape) if torch.is_tensor(v) or isinstance(v, np.ndarray) else ()


# ---------------------------------------------------------------------------
# the expression tree
# ---------------------------------------------------------------------------


class Expr:
    """One node of a column-expression tree.

    ``kind`` is one of ``col | lit | bin | un | cast | where | udf`` (and the
    NULL, string and date kinds); ``args`` holds the operands (child
    ``Expr`` nodes and/or Python values). Build trees with :func:`col` /
    :func:`lit` and operators; never construct nodes directly.
    """

    __slots__ = ("kind", "args")

    def __init__(self, kind, args):
        self.kind = kind
        self.args = tuple(args)

    # -- analysis ---------------------------------------------------------

    @property
    def columns(self) -> frozenset:
        """Names of every column this expression reads."""
        if self.kind == "col":
            return frozenset((self.args[0],))
        if self.kind == "lit":
            return frozenset()
        if self.kind == "udf":
            return frozenset(self.args[2])
        out = frozenset()
        for a in self.args:
            if isinstance(a, Expr):
                out |= a.columns
        return out

    def rename(self, mapping) -> "Expr":
        """The same expression reading renamed columns (for pushing filters
        through ``rename`` nodes)."""
        if self.kind == "col":
            return Expr("col", (mapping.get(self.args[0], self.args[0]),))
        if self.kind == "lit":
            return self
        if self.kind == "udf":
            fn, label, cols = self.args
            return Expr("udf", (fn, label,
                                tuple(mapping.get(c, c) for c in cols)))
        return Expr(
            self.kind,
            tuple(a.rename(mapping) if isinstance(a, Expr) else a
                  for a in self.args),
        )

    # -- evaluation -------------------------------------------------------

    def evaluate(self, table):
        """Compute against anything supporting ``table[name]``. NULL masks
        are dropped; use :meth:`evaluate_masked` to keep them."""
        return self.evaluate_masked(table)[0]

    def evaluate_masked(self, table):
        """Compute ``(values, null_mask)``: the mask is a bool tensor (True =
        NULL) or None when no operand is nullable. Values are canonicalized
        to 0 under the mask for boolean results; other dtypes may carry
        garbage under masked slots (the mask is the truth; consumers must
        honor it). Values are tensors on the table's device, or Python /
        numpy scalars where every operand was one."""
        v, m, _ = self._eval(table)
        return v, m

    def _eval(self, table):
        """``(values, mask, weak)``: ``weak`` marks a value whose dtype is
        still a Python literal's (see ``result_type``)."""
        k = self.kind
        dev = _device_of(table)
        if k == "col":
            name = self.args[0]
            getm = getattr(table, "null_mask", None)
            return table[name], (getm(name) if getm is not None else None), False
        if k == "lit":
            v = self.args[0]
            if isinstance(v, np.ndarray) and v.ndim > 0:
                v = _host_to(v, dev)
            elif isinstance(v, np.ndarray):
                v = v[()]
            return v, None, _jtype(v)[1] if not torch.is_tensor(v) else False
        if k == "nulllit":
            # a typeless NULL scalar: canonical value False (a 0-dim bool
            # tensor: acts as 0 in arithmetic, stays bool through Kleene
            # and/or) and mask True (a tensor, not a Python bool: `~True` is
            # -2 and would poison downstream logic)
            return (torch.zeros((), dtype=torch.bool, device=dev),
                    torch.ones((), dtype=torch.bool, device=dev), False)
        if k == "bin":
            op, a, b = self.args
            if op not in _COMPARES:
                _reject_string_arith(op, (a, b), table)
            elif (_is_string_valued(a, table) or _is_string_valued(b, table)
                  or _is_str_lit(a) or _is_str_lit(b)):
                v, m = _string_compare(op, a, b, table)
                return v, m, False
            # evaluate each child exactly once, values and mask together (a
            # mask re-walk would make deep chains O(2^depth))
            av, am, aw = _ev(a, table)
            bv, bm, bw = _ev(b, table)
            if op in ("and", "or"):
                return _kleene(op, av, am, aw, bv, bm, bw, dev)
            m = _mor(am, bm)
            v, w = _binop(op, av, aw, bv, bw, dev)
            if m is not None:
                # v can be a Python scalar (two literal operands)
                if not torch.is_tensor(v):
                    v = _as_tensor(v, _jtype(v)[0], dev)
                if v.dtype == torch.bool:
                    v = v & ~m
            return v, m, w
        if k == "un":
            op, a = self.args
            _reject_string_arith(op, (a,), table)
            av, am, aw = _ev(a, table)
            v, w = _unop(op, av, aw, dev)
            if am is not None and op == "invert" and torch.is_tensor(v) \
                    and v.dtype == torch.bool:
                v = v & ~am
            return v, am, w
        if k == "cast":
            a, dt = self.args
            tdt = torch_dtype(dt)
            if _is_string_valued(a, table):
                # parse the (small, host-side) vocabulary once, gather by
                # code; unparseable values come back NULL (TRY_CAST
                # semantics: a strict error would have to fire even for
                # vocabulary entries no row references)
                codes, vals, m = _ev_str_chain(a, table)
                parsed, bad = _parse_vocab(vals, dt)
                v = _gather(parsed, codes, dev)
                m = _mor(m, _gather(bad, codes, dev))
                return _where_typed(m, _zero_like(v), False, v, False, dev)[0], m, False
            av, am, _ = _ev(a, table)
            return _as_tensor(av, tdt, dev), am, False
        if k in ("strfn", "concat"):
            codes, _vocab, m = self.string_result(table)
            return codes, m, False
        if k in ("strnum", "strbool"):
            fname, child, params = self.args
            sub = _ev_str_chain(child, table)
            if sub is None:
                raise TypeError(
                    f"{fname.upper()} needs a string-valued argument (a "
                    f"string column or string expression), got {child!r}"
                )
            codes, vals, m = sub
            fns = _S().STR_NUM_FNS if k == "strnum" else _S().STR_BOOL_FNS
            v = _gather(np.asarray(fns[fname](vals, *params)), codes, dev)
            if k == "strbool" and m is not None:
                v = v & ~m
            return v, m, False
        if k == "datefn":
            return (*_datefn(self.args, table, dev), False)
        if k == "where":
            c, a, b = self.args
            if _is_string_valued(a, table) or _is_string_valued(b, table):
                sr = self.string_result(table)
                if sr is None:
                    raise TypeError(
                        "CASE/where over strings needs BOTH branches "
                        "string-valued (or NULL / string literals)"
                    )
                return sr[0], sr[2], False
            cv, cm, _ = _ev(c, table)
            av, am, aw = _ev(a, table)
            bv, bm, bw = _ev(b, table)
            take_a = _take_a(cv, cm, dev)  # SQL CASE: a NULL condition is false
            v, w = _where_typed(take_a, av, aw, bv, bw, dev)
            if am is None and bm is None:
                return v, None, w
            m = torch.where(take_a, _bool_tensor(am if am is not None else False, dev),
                            _bool_tensor(bm if bm is not None else False, dev))
            return v, m, w
        if k == "isnull":
            (a,) = self.args
            av, am, _ = _ev(a, table)
            if am is None:
                return torch.zeros(_shape(av), dtype=torch.bool, device=dev), None, False
            return torch.broadcast_to(am, _shape(av)), None, False
        if k == "coalesce":
            if any(_is_string_valued(a, table) for a in self.args):
                sr = self.string_result(table)
                if sr is None:
                    raise TypeError(
                        "COALESCE over strings needs every operand "
                        "string-valued (or NULL / string literals)"
                    )
                return sr[0], sr[2], False
            v, m, w = _ev(self.args[0], table)
            for nxt in self.args[1:]:
                if m is None:
                    break
                nv, nm, nw = _ev(nxt, table)
                v, w = _where_typed(m, nv, nw, v, w, dev)
                m = None if nm is None else (m & nm)
            return v, m, w
        if k == "nullif":
            a, b = self.args
            av, am, aw = _ev(a, table)
            bv, bm, bw = _ev(b, table)
            eq = _bool_tensor(_binop("eq", av, aw, bv, bw, dev)[0], dev)
            if am is not None:
                eq = eq & ~am   # unknown comparison -> keep a (SQL CASE)
            if bm is not None:
                eq = eq & ~bm
            m = eq if am is None else (am | eq)
            z = _zero_like(av)
            v, w = _where_typed(m, z, _jtype(z)[1] if not torch.is_tensor(z) else False,
                                av, aw, dev)
            return v, m, w
        if k == "udf":
            fn, _, cols = self.args
            getm = getattr(table, "null_mask", None)
            m = None
            if getm is not None:
                for c in cols:  # scalar functions propagate NULL (SQL)
                    m = _mor(m, getm(c))
            v = fn(*(table[c] for c in cols))
            return v, m, _jtype(v)[1] if not torch.is_tensor(v) else False
        if k == "like":
            a, pattern = self.args
            sub = _ev_str_chain(a, table)
            if sub is None:
                raise TypeError(
                    f"LIKE requires a string column, got {a!r} (numeric "
                    f"columns and numeric expressions have no character "
                    f"patterns)"
                )
            codes, vals, m = sub
            # the pattern evaluates on the host per-code values; on the
            # device the predicate is one gather of the per-code mask
            v = _gather(_S().like_mask(vals, pattern), codes, dev)
            return (v if m is None else (v & ~m)), m, False
        raise AssertionError(f"unknown Expr kind {k!r}")

    def string_result(self, table):
        """``(codes, vocab, mask)`` when this expression is string-valued (a
        string column, a string-function/CONCAT chain, or CASE / COALESCE
        over strings), else None. ``codes`` index the SORTED host ``vocab``
        (order-preserving, ``""`` at index 0), so the triple is exactly what
        :class:`strings.DictColumn` carries and facades attach as the output
        column's dictionary."""
        S = _S()
        k = self.kind
        dev = _device_of(table)
        if k == "col":
            name = _str_col_name(self, table)
            if name is None:
                return None
            getm = getattr(table, "null_mask", None)
            return (table[name], np.asarray(table.dictionary(name)),
                    getm(name) if getm is not None else None)
        if k in ("strfn", "concat"):
            codes, vals, m = _ev_str_chain(self, table)
            vocab, mapping = S.revocab(vals)
            return _gather(mapping, codes, dev), vocab, m
        if k == "lit" and isinstance(self.args[0], (str, bytes)):
            s = _lit_str(self)
            vocab, mapping = S.revocab(np.array([s], dtype=np.str_))
            return _u32(mapping[0], dev), vocab, None
        if k == "nulllit":
            # NULL in a string CASE/COALESCE branch: code 0 = "" + mask
            return (_u32(0, dev), np.array([""], dtype=np.str_),
                    torch.ones((), dtype=torch.bool, device=dev))
        if k == "where":
            c, a, b = self.args
            ar = a.string_result(table) if isinstance(a, Expr) else None
            br = b.string_result(table) if isinstance(b, Expr) else None
            if ar is None or br is None:
                return None
            union, ra, rb = S.unify(ar[1], br[1])
            cv, cm, _ = _ev(c, table)
            take_a = _take_a(cv, cm, dev)
            v = _where_typed(take_a, _gather(ra, ar[0], dev), False,
                             _gather(rb, br[0], dev), False, dev)[0]
            am, bm = ar[2], br[2]
            if am is None and bm is None:
                return v, union, None
            m = torch.where(take_a, _bool_tensor(am if am is not None else False, dev),
                            _bool_tensor(bm if bm is not None else False, dev))
            return _where_typed(m, _u32(0, dev), False, v, False, dev)[0], union, m
        if k == "coalesce":
            rs = [a.string_result(table) if isinstance(a, Expr) else None
                  for a in self.args]
            if any(r is None for r in rs):
                return None
            union = rs[0][1]
            for r in rs[1:]:
                union = np.union1d(union, r[1])
            v, m = None, None
            for codes, vocab, am in rs:
                remap = np.searchsorted(union, vocab).astype(np.uint32)
                cv = _gather(remap, codes, dev)
                if v is None:
                    v, m = cv, am
                    continue
                if m is None:
                    break  # earlier operand never NULL
                v = _where_typed(m, cv, False, v, False, dev)[0]
                m = None if am is None else (m & am)
            if m is not None:
                v = _where_typed(m, _u32(0, dev), False, v, False, dev)[0]
            return v, union, m
        return None

    # -- operators --------------------------------------------------------

    def _bin(self, op, other, swap=False):
        other = other if isinstance(other, Expr) else lit(other)
        a, b = (other, self) if swap else (self, other)
        return Expr("bin", (op, a, b))

    def __add__(self, o):
        return self._bin("add", o)

    def __radd__(self, o):
        return self._bin("add", o, swap=True)

    def __sub__(self, o):
        return self._bin("sub", o)

    def __rsub__(self, o):
        return self._bin("sub", o, swap=True)

    def __mul__(self, o):
        return self._bin("mul", o)

    def __rmul__(self, o):
        return self._bin("mul", o, swap=True)

    def __truediv__(self, o):
        return self._bin("truediv", o)

    def __rtruediv__(self, o):
        return self._bin("truediv", o, swap=True)

    def __floordiv__(self, o):
        return self._bin("floordiv", o)

    def __rfloordiv__(self, o):
        return self._bin("floordiv", o, swap=True)

    def __mod__(self, o):
        return self._bin("mod", o)

    def __rmod__(self, o):
        return self._bin("mod", o, swap=True)

    def __lshift__(self, o):
        return self._bin("lshift", o)

    def __rshift__(self, o):
        return self._bin("rshift", o)

    def __eq__(self, o):  # noqa: D105 — Expr equality builds a node
        return self._bin("eq", o)

    def __ne__(self, o):
        return self._bin("ne", o)

    def __lt__(self, o):
        return self._bin("lt", o)

    def __le__(self, o):
        return self._bin("le", o)

    def __gt__(self, o):
        return self._bin("gt", o)

    def __ge__(self, o):
        return self._bin("ge", o)

    def __and__(self, o):
        return self._bin("and", o)

    def __rand__(self, o):
        return self._bin("and", o, swap=True)

    def __or__(self, o):
        return self._bin("or", o)

    def __ror__(self, o):
        return self._bin("or", o, swap=True)

    def __xor__(self, o):
        return self._bin("xor", o)

    def __rxor__(self, o):
        return self._bin("xor", o, swap=True)

    def __neg__(self):
        return Expr("un", ("neg", self))

    def __invert__(self):
        return Expr("un", ("invert", self))

    def __hash__(self):  # __eq__ is overloaded; hash by identity
        return id(self)

    def __bool__(self):
        raise TypeError(
            "an Expr has no truth value (it is a deferred column "
            "expression); combine predicates with & | ~, not and/or/not"
        )

    def abs(self) -> "Expr":
        return Expr("un", ("abs", self))

    def floor(self) -> "Expr":
        return Expr("un", ("floor", self))

    def ceil(self) -> "Expr":
        return Expr("un", ("ceil", self))

    def round(self) -> "Expr":
        """Round half-to-even (np.round semantics)."""
        return Expr("un", ("round", self))

    def sign(self) -> "Expr":
        return Expr("un", ("sign", self))

    def sqrt(self) -> "Expr":
        return Expr("un", ("sqrt", self))

    def exp(self) -> "Expr":
        return Expr("un", ("exp", self))

    def log(self) -> "Expr":
        """Natural logarithm."""
        return Expr("un", ("log", self))

    def log10(self) -> "Expr":
        return Expr("un", ("log10", self))

    def log2(self) -> "Expr":
        return Expr("un", ("log2", self))

    def pow(self, o) -> "Expr":
        return self._bin("pow", o)

    def __pow__(self, o):
        return self._bin("pow", o)

    def __rpow__(self, o):
        return self._bin("pow", o, swap=True)

    def cast(self, dtype) -> "Expr":
        return Expr("cast", (self, np.dtype(dtype)))

    def minimum(self, o) -> "Expr":
        return self._bin("min", o)

    def maximum(self, o) -> "Expr":
        return self._bin("max", o)

    def like(self, pattern: str) -> "Expr":
        """SQL LIKE over a dictionary-encoded string column: ``%`` = any
        run, ``_`` = one char, backslash escapes. Evaluates against the
        host-side vocabulary; one mask gather on device."""
        return Expr("like", (self, str(pattern)))

    # -- string functions (host vocabulary transforms; one device gather) --

    def _strfn(self, fname, *params) -> "Expr":
        return Expr("strfn", (fname, self, tuple(params)))

    def upper(self) -> "Expr":
        return self._strfn("upper")

    def lower(self) -> "Expr":
        return self._strfn("lower")

    def trim(self, chars: str = " ") -> "Expr":
        """SQL TRIM: strip ``chars`` (default spaces) from both ends."""
        return self._strfn("trim", str(chars))

    def ltrim(self, chars: str = " ") -> "Expr":
        return self._strfn("ltrim", str(chars))

    def rtrim(self, chars: str = " ") -> "Expr":
        return self._strfn("rtrim", str(chars))

    def substr(self, start: int, length=None) -> "Expr":
        """SQL SUBSTR: 1-based ``start``; to the end if no ``length``."""
        if length is None:
            return self._strfn("substr", int(start))
        return self._strfn("substr", int(start), int(length))

    def replace(self, old: str, new: str) -> "Expr":
        return self._strfn("replace", str(old), str(new))

    def left(self, n: int) -> "Expr":
        return self._strfn("left", int(n))

    def right(self, n: int) -> "Expr":
        return self._strfn("right", int(n))

    def reverse(self) -> "Expr":
        return self._strfn("reverse")

    def lpad(self, width: int, fill: str = " ") -> "Expr":
        """SQL LPAD: pad/truncate to ``width`` characters."""
        return self._strfn("lpad", int(width), str(fill))

    def rpad(self, width: int, fill: str = " ") -> "Expr":
        return self._strfn("rpad", int(width), str(fill))

    def length(self) -> "Expr":
        """Character count (int32)."""
        return Expr("strnum", ("length", self, ()))

    def strpos(self, sub: str) -> "Expr":
        """SQL STRPOS: 1-based position of ``sub``, 0 when absent."""
        return Expr("strnum", ("strpos", self, (str(sub),)))

    def starts_with(self, prefix: str) -> "Expr":
        return Expr("strbool", ("starts_with", self, (str(prefix),)))

    def ends_with(self, suffix: str) -> "Expr":
        return Expr("strbool", ("ends_with", self, (str(suffix),)))

    def contains(self, sub: str) -> "Expr":
        return Expr("strbool", ("contains", self, (str(sub),)))

    def concat(self, *others) -> "Expr":
        """String concatenation (SQL ``||``): this value then each of
        ``others`` (string expressions or literals)."""
        return concat(self, *others)

    # -- date functions (operand = int32 epoch days; dates.py) ------------

    def _datefn(self, fname, *params) -> "Expr":
        return Expr("datefn", (fname, self, tuple(params)))

    def year(self) -> "Expr":
        """Civil year of an epoch-days value (int32)."""
        return self._datefn("year")

    def month(self) -> "Expr":
        return self._datefn("month")

    def day(self) -> "Expr":
        return self._datefn("day")

    def day_of_week(self) -> "Expr":
        """ISO day of week: 1 = Monday ... 7 = Sunday."""
        return self._datefn("dow")

    def day_of_year(self) -> "Expr":
        return self._datefn("doy")

    def week(self) -> "Expr":
        """ISO-8601 week number."""
        return self._datefn("week")

    def quarter(self) -> "Expr":
        return self._datefn("quarter")

    def date_trunc(self, unit: str) -> "Expr":
        """Start of ``unit`` (year/quarter/month/week/day) as epoch
        days."""
        return self._datefn("trunc", str(unit).lower())

    def add_months(self, n: int) -> "Expr":
        """SQL INTERVAL MONTH arithmetic (day clamped to month end)."""
        return self._datefn("add_months", int(n))

    def isin(self, values) -> "Expr":
        """Membership in a small static value list (ORed equalities)."""
        vals = list(values)
        if not vals:
            return lit(False)
        out = self == vals[0]
        for v in vals[1:]:
            out = out | (self == v)
        return out

    def is_null(self) -> "Expr":
        """SQL ``IS NULL`` — a (never-null) bool column."""
        return Expr("isnull", (self,))

    def is_not_null(self) -> "Expr":
        """SQL ``IS NOT NULL``."""
        return Expr("un", ("invert", Expr("isnull", (self,))))

    def fill_null(self, value) -> "Expr":
        """Replace NULLs with ``value`` (``COALESCE(self, value)``)."""
        return coalesce(self, value)

    # -- display ----------------------------------------------------------

    def __repr__(self):
        k = self.kind
        if k == "col":
            return f"col({self.args[0]!r})"
        if k == "lit":
            return _lit_repr(self.args[0])
        if k == "bin":
            op, a, b = self.args
            sym = _BINOPS[op][1]
            if sym in ("min", "max", "pow"):
                return f"{sym}({a!r}, {b!r})"
            return f"({a!r} {sym} {b!r})"
        if k == "un":
            op, a = self.args
            sym = _UNOPS[op]
            return f"{sym}{a!r}" if sym in ("-", "~") else f"{sym}({a!r})"
        if k == "cast":
            a, dt = self.args
            return f"{a!r}.cast({dt.name})"
        if k == "where":
            c, a, b = self.args
            return f"where({c!r}, {a!r}, {b!r})"
        if k == "udf":
            _, label, cols = self.args
            return f"udf({label}, columns={sorted(cols)})"
        if k == "like":
            a, pattern = self.args
            return f"{a!r}.like({pattern!r})"
        if k == "isnull":
            return f"{self.args[0]!r}.is_null()"
        if k == "coalesce":
            return f"coalesce({', '.join(repr(a) for a in self.args)})"
        if k == "nullif":
            return f"nullif({self.args[0]!r}, {self.args[1]!r})"
        if k == "nulllit":
            return "NULL"
        if k in ("strfn", "strnum", "strbool", "datefn"):
            fname, a, params = self.args
            ps = "".join(f", {p!r}" for p in params)
            return f"{a!r}.{fname}({ps[2:] if ps else ''})"
        if k == "concat":
            return f"concat({', '.join(repr(a) for a in self.args)})"
        return f"Expr({k})"



def _lit_repr(v):
    """A literal as the JAX package prints it: a tensor in the form of a
    ``jax.Array`` repr, so ``explain()`` reads the same in both packages."""
    if not torch.is_tensor(v):
        return repr(v)
    sdt = _SIGNED_VIEW.get(v.dtype)
    host = (v if sdt is None else v.view(sdt)).detach().cpu().numpy()
    a = host.view(str(v.dtype).replace("torch.", "")) if sdt is not None else host
    body = np.array2string(a, separator=", ", prefix="Array(")
    return f"Array({body}, dtype={a.dtype.name})"


def _parse_vocab(vals, dt):
    """Parse a vocabulary's string values to ``dt``: ``(parsed, bad)``
    numpy arrays — ``bad`` flags unparseable entries (they become 0 and
    NULL after the code gather). Integer targets accept optional sign
    and digits; floats take Python float syntax; bool accepts
    true/false/t/f/1/0 (case-insensitive)."""
    dt = np.dtype(dt)
    parsed = np.zeros(len(vals), dt)
    bad = np.zeros(len(vals), bool)
    for i, raw in enumerate(vals):
        s = str(raw).strip()
        try:
            if dt.kind == "b":
                low = s.lower()
                if low in ("true", "t", "1"):
                    parsed[i] = True
                elif low in ("false", "f", "0"):
                    parsed[i] = False
                else:
                    raise ValueError(s)
            elif dt.kind in ("i", "u"):
                parsed[i] = dt.type(int(s, 10))
            else:
                parsed[i] = dt.type(float(s))
        except (ValueError, OverflowError):
            bad[i] = True
    return parsed, bad


def _ev(x, table):
    """``(values, mask, weak)`` of an Expr or a raw operand."""
    if isinstance(x, Expr):
        return x._eval(table)
    return x, None, _jtype(x)[1] if not torch.is_tensor(x) else False


def _mor(a, b):
    if a is None:
        return b
    if b is None:
        return a
    return a | b


def _take_a(cv, cm, dev):
    """A CASE condition as a bool tensor; a NULL condition is false."""
    cv = _bool_tensor(cv, dev)
    return cv if cm is None else (cv & ~cm)


def _kleene(op, av, am, aw, bv, bm, bw, dev):
    """Three-valued AND/OR: known-false dominates AND, known-true dominates
    OR; values are canonicalized False under the mask. Integer operands
    combine bitwise, promoted as the reference promotes them."""
    if am is None and bm is None:
        v, w = _binop(op, av, aw, bv, bw, dev)
        return v, None, w
    av, bv = _as_operand(av, aw, dev), _as_operand(bv, bw, dev)
    amk = am if am is not None else _bool_tensor(False, dev)
    bmk = bm if bm is not None else _bool_tensor(False, dev)

    def bop(o, x, y):
        return _binop(o, x, False, y, False, dev)[0]

    def inv(x):
        return _unop("invert", x, False, dev)[0]

    a_known = bop("and", av, ~amk)
    b_known = bop("and", bv, ~bmk)
    if op == "and":
        value = bop("and", a_known, b_known)
        known_false = bop("or", bop("and", ~amk, inv(av)), bop("and", ~bmk, inv(bv)))
        mask = bop("and", amk | bmk, inv(known_false))
    else:
        value = bop("or", a_known, b_known)
        mask = bop("and", amk | bmk, inv(value))
    return value, mask, False


def _as_operand(v, weak, dev):
    """A scalar operand of a masked Kleene op as a tensor (a Python bool
    would invert to -2)."""
    if torch.is_tensor(v):
        return v
    return _as_tensor(v, _jtype(v, weak)[0], dev)


def _datefn(args, table, dev):
    from radix_sort_tpu_torch import dates as D

    fname, child, params = args
    if _is_string_valued(child, table):
        raise TypeError(
            f"{fname.upper()} needs an epoch-days integer "
            f"column, got a string column"
        )
    av, am, aw = _ev(child, table)
    av = _as_tensor(av, _jtype(av, aw)[0], dev)
    is_ts = av.dtype == torch.int64  # epoch-us timestamp column
    if fname == "add_time":
        days, us = params
        if is_ts:
            return _binop("add", av, aw, days * D.US_PER_DAY + us, True, dev)[0], am
        if us:
            raise TypeError(
                "a sub-day INTERVAL needs an int64 "
                "epoch-microseconds timestamp column (a DATE "
                "has no time of day)"
            )
        return _binop("add", av, aw, days, True, dev)[0], am
    if fname in D.TS_NUM_FNS:
        if not is_ts:
            raise TypeError(
                f"{fname.upper()} needs an int64 "
                f"epoch-microseconds timestamp column, got "
                f"{str(av.dtype).replace('torch.', '')} (a DATE has no time of day)"
            )
        return D.TS_NUM_FNS[fname](av), am
    if fname == "trunc":
        v = (D.trunc_us(params[0], av) if is_ts
             else D.trunc_days(params[0], av))
    elif fname == "add_months":
        if is_ts:
            days = D.ts_days(av)
            tod = av - days.to(torch.int64) * D.US_PER_DAY
            v = (D.add_months(days, params[0]).to(torch.int64)
                 * D.US_PER_DAY + tod)
        else:
            v = D.add_months(av, params[0])
    else:
        v = D.DATE_NUM_FNS[fname](D.ts_days(av) if is_ts else av)
    return v, am


def _S():
    from radix_sort_tpu_torch import strings as S
    return S


def _str_col_name(x, table):
    """Column name if ``x`` is col() of a string column of ``table``."""
    if (isinstance(x, Expr) and x.kind == "col"
            and getattr(table, "is_string", lambda n: False)(x.args[0])):
        return x.args[0]
    return None


def _is_str_lit(x):
    return (isinstance(x, Expr) and x.kind == "lit"
            and isinstance(x.args[0], (str, bytes)))


def _lit_str(x):
    s = x.args[0]
    return s.decode() if isinstance(s, bytes) else s


def _is_string_valued(x, table):
    """True when ``x`` evaluates to dictionary-encoded string values: a
    string column, a string function / CONCAT chain, or CASE / COALESCE
    whose branches are string-valued. Structural: nothing evaluates."""
    if not isinstance(x, Expr):
        return False
    k = x.kind
    if k == "col":
        return _str_col_name(x, table) is not None
    if k in ("strfn", "concat"):
        return True
    if k == "where":
        return (_is_string_valued(x.args[1], table)
                or _is_string_valued(x.args[2], table))
    if k == "coalesce":
        return any(_is_string_valued(a, table) for a in x.args)
    return False


def _ev_str_chain(x, table):
    """Resolve a string-valued expression into ``(codes, vals, mask)``:
    ``codes`` is a device ``uint32`` tensor of dictionary codes, ``vals`` a
    host numpy string array POSITIONAL BY CODE (``vals[c]`` is the string
    value of code ``c``: unsorted, possibly duplicated), ``mask`` the null
    mask or None. All function composition happens on the (small) host
    ``vals`` array; the only device work a consumer pays is one gather by
    ``codes``. Returns None when ``x`` is not string-valued."""
    if not isinstance(x, Expr):
        return None
    k = x.kind
    dev = _device_of(table)
    if k == "col":
        name = _str_col_name(x, table)
        if name is None:
            return None
        getm = getattr(table, "null_mask", None)
        return (table[name], np.asarray(table.dictionary(name)),
                getm(name) if getm is not None else None)
    if k == "strfn":
        fname, child, params = x.args
        sub = _ev_str_chain(child, table)
        if sub is None:
            raise TypeError(
                f"{fname.upper()} needs a string-valued argument (a "
                f"string column or string expression), got {child!r}"
            )
        codes, vals, m = sub
        return codes, _S().STR_FNS[fname](vals, *params), m
    if k == "concat":
        chains, parts = [], []
        for p in x.args:
            if _is_str_lit(p):
                parts.append(_lit_str(p))
                continue
            sub = _ev_str_chain(p, table)
            if sub is None:
                raise TypeError(
                    f"CONCAT/|| operands must be string-valued or string "
                    f"literals, got {p!r}"
                )
            chains.append(sub)
            parts.append(len(chains) - 1)
        if not chains:  # all-literal concat (normally folded by
            s = "".join(parts)  # concat(); defensive)
            return _u32(0, dev), np.array([s], dtype=np.str_), None
        # fold the parts left to right over a running (codes, vals, mask).
        # Chains sharing the running base code tensor combine positionally
        # on the host values (w || '-' || UPPER(w)); a DIFFERENT column
        # combines via the dictionary CROSS PRODUCT: vals grows to |left| *
        # |right| (every combination, realized or not) and codes become
        # codes * |right| + codes2 with one extra device multiply-add, so
        # the device cost stays one gather.
        codes, vals, m = None, np.array([""], dtype=np.str_), None
        for s in parts:
            if not isinstance(s, int):
                vals = np.char.add(vals, s)
                continue
            c2, v2, m2 = chains[s]
            v2 = np.asarray(v2, dtype=np.str_)
            if codes is None:
                codes = c2
                vals = np.char.add(vals, v2)
            elif c2 is codes:
                vals = np.char.add(vals, v2)
            else:
                k1, k2 = vals.shape[0], v2.shape[0]
                if k1 * k2 > (1 << 20):
                    raise TypeError(
                        f"CONCAT over different string columns builds "
                        f"the dictionary cross product; {k1} x {k2} "
                        f"distinct values exceeds the 2^20 bound; "
                        f"reduce the vocabularies or concatenate after "
                        f"aggregation"
                    )
                vals = np.char.add(np.repeat(vals, k2),
                                   np.tile(v2, k1))
                prod = _binop("mul", codes, False, np.uint32(k2), False, dev)[0]
                codes = _binop("add", prod, False, c2, False, dev)[0]
            m = _mor(m, m2)
        return codes, vals, m
    if k == "lit" and isinstance(x.args[0], (str, bytes)):
        return _u32(0, dev), np.array([_lit_str(x)], dtype=np.str_), None
    if k in ("where", "coalesce", "nulllit"):
        sr = x.string_result(table)
        if sr is not None:
            return sr  # a sorted vocab is a valid positional vals array
    return None


def _masked_bool(v, m):
    return v if m is None else (v & ~m)


def _string_compare(op, a, b, table):
    """Comparison where at least one side is string-valued (or a string
    literal). Returns ``(values, mask)``.

    chain OP "literal": the literal resolves against the chain's output
    vocabulary: equality via code lookup (absent values equal nothing);
    ordering via the literal's boundary rank (code < left-rank <=> value <
    literal; side/op adjust for <=/>). chain OP chain: the two output
    vocabularies unify and both code columns remap so one code space carries
    the total order. A device code scalar (the ``Table.code()`` escape
    hatch) passes through as a plain code comparison."""
    S = _S()
    dev = _device_of(table)
    if _is_str_lit(a) and _is_str_lit(b):
        v = _BINOPS[op][0](_lit_str(a), _lit_str(b))
        return _bool_tensor(v, dev), None
    if _is_str_lit(a) or (not _is_string_valued(a, table)
                          and _is_string_valued(b, table)):
        op, a, b = _MIRROR[op], b, a  # string chain on the left
    ar = a.string_result(table) if isinstance(a, Expr) else None
    if ar is None:  # e.g. numeric column vs a string literal
        raise TypeError(
            f"comparing a string literal against non-string operand "
            f"{a!r} (it has no dictionary to resolve the literal in)"
        )
    codes, vocab, am = ar
    if _is_str_lit(b):
        s = _lit_str(b)
        if op in ("eq", "ne"):
            v = _binop(op, codes, False, np.uint32(S.lookup(vocab, s)), False, dev)[0]
        else:
            side = "left" if op in ("lt", "ge") else "right"
            bound = np.uint32(np.searchsorted(vocab, s, side=side))
            # lt/le <=> code < (left|right) bound; ge/gt <=> code >= bound
            v = _binop("lt" if op in ("lt", "le") else "ge", codes, False,
                       bound, False, dev)[0]
        return _masked_bool(v, am), am
    if _is_string_valued(b, table):
        br = b.string_result(table)
        _, ra, rb = S.unify(vocab, br[1])
        v = _binop(op, _gather(ra, codes, dev), False, _gather(rb, br[0], dev),
                   False, dev)[0]
        m = _mor(am, br[2])
        return _masked_bool(v, m), m
    # string side vs non-string side: device code tensors/scalars (the
    # Table.code() escape hatch) pass through; Python number literals and
    # numeric expressions are meaningless against dictionary codes
    is_code = (isinstance(b, Expr) and b.kind == "lit"
               and not isinstance(b.args[0], (bool, int, float)))
    if not is_code:
        raise TypeError(
            f"comparing a string column/expression against a non-string "
            f"operand {b!r} (dictionary codes vs numbers would be "
            f"meaningless); compare against a str literal or a code from "
            f"Table.code()"
        )
    v = _binop(op, codes, False, b.args[0], False, dev)[0]
    return _masked_bool(v, am), am


def _reject_string_arith(op, operands, table):
    """Arithmetic/bit ops over dictionary-encoded string values would
    silently compute on uint32 codes; refuse."""
    for x in operands:
        if _is_string_valued(x, table):
            name = _str_col_name(x, table)
            what = (f"string column {name!r}" if name is not None
                    else f"string expression {x!r}")
            raise TypeError(
                f"operator {op!r} is not defined for {what} (it would "
                f"compute on dictionary codes, not string values); only "
                f"comparisons, LIKE, || and the string functions are "
                f"supported"
            )


def col(name: str) -> Expr:
    """Reference a column by name."""
    return Expr("col", (str(name),))


def lit(value) -> Expr:
    """A literal scalar (or array) operand."""
    return Expr("lit", (value,))


def where(cond, a, b) -> Expr:
    """Elementwise ``cond ? a : b`` (SQL ``CASE WHEN``)."""
    mk = lambda x: x if isinstance(x, Expr) else lit(x)
    return Expr("where", (mk(cond), mk(a), mk(b)))


def udf(fn, columns, label: str = "udf") -> Expr:
    """Escape hatch: an arbitrary elementwise function of the named
    columns, ``fn(*tensors) -> tensor``. Unlike a raw lambda at the plan
    level, the column reads are DECLARED, so projection pruning still
    works through it. NULL-propagating: the result is NULL wherever any
    read column is NULL (the SQL scalar-function rule)."""
    return Expr("udf", (fn, str(label), tuple(str(c) for c in columns)))


def coalesce(*exprs) -> Expr:
    """SQL ``COALESCE``: the first non-NULL operand, elementwise."""
    if not exprs:
        raise ValueError("coalesce needs at least one operand")
    mk = lambda x: x if isinstance(x, Expr) else lit(x)
    return Expr("coalesce", tuple(mk(x) for x in exprs))


def nullif(a, b) -> Expr:
    """SQL ``NULLIF(a, b)``: NULL where ``a == b``, else ``a``."""
    mk = lambda x: x if isinstance(x, Expr) else lit(x)
    return Expr("nullif", (mk(a), mk(b)))


def null() -> Expr:
    """The SQL ``NULL`` literal (untyped; broadcasts in CASE/COALESCE)."""
    return Expr("nulllit", ())


def concat(*parts) -> Expr:
    """SQL ``||`` / CONCAT over string expressions and literals. At most
    one operand may be a string COLUMN chain (the result stays a single
    dictionary transform); pure-literal concats fold to a literal."""
    if not parts:
        raise ValueError("concat needs at least one operand")
    mk = lambda x: x if isinstance(x, Expr) else lit(x)
    flat = []
    for p in parts:
        p = mk(p)
        if isinstance(p, Expr) and p.kind == "concat":
            flat.extend(p.args)  # a || b || c parses left-nested
        else:
            flat.append(p)
    if all(_is_str_lit(p) for p in flat):
        return lit("".join(_lit_str(p) for p in flat))
    return Expr("concat", tuple(flat))
