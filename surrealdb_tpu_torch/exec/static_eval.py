"""Static evaluation of literal-only expressions (no datastore needed).

Used by the test harness (parsing expected values) and literal kinds.
"""

from __future__ import annotations

from surrealdb_tpu_torch.err import SdbError
from surrealdb_tpu_torch.expr.ast import (
    ArrayExpr,
    SetExpr,
    Binary,
    Idiom,
    Literal,
    ObjectExpr,
    PField,
    Prefix,
    RangeExpr,
    RecordIdLit,
    RegexLit,
)
from surrealdb_tpu_torch.val import NONE, Range, RecordId, Regex


def static_value(node):
    if isinstance(node, Literal):
        return node.value
    if isinstance(node, ArrayExpr):
        return [static_value(x) for x in node.items]
    if isinstance(node, ObjectExpr):
        out = {k: static_value(v) for k, v in node.items}
        if len(out) == 2 and "type" in out and (
            "coordinates" in out or "geometries" in out
        ):
            from surrealdb_tpu_torch.exec.coerce import object_to_geometry

            g = object_to_geometry(out)
            if g is not None:
                return g
        return out
    if isinstance(node, SetExpr):
        from surrealdb_tpu_torch.val import SSet

        return SSet([static_value(x) for x in node.items])
    if isinstance(node, RecordIdLit):
        idv = node.id
        if isinstance(idv, RangeExpr):
            return RecordId(node.tb, static_value_range(idv))
        return RecordId(node.tb, static_value(idv))
    if isinstance(node, RangeExpr):
        return static_value_range(node)
    if isinstance(node, Prefix) and node.op == "-":
        v = static_value(node.expr)
        return -v
    if isinstance(node, Prefix) and node.op == "+":
        return static_value(node.expr)
    if isinstance(node, RegexLit):
        return Regex(node.pattern)
    if isinstance(node, Idiom) and len(node.parts) == 1 and isinstance(
        node.parts[0], PField
    ):
        # bare word in a static context = string-ish identity (rare)
        return node.parts[0].name
    if isinstance(node, Binary):
        from surrealdb_tpu_torch.exec.operators import binary_op

        return binary_op(node.op, static_value(node.lhs), static_value(node.rhs))
    from surrealdb_tpu_torch.expr.ast import FunctionCall as _FC

    if isinstance(node, _FC) and node.name == "__point__":
        from surrealdb_tpu_torch.val import Geometry

        return Geometry(
            "Point",
            (float(static_value(node.args[0])), float(static_value(node.args[1]))),
        )
    raise SdbError(f"not a static value: {node!r}")


def static_value_range(node: RangeExpr):
    beg = static_value(node.beg) if node.beg is not None else NONE
    end = static_value(node.end) if node.end is not None else NONE
    return Range(beg, end, node.beg_incl, node.end_incl)


def static_value_maybe(v):
    """Kind.literal payloads may be raw values or AST nodes."""
    from surrealdb_tpu_torch.expr.ast import Node

    if isinstance(v, Node):
        return static_value(v)
    return v
