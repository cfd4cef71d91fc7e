"""Canonical SQL text of expressions, data clauses and SELECTs (the
reference's ToSql impls: sql/statements/*.rs fmt_sql): the names of
projected fields, closures' and subqueries' renderings, and index
messages."""

from __future__ import annotations

from surrealdb_tpu_torch.val import NONE, Duration, escape_ident


def _expr_sql(node) -> str:
    """Canonical text of an expression AST (reference CoverStmts rendering)."""
    from surrealdb_tpu_torch.expr.ast import (
        ArrayExpr,
        Binary,
        BlockExpr,
        Cast,
        ClosureExpr,
        Constant,
        FunctionCall,
        Idiom,
        IfElse,
        Knn,
        Literal,
        Matches,
        Mock,
        ObjectExpr,
        Param,
        PField,
        Prefix,
        SetExpr,
        RangeExpr,
        RecordIdLit,
        RegexLit,
        SelectStmt,
        Subquery,
    )
    from surrealdb_tpu_torch.val import render

    if node is None:
        return ""
    if isinstance(node, Literal):
        return render(node.value)
    if isinstance(node, Param):
        return f"${node.name}"
    if isinstance(node, Binary):
        op = {"&&": "AND", "||": "OR", "∈": "INSIDE", "∉": "NOT INSIDE",
              "∋": "CONTAINS", "∌": "CONTAINSNOT", "⊇": "CONTAINSALL",
              "⊆": "ALLINSIDE", "containsany": "CONTAINSANY",
              "containsnone": "CONTAINSNONE", "anyinside": "ANYINSIDE",
              "noneinside": "NONEINSIDE"}.get(node.op, node.op)
        return f"{_expr_sql(node.lhs)} {op} {_expr_sql(node.rhs)}"
    if isinstance(node, Prefix):
        if node.op == "!":
            return f"! {_expr_sql(node.expr)}"
        return f"{node.op}{_expr_sql(node.expr)}"
    if isinstance(node, RegexLit):
        return f"/{node.pattern}/"
    if isinstance(node, Matches):
        op = f"@{node.ref}@" if node.ref is not None else "@@"
        return f"{_expr_sql(node.lhs)} {op} {_expr_sql(node.rhs)}"
    if isinstance(node, Knn):
        if node.ef is not None:
            return f"{_expr_sql(node.lhs)} <|{node.k},{node.ef}|> {_expr_sql(node.rhs)}"
        if node.dist is not None:
            d = node.dist
            ds = f"MINKOWSKI {d[1]}" if isinstance(d, tuple) else d.upper()
            return f"{_expr_sql(node.lhs)} <|{node.k},{ds}|> {_expr_sql(node.rhs)}"
        return f"{_expr_sql(node.lhs)} <|{node.k}|> {_expr_sql(node.rhs)}"
    if isinstance(node, FunctionCall):
        args = ", ".join(_expr_sql(a) for a in node.args)
        return f"{node.name}({args})"
    if isinstance(node, Idiom):
        from surrealdb_tpu_torch.exec.statements import expr_name

        parts = node.parts
        if parts and isinstance(parts[0], tuple) and parts[0][0] == "start":
            head = _expr_sql(parts[0][1])
            rest = (
                expr_name(Idiom(list(parts[1:])), sql=True)
                if len(parts) > 1 else ""
            )
            if not rest:
                return head
            sep = "" if rest.startswith(("[", "-", "<")) else "."
            return head + sep + rest
        return expr_name(node, sql=True)
    if isinstance(node, ArrayExpr):
        return "[" + ", ".join(_expr_sql(x) for x in node.items) + "]"
    if isinstance(node, ObjectExpr):
        if not node.items:
            return "{  }"
        inner = ", ".join(f"{escape_ident(k)}: {_expr_sql(v)}" for k, v in node.items)
        return "{ " + inner + " }"
    if isinstance(node, SetExpr):
        if not node.items:
            return "{,}"
        return "{" + ", ".join(_expr_sql(x) for x in node.items) + "}"
    if isinstance(node, RecordIdLit):
        from surrealdb_tpu_torch.val import render_record_id_key

        idv = node.id
        if isinstance(idv, Literal):
            return f"{escape_ident(node.tb)}:{render_record_id_key(idv.value)}"
        return f"{escape_ident(node.tb)}:{_expr_sql(idv)}"
    if isinstance(node, RangeExpr):
        beg = _expr_sql(node.beg) if node.beg is not None else ""
        end = _expr_sql(node.end) if node.end is not None else ""
        op = "..=" if node.end_incl else ".."
        if not node.beg_incl:
            beg += ">"
        return f"{beg}{op}{end}"
    if isinstance(node, Subquery):
        return f"({_expr_sql(node.stmt)})"
    if isinstance(node, BlockExpr):
        if not node.stmts:
            return "{  }"
        if len(node.stmts) == 1:
            return "{ " + _expr_sql(node.stmts[0]) + " }"
        return "{ " + "; ".join(_expr_sql(s) for s in node.stmts) + "; }"
    if isinstance(node, Constant):
        return node.name
    if isinstance(node, Cast):
        from surrealdb_tpu_torch.exec.coerce import kind_name

        return f"<{kind_name(node.kind)}> {_expr_sql(node.expr)}"
    if isinstance(node, ClosureExpr):
        from surrealdb_tpu_torch.exec.coerce import kind_name

        ps = ", ".join(
            f"${n}: " + (kind_name(k) if k is not None else "any")
            for n, k in node.params
        )
        ret = f" -> {kind_name(node.returns)}" if node.returns else ""
        body = node.body
        if isinstance(body, Subquery):
            from surrealdb_tpu_torch.expr.ast import BlockExpr as _Blk

            if isinstance(body.stmt, _Blk):
                body = body.stmt
        return f"|{ps}|{ret} {_expr_sql(body)}"
    if isinstance(node, IfElse):
        bodies = [b for _c, b in node.branches]
        if node.otherwise is not None:
            bodies.append(node.otherwise)
        blocky = all(
            isinstance(b, BlockExpr)
            or (isinstance(b, Subquery) and isinstance(b.stmt, BlockExpr))
            for b in bodies
        )
        out = []
        for i, (cond, body) in enumerate(node.branches):
            kw = "IF" if i == 0 else "ELSE IF"
            if blocky:
                out.append(f"{kw} {_expr_sql(cond)} {_expr_sql(body)}")
            else:
                out.append(f"{kw} {_expr_sql(cond)} THEN {_expr_sql(body)}")
        if node.otherwise is not None:
            out.append(f"ELSE {_expr_sql(node.otherwise)}")
        if not blocky:
            out.append("END")
        return " ".join(out)
    if isinstance(node, Mock):
        if node.end is not None:
            return f"|{node.tb}:{node.beg}..{node.end}|"
        return f"|{node.tb}:{node.beg}|"
    if isinstance(node, SelectStmt):
        return _select_sql(node)
    # statements in expression position
    from surrealdb_tpu_torch.expr.ast import (
        CreateStmt,
        DeleteStmt,
        LetStmt,
        RelateStmt,
        ReturnStmt,
        UpdateStmt,
        UpsertStmt,
    )

    if isinstance(node, ReturnStmt):
        return f"RETURN {_expr_sql(node.what)}"
    if isinstance(node, LetStmt):
        return f"LET ${node.name} = {_expr_sql(node.what)}"
    if isinstance(node, CreateStmt):
        return "CREATE " + ", ".join(_expr_sql(w) for w in node.what) + _data_sql(node.data)
    if isinstance(node, (UpdateStmt, UpsertStmt)):
        kw = "UPDATE" if isinstance(node, UpdateStmt) else "UPSERT"
        out = f"{kw} " + ", ".join(_expr_sql(w) for w in node.what) + _data_sql(node.data)
        if node.cond is not None:
            out += f" WHERE {_expr_sql(node.cond)}"
        return out
    if isinstance(node, DeleteStmt):
        out = "DELETE " + ", ".join(_expr_sql(w) for w in node.what)
        if node.cond is not None:
            out += f" WHERE {_expr_sql(node.cond)}"
        return out
    if isinstance(node, RelateStmt):
        return (
            f"RELATE {_expr_sql(node.from_)} -> {_expr_sql(node.kind)} -> "
            f"{_expr_sql(node.to)}" + _data_sql(node.data)
        )
    return str(node)


def _data_sql(data) -> str:
    from surrealdb_tpu_torch.expr.ast import (
        ContentData,
        MergeData,
        PatchData,
        ReplaceData,
        SetData,
        UnsetData,
    )

    if data is None:
        return ""
    if isinstance(data, SetData):
        items = ", ".join(
            f"{_expr_sql(t)} {op} {_expr_sql(e)}" for t, op, e in data.items
        )
        return f" SET {items}"
    if isinstance(data, ContentData):
        return f" CONTENT {_expr_sql(data.expr)}"
    if isinstance(data, ReplaceData):
        return f" REPLACE {_expr_sql(data.expr)}"
    if isinstance(data, MergeData):
        return f" MERGE {_expr_sql(data.expr)}"
    if isinstance(data, PatchData):
        return f" PATCH {_expr_sql(data.expr)}"
    if isinstance(data, UnsetData):
        return " UNSET " + ", ".join(_expr_sql(f) for f in data.fields)
    return ""


def _select_sql(node) -> str:
    from surrealdb_tpu_torch.exec.statements import expr_name

    if node.value is not None:
        fields = f"VALUE {_expr_sql(node.value)}"
    else:
        fields = ", ".join(
            "*" if e == "*" else (_expr_sql(e) + (f" AS {a}" if a else ""))
            for e, a in node.exprs
        )
    whats = ", ".join(_expr_sql(w) for w in node.what)
    out = f"SELECT {fields} FROM {whats}"
    if node.cond is not None:
        out += f" WHERE {_expr_sql(node.cond)}"
    if node.split:
        out += " SPLIT " + ", ".join(_expr_sql(s) for s in node.split)
    if node.group is not None:
        if node.group:
            out += " GROUP BY " + ", ".join(_expr_sql(g) for g in node.group)
        else:
            out += " GROUP ALL"
    if node.order:
        if node.order == "rand":
            out += " ORDER BY RAND()"
        else:
            items = []
            for expr, d, collate, numeric in node.order:
                s = _expr_sql(expr)
                if collate:
                    s += " COLLATE"
                if numeric:
                    s += " NUMERIC"
                if d == "desc":
                    s += " DESC"
                items.append(s)
            out += " ORDER BY " + ", ".join(items)
    if node.limit is not None:
        out += f" LIMIT {_expr_sql(node.limit)}"
    if node.start is not None:
        out += f" START {_expr_sql(node.start)}"
    if node.fetch:
        out += " FETCH " + ", ".join(_expr_sql(f) for f in node.fetch)
    return out


# ---------------------------------------------------------------------------
# permissions
# ---------------------------------------------------------------------------

_ACTIONS = ("select", "create", "update", "delete")


# ---------------------------------------------------------------------------
# canonical DEFINE statements
# ---------------------------------------------------------------------------

