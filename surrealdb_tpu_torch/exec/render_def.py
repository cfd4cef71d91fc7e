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


def _kind_sql(kind) -> str:
    from surrealdb_tpu_torch.exec.coerce import kind_name

    return kind_name(kind)


# ---------------------------------------------------------------------------
# permissions
# ---------------------------------------------------------------------------

_ACTIONS = ("select", "create", "update", "delete")


def _perm_of(perms, action, default):
    if perms is None:
        return default
    return perms.get(action, default)


def _perms_sql(perms, default=False, field=False) -> str:
    """Reference sql/permission.rs fmt_sql: NONE / FULL / grouped FOR.
    Fields don't track delete (implicitly Full), so all-NONE field perms
    never collapse to the bare NONE form."""
    actions = _ACTIONS[:3] if field else _ACTIONS
    vals = {a: _perm_of(perms, a, default) for a in _ACTIONS}
    considered = [vals[a] for a in actions]
    if field:
        vals["delete"] = True
    if all(v is False for v in considered) and vals["delete"] is False:
        return "PERMISSIONS NONE"
    if all(v is True for v in considered) and vals["delete"] is True:
        return "PERMISSIONS FULL"
    # group kinds by identical permission, order select, create, update, delete
    lines = []
    order = ["select", "create", "update"] + ([] if field else ["delete"])
    for a in order:
        v = vals[a]
        if a == "delete" and v is True:
            continue  # delete Full skipped (catalog fields don't track it)
        placed = False
        for entry in lines:
            if _perm_eq(entry[1], v):
                entry[0].append(a)
                placed = True
                break
        if not placed:
            lines.append(([a], v))
    parts = []
    for kinds, v in lines:
        ks = ", ".join(kinds)
        if v is True:
            parts.append(f"FOR {ks} FULL")
        elif v is False:
            parts.append(f"FOR {ks} NONE")
        else:
            parts.append(f"FOR {ks} WHERE {_expr_sql(v)}")
    return "PERMISSIONS " + ", ".join(parts)


def _perm_eq(a, b):
    if isinstance(a, bool) or isinstance(b, bool):
        return a is b
    # WHERE permissions group when structurally equal (reference compares
    # the Permission values, not identities)
    return _expr_sql(a) == _expr_sql(b)


def _perm_structure(v):
    if v is True:
        return True
    if v is False:
        return False
    return _expr_sql(v)


def perms_structure(perms, default=False, field=False):
    actions = _ACTIONS[:3] if field else _ACTIONS
    return {
        a: _perm_structure(_perm_of(perms, a, default)) for a in actions
    }


# ---------------------------------------------------------------------------
# canonical DEFINE statements
# ---------------------------------------------------------------------------


def render_ns(d) -> str:
    out = f"DEFINE NAMESPACE {escape_ident(d.name)}"
    if d.comment:
        out += f" COMMENT {_str_sql(d.comment)}"
    return out


def _str_sql(s) -> str:
    from surrealdb_tpu_torch.val import escape_string

    return escape_string(s)


def render_db(d) -> str:
    out = f"DEFINE DATABASE {escape_ident(d.name)}"
    if d.comment:
        out += f" COMMENT {_str_sql(d.comment)}"
    if d.changefeed:
        out += f" CHANGEFEED {Duration(d.changefeed).render()}"
    return out


def render_table(d) -> str:
    out = f"DEFINE TABLE {escape_ident(d.name)} TYPE"
    if d.kind == "any":
        out += " ANY"
    elif d.kind == "relation":
        out += " RELATION"
        if d.relation_from:
            out += " IN " + " | ".join(escape_ident(x) for x in d.relation_from)
        if d.relation_to:
            out += " OUT " + " | ".join(escape_ident(x) for x in d.relation_to)
        if d.enforced:
            out += " ENFORCED"
    else:
        out += " NORMAL"
    if d.drop:
        out += " DROP"
    out += " SCHEMAFULL" if d.full else " SCHEMALESS"
    if d.comment:
        out += f" COMMENT {_str_sql(d.comment)}"
    if d.view is not None:
        out += f" AS {_expr_sql(d.view)}"
    if d.changefeed:
        out += f" CHANGEFEED {Duration(d.changefeed).render()}"
        if d.changefeed_original:
            out += " INCLUDE ORIGINAL"
    out += " " + _perms_sql(d.permissions, default=False)
    return out


def table_structure(d) -> dict:
    out = {
        "id": getattr(d, "table_id", 0),
        "name": d.name,
        "drop": d.drop,
        "schemafull": d.full,
        "kind": _table_kind_structure(d),
        "permissions": perms_structure(d.permissions, default=False),
    }
    if d.view is not None:
        out["view"] = _expr_sql(d.view)
    if d.changefeed:
        out["changefeed"] = {
            "expiry": Duration(d.changefeed).render(),
            "original": d.changefeed_original,
        }
    if d.comment:
        out["comment"] = d.comment
    return out


def _table_kind_structure(d):
    if d.kind == "relation":
        out = {"kind": "RELATION"}
        if d.relation_from:
            out["in"] = d.relation_from
        if d.relation_to:
            out["out"] = d.relation_to
        out["enforced"] = d.enforced
        return out
    return {"kind": d.kind.upper()}


def _field_seg_sql(seg: str, keyish: bool) -> str:
    """One dot-segment of a field name. Bracket suffixes ([1], [*]) and a
    trailing flatten ellipsis stay OUTSIDE the ident escaping (reference
    renders `index[1]` and `flatten…` bare)."""
    import re as _re3

    from surrealdb_tpu_torch.val import escape_rid_table

    m = _re3.match(r"^(.*?)((?:\[[^\]]*\])*)(\u2026?)$", seg)
    base, brackets, flat = m.group(1), m.group(2), m.group(3)
    if base == "*" or (base == "" and (brackets or flat)):
        return seg
    esc = escape_rid_table(base) if keyish else escape_ident(base)
    return esc + brackets + flat


def _field_name_sql(name_str: str) -> str:
    # escape each dot segment independently (`value`.sub stays quoted)
    parts = []
    for seg in name_str.split("."):
        if seg == "*" or seg.startswith("["):
            parts.append(seg)
        else:
            parts.append(_field_seg_sql(seg, keyish=False))
    return ".".join(parts)


def field_name_key(name_str: str) -> str:
    """INFO map key for a field: quote only lexically-invalid segments
    (keywords stay bare — reference EscapeKey, not EscapeIdent)."""
    from surrealdb_tpu_torch.val import escape_rid_table

    parts = []
    for seg in name_str.split("."):
        if seg == "*" or seg.startswith("["):
            parts.append(seg)
        else:
            parts.append(_field_seg_sql(seg, keyish=True))
    return ".".join(parts)


def render_field(d, tb) -> str:
    out = f"DEFINE FIELD {_field_name_sql(d.name_str)} ON {escape_ident(tb)}"
    if d.kind is not None:
        out += f" TYPE {_kind_sql(d.kind)}"
        if d.flex:
            out += " FLEXIBLE"
    if d.default is not None:
        out += " DEFAULT"
        if d.default_always:
            out += " ALWAYS"
        out += f" {_expr_sql(d.default)}"
    if d.readonly:
        out += " READONLY"
    if d.value is not None:
        out += f" VALUE {_expr_sql(d.value)}"
    if d.assert_ is not None:
        out += f" ASSERT {_expr_sql(d.assert_)}"
    if d.computed is not None:
        comp = d.computed
        from surrealdb_tpu_torch.expr.ast import BlockExpr as _Blk2
        from surrealdb_tpu_torch.expr.ast import Subquery as _Sub2

        if isinstance(comp, _Sub2) and isinstance(comp.stmt, _Blk2):
            comp = comp.stmt  # COMPUTED { a } renders without parens
        out += f" COMPUTED {_expr_sql(comp)}"
    if d.reference is not None:
        out += " REFERENCE ON DELETE " + d.reference.get(
            "on_delete", "ignore"
        ).upper()
        if d.reference.get("on_delete") == "then":
            out += f" {_expr_sql(d.reference.get('then'))}"
    if d.comment:
        out += f" COMMENT {_str_sql(d.comment)}"
    out += " " + _perms_sql(d.permissions, default=True, field=True)
    return out


def field_structure(d, tb) -> dict:
    out = {"name": d.name_str, "table": tb}
    if d.kind is not None:
        out["kind"] = _kind_sql(d.kind)
    if d.flex:
        out["flexible"] = True
    if d.value is not None:
        out["value"] = _expr_sql(d.value)
    if d.assert_ is not None:
        out["assert"] = _expr_sql(d.assert_)
    if d.computed is not None:
        out["computed"] = _expr_sql(d.computed)
    if d.default is not None:
        out["default_always"] = d.default_always
        out["default"] = _expr_sql(d.default)
    out["readonly"] = d.readonly
    out["permissions"] = perms_structure(d.permissions, default=True, field=True)
    if d.comment:
        out["comment"] = d.comment
    return out


def render_index(d) -> str:
    out = f"DEFINE INDEX {escape_ident(d.name)} ON {escape_ident(d.tb)}"
    if d.cols_str:
        out += " FIELDS " + ", ".join(d.cols_str)
    if d.unique:
        out += " UNIQUE"
    if d.count:
        out += " COUNT"
        if getattr(d, "count_cond", None) is not None:
            out += f" WHERE {_expr_sql(d.count_cond)}"
    if d.fulltext is not None:
        ft = d.fulltext
        out += f" FULLTEXT ANALYZER {ft.get('analyzer')}"
        k1, b = ft.get("bm25", (1.2, 0.75))
        out += f" BM25({k1},{b})"
        if ft.get("highlights"):
            out += " HIGHLIGHTS"
    if d.hnsw is not None:
        h = d.hnsw
        dist = h.get("distance", "euclidean")
        dist_s = (
            f"MINKOWSKI {dist[1]}" if isinstance(dist, tuple) else dist.upper()
        )
        out += (
            f" HNSW DIMENSION {h.get('dimension')} DIST {dist_s}"
            f" TYPE {h.get('vector_type', 'f32').upper()}"
            f" EFC {h.get('ef_construction', 150)} M {h.get('m', 12)}"
            f" M0 {h.get('m0', 24)}"
        )
        import math as _m

        ml = h.get("ml")
        if ml is None:
            ml = 1.0 / _m.log(h.get("m", 12))
        from surrealdb_tpu_torch.val import render as _render

        out += f" LM {_render(float(ml))}"
        if h.get("extend_candidates"):
            out += " EXTEND_CANDIDATES"
        if h.get("keep_pruned_connections"):
            out += " KEEP_PRUNED_CONNECTIONS"
        if h.get("use_hashed_vector"):
            out += " HASHED_VECTOR"
    if d.comment:
        out += f" COMMENT {_str_sql(d.comment)}"
    return out


def index_structure(d) -> dict:
    out = {"name": d.name, "table": d.tb, "cols": list(d.cols_str)}
    if d.unique:
        out["index"] = "UNIQUE"
    elif d.count:
        out["index"] = "COUNT"
    elif d.fulltext is not None:
        out["index"] = "FULLTEXT"
    elif d.hnsw is not None:
        out["index"] = "HNSW"
    else:
        out["index"] = "IDX"
    if getattr(d, "prepare_remove", False):
        out["prepare_remove"] = True
    if d.comment:
        out["comment"] = d.comment
    return out


def render_event(d, tb) -> str:
    def wrap(t):
        from surrealdb_tpu_torch.expr.ast import BlockExpr as _Blk, Subquery as _Sub

        if isinstance(t, _Sub) and isinstance(t.stmt, _Blk):
            t = t.stmt
        x = _expr_sql(t)
        from surrealdb_tpu_torch.expr.ast import Idiom as _Idm, Literal as _Lit

        if isinstance(t, (_Lit, _Idm)):
            return x  # plain values/idioms render bare: THEN bla
        return x if x.startswith(("(", "{")) else f"({x})"

    then = ", ".join(wrap(t) for t in d.then)
    attrs = ""
    if getattr(d, "async_", False):
        retry = getattr(d, "retry", None)
        maxdepth = getattr(d, "maxdepth", None)
        attrs = (
            f" ASYNC RETRY {1 if retry is None else retry} "
            f"MAXDEPTH {3 if maxdepth is None else maxdepth}"
        )
    out = (
        f"DEFINE EVENT {escape_ident(d.name)} ON {escape_ident(tb)}{attrs} "
        f"WHEN {_expr_sql(d.when) if d.when is not None else 'true'} THEN {then}"
    )
    if d.comment:
        out += f" COMMENT {_str_sql(d.comment)}"
    return out


def event_structure(d, tb) -> dict:
    return {
        "name": d.name,
        "what": tb,
        "when": _expr_sql(d.when) if d.when is not None else "true",
        "then": [_expr_sql(t) for t in d.then],
    }


def render_param(d) -> str:
    from surrealdb_tpu_torch.val import render as vr

    out = f"DEFINE PARAM ${d.name} VALUE {vr(d.value)}"
    if d.comment is not None:
        out += f" COMMENT {_str_sql(d.comment)}"
    p = d.permissions
    if p is True or p is None:
        out += " PERMISSIONS FULL"
    elif p is False:
        out += " PERMISSIONS NONE"
    else:
        out += f" PERMISSIONS WHERE {_expr_sql(p)}"
    return out


def render_function(d) -> str:
    from surrealdb_tpu_torch.exec.coerce import kind_name

    args = ", ".join(f"${n}: {kind_name(k)}" for n, k in d.args)
    out = f"DEFINE FUNCTION fn::{d.name}({args})"
    if d.returns is not None:
        out += f" -> {kind_name(d.returns)}"
    body = _expr_sql(d.block)
    if body == "{  }":
        body = "{;}"  # reference renders an empty function body as {;}
    out += f" {body}"
    if d.comment is not None:
        out += f" COMMENT {_str_sql(d.comment)}"
    p = d.permissions
    if p is True or p is None:
        out += " PERMISSIONS FULL"
    elif p is False:
        out += " PERMISSIONS NONE"
    else:
        out += f" PERMISSIONS WHERE {_expr_sql(p)}"
    return out


def render_analyzer(d) -> str:
    out = f"DEFINE ANALYZER {escape_ident(d.name)}"
    if d.function:
        out += f" FUNCTION fn::{d.function}"
    if d.tokenizers:
        out += " TOKENIZERS " + ",".join(t.upper() for t in d.tokenizers)
    if d.filters:
        fs = []
        for f in d.filters:
            if len(f) == 1:
                fs.append(f[0].upper())
            elif f[0].lower() == "mapper":
                fs.append(f"MAPPER({_str_sql(str(f[1]))})")
            elif f[0].lower() == "snowball":
                fs.append(
                    f"SNOWBALL({','.join(str(x).upper() for x in f[1:])})"
                )
            else:
                fs.append(f"{f[0].upper()}({','.join(str(x) for x in f[1:])})")
        out += " FILTERS " + ", ".join(fs)
    if d.comment:
        out += f" COMMENT {_str_sql(d.comment)}"
    return out


def render_user(d) -> str:
    roles = ", ".join(r.upper() for r in d.roles)
    base = {"root": "ROOT", "ns": "NAMESPACE", "db": "DATABASE"}.get(
        d.base, d.base.upper()
    )
    out = (
        f"DEFINE USER {escape_ident(d.name)} ON {base} "
        f"PASSHASH {_str_sql(d.passhash)} ROLES {roles}"
    )
    dur = d.duration or {}
    tok = dur.get("token", Duration.parse("1h"))
    ses = dur.get("session")
    tok_s = tok.render() if isinstance(tok, Duration) else (tok or "NONE")
    ses_s = ses.render() if isinstance(ses, Duration) else (ses or "NONE")
    out += f" DURATION FOR TOKEN {tok_s}, FOR SESSION {ses_s}"
    if d.comment:
        out += f" COMMENT {_str_sql(d.comment)}"
    return out


def render_access(d) -> str:
    from surrealdb_tpu_torch.val import Duration

    base = {"root": "ROOT", "ns": "NAMESPACE", "db": "DATABASE"}.get(
        d.base, d.base.upper()
    )
    cfg = d.config or {}
    out = f"DEFINE ACCESS {escape_ident(d.name)} ON {base} TYPE {d.kind.upper()}"
    if d.kind == "record":
        if cfg.get("signup") is not None:
            out += f" SIGNUP {_expr_sql(cfg['signup'])}"
        if cfg.get("signin") is not None:
            out += f" SIGNIN {_expr_sql(cfg['signin'])}"
        if cfg.get("alg") or cfg.get("key") or cfg.get("url"):
            out += " WITH JWT" + _jwt_sql(cfg)
    elif d.kind == "jwt":
        out += _jwt_sql(cfg)
    elif d.kind == "bearer" and cfg.get("for"):
        out += f" FOR {cfg['for'].upper()}"
    if cfg.get("authenticate") is not None:
        out += f" AUTHENTICATE {_expr_sql(cfg['authenticate'])}"
    # durations always printed (reference: exports stay forward compatible)
    def _dur(v, dflt):
        if v is None and dflt is not None:
            v = dflt
        if v is None:
            return "NONE"
        return v.render() if isinstance(v, Duration) else str(v)

    dur = d.duration or {}

    def slot(name, dflt):
        if name in dur:
            return _dur(dur[name], None)
        return _dur(None, dflt)

    out += " DURATION"
    if d.kind == "bearer":
        out += f" FOR GRANT {slot('grant', Duration.parse('30d'))},"
    if d.kind in ("jwt", "record", "bearer"):
        out += f" FOR TOKEN {slot('token', Duration.parse('1h'))},"
    out += f" FOR SESSION {slot('session', None)}"
    if d.comment:
        out += f" COMMENT {_str_sql(d.comment)}"
    return out


def _jwt_sql(cfg) -> str:
    """ALGORITHM/KEY clauses; symmetric verify keys and all issuer keys
    render redacted (reference catalog/schema/access.rs redacted())."""
    out = ""
    if cfg.get("url"):
        out += f" URL {_str_sql(cfg['url'])}"
        return out
    alg = (cfg.get("alg") or "HS512").upper()
    sym = alg.startswith("HS")
    key = "[REDACTED]" if sym else cfg.get("key", "")
    out += f" ALGORITHM {alg} KEY {_str_sql(key)}"
    issuer = cfg.get("issuer_key")
    if issuer is None and sym and cfg.get("key") is not None:
        issuer = cfg.get("key")
    ialg = (cfg.get("issuer_alg") or "").upper()
    if issuer is not None or ialg:
        out += " WITH ISSUER"
        if ialg:
            out += f" ALGORITHM {ialg}"
        if issuer is not None:
            out += " KEY '[REDACTED]'"
    return out


def _middleware_sql(mw) -> str:
    return ", ".join(
        f"{name}({', '.join(_expr_sql(a) for a in args)})"
        for name, args in mw
    )


def _perm_value_sql(p) -> str:
    if p is True or p is None:
        return "FULL"
    if p is False:
        return "NONE"
    return f"WHERE {_expr_sql(p)}"


def render_api(d) -> str:
    from surrealdb_tpu_torch.val import escape_string

    out = f"DEFINE API {escape_string(d.path)}"
    from surrealdb_tpu_torch.catalog import ApiActionDef

    actions = list(d.actions or [])
    if not any("any" in a.methods for a in actions):
        actions.insert(0, ApiActionDef(methods=["any"]))
    else:
        # the fallback (FOR any) always renders first
        actions.sort(key=lambda a: 0 if "any" in a.methods else 1)
    for a in actions:
        out += " FOR " + ", ".join(a.methods)
        if a.middleware:
            out += f" MIDDLEWARE {_middleware_sql(a.middleware)}"
        out += f" PERMISSIONS {_perm_value_sql(a.permissions)}"
        if a.then is not None:
            body = a.then
            from surrealdb_tpu_torch.expr.ast import (
                BlockExpr as _Blk,
                Subquery as _Sub,
            )

            if isinstance(body, _Sub) and isinstance(body.stmt, _Blk):
                body = body.stmt
            out += f" THEN {_expr_sql(body)}"
    if d.comment:
        out += f" COMMENT {_str_sql(d.comment)}"
    return out


def render_bucket(d) -> str:
    out = f"DEFINE BUCKET {escape_ident(d.name)}"
    if d.readonly:
        out += " READONLY"
    if d.backend:
        out += f" BACKEND {_str_sql(d.backend)}"
    out += f" PERMISSIONS {_perm_value_sql(d.permissions)}"
    if d.comment:
        out += f" COMMENT {_str_sql(d.comment)}"
    return out


def render_config(d) -> str:
    if d.what == "API":
        out = "API"
        if d.middleware:
            out += f" MIDDLEWARE {_middleware_sql(d.middleware)}"
        out += f" PERMISSIONS {_perm_value_sql(d.permissions)}"
        return out
    if d.what == "GRAPHQL":
        def part(v):
            if isinstance(v, tuple):
                return f"{v[0]} " + ", ".join(v[1])
            if isinstance(v, list):
                return "INCLUDE " + ", ".join(v)
            return str(v)

        out = f"GRAPHQL TABLES {part(d.tables)} FUNCTIONS {part(d.functions)}"
        if getattr(d, "depth", None) is not None:
            out += f" DEPTH {d.depth}"
        if getattr(d, "complexity", None) is not None:
            out += f" COMPLEXITY {d.complexity}"
        if getattr(d, "introspection", None) == "NONE":
            out += " INTROSPECTION NONE"
        return out
    if d.what == "DEFAULT":
        out = "DEFAULT"
        if getattr(d, "namespace", None):
            out += f" NAMESPACE {d.namespace}"
        if getattr(d, "database", None):
            out += f" DATABASE {d.database}"
        return out
    return d.what


def config_structure(d) -> dict:
    """INFO FOR DB STRUCTURE entry for one config definition."""
    from surrealdb_tpu_torch.val import NONE as _NONE

    def part(v):
        if isinstance(v, tuple):
            return {v[0].lower(): list(v[1])}
        if v == "NONE":
            return _NONE
        return v

    if d.what == "GRAPHQL":
        out = {"tables": part(d.tables), "functions": part(d.functions)}
        if getattr(d, "depth", None) is not None:
            out["depth_limit"] = d.depth
        if getattr(d, "complexity", None) is not None:
            out["complexity_limit"] = d.complexity
        if getattr(d, "introspection", None) == "NONE":
            out["introspection"] = _NONE
        return {"graphql": out}
    if d.what == "API":
        perms = getattr(d, "config", None) or {}
        return {"api": {
            "permissions": perms.get("permissions", True),
        }}
    return {d.what.lower(): {}}


def render_sequence(d) -> str:
    out = f"DEFINE SEQUENCE {escape_ident(d.name)} BATCH {d.batch} START {d.start}"
    if getattr(d, "timeout", None) is not None:
        out += f" TIMEOUT {d.timeout.render()}"
    return out
