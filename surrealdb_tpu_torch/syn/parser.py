"""SurrealQL recursive-descent parser (reference: core/src/syn/parser/).

Parses directly into surrealdb_tpu_torch.expr.ast nodes. Keywords are contextual
(not reserved): an IDENT token is compared case-insensitively at each
decision point, like the reference's keyword-as-ident handling.
"""

from __future__ import annotations

from surrealdb_tpu_torch.err import ParseError
from surrealdb_tpu_torch.expr.ast import *  # noqa: F401,F403
from surrealdb_tpu_torch.syn import lexer as L
from surrealdb_tpu_torch.val import NONE, Datetime, Duration, File, Table, Uuid

_STMT_KEYWORDS = {
    "select", "create", "update", "upsert", "delete", "insert", "relate",
    "define", "remove", "info", "let", "return", "if", "for", "use", "live",
    "kill", "show", "rebuild", "alter", "option", "sleep", "begin", "commit",
    "cancel", "break", "continue", "throw", "access", "explain",
}

_CONSTANTS = {
    "math::pi", "math::e", "math::tau", "math::inf", "math::neg_inf",
    "math::frac_1_pi", "math::frac_1_sqrt_2", "math::frac_2_pi",
    "math::frac_2_sqrt_pi", "math::frac_pi_2", "math::frac_pi_3",
    "math::frac_pi_4", "math::frac_pi_6", "math::frac_pi_8", "math::ln_10",
    "math::ln_2", "math::log10_2", "math::log10_e", "math::log2_10",
    "math::log2_e", "math::sqrt_2", "math::nan",
    "time::epoch", "time::minimum", "time::maximum",
    "duration::max",
}

_KIND_NAMES = {
    "any", "null", "none", "bool", "bytes", "datetime", "decimal", "duration",
    "float", "int", "number", "object", "point", "string", "uuid", "record",
    "geometry", "option", "either", "set", "array", "function", "regex",
    "range", "literal", "file", "references", "table",
}


def _edit_distance(a: str, b: str, cap: int = 1 << 30) -> int:
    """Levenshtein distance with an early-exit cap (did-you-mean hints)."""
    if abs(len(a) - len(b)) >= cap:
        return cap
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i]
        best = i
        for j, cb in enumerate(b, 1):
            v = min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + (ca != cb))
            cur.append(v)
            best = min(best, v)
        if best >= cap:
            return cap
        prev = cur
    return prev[-1]


class Parser:
    def __init__(self, text: str):
        self.toks = L.tokenize(text)
        self.i = 0
        self.no_graph = 0  # >0: '->' is not an idiom part (RELATE targets)

    # -- token helpers ------------------------------------------------------
    def peek(self, off=0) -> L.Token:
        j = min(self.i + off, len(self.toks) - 1)
        return self.toks[j]

    def next(self) -> L.Token:
        t = self.toks[self.i]
        if t.kind != L.EOF:
            self.i += 1
        return t

    def err(self, msg) -> ParseError:
        t = self.peek()
        return ParseError(f"{msg} (found {t.text!r})", t.line, t.col)

    def at_op(self, *ops) -> bool:
        t = self.peek()
        return t.kind == L.OP and t.text in ops

    def eat_op(self, *ops) -> bool:
        if self.at_op(*ops):
            self.next()
            return True
        return False

    def expect_op(self, op):
        if not self.eat_op(op):
            raise self.err(f"expected {op!r}")

    def at_kw(self, *words) -> bool:
        t = self.peek()
        # quoted identifiers (`value`, ⟨value⟩) are never keywords
        return (
            t.kind == L.IDENT
            and t.value.lower() in words
            and not t.text.startswith(("`", "⟨"))
        )

    def eat_kw(self, *words) -> bool:
        if self.at_kw(*words):
            self.next()
            return True
        return False

    def expect_kw(self, word):
        if not self.eat_kw(word):
            raise self.err(f"expected {word.upper()}")

    def ident(self) -> str:
        t = self.peek()
        if t.kind != L.IDENT:
            raise self.err("expected identifier")
        self.next()
        return t.value

    def ident_or_str(self) -> str:
        t = self.peek()
        if t.kind in (L.IDENT, L.STRING):
            self.next()
            return t.value
        raise self.err("expected identifier or string")

    def name_expr(self):
        """A DDL name: identifier/string, or a $param resolved when the
        statement executes (reference: parameterized schema statements,
        language-tests/tests/language/parameterized/schema/)."""
        t = self.peek()
        if t.kind == L.PARAM:
            self.next()
            return Param(t.value)
        return self.ident_or_str()

    # -- query / statements --------------------------------------------------
    def parse_query(self) -> list:
        stmts = []
        while self.eat_op(";"):
            pass
        while self.peek().kind != L.EOF:
            stmts.append(self.parse_stmt(stmt_pos=True))
            if self.peek().kind == L.EOF:
                break
            if not self.eat_op(";"):
                raise self.err("expected ';' between statements")
            while self.eat_op(";"):
                pass
        return stmts

    def parse_stmt(self, stmt_pos=False):
        t = self.peek()
        if t.kind == L.IDENT:
            kw = t.value.lower()
            m = getattr(self, f"_stmt_{kw}", None)
            if m is not None and kw in _STMT_KEYWORDS:
                return m()
        if stmt_pos and t.kind == L.PARAM and self.peek(1).kind == L.OP \
                and self.peek(1).text == "=":
            # 1.x-style `$a = 1` assignment statements are removed; only
            # flagged in true statement positions (query top level and
            # `{}` blocks) — `IF x THEN $a = 1` stays an equality check
            raise self.err(
                "Parameter declarations without `let` are deprecated. "
                "Replace with `let $a = ...` to keep the previous behavior"
            )
        return self.parse_expr()

    # -- simple statements ---------------------------------------------------
    def _stmt_use(self):
        self.next()
        ns = db = None
        while True:
            if self.eat_kw("ns", "namespace"):
                ns = self.ident_or_str()
            elif self.eat_kw("db", "database"):
                db = self.ident_or_str()
            else:
                break
        return UseStmt(ns, db)

    def _stmt_let(self):
        self.next()
        t = self.peek()
        if t.kind != L.PARAM:
            raise self.err("expected $param after LET")
        self.next()
        kind = None
        if self.at_op(":"):
            self.next()
            kind = self.parse_kind()
        self.expect_op("=")
        return LetStmt(t.value, self.parse_expr(), kind)

    def _stmt_return(self):
        self.next()
        what = self.parse_expr()
        fetch = []
        if self.eat_kw("fetch"):
            fetch = self._idiom_list()
        return ReturnStmt(what, fetch)

    def _stmt_break(self):
        self.next()
        return BreakStmt()

    def _stmt_continue(self):
        self.next()
        return ContinueStmt()

    def _stmt_throw(self):
        self.next()
        return ThrowStmt(self.parse_expr())

    def _stmt_begin(self):
        self.next()
        self.eat_kw("transaction")
        return BeginStmt()

    def _stmt_commit(self):
        self.next()
        self.eat_kw("transaction")
        return CommitStmt()

    def _stmt_cancel(self):
        self.next()
        self.eat_kw("transaction")
        return CancelStmt()

    def _stmt_option(self):
        self.next()
        name = self.ident()
        val = True
        if self.eat_op("="):
            if self.eat_kw("false"):
                val = False
            else:
                self.eat_kw("true")
        return OptionStmt(name, val)

    def _stmt_sleep(self):
        self.next()
        return SleepStmt(self.parse_expr())

    def _stmt_if(self):
        return self._parse_if()

    def _stmt_for(self):
        self.next()
        t = self.peek()
        if t.kind != L.PARAM:
            raise self.err("expected $param after FOR")
        self.next()
        self.expect_kw("in")
        rng = self.parse_expr()
        body = self._parse_block()
        return ForStmt(t.value, rng, body)

    def _parse_if(self):
        self.expect_kw("if")
        branches = []
        otherwise = None
        while True:
            cond = self.parse_expr()
            if self.eat_kw("then"):  # legacy syntax
                body = self.parse_stmt()
                branches.append((cond, body))
                self.eat_op(";")
                if self.eat_kw("else"):
                    if self.eat_kw("if"):
                        continue
                    otherwise = self.parse_stmt()
                    self.eat_op(";")
                self.eat_kw("end")
                break
            body = self._parse_block()
            branches.append((cond, body))
            if self.eat_kw("else"):
                if self.eat_kw("if"):
                    continue
                otherwise = self._parse_block()
            break
        return IfElse(branches, otherwise)

    def _parse_block(self):
        if not self.at_op("{"):
            raise self.err("expected '{'")
        self.next()
        stmts = []
        while self.eat_op(";"):
            pass
        while not self.at_op("}"):
            stmts.append(self.parse_stmt(stmt_pos=True))
            if not self.eat_op(";"):
                # the reference's block parser accepts a new statement
                # keyword as an implicit separator (fetch/objects.surql)
                t = self.peek()
                if t.kind == L.IDENT and t.value.lower() in _STMT_KEYWORDS \
                        and not t.text.startswith(("`", "⟨")):
                    continue
                break
            while self.eat_op(";"):
                pass
        self.expect_op("}")
        return BlockExpr(stmts)

    # -- SELECT ---------------------------------------------------------------
    def _stmt_explain(self):
        """EXPLAIN [FULL|ANALYZE] <statement> — statement-prefix form."""
        self.next()
        mode = True
        if self.eat_kw("full"):
            mode = "full"
        elif self.eat_kw("analyze"):
            mode = "analyze"
        json_fmt = False
        if self.eat_kw("format"):
            self.expect_kw("json")
            json_fmt = True
        if self.at_kw("select"):
            sel = self._stmt_select()
            if json_fmt:
                sel.explain = (
                    "analyze-json" if mode == "analyze" else "json"
                )
            else:
                sel.explain = mode
            return sel
        inner = self.parse_stmt()
        return ExplainStmt(inner, mode == "analyze")

    def _stmt_select(self):
        self.next()
        s = SelectStmt(exprs=[], what=[])
        if self.eat_kw("value"):
            s.value = self.parse_expr()
            if self.eat_kw("as"):
                s.value_alias = self._alias_idiom()
        else:
            s.exprs = self._select_fields()
        if self.eat_kw("omit"):
            s.omit = self._idiom_list()
        self.expect_kw("from")
        s.only = self.eat_kw("only")
        s.what = [self.parse_expr()]
        while self.eat_op(","):
            s.what.append(self.parse_expr())
        if self.eat_kw("with"):
            if self.eat_kw("noindex"):
                s.with_index = []
            elif self.eat_kw("no"):
                self.expect_kw("index")
                s.with_index = []
            else:
                self.expect_kw("index")
                s.with_index = [self.ident()]
                while self.eat_op(","):
                    s.with_index.append(self.ident())
        while True:
            if self.eat_kw("where"):
                s.cond = self.parse_expr()
            elif self.eat_kw("split"):
                self.eat_kw("on")
                s.split = self._idiom_list()
            elif self.eat_kw("group"):
                if self.eat_kw("all"):
                    s.group = []
                else:
                    self.eat_kw("by")
                    s.group = self._idiom_list()
            elif self.eat_kw("order"):
                self.eat_kw("by")
                if (
                    self.at_kw("rand")
                    and self.peek(1).kind == L.OP
                    and self.peek(1).text == "("
                ):
                    self.next()
                    self.expect_op("(")
                    self.expect_op(")")
                    s.order = "rand"
                else:
                    s.order = [self._order_item()]
                    while self.eat_op(","):
                        s.order.append(self._order_item())
            elif self.eat_kw("limit"):
                self.eat_kw("by")
                s.limit = self.parse_expr()
            elif self.eat_kw("start"):
                self.eat_kw("at")
                s.start = self.parse_expr()
            elif self.eat_kw("fetch"):
                s.fetch = self._idiom_list()
            elif self.eat_kw("field"):
                s.ref_field = self.ident()
            elif self.eat_kw("version"):
                s.version = self.parse_expr()
            elif self.eat_kw("timeout"):
                s.timeout = self.parse_expr()
            elif self.eat_kw("parallel"):
                s.parallel = True
            elif self.at_kw("read") and self.peek(1).kind == L.IDENT \
                    and str(self.peek(1).value).lower() == "at":
                # READ AT <duration>: bounded-staleness follower read
                self.next()
                self.next()
                s.read_at = self.parse_expr()
            elif self.eat_kw("tempfiles"):
                s.tempfiles = True
            elif self.eat_kw("explain"):
                # postfix EXPLAIN [FULL]: under the streaming strategy it
                # rewrites to the JSON format (explain/select_explain_rewrite)
                if self.eat_kw("full"):
                    s.explain = "postfix-full"
                elif self.eat_kw("analyze"):
                    s.explain = "analyze"
                else:
                    s.explain = "postfix"
            else:
                break
        if s.split and s.group is not None:
            raise self.err("SPLIT cannot be combined with GROUP BY")
        self._check_clause_idioms(s)
        return s

    def _check_clause_idioms(self, s):
        """SPLIT/GROUP/ORDER idioms must appear in the selection (reference
        syn/parser/stmt/parts.rs check_idiom; GROUP allows prefix matches,
        ORDER on a VALUE selector runs on the full row)."""
        from surrealdb_tpu_torch.expr.ast import Idiom

        if any(e == "*" for e, _a in s.exprs):
            return

        def _name(expr):
            from surrealdb_tpu_torch.exec.statements import expr_name

            try:
                return expr_name(expr)
            except Exception:
                return None

        def _found(idiom, prefix_ok):
            text = _name(idiom)
            if text is None:
                return True
            if s.value is not None:
                fields = [(s.value, None)]
            else:
                fields = s.exprs
            for e, a in fields:
                if a is not None and (a == text or (
                        prefix_ok and a.startswith(text + "."))):
                    return True
                ft = _name(e)
                if ft is None:
                    continue
                if ft == text or (prefix_ok and ft.startswith(text + ".")):
                    return True
            return False

        for sp in s.split or []:
            if not _found(sp, False):
                raise ParseError(
                    f"Missing split idiom `{_name(sp)}` in statement "
                    "selection", 0, 0)
        for g in s.group or []:
            if isinstance(g, Idiom) or True:
                if not _found(g, True):
                    raise ParseError(
                        f"Missing group idiom `{_name(g)}` in statement "
                        "selection", 0, 0)
        if isinstance(s.order, list) and s.value is None:
            for item in s.order:
                if not _found(item[0], False):
                    raise ParseError(
                        f"Missing order idiom `{_name(item[0])}` in "
                        "statement selection", 0, 0)

    def _select_fields(self):
        fields = []
        while True:
            if self.at_op("*"):
                self.next()
                fields.append(("*", None))
            else:
                e = self.parse_expr()
                alias = None
                if self.eat_kw("as"):
                    alias = self._alias_idiom()
                fields.append((e, alias))
            if not self.eat_op(","):
                break
        return fields

    def _alias_idiom(self):
        parts = [self.ident()]
        while self.at_op(".") and self.peek(1).kind == L.IDENT:
            self.next()
            parts.append(self.ident())
        return ".".join(parts)

    def _order_item(self):
        e = self._parse_idiom_expr()
        collate = self.eat_kw("collate")
        numeric = self.eat_kw("numeric")
        direction = "asc"
        if self.eat_kw("desc"):
            direction = "desc"
        else:
            self.eat_kw("asc")
        return (e, direction, collate, numeric)

    def _idiom_list(self):
        out = [self._parse_idiom_expr()]
        while self.eat_op(","):
            out.append(self._parse_idiom_expr())
        return out

    def _parse_idiom_expr(self):
        """An idiom in clause position (ORDER BY x.y, FETCH a.b, GROUP BY)."""
        return self.parse_expr()

    # -- data-modifying statements -------------------------------------------
    def _targets(self):
        out = [self.parse_expr()]
        while self.eat_op(","):
            out.append(self.parse_expr())
        return out

    def _parse_data(self):
        if self.eat_kw("set"):
            items = [self._assignment()]
            while self.eat_op(","):
                items.append(self._assignment())
            return SetData(items)
        if self.eat_kw("unset"):
            fields = self._idiom_list()
            return UnsetData(fields)
        if self.eat_kw("content"):
            return ContentData(self.parse_expr())
        if self.eat_kw("replace"):
            return ReplaceData(self.parse_expr())
        if self.eat_kw("merge"):
            return MergeData(self.parse_expr())
        if self.eat_kw("patch"):
            return PatchData(self.parse_expr())
        return None

    def _assignment(self):
        target = self._parse_postfix(self._parse_primary())
        if self.at_op("=", "+=", "-=", "+?="):
            op = self.next().text
        elif self.at_op("*") and self.peek(1).text == "=":
            self.next()
            self.next()
            op = "*="
        else:
            raise self.err("expected assignment operator")
        return (target, op, self.parse_expr())

    def _parse_output(self):
        if not self.eat_kw("return"):
            return None
        if self.eat_kw("none"):
            return OutputClause("none")
        if self.eat_kw("null"):
            return OutputClause("null")
        if self.eat_kw("diff"):
            return OutputClause("diff")
        if self.eat_kw("before"):
            return OutputClause("before")
        if self.eat_kw("after"):
            return OutputClause("after")
        if self.eat_kw("value"):
            return OutputClause("value", [(self.parse_expr(), None)])
        return OutputClause("fields", self._select_fields())

    def _tail_clauses(self, stmt, where=True):
        while True:
            if where and self.eat_kw("where"):
                stmt.cond = self.parse_expr()
            elif self.at_kw("return"):
                stmt.output = self._parse_output()
            elif self.eat_kw("timeout"):
                stmt.timeout = self.parse_expr()
            elif self.eat_kw("parallel"):
                stmt.parallel = True
            elif hasattr(stmt, "version") and self.eat_kw("version"):
                stmt.version = self.parse_expr()
            elif hasattr(stmt, "explain") and self.eat_kw("explain"):
                stmt.explain = "full" if self.eat_kw("full") else True
            else:
                break

    def _stmt_create(self):
        self.next()
        only = self.eat_kw("only")
        what = self._targets()
        data = self._parse_data()
        s = CreateStmt(what, data, only=only)
        self._tail_clauses(s, where=False)
        return s

    def _stmt_update(self):
        self.next()
        only = self.eat_kw("only")
        what = self._targets()
        data = self._parse_data()
        s = UpdateStmt(what, data, only=only)
        self._tail_clauses(s)
        return s

    def _stmt_upsert(self):
        self.next()
        only = self.eat_kw("only")
        what = self._targets()
        data = self._parse_data()
        s = UpsertStmt(what, data, only=only)
        self._tail_clauses(s)
        return s

    def _stmt_delete(self):
        self.next()
        only = self.eat_kw("only")
        self.eat_kw("from")
        what = self._targets()
        s = DeleteStmt(what, only=only)
        self._tail_clauses(s)
        return s

    def _stmt_insert(self):
        self.next()
        ignore = relation = False
        while True:
            if not ignore and self.eat_kw("ignore"):
                ignore = True
            elif not relation and self.eat_kw("relation"):
                relation = True
            else:
                break
        into = None
        if self.eat_kw("into"):
            t = self.peek()
            if t.kind == L.IDENT:
                self.next()
                into = Literal(Table(t.value))
            else:
                into = self.parse_expr()
        if self.at_op("(") and self._peek2_is_kw(
            "select", "create", "update", "delete", "insert", "return"
        ):
            # INSERT INTO t (SELECT ...) — parenthesized subquery source
            data = self.parse_expr()
            return self._insert_finish(into, data, ignore, relation)
        if self.at_op("("):
            # INSERT INTO t (a, b) VALUES (1, 2), (3, 4)
            self.next()
            fields = self._idiom_list()
            self.expect_op(")")
            self.expect_kw("values")
            rows = []
            while True:
                self.expect_op("(")
                row = [self.parse_expr()]
                while self.eat_op(","):
                    row.append(self.parse_expr())
                self.expect_op(")")
                rows.append(row)
                if not self.eat_op(","):
                    break
            data = InsertRows(fields, rows)
        else:
            data = self.parse_expr()
        return self._insert_finish(into, data, ignore, relation)

    def _peek2_is_kw(self, *words) -> bool:
        t = self.toks[self.i + 1] if self.i + 1 < len(self.toks) else None
        return (
            t is not None
            and t.kind == L.IDENT
            and t.value.lower() in words
            and not t.text.startswith(("`", "⟨"))
        )

    def _insert_finish(self, into, data, ignore, relation):
        update = None
        if self.eat_kw("on"):
            self.expect_kw("duplicate")
            self.expect_kw("key")
            self.expect_kw("update")
            update = [self._assignment()]
            while self.eat_op(","):
                update.append(self._assignment())
        s = InsertStmt(into, data, ignore=ignore, update=update, relation=relation)
        if self.at_kw("return"):
            s.output = self._parse_output()
        if self.eat_kw("version"):
            s.version = self.parse_expr()
        return s

    def _stmt_relate(self):
        self.next()
        only = self.eat_kw("only")
        self.no_graph += 1
        try:
            first = self.parse_expr()
            if self.at_op("->"):
                self.next()
                kind = self.parse_expr()
                self.expect_op("->")
                to = self.parse_expr()
                from_ = first
            elif self.at_op("<-"):
                self.next()
                kind = self.parse_expr()
                self.expect_op("<-")
                from_ = self.parse_expr()
                to = first
            else:
                raise self.err("expected -> or <- in RELATE")
        finally:
            self.no_graph -= 1
        uniq = self.eat_kw("unique")
        data = self._parse_data()
        s = RelateStmt(kind, from_, to, uniq=uniq, data=data, only=only)
        self._tail_clauses(s, where=False)
        return s

    # -- LIVE / KILL / SHOW ---------------------------------------------------
    def _stmt_live(self):
        self.next()
        self.expect_kw("select")
        if self.eat_kw("diff"):
            expr = "diff"
        elif self.eat_kw("value"):
            expr = [(self.parse_expr(), None)]
        else:
            expr = self._select_fields()
        self.expect_kw("from")
        what = self.parse_expr()
        cond = None
        fetch = []
        if self.eat_kw("where"):
            cond = self.parse_expr()
        if self.eat_kw("fetch"):
            fetch = self._idiom_list()
        return LiveStmt(expr, what, cond, fetch)

    def _stmt_kill(self):
        self.next()
        return KillStmt(self.parse_expr())

    def _stmt_show(self):
        self.next()
        self.expect_kw("changes")
        self.expect_kw("for")
        table = None
        if self.eat_kw("table"):
            table = self.ident_or_str()
        else:
            self.expect_kw("database")
        self.expect_kw("since")
        since = self.parse_expr()
        limit = None
        if self.eat_kw("limit"):
            limit = self.parse_expr()
        return ShowStmt(table, since, limit)

    def _stmt_rebuild(self):
        self.next()
        self.expect_kw("index")
        if_exists = False
        if self.eat_kw("if"):
            self.expect_kw("exists")
            if_exists = True
        name = self.ident()
        self.expect_kw("on")
        self.eat_kw("table")
        tb = self.ident()
        return RebuildIndex(name, tb, if_exists)

    # deprecated 2.x paths that renamed in 3.x (reference path-hint table)
    _DEPRECATED_FN = {
        "type::thing": "type::record",
        "rand::uuid::v4": "rand::uuid",
        "meta::id": "record::id",
        "meta::tb": "record::tb",
    }

    def _check_function_path(self, full: str):
        """Built-in function paths validate at PARSE time with
        did-you-mean hints (reference syn function-path checking);
        fn::/mod::/ml::/api:: and internal markers stay dynamic."""
        low = full.lower()
        head = low.split("::", 1)[0]
        if head in ("fn", "ml", "api") or low.startswith("__"):
            return
        if head == "mod":
            caps = getattr(self, "capabilities", None)
            allowed = caps is not None and caps.allows_experimental(
                "surrealism"
            )
            if not allowed:
                raise self.err(
                    "Experimental capability `surrealism` is not enabled"
                )
            return
        from surrealdb_tpu_torch.fnc import ARITY, FUNCS

        if low in FUNCS or low in ARITY:
            return
        hint = self._DEPRECATED_FN.get(low)
        if hint is None:
            best, bd = None, 1 << 30
            for cand in FUNCS:
                if "::" not in cand or cand.startswith("__"):
                    continue
                d = _edit_distance(low, cand, bd)
                if d < bd:
                    best, bd = cand, d
            hint = best if best is not None and bd <= 3 else None
        if hint is not None:
            raise self.err(
                f"Invalid function/constant path, did you maybe mean "
                f"`{hint}`"
            )
        raise self.err("Invalid function/constant path")

    def _stmt_access(self):
        self.next()
        name = self.ident()
        base = None
        if self.eat_kw("on"):
            if self.eat_kw("root"):
                base = "root"
            elif self.eat_kw("namespace", "ns"):
                base = "ns"
            elif self.eat_kw("database", "db"):
                base = "db"
            else:
                raise self.err("expected ROOT, NAMESPACE or DATABASE")
        if self.eat_kw("grant"):
            self.expect_kw("for")
            if self.eat_kw("user"):
                subject = ("user", self.ident())
            elif self.eat_kw("record"):
                subject = ("record", self.parse_expr())
            else:
                raise self.err("expected USER or RECORD")
            return AccessStmt(name, base, "grant", subject)
        op = "show" if self.eat_kw("show") else (
            "revoke" if self.eat_kw("revoke") else None
        )
        if op is not None:
            if self.eat_kw("all"):
                sel = ("all", None)
            elif self.eat_kw("grant"):
                sel = ("grant", self.ident_or_str())
            elif self.eat_kw("where"):
                sel = ("where", self.parse_expr())
            else:
                raise self.err("expected ALL, GRANT or WHERE")
            return AccessStmt(name, base, op, selector=sel)
        if self.eat_kw("purge"):
            kinds = set()
            while True:
                if self.eat_kw("expired"):
                    kinds.add("expired")
                elif self.eat_kw("revoked"):
                    kinds.add("revoked")
                else:
                    raise self.err("expected EXPIRED or REVOKED")
                if not self.eat_op(","):
                    break
            grace = self.parse_expr() if self.eat_kw("for") else None
            return AccessStmt(name, base, "purge", purge=(kinds, grace))
        raise self.err("expected GRANT, SHOW, REVOKE or PURGE")

    # -- INFO -----------------------------------------------------------------
    def _stmt_info(self):
        self.next()
        self.expect_kw("for")
        if self.eat_kw("system", "sys"):
            s = InfoStmt("system")
        elif self.eat_kw("root", "kv"):
            s = InfoStmt("root")
        elif self.eat_kw("ns", "namespace"):
            s = InfoStmt("ns")
        elif self.eat_kw("db", "database"):
            s = InfoStmt("db")
            if self.eat_kw("version"):
                s.version = self.parse_expr()
        elif self.eat_kw("table", "tb"):
            s = InfoStmt("table", self.name_expr())
        elif self.eat_kw("user"):
            s = InfoStmt("user", self.name_expr())
            if self.eat_kw("on"):
                s.target2 = self.ident()
        elif self.eat_kw("index"):
            name = self.name_expr()
            self.expect_kw("on")
            self.eat_kw("table")
            s = InfoStmt("index", name, self.name_expr())
        else:
            raise self.err("expected INFO target")
        if self.eat_kw("version"):
            s.version = self.parse_expr()
        if self.eat_kw("structure"):
            s.structure = True
        return s

    # -- DEFINE ---------------------------------------------------------------
    def _def_flags(self):
        if_not_exists = overwrite = False
        if self.eat_kw("if"):
            self.expect_kw("not")
            self.expect_kw("exists")
            if_not_exists = True
        elif self.eat_kw("overwrite"):
            overwrite = True
        return if_not_exists, overwrite

    def _stmt_define(self):
        self.next()
        if self.eat_kw("namespace", "ns"):
            ine, ow = self._def_flags()
            d = DefineNamespace(self.name_expr(), ine, ow)
            if self.eat_kw("comment"):
                d.comment = self._comment_value()
            return d
        if self.eat_kw("database", "db"):
            ine, ow = self._def_flags()
            d = DefineDatabase(self.name_expr(), ine, ow)
            while True:
                if self.eat_kw("strict"):
                    d.strict = True
                elif self.eat_kw("comment"):
                    d.comment = self._comment_value()
                elif self.eat_kw("changefeed"):
                    d.changefeed = self.parse_expr()
                    self.eat_kw("include") and self.expect_kw("original")
                else:
                    break
            return d
        if self.eat_kw("table", "tb"):
            return self._define_table()
        if self.eat_kw("field", "fd"):
            return self._define_field()
        if self.eat_kw("index", "ix"):
            return self._define_index()
        if self.eat_kw("event", "ev"):
            return self._define_event()
        if self.eat_kw("param"):
            ine, ow = self._def_flags()
            t = self.peek()
            if t.kind != L.PARAM:
                raise self.err("expected $param")
            self.next()
            perms = None
            comment = None
            value = None
            while True:
                if self.eat_kw("value"):
                    value = self.parse_expr()
                elif self.eat_kw("permissions"):
                    perms = self._parse_permissions_value()
                elif self.eat_kw("comment"):
                    comment = self._comment_value()
                else:
                    break
            if value is None:
                # VALUE is optional (upgrade/define/param): defaults NONE
                value = Literal(NONE)
            return DefineParam(t.value, value, ine, ow, perms, comment)
        if self.eat_kw("function", "fn"):
            return self._define_function()
        if self.eat_kw("analyzer"):
            return self._define_analyzer()
        if self.eat_kw("user"):
            return self._define_user()
        if self.eat_kw("access"):
            return self._define_access()
        if self.eat_kw("module"):
            return self._define_module()
        if self.eat_kw("sequence"):
            ine, ow = self._def_flags()
            name = self.name_expr()
            d = DefineSequence(name, if_not_exists=ine, overwrite=ow)
            while True:
                if self.eat_kw("batch"):
                    d.batch = (Param(self.next().value)
                               if self.peek().kind == L.PARAM
                               else self._signed_int())
                elif self.eat_kw("start"):
                    d.start = (Param(self.next().value)
                               if self.peek().kind == L.PARAM
                               else self._signed_int())
                elif self.eat_kw("timeout"):
                    d.timeout = self.parse_expr()
                else:
                    break
            return d
        if self.eat_kw("api"):
            return self._parse_define_api()
        if self.eat_kw("bucket"):
            ine, ow = self._def_flags()
            name = self.name_expr()
            cfg = {"name": name, "backend": None, "readonly": False,
                   "permissions": True, "comment": None}
            while True:
                if self.eat_kw("backend"):
                    cfg["backend"] = self.ident_or_str()
                elif self.eat_kw("readonly"):
                    cfg["readonly"] = True
                elif self.eat_kw("comment"):
                    cfg["comment"] = self._comment_value()
                elif self.eat_kw("permissions"):
                    cfg["permissions"] = self._parse_permissions_value()
                else:
                    break
            return DefineConfig("BUCKET", cfg, ine, ow)
        if self.eat_kw("config"):
            ine, ow = self._def_flags()
            what = self.ident().upper()
            cfg = self._config_spec(what)
            return DefineConfig(what, cfg, ine, ow)
        raise self.err("unknown DEFINE target")

    def _config_spec(self, what):
        """The clause grammar shared by DEFINE CONFIG and ALTER CONFIG."""
        cfg = {}
        if what == "DEFAULT":
            while True:
                if self.eat_kw("namespace", "ns"):
                    cfg["namespace"] = self.name_expr()
                elif self.eat_kw("database", "db"):
                    cfg["database"] = self.name_expr()
                else:
                    break
            return cfg

        def _name_list():
            inc = [self.ident()]
            while self.eat_op(","):
                inc.append(self.ident())
            return inc

        while True:
            if self.eat_kw("middleware"):
                cfg["middleware"] = self._parse_middleware()
            elif self.eat_kw("permissions"):
                cfg["permissions"] = self._parse_permissions_value()
            elif self.eat_kw("auto"):
                # bare AUTO sets both tables and functions
                cfg["tables"] = "AUTO"
                cfg["functions"] = "AUTO"
            elif self.eat_kw("none"):
                cfg["tables"] = "NONE"
                cfg["functions"] = "NONE"
            elif self.eat_kw("tables"):
                if self.eat_kw("auto"):
                    cfg["tables"] = "AUTO"
                elif self.eat_kw("none"):
                    cfg["tables"] = "NONE"
                elif self.eat_kw("include"):
                    cfg["tables"] = ("INCLUDE", _name_list())
                elif self.eat_kw("exclude"):
                    cfg["tables"] = ("EXCLUDE", _name_list())
            elif self.eat_kw("functions"):
                if self.eat_kw("auto"):
                    cfg["functions"] = "AUTO"
                elif self.eat_kw("none"):
                    cfg["functions"] = "NONE"
                elif self.eat_kw("include"):
                    cfg["functions"] = ("INCLUDE", _name_list())
                elif self.eat_kw("exclude"):
                    cfg["functions"] = ("EXCLUDE", _name_list())
            elif self.eat_kw("depth"):
                cfg["depth"] = self.next().value
            elif self.eat_kw("complexity"):
                cfg["complexity"] = self.next().value
            elif self.eat_kw("introspection"):
                if self.eat_kw("auto"):
                    cfg["introspection"] = "AUTO"
                elif self.eat_kw("none"):
                    cfg["introspection"] = "NONE"
            else:
                break
        return cfg

    def _define_table(self):
        ine, ow = self._def_flags()
        d = DefineTable(self.name_expr(), ine, ow)
        while True:
            if self.eat_kw("drop"):
                d.drop = True
            elif self.eat_kw("schemafull", "schemaful"):
                d.full = True
            elif self.eat_kw("schemaless"):
                d.full = False
            elif self.eat_kw("type"):
                if self.eat_kw("any"):
                    d.kind = "any"
                elif self.eat_kw("normal"):
                    d.kind = "normal"
                elif self.eat_kw("relation"):
                    d.kind = "relation"
                    while True:
                        if self.eat_kw("in", "from"):
                            d.relation_from = [self.ident()]
                            while self.eat_op("|"):
                                d.relation_from.append(self.ident())
                        elif self.eat_kw("out", "to"):
                            d.relation_to = [self.ident()]
                            while self.eat_op("|"):
                                d.relation_to.append(self.ident())
                        elif self.eat_kw("enforced"):
                            d.enforced = True
                        else:
                            break
            elif self.eat_kw("relation"):
                d.kind = "relation"
            elif self.eat_kw("as"):
                if self.at_op("("):
                    self.next()
                    d.view = self.parse_stmt()
                    self.expect_op(")")
                else:
                    d.view = self.parse_stmt()
            elif self.eat_kw("changefeed"):
                d.changefeed = self.parse_expr()
                if self.eat_kw("include"):
                    self.expect_kw("original")
            elif self.eat_kw("permissions"):
                d.permissions = self._parse_permissions()
            elif self.eat_kw("comment"):
                d.comment = self._comment_value()
            else:
                break
        return d

    def _define_field(self):
        ine, ow = self._def_flags()
        if self.peek().kind == L.PARAM:
            name = Param(self.next().value)
        else:
            name = self._field_name_parts()
        self.expect_kw("on")
        self.eat_kw("table")
        tb = self.name_expr()
        d = DefineField(name, tb, ine, ow)
        while True:
            if self.at_kw("flexible", "flexi", "flex"):
                if d.kind is None:
                    raise self.err("FLEXIBLE must be specified after TYPE")
                if not self._kind_has_object(d.kind):
                    raise self.err(
                        "FLEXIBLE can only be used with types containing "
                        "object"
                    )
                self.next()
                d.flex = True
            elif self.eat_kw("type"):
                d.kind = self.parse_kind()
            elif self.eat_kw("readonly"):
                d.readonly = True
            elif self.eat_kw("value"):
                d.value = self.parse_expr()
            elif self.eat_kw("assert"):
                d.assert_ = self.parse_expr()
            elif self.eat_kw("computed"):
                d.computed = self.parse_expr()
            elif self.eat_kw("default"):
                d.default_always = self.eat_kw("always")
                d.default = self.parse_expr()
            elif self.eat_kw("permissions"):
                d.permissions = self._parse_permissions(no_delete=True)
            elif self.eat_kw("reference"):
                d.reference = self._parse_reference()
            elif self.eat_kw("comment"):
                d.comment = self._comment_value()
            else:
                break
        return d

    def _parse_reference(self):
        ref = {"on_delete": "ignore"}
        if self.eat_kw("on"):
            self.expect_kw("delete")
            if self.eat_kw("reject"):
                ref["on_delete"] = "reject"
            elif self.eat_kw("cascade"):
                ref["on_delete"] = "cascade"
            elif self.eat_kw("ignore"):
                ref["on_delete"] = "ignore"
            elif self.eat_kw("unset"):
                ref["on_delete"] = "unset"
            elif self.eat_kw("then"):
                ref["on_delete"] = "then"
                ref["then"] = self.parse_expr()
        return ref

    def _parse_middleware(self):
        """MIDDLEWARE name::path(args) [, ...] -> [(name, [arg exprs])]"""
        out = []
        while True:
            parts = [self.ident()]
            while self.eat_op("::"):
                parts.append(self.ident())
            args = []
            if self.at_op("("):
                self.next()
                while not self.at_op(")"):
                    args.append(self.parse_expr())
                    if not self.eat_op(","):
                        break
                self.expect_op(")")
            out.append(("::".join(parts), args))
            if not self.eat_op(","):
                break
        return out

    def _parse_define_api(self):
        ine, ow = self._def_flags()
        path = self.name_expr()
        actions = []
        comment = None
        while True:
            if self.eat_kw("for"):
                methods = [self.ident().lower()]
                while self.eat_op(","):
                    methods.append(self.ident().lower())
                action = {"methods": methods, "middleware": [],
                          "permissions": True, "then": None}
                while True:
                    if self.eat_kw("middleware"):
                        action["middleware"] = self._parse_middleware()
                    elif self.eat_kw("permissions"):
                        action["permissions"] = self._parse_permissions_value()
                    elif self.eat_kw("then"):
                        action["then"] = self.parse_expr()
                    else:
                        break
                actions.append(action)
            elif self.eat_kw("then"):
                actions.append({"methods": ["any"], "middleware": [],
                                "permissions": True,
                                "then": self.parse_expr()})
            elif self.eat_kw("middleware"):
                actions.append({"methods": ["any"],
                                "middleware": self._parse_middleware(),
                                "permissions": True, "then": None})
            elif self.eat_kw("permissions"):
                if actions:
                    actions[-1]["permissions"] = self._parse_permissions_value()
                else:
                    self._parse_permissions_value()
            elif self.eat_kw("comment"):
                comment = self._comment_value()
            else:
                break
        return DefineConfig(
            "API_DEF",
            {"path": path, "actions": actions, "comment": comment},
            ine, ow,
        )

    def _field_name_parts(self):
        """Field name as idiom parts: a.b.c, a[*], a.*, a..."""
        parts = [PField(self.ident_or_str())]
        while True:
            if self.at_op("..."):
                self.next()
                parts.append(PFlatten())
            elif self.at_op(".") :
                self.next()
                if self.at_op("*"):
                    self.next()
                    parts.append(PAll())
                else:
                    parts.append(PField(self.ident_or_str()))
            elif self.at_op("["):
                self.next()
                if self.at_op("*"):
                    self.next()
                    parts.append(PAll())
                    self.expect_op("]")
                elif self.peek().kind == L.INT:
                    parts.append(PIndex(Literal(self.next().value)))
                    self.expect_op("]")
                else:
                    raise self.err("expected [*] in field name")
            else:
                break
        return parts

    def _define_index(self):
        ine, ow = self._def_flags()
        name = self.name_expr()
        self.expect_kw("on")
        self.eat_kw("table")
        tb = self.name_expr()
        d = DefineIndex(name, tb, [], ine, ow)
        if self.eat_kw("fields", "columns"):
            d.cols = self._idiom_list()
        while True:
            if self.eat_kw("unique"):
                d.unique = True
            elif self.eat_kw("count"):
                d.count = True
                if self.eat_kw("where"):
                    # conditional count index (COUNT WHERE cond)
                    d.count_cond = self.parse_expr()
            elif self.eat_kw("search", "fulltext"):
                ft = {"analyzer": None, "bm25": (1.2, 0.75), "highlights": False}
                while True:
                    if self.eat_kw("analyzer"):
                        ft["analyzer"] = self.ident()
                    elif self.eat_kw("bm25"):
                        if self.at_op("("):
                            self.next()
                            k1 = float(self.next().value)
                            self.eat_op(",")
                            b = float(self.next().value)
                            self.expect_op(")")
                            ft["bm25"] = (k1, b)
                        elif self.peek().kind in (L.FLOAT, L.INT):
                            k1 = float(self.next().value)
                            self.eat_op(",")
                            b = float(self.next().value)
                            ft["bm25"] = (k1, b)
                    elif self.eat_kw("highlights"):
                        ft["highlights"] = True
                    elif self.eat_kw("doc_ids_order", "doc_ids_cache",
                                     "doc_lengths_order", "doc_lengths_cache",
                                     "postings_order", "postings_cache",
                                     "terms_order", "terms_cache"):
                        self.next()  # legacy knobs: swallow value
                    else:
                        break
                d.fulltext = ft
            elif self.eat_kw("hnsw", "mtree"):
                h = {
                    "dimension": None, "distance": "euclidean", "vector_type": "f32",
                    "m": 12, "m0": 24, "ml": None, "ef_construction": 150,
                    "extend_candidates": False, "keep_pruned_connections": False,
                    "capacity": 40,
                }
                while True:
                    if self.eat_kw("dimension"):
                        h["dimension"] = self.next().value
                    elif self.eat_kw("dist", "distance"):
                        h["distance"] = self._parse_distance()
                    elif self.eat_kw("type"):
                        h["vector_type"] = self.ident().lower()
                    elif self.eat_kw("efc"):
                        h["ef_construction"] = self.next().value
                    elif self.eat_kw("m"):
                        h["m"] = self.next().value
                    elif self.eat_kw("m0"):
                        h["m0"] = self.next().value
                    elif self.eat_kw("lm", "ml"):
                        h["ml"] = float(self.next().value)
                    elif self.eat_kw("capacity"):
                        h["capacity"] = self.next().value
                    elif self.eat_kw("extend_candidates"):
                        h["extend_candidates"] = True
                    elif self.eat_kw("keep_pruned_connections"):
                        h["keep_pruned_connections"] = True
                    elif self.eat_kw("hashed_vector"):
                        # dedupe vectors by hash in the doc map
                        # (reference define.rs t!("HASHED_VECTOR"))
                        h["use_hashed_vector"] = True
                    else:
                        break
                d.hnsw = h
            elif self.eat_kw("concurrently"):
                d.concurrently = True
            elif self.eat_kw("comment"):
                d.comment = self._comment_value()
            else:
                break
        # reference define.rs index validation (parse-time)
        if d.count and d.cols:
            raise self.err(
                "Count indexes do not index fields - remove the FIELDS "
                "clause"
            )
        if not d.cols and not d.count:
            raise self.err(
                "Expected at least one column - Use FIELDS to define columns"
            )
        if getattr(d, "fulltext", None) and len(d.cols) > 1:
            raise self.err(
                "Fulltext indexes can only index a single field"
            )
        return d

    def _parse_distance(self):
        name = self.ident().lower()
        if name == "minkowski":
            order = self.next().value
            return ("minkowski", order)
        return name

    def _define_event(self):
        ine, ow = self._def_flags()
        name = self.name_expr()
        self.expect_kw("on")
        self.eat_kw("table")
        tb = self.name_expr()
        when = None
        then = []
        comment = None
        async_ = False
        retry = None
        maxdepth = None
        while True:
            if self.eat_kw("async"):
                async_ = True
            elif self.at_kw("retry"):
                if not async_:
                    raise self.err("Unexpected token `RETRY`")
                self.next()
                if self.peek().kind != L.INT:
                    raise self.err("expected an integer RETRY count")
                retry = self.next().value
            elif self.at_kw("maxdepth"):
                if not async_:
                    raise self.err("Unexpected token `MAXDEPTH`")
                self.next()
                if self.peek().kind != L.INT:
                    raise self.err("expected an integer MAXDEPTH")
                maxdepth = self.next().value
            elif self.eat_kw("when"):
                when = self.parse_expr()
            elif self.eat_kw("then"):
                if self.at_op("("):
                    self.next()
                    then = [self.parse_stmt()]
                    while self.eat_op(","):
                        then.append(self.parse_stmt())
                    self.expect_op(")")
                else:
                    then = [self.parse_expr()]
                    while self.eat_op(","):
                        then.append(self.parse_expr())
            elif self.eat_kw("comment"):
                comment = self._comment_value()
            else:
                break
        if not then:
            raise self.err("Expected at least one `THEN` statement")
        d = DefineEvent(name, tb, when, then, ine, ow, comment)
        d.async_ = async_
        d.retry = retry
        d.maxdepth = maxdepth
        return d

    def _define_function(self):
        ine, ow = self._def_flags()
        # fn::name::sub(...) — catalog name excludes the fn:: prefix
        self.eat_op("::")
        parts = [self.ident()]
        while self.eat_op("::"):
            parts.append(self.ident())
        if parts and parts[0] == "fn":
            parts = parts[1:]
        name = "::".join(parts)
        self.expect_op("(")
        args = []
        while not self.at_op(")"):
            t = self.next()
            if t.kind != L.PARAM:
                raise self.err("expected $param in function args")
            self.expect_op(":")
            kind = self.parse_kind()
            args.append((t.value, kind))
            if not self.eat_op(","):
                break
        self.expect_op(")")
        returns = None
        if self.at_op("->"):
            self.next()
            returns = self.parse_kind()
        block = self._parse_block()
        perms = comment = None
        while True:
            if self.eat_kw("permissions"):
                perms = self._parse_permissions_value()
            elif self.eat_kw("comment"):
                comment = self._comment_value()
            else:
                break
        return DefineFunction(name, args, block, returns, ine, ow, perms, comment)

    def _define_analyzer(self):
        ine, ow = self._def_flags()
        name = self.name_expr()
        d = DefineAnalyzer(name, if_not_exists=ine, overwrite=ow)
        while True:
            if self.eat_kw("tokenizers"):
                d.tokenizers = [self.ident().lower()]
                while self.eat_op(","):
                    d.tokenizers.append(self.ident().lower())
            elif self.eat_kw("filters"):
                d.filters = [self._parse_filter()]
                while self.eat_op(","):
                    d.filters.append(self._parse_filter())
            elif self.eat_kw("function"):
                parts = [self.ident()]
                while self.eat_op("::"):
                    parts.append(self.ident())
                if parts and parts[0] == "fn":
                    parts = parts[1:]
                d.function = "::".join(parts)
            elif self.eat_kw("comment"):
                d.comment = self._comment_value()
            else:
                break
        return d

    def _parse_filter(self):
        name = self.ident().lower()
        if name in ("edgengram", "ngram") and self.at_op("("):
            self.next()
            a = self.next().value
            self.expect_op(",")
            b = self.next().value
            self.expect_op(")")
            return (name, a, b)
        if name == "snowball" and self.at_op("("):
            self.next()
            lang = self.ident()
            self.expect_op(")")
            return (name, lang)
        if name == "mapper" and self.at_op("("):
            self.next()
            path = self.next().value
            self.expect_op(")")
            return (name, path)
        return (name,)

    def _define_user(self):
        ine, ow = self._def_flags()
        name = self.name_expr()
        self.expect_kw("on")
        if self.eat_kw("root"):
            base = "root"
        elif self.eat_kw("namespace", "ns"):
            base = "ns"
        else:
            if not self.eat_kw("database", "db"):
                raise self.err("expected DATABASE")
            base = "db"
        d = DefineUser(name, base, if_not_exists=ine, overwrite=ow)
        while True:
            if self.eat_kw("password"):
                d.password = self.ident_or_str()
            elif self.eat_kw("passhash"):
                d.passhash = self.ident_or_str()
            elif self.eat_kw("roles"):
                d.roles = [self.ident().capitalize()]
                while self.eat_op(","):
                    d.roles.append(self.ident().capitalize())
            elif self.eat_kw("duration"):
                dur = {}
                while True:
                    if self.eat_kw("for"):
                        which = self.ident().lower()
                        if self.eat_kw("none"):
                            dur[which] = None
                        else:
                            dur[which] = self.parse_expr()
                        self.eat_op(",")
                    else:
                        break
                d.duration = dur
            elif self.eat_kw("comment"):
                d.comment = self._comment_value()
            else:
                break
        return d

    def _define_module(self):
        """DEFINE MODULE [IF NOT EXISTS|OVERWRITE] [mod::name AS] <bytes>
        (reference sql/statements/define/module.rs)."""
        ine, ow = self._def_flags()
        name = None
        t = self.peek()
        if t.kind == L.IDENT and t.value.lower() == "mod" and \
                self.peek(1).kind == L.OP and self.peek(1).text == "::":
            self.next()
            self.expect_op("::")
            name = self.ident()
            self.expect_kw("as")
        execu = self.parse_expr()
        comment = None
        if self.eat_kw("comment"):
            comment = self._comment_value()
        return DefineModule(name, execu, comment, ine, ow)

    def _define_access(self):
        ine, ow = self._def_flags()
        name = self.name_expr()
        self.expect_kw("on")
        if self.eat_kw("root"):
            base = "root"
        elif self.eat_kw("namespace", "ns"):
            base = "ns"
        else:
            if not self.eat_kw("database", "db"):
                raise self.err("expected DATABASE")
            base = "db"
        self.expect_kw("type")
        cfg = {}
        if self.eat_kw("jwt"):
            kind = "jwt"
            cfg.update(self._parse_jwt_config())
        elif self.eat_kw("record"):
            kind = "record"
            while True:
                if self.eat_kw("signup"):
                    cfg["signup"] = self.parse_expr()
                elif self.eat_kw("signin"):
                    cfg["signin"] = self.parse_expr()
                elif self.eat_kw("with"):
                    self.expect_kw("jwt")
                    cfg.update(self._parse_jwt_config())
                elif self.eat_kw("with"):
                    break
                else:
                    break
        elif self.eat_kw("bearer"):
            kind = "bearer"
            if self.eat_kw("for"):
                cfg["for"] = self.ident().lower()
        else:
            raise self.err("unknown ACCESS type")
        d = DefineAccess(name, base, kind, cfg, if_not_exists=ine, overwrite=ow)
        while True:
            if self.eat_kw("duration"):
                dur = {}
                while True:
                    if self.eat_kw("for"):
                        which = self.ident().lower()
                        if self.eat_kw("none"):
                            dur[which] = None
                        else:
                            dur[which] = self.parse_expr()
                        self.eat_op(",")
                    else:
                        break
                d.duration = dur
            elif self.eat_kw("authenticate"):
                cfg["authenticate"] = self.parse_expr()
            elif self.eat_kw("comment"):
                d.comment = self._comment_value()
            else:
                break
        return d

    def _parse_jwt_config(self):
        cfg = {}
        while True:
            if self.eat_kw("algorithm"):
                cfg["alg"] = self.ident().upper()
            elif self.eat_kw("key"):
                cfg["key"] = self.name_expr()
            elif self.eat_kw("url"):
                cfg["url"] = self.ident_or_str()
            elif self.eat_kw("issuer"):
                self._parse_issuer_spec(cfg)
            elif self.eat_kw("with"):
                self.expect_kw("issuer")
                self._parse_issuer_spec(cfg)
            else:
                break
        return cfg

    def _parse_issuer_spec(self, cfg):
        """ISSUER [ALGORITHM alg] [KEY key] (reference access_type.rs
        issuer grammar)."""
        found = False
        while True:
            if self.eat_kw("algorithm"):
                cfg["issuer_alg"] = self.ident().upper()
                found = True
            elif self.eat_kw("key"):
                cfg["issuer_key"] = self.name_expr()
                found = True
            else:
                break
        if not found:
            raise self.err("expected ALGORITHM or KEY after ISSUER")

    def _kind_has_object(self, k) -> bool:
        if k is None:
            return False
        if k.name in ("object", "object_literal"):
            return True
        inner = getattr(k, "inner", None) or []
        return any(
            isinstance(x, Kind) and self._kind_has_object(x) for x in inner
        )

    def _parse_permissions(self, no_delete=False):
        if self.eat_kw("none"):
            return {"select": False, "create": False, "update": False, "delete": False}
        if self.eat_kw("full"):
            return {"select": True, "create": True, "update": True, "delete": True}
        perms = {}
        while self.eat_kw("for"):
            kinds = [self.ident().lower()]
            stop = False
            while self.eat_op(","):
                if self.at_kw("for"):
                    stop = True
                    break
                kinds.append(self.ident().lower())
            if no_delete and "delete" in kinds:
                raise self.err("Can't define permission DELETE for fields")
            if stop:
                # `FOR select, FOR ...`: value defaults empty -> keep parsing
                for k in kinds:
                    perms.setdefault(k, False)
                continue
            if self.eat_kw("none"):
                val = False
            elif self.eat_kw("full"):
                val = True
            else:
                self.expect_kw("where")
                val = self.parse_expr()
            for k in kinds:
                perms[k] = val
            self.eat_op(",")
        return perms

    def _parse_permissions_value(self):
        if self.eat_kw("none"):
            return False
        if self.eat_kw("full"):
            return True
        self.expect_kw("where")
        return self.parse_expr()

    # -- REMOVE / ALTER -------------------------------------------------------
    def _stmt_remove(self):
        self.next()
        kinds = {
            "namespace": "namespace", "ns": "namespace",
            "database": "database", "db": "database",
            "table": "table", "tb": "table",
            "field": "field", "index": "index", "event": "event",
            "param": "param", "function": "function", "fn": "function",
            "analyzer": "analyzer", "user": "user", "access": "access",
            "sequence": "sequence", "config": "config", "api": "api",
            "bucket": "bucket", "module": "module",
        }
        t = self.peek()
        if t.kind != L.IDENT or t.value.lower() not in kinds:
            raise self.err("unknown REMOVE target")
        kind = kinds[self.next().value.lower()]
        if_exists = False
        if self.eat_kw("if"):
            self.expect_kw("exists")
            if_exists = True
        if kind == "function":
            self.eat_op("::")
            parts = [self.ident()]
            while self.eat_op("::"):
                parts.append(self.ident())
            if parts and parts[0] == "fn":
                parts = parts[1:]
            name = "::".join(parts)
            if self.at_op("("):  # optional trailing () in REMOVE FUNCTION
                self.next()
                self.expect_op(")")
        elif kind == "module":
            # REMOVE MODULE [mod::]name
            name = self.ident()
            if name.lower() == "mod" and self.eat_op("::"):
                name = self.ident()
        elif kind == "param":
            t = self.next()
            name = t.value
        elif kind == "field":
            if self.peek().kind == L.PARAM:
                name = Param(self.next().value)
            else:
                name = self._field_name_parts()
        else:
            name = self.name_expr()
        s = RemoveStmt(kind, name, if_exists=if_exists)
        if kind in ("field", "index", "event") :
            self.expect_kw("on")
            self.eat_kw("table")
            s.tb = self.name_expr()
        if kind in ("user", "access") and self.eat_kw("on"):
            if self.eat_kw("root"):
                s.base = "root"
            elif self.eat_kw("namespace", "ns"):
                s.base = "ns"
            else:
                if not self.eat_kw("database", "db"):
                    raise self.err("expected DATABASE")
                s.base = "db"
        if kind == "table" and self.eat_kw("expunge"):
            s.expunge = True
        return s

    def _stmt_alter(self):
        self.next()
        if self.eat_kw("sequence"):
            if_exists = False
            if self.eat_kw("if"):
                self.expect_kw("exists")
                if_exists = True
            name = self.ident()
            changes = []
            while True:
                if self.eat_kw("timeout"):
                    changes.append(("timeout", self.parse_expr()))
                elif self.eat_kw("batch"):
                    changes.append(("batch", self._signed_int()))
                elif self.eat_kw("start"):
                    changes.append(("start", self._signed_int()))
                else:
                    break
            return AlterStmt("sequence", name, None, None, if_exists, changes)
        kinds = {
            "field": "field", "index": "index", "event": "event",
            "param": "param", "function": "function", "fn": "function",
            "analyzer": "analyzer", "user": "user", "access": "access",
            "api": "api", "bucket": "bucket", "config": "config",
            "system": "system", "model": "model", "module": "module",
        }
        t = self.peek()
        if t.kind == L.IDENT and t.value.lower() in kinds:
            return self._alter_other(kinds[self.next().value.lower()])
        if self.eat_kw("namespace", "ns", "database", "db"):
            # ALTER NAMESPACE [x] COMPACT / ALTER DATABASE [x] maintenance
            if_exists = False
            if self.eat_kw("if"):
                self.expect_kw("exists")
                if_exists = True
            name = None
            if not self.at_kw("compact", "comment") and \
                    self.peek().kind == L.IDENT:
                name = self.ident_or_str()
            changes = []
            while True:
                if self.eat_kw("compact"):
                    changes.append(("compact", True))
                elif self.eat_kw("comment"):
                    changes.append(("comment", self._comment_value()))
                else:
                    break
            return AlterStmt("database", name, None, None, if_exists, changes)
        if not self.eat_kw("table"):
            raise self.err("unknown ALTER target")
        if_exists = False
        if self.eat_kw("if"):
            self.expect_kw("exists")
            if_exists = True
        d = AlterTable(self.ident_or_str(), if_exists)
        while True:
            if self.at_kw("drop") and self.peek(1).kind == L.IDENT and \
                    self.peek(1).value.lower() in ("comment", "changefeed"):
                self.next()
                which = self.next().value.lower()
                if which == "comment":
                    d.comment = "__drop__"
                else:
                    d.changefeed = "__drop__"
            elif self.eat_kw("drop"):
                d.drop = True
            elif self.eat_kw("compact"):
                d.compact = True
            elif self.eat_kw("schemafull", "schemaful"):
                d.full = True
            elif self.eat_kw("schemaless"):
                d.full = False
            elif self.eat_kw("type"):
                if self.eat_kw("any"):
                    d.kind = "any"
                elif self.eat_kw("normal"):
                    d.kind = "normal"
                elif self.eat_kw("relation"):
                    d.kind = "relation"
                    if self.eat_kw("in", "from"):
                        d.relation_from = [self.ident()]
                        while self.eat_op("|"):
                            d.relation_from.append(self.ident())
                    if self.eat_kw("out", "to"):
                        d.relation_to = [self.ident()]
                        while self.eat_op("|"):
                            d.relation_to.append(self.ident())
            elif self.eat_kw("permissions"):
                d.permissions = self._parse_permissions()
            elif self.eat_kw("changefeed"):
                d.changefeed = self.parse_expr()
            elif self.eat_kw("comment"):
                d.comment = self._comment_value()
            else:
                break
        return d

    def _signed_int(self):
        neg = self.eat_op("-")
        v = self.next().value
        return -v if neg else v

    def _comment_value(self):
        t = self.peek()
        if t.kind == L.STRING:
            self.next()
            return t.value
        return self.parse_expr()

    def _alter_other(self, kind: str):
        """ALTER <kind> [IF EXISTS] name [ON tb|base] clause-edits."""
        if_exists = False
        if self.eat_kw("if"):
            self.expect_kw("exists")
            if_exists = True
        if kind == "system":
            # reference grammar (syn alter.rs): exactly COMPACT, DROP
            # QUERY_TIMEOUT, or QUERY_TIMEOUT <duration>
            changes = []
            if self.eat_kw("compact"):
                changes.append(("compact", True))
            elif self.eat_kw("drop"):
                self.expect_kw("query_timeout")
                changes.append(("query_timeout", "__drop__"))
            elif self.eat_kw("query_timeout"):
                changes.append(("query_timeout", self.parse_expr()))
            else:
                raise self.err(
                    "Unexpected token, expected `COMPACT`, `DROP` or "
                    "`QUERY_TIMEOUT`"
                )
            return AlterStmt("system", "system", None, None, if_exists, changes)
        if kind == "config":
            what = self.ident().upper()
            cfg = self._config_spec(what)
            return AlterStmt("config", what, None, None, if_exists,
                             [("config_spec", cfg)])
        if kind == "param":
            tp = self.peek()
            if tp.kind == L.PARAM:
                self.next()
                name = tp.value
            else:
                name = self.ident_or_str()
        elif kind == "function":
            self.eat_op("::")
            parts = [self.ident()]
            while self.eat_op("::"):
                parts.append(self.ident())
            if parts and parts[0] == "fn":
                parts = parts[1:]
            name = "::".join(parts)
        elif kind == "field":
            from surrealdb_tpu_torch.exec.statements import _field_name_str

            name = _field_name_str(self._field_name_parts())
        else:
            name = self.ident_or_str()
        tb = base = None
        if kind in ("field", "index", "event") :
            self.expect_kw("on")
            self.eat_kw("table")
            tb = self.ident_or_str()
        elif kind in ("user", "access") and self.eat_kw("on"):
            if self.eat_kw("root"):
                base = "root"
            elif self.eat_kw("namespace", "ns"):
                base = "ns"
            elif self.eat_kw("database", "db"):
                base = "db"
        changes = []
        while True:
            if self.eat_kw("drop"):
                clause = self.ident().lower()
                if clause == "prepare":
                    self.expect_kw("remove")
                    changes.append(("prepare_remove", False))
                else:
                    changes.append((clause, "__drop__"))
            elif kind == "index" and self.eat_kw("prepare"):
                # ALTER INDEX ... PREPARE REMOVE: decommission — writes
                # still maintain it, the planner stops reading it
                self.expect_kw("remove")
                changes.append(("prepare_remove", True))
            elif self.eat_kw("comment"):
                changes.append(("comment", self._comment_value()))
            elif kind == "field" and self.eat_kw("type"):
                changes.append(("kind", self.parse_kind()))
                if self.eat_kw("flexible"):
                    changes.append(("flex", True))
            elif kind == "field" and self.eat_kw("value"):
                changes.append(("value", self.parse_expr()))
            elif kind == "field" and self.eat_kw("assert"):
                changes.append(("assert_", self.parse_expr()))
            elif kind == "field" and self.eat_kw("default"):
                always = self.eat_kw("always")
                changes.append(("default", self.parse_expr()))
                changes.append(("default_always", always))
            elif kind == "field" and self.eat_kw("readonly"):
                changes.append(("readonly", True))
            elif kind == "field" and self.eat_kw("flexible"):
                changes.append(("flex", True))
            elif kind == "event" and self.eat_kw("when"):
                changes.append(("when", self.parse_expr()))
            elif kind == "event" and self.eat_kw("then"):
                if self.at_op("("):
                    self.next()
                    then = [self.parse_stmt()]
                    while self.eat_op(","):
                        then.append(self.parse_stmt())
                    self.expect_op(")")
                else:
                    then = [self.parse_expr()]
                changes.append(("then", then))
            elif kind == "event" and self.eat_kw("async"):
                changes.append(("async_", True))
            elif kind == "event" and self.eat_kw("retry"):
                changes.append(("retry", self._signed_int()))
            elif kind == "event" and self.eat_kw("maxdepth"):
                changes.append(("maxdepth", self._signed_int()))
            elif kind == "param" and self.eat_kw("value"):
                changes.append(("value", self.parse_expr()))
            elif kind == "user" and self.eat_kw("password"):
                changes.append(("password", self.ident_or_str()))
            elif kind == "user" and self.eat_kw("passhash"):
                changes.append(("passhash", self.ident_or_str()))
            elif kind == "user" and self.eat_kw("roles"):
                roles = [self.ident().capitalize()]
                while self.eat_op(","):
                    roles.append(self.ident().capitalize())
                changes.append(("roles", roles))
            elif kind in ("field", "table", "function", "param", "api",
                          "bucket") and self.eat_kw("permissions"):
                if kind == "field":
                    changes.append(("permissions", self._parse_permissions()))
                else:
                    changes.append(
                        ("permissions", self._parse_permissions_value())
                    )
            elif kind == "bucket" and self.eat_kw("readonly"):
                changes.append(("readonly", True))
            elif kind == "api" and self.eat_kw("for"):
                methods = [self.ident().lower()]
                while self.eat_op(","):
                    methods.append(self.ident().lower())
                if self.eat_kw("drop"):
                    self.expect_kw("then")
                    changes.append(("api_drop_then", methods))
                elif self.eat_kw("then"):
                    changes.append(("api_then", (methods, self.parse_expr())))
            elif kind == "analyzer" and self.eat_kw("tokenizers"):
                toks = [self.ident().lower()]
                while self.eat_op(","):
                    toks.append(self.ident().lower())
                changes.append(("tokenizers", toks))
            elif kind == "analyzer" and self.eat_kw("filters"):
                fs = [self._parse_filter()]
                while self.eat_op(","):
                    fs.append(self._parse_filter())
                changes.append(("filters", fs))
            elif kind == "event" and self.eat_kw("async"):
                changes.append(("async", True))
            elif kind == "event" and self.eat_kw("retry"):
                changes.append(("retry", self.next().value))
            elif kind == "event" and self.eat_kw("maxdepth"):
                changes.append(("maxdepth", self.next().value))
            elif kind == "field" and self.eat_kw("reference"):
                changes.append(("reference", self._parse_reference()))
            elif kind == "function" and self.at_op("("):
                # ALTER FUNCTION fn::x(args) { body }
                self.next()
                args = []
                while not self.at_op(")"):
                    tp = self.next()
                    self.expect_op(":")
                    args.append((tp.value, self.parse_kind()))
                    if not self.eat_op(","):
                        break
                self.expect_op(")")
                returns = None
                if self.at_op("->"):
                    self.next()
                    returns = self.parse_kind()
                changes.append(("args", args))
                changes.append(("returns", returns))
                changes.append(("block", self._parse_block()))
            elif kind == "index" and self.eat_kw("prepare"):
                self.expect_kw("remove")
                changes.append(("prepare_remove", True))
            elif kind in ("user", "access") and self.eat_kw("duration"):
                dur = {}
                while self.eat_kw("for"):
                    which = self.ident().lower()
                    if self.eat_kw("none"):
                        dur[which] = None
                    else:
                        dur[which] = self.next().value
                    if not self.eat_op(","):
                        break
                changes.append(("duration", dur))
            else:
                break
        if kind == "index" and not changes:
            raise self.err(
                "Unexpected token, expected `PREPARE`, `DROP` or `COMMENT`"
            )
        return AlterStmt(kind, name, tb, base, if_exists, changes)

    # -- kinds ---------------------------------------------------------------
    def parse_kind(self, no_union: bool = False) -> Kind:
        kinds = [self._single_kind()]
        while not no_union and self.eat_op("|"):
            kinds.append(self._single_kind())
        if len(kinds) == 1:
            return kinds[0]
        return Kind("either", kinds)

    def _single_kind(self) -> Kind:
        t = self.peek()
        # literal kinds: 'a', 123, true, { obj }, [ arr ]
        if t.kind in (L.STRING, L.INT, L.FLOAT, L.DECIMAL, L.DURATION):
            self.next()
            return Kind("literal", literal=t.value)
        if t.kind == L.OP and t.text == "{":
            # object kind: { key: kind, ... }
            self.next()
            fields = []
            while not self.at_op("}"):
                kt = self.peek()
                if kt.kind in (L.IDENT, L.STRING):
                    key = self.next().value
                elif kt.kind == L.INT:
                    key = str(self.next().value)
                else:
                    raise self.err("expected object key in kind")
                self.expect_op(":")
                fields.append((key, self.parse_kind()))
                if not self.eat_op(","):
                    break
            self.expect_op("}")
            return Kind("object_literal", inner=fields)
        if t.kind == L.OP and t.text == "[":
            # tuple kind: [kind, kind, ...] — fixed-position element kinds
            self.next()
            inner = []
            while not self.at_op("]"):
                inner.append(self.parse_kind())
                if not self.eat_op(","):
                    break
            self.expect_op("]")
            return Kind("array_literal", inner=inner)
        if t.kind != L.IDENT:
            raise self.err("expected type name")
        name = self.next().value.lower()
        if name in ("true", "false"):
            return Kind("literal", literal=(name == "true"))
        k = Kind(name)
        if name in ("option", "set", "array", "either") and self.eat_op("<"):
            k.inner = [self.parse_kind()]
            while self.eat_op(","):
                t2 = self.peek()
                if t2.kind == L.INT:
                    k.size = self.next().value
                else:
                    k.inner.append(self.parse_kind())
            self._expect_gt()
        elif name == "record" and self.eat_op("<"):
            k.inner = [self.ident()]
            while self.eat_op("|"):
                k.inner.append(self.ident())
            self._expect_gt()
        elif name == "geometry" and self.eat_op("<"):
            k.inner = [self.ident().lower()]
            while self.eat_op("|"):
                k.inner.append(self.ident().lower())
            self._expect_gt()
        elif name == "table" and self.at_op("<"):
            self.next()
            k.inner = [self.ident()]
            while self.eat_op("|"):
                k.inner.append(self.ident())
            self._expect_gt()
        elif name == "references" and self.eat_op("<"):
            k.inner = [self.ident()]
            while self.eat_op(","):
                k.inner.append(self.ident())
            self._expect_gt()
        elif name == "function":
            pass
        return k

    def _expect_gt(self):
        if not self.eat_op(">"):
            raise self.err("expected '>'")

    # -- expressions ----------------------------------------------------------
    def parse_expr(self):
        return self._parse_or()

    def _script_expr(self, raw: str):
        """A SCRIPT token: `function($a, $b) { js }` — parse the SurrealQL
        arg expressions; the body stays raw for the script runtime."""
        inner = raw[raw.index("(") + 1:]
        depth = 1
        args_src = ""
        for i, ch in enumerate(inner):
            if ch == "(":
                depth += 1
            elif ch == ")":
                depth -= 1
                if depth == 0:
                    args_src = inner[:i]
                    break
        args = []
        if args_src.strip():
            sub = Parser(args_src)
            args.append(sub.parse_expr())
            while sub.eat_op(","):
                args.append(sub.parse_expr())
        return ScriptExpr(args, raw)

    def _parse_or(self):
        lhs = self._parse_and()
        while self.at_op("||") or self.at_kw("or"):
            self.next()
            lhs = Binary("||", lhs, self._parse_and())
        return lhs

    def _parse_and(self):
        lhs = self._parse_nullco()
        while self.at_op("&&") or self.at_kw("and"):
            self.next()
            lhs = Binary("&&", lhs, self._parse_nullco())
        return lhs

    def _parse_nullco(self):
        lhs = self._parse_relation()
        while self.at_op("??", "?:"):
            op = self.next().text
            lhs = Binary(op, lhs, self._parse_relation())
        return lhs

    _REL_OPS = {
        "=", "==", "!=", "?=", "*=", "~", "!~", "?~", "*~", "<", "<=", ">",
        ">=", "∋", "∌", "⊇", "⊆", "∈", "∉", "@@",
    }
    _REL_KWS = {
        "contains": "∋", "containsnot": "∌", "containsall": "⊇",
        "containsany": "containsany", "containsnone": "containsnone",
        "inside": "∈", "notinside": "∉", "allinside": "⊆",
        "anyinside": "anyinside", "noneinside": "noneinside",
        "outside": "outside", "intersects": "intersects", "in": "∈",
        "matches": "@@", "is": "=", "knn": None,
    }

    def _parse_relation(self):
        lhs = self._parse_range()
        while True:
            t = self.peek()
            if t.kind == L.OP and t.text in self._REL_OPS:
                # `<` might be a cast start only in prefix position; here it
                # is always a comparison.
                self.next()
                op = t.text
                if op == "@@":
                    lhs = Matches(lhs, self._parse_range())
                    continue
                rhs = self._parse_range()
                lhs = Binary(op, lhs, rhs)
                continue
            if t.kind == L.OP and t.text == "@":
                # matches with options: @N@ / @AND@ / @OR@ / @N,AND@
                save = self.i
                self.next()
                ref = None
                boolean = "AND"
                ok = True
                while not self.at_op("@"):
                    tt = self.peek()
                    if tt.kind == L.INT:
                        ref = self.next().value
                    elif tt.kind == L.IDENT and tt.value.upper() in ("AND", "OR"):
                        boolean = self.next().value.upper()
                    elif self.eat_op(","):
                        continue
                    else:
                        ok = False
                        break
                if ok and self.eat_op("@"):
                    lhs = Matches(lhs, self._parse_range(), ref, boolean)
                    continue
                self.i = save
                break
            if t.kind == L.IDENT:
                kw = t.value.lower()
                if kw == "not" and self.peek(1).kind == L.IDENT and \
                        self.peek(1).value.lower() in ("in", "inside"):
                    self.next()
                    self.next()
                    lhs = Binary("∉", lhs, self._parse_range())
                    continue
                if kw == "is" and self.peek(1).kind == L.IDENT and \
                        self.peek(1).value.lower() == "not":
                    self.next()
                    self.next()
                    lhs = Binary("!=", lhs, self._parse_range())
                    continue
                if kw == "matches":
                    self.next()
                    lhs = Matches(lhs, self._parse_range())
                    continue
                if kw in self._REL_KWS and kw != "knn":
                    # guard: `in` inside FOR handled elsewhere
                    self.next()
                    lhs = Binary(self._REL_KWS[kw], lhs, self._parse_range())
                    continue
            if t.kind == L.OP and t.text == "<|":
                self.next()
                k = self.next().value
                ef = dist = None
                if self.eat_op(","):
                    t2 = self.peek()
                    if t2.kind == L.INT:
                        ef = self.next().value
                    else:
                        dist = self._parse_distance()
                self.expect_op("|>")
                rhs = self._parse_range()
                lhs = Knn(lhs, rhs, k, ef, dist)
                continue
            break
        return lhs

    def _parse_range(self):
        # beg..end / beg>..=end / ..end / beg..
        if self.at_op("..", "..="):
            incl = self.next().text == "..="
            if self._at_expr_start():
                return RangeExpr(None, self._parse_additive(), True, incl)
            return RangeExpr(None, None, True, incl)
        lhs = self._parse_additive()
        beg_incl = True
        if self.at_op(">") and self.peek(1).kind == L.OP and \
                self.peek(1).text in ("..", "..="):
            self.next()
            beg_incl = False
        if self.at_op("..", "..="):
            incl = self.next().text == "..="
            if self._at_expr_start():
                return RangeExpr(lhs, self._parse_additive(), beg_incl, incl)
            return RangeExpr(lhs, None, beg_incl, incl)
        return lhs

    def _at_expr_start(self):
        t = self.peek()
        if t.kind in (L.INT, L.FLOAT, L.DECIMAL, L.STRING, L.PARAM, L.IDENT,
                      L.DURATION, L.DATETIME_STR, L.UUID_STR, L.RECORD_STR,
                      L.BYTES_LIT, L.REGEX, L.FILE_STR):
            return True
        return t.kind == L.OP and t.text in ("(", "[", "{", "-", "+", "!", "<",
                                             "$", "->", "<-", "<->", "*", "/")

    def _parse_additive(self):
        lhs = self._parse_multiplicative()
        while self.at_op("+", "-"):
            op = self.next().text
            lhs = Binary(op, lhs, self._parse_multiplicative())
        return lhs

    def _parse_multiplicative(self):
        lhs = self._parse_power()
        while self.at_op("*", "/", "%", "×", "÷"):
            # `SELECT *` handled in select; here `*` is multiplication
            op = self.next().text
            if op in ("×",):
                op = "*"
            if op in ("÷",):
                op = "/"
            lhs = Binary(op, lhs, self._parse_power())
        return lhs

    def _parse_power(self):
        lhs = self._parse_unary()
        if self.at_op("**"):
            self.next()
            return Binary("**", lhs, self._parse_power())
        return lhs

    def _parse_unary(self):
        if self.at_op("-"):
            self.next()
            t = self.peek()
            if t.kind == L.INT and t.value == (1 << 63):
                # i64::MIN: the one magnitude only valid when negated
                self.next()
                return self._parse_postfix(Literal(-(1 << 63)))
            if t.kind in (L.INT, L.FLOAT) and not t.ws_before:
                # `-13` lexes as a negative literal, so postfix binds the
                # negated value: -13.abs() == 13 (reference lexer folds the
                # sign into the number token)
                self.next()
                return self._parse_postfix(Literal(-t.value))
            return Prefix("-", self._parse_unary())
        if self.at_op("!"):
            self.next()
            return Prefix("!", self._parse_unary())
        if self.at_op("+"):
            self.next()
            return Prefix("+", self._parse_unary())
        if self.at_op("<"):
            # cast or future
            save = self.i
            self.next()
            try:
                kind = self.parse_kind()
                self._expect_gt()
            except ParseError:
                self.i = save
                raise
            if kind.name == "future":
                body = self._parse_block()
                return FunctionCall("__future__", [BlockExpr(body.stmts)])
            operand = self._parse_unary()
            # a trailing range glues into the cast operand: <array> 0..1000
            beg_incl = True
            if self.at_op(">") and self.peek(1).kind == L.OP and \
                    self.peek(1).text in ("..", "..="):
                self.next()
                beg_incl = False
            if self.at_op("..", "..="):
                incl = self.next().text == "..="
                end = self._parse_additive() if self._at_expr_start() else None
                operand = RangeExpr(operand, end, beg_incl, incl)
            return Cast(kind, operand)
        return self._parse_postfix(self._parse_primary())

    # -- postfix idiom parts ---------------------------------------------------
    def _parse_postfix(self, base):
        parts = []
        while True:
            if self.at_op("."):
                # .field / .method(...) / .* / .{destructure|recurse}
                self.next()
                if self.at_op("*"):
                    self.next()
                    parts.append(PAll())
                    continue
                if self.at_op("?"):
                    self.next()
                    parts.append(POptional())
                    continue
                if self.at_op("{"):
                    parts.append(self._parse_destructure_or_recurse())
                    continue
                if self.at_op("->", "<-", "<->", "<~") and not self.no_graph:
                    parts.append(self._parse_graph_part(self.next().text))
                    continue
                if self.at_op("@"):
                    self.next()
                    parts.append(PField("@"))
                    continue
                name = self.ident()
                if self.at_op("(") and not self.peek(0).ws_before:
                    self.next()
                    args = []
                    while not self.at_op(")"):
                        args.append(self.parse_expr())
                        if not self.eat_op(","):
                            break
                    self.expect_op(")")
                    parts.append(PMethod(name, args))
                else:
                    parts.append(PField(name))
                continue
            if self.at_op("?") and self.peek(1).kind == L.OP and \
                    self.peek(1).text == ".":
                self.next()  # the `.` branch parses the following field
                parts.append(POptional())
                continue
            if self.at_op("["):
                self.next()
                if self.at_op("*"):
                    self.next()
                    parts.append(PAll())
                    self.expect_op("]")
                elif self.at_op("$"):
                    self.next()
                    parts.append(PLast())
                    self.expect_op("]")
                elif self.eat_kw("where"):
                    parts.append(PWhere(self.parse_expr()))
                    self.expect_op("]")
                elif self.at_op("?"):
                    self.next()
                    parts.append(PWhere(self.parse_expr()))
                    self.expect_op("]")
                else:
                    parts.append(PIndex(self.parse_expr()))
                    self.expect_op("]")
                continue
            if self.at_op("(") and not self.peek().ws_before:
                self.next()
                args = []
                while not self.at_op(")"):
                    args.append(self.parse_expr())
                    if not self.eat_op(","):
                        break
                self.expect_op(")")
                parts.append(PMethod("__call__", args))
                continue
            if self.at_op("…", "..."):
                self.next()
                parts.append(PFlatten())
                continue
            if self.at_op("->", "<-", "<->", "<~") and not self.no_graph:
                parts.append(self._parse_graph_part(self.next().text))
                continue
            break
        if not parts:
            return base
        if isinstance(base, Idiom) and not getattr(base, "_paren", False):
            base.parts.extend(parts)
            return base
        return Idiom([("start", base)] + parts)

    def _parse_destructure_or_recurse(self):
        """After '.': '{' — destructure {a, b: c} or recursion bound {1..3}."""
        self.expect_op("{")
        t = self.peek()
        # recursion bounds: INT / INT..INT / ..INT / .. / INT.. (+instruction)
        if (t.kind == L.INT and self.peek(1).kind == L.OP and
                self.peek(1).text in ("..", "..=", "}", ",", "+")) or \
           (t.kind == L.OP and t.text in ("..", "..=")):
            rmin, rmax = 1, None
            if t.kind == L.INT:
                rmin = self.next().value
                rmax = rmin
            if self.at_op("..", "..="):
                incl = self.next().text == "..="
                rmax = None
                if self.peek().kind == L.INT:
                    rmax = self.next().value
                    if not incl:
                        pass
            instruction = None
            names = []
            target = None
            while self.eat_op(",") or self.eat_op("+"):
                nm = self.ident().lower()
                if nm not in ("collect", "path", "shortest", "inclusive"):
                    raise self.err(f"unknown recursion instruction '{nm}'")
                names.append(nm)
                if self.eat_op("="):
                    if nm != "shortest":
                        raise self.err(
                            "only the shortest instruction takes a target"
                        )
                    # restricted: `a:5+inclusive` must not parse as addition
                    target = self._parse_unary()
                    from surrealdb_tpu_torch.expr.ast import (
                        Param as _Pm, RecordIdLit as _RL,
                    )

                    if not isinstance(target, (_Pm, _RL)):
                        raise self.err(
                            "shortest target must be a record id or param"
                        )
                elif nm == "shortest":
                    raise self.err("shortest requires a =target")
            if names:
                instruction = {"names": names, "target": target}
            self.expect_op("}")
            # optional (path) group
            inner_parts = []
            if self.at_op("("):
                self.next()
                inner = self._parse_postfix(Idiom([]))
                self.expect_op(")")
                if isinstance(inner, Idiom):
                    inner_parts = inner.parts
            return PRecurse(rmin, rmax, inner_parts, instruction)
        # destructure
        fields = []
        while not self.at_op("}"):
            name = self.ident_or_str()
            if self.at_op(":"):
                self.next()
                if self.at_op("{"):
                    # nested destructure on this field
                    inner = self._parse_destructure_or_recurse()
                    sub = Idiom([("start", Idiom([PField(name)])), inner])
                else:
                    sub = self.parse_expr()
                fields.append((name, sub))
            elif self.at_op("."):
                # a.* or nested chain
                sub = self._parse_postfix(Idiom([("start", Idiom([PField(name)]))]))
                fields.append((name, sub))
            else:
                fields.append((name, None))
            if not self.eat_op(","):
                break
        self.expect_op("}")
        return PDestructure(fields)

    def _parse_graph_part(self, arrow):
        direction = {"->": "out", "<-": "in", "<->": "both", "<~": "ref"}[arrow]
        what = []
        cond = alias = None
        expr = None
        rec = None
        if self.at_op("?"):
            self.next()
        elif self.at_op("("):
            self.next()
            if self.at_kw("select"):
                sub = self._stmt_select()
                self.expect_op(")")
                g = PGraph(direction, [], None)
                g.expr = sub
                return g
            while True:
                if self.at_op("?"):
                    self.next()
                else:
                    name = self.ident_or_str()
                    rng = None
                    if self.at_op(":") and not self.peek().ws_before:
                        self.next()
                        rng = self._parse_record_id(name)
                    what.append((name, rng))
                if not self.eat_op(","):
                    break
            order = limit = start = None
            ref_field = None
            while True:
                if self.eat_kw("where"):
                    cond = self.parse_expr()
                elif direction == "ref" and self.eat_kw("field"):
                    # <~(table FIELD f): restrict to references made via
                    # the named referencing field (reference refs lookup)
                    ref_field = self.ident()
                elif self.eat_kw("as"):
                    alias = self._alias_idiom()
                elif self.eat_kw("order"):
                    self.eat_kw("by")
                    order = [self._order_item()]
                    while self.eat_op(","):
                        order.append(self._order_item())
                elif self.eat_kw("limit"):
                    self.eat_kw("by")
                    limit = self.parse_expr()
                elif self.eat_kw("start"):
                    self.eat_kw("at")
                    start = self.parse_expr()
                else:
                    break
            self.expect_op(")")
            if order is not None or limit is not None or start is not None:
                # clause shorthand lowers to a subquery over the edge table
                sel = SelectStmt(exprs=[], what=[])
                sel.value = Idiom([PField("id")])
                sel.what = [
                    Idiom([PField(nm)]) for nm, _rng in what
                ]
                sel.cond = cond
                sel.order = order or []
                sel.limit = limit
                sel.start = start
                if ref_field is not None:
                    sel.ref_field = ref_field
                g = PGraph(direction, [], None, alias)
                g.expr = sel
                return g
            if ref_field is not None:
                g = PGraph(direction, what, cond, alias)
                g.ref_field = ref_field
                return g
        else:
            name = self.ident_or_str()
            rng = None
            if self.at_op(":") and not self.peek().ws_before:
                self.next()
                rng = self._parse_record_id(name)
            what.append((name, rng))
        return PGraph(direction, what, cond, alias, expr)

    # -- primary ----------------------------------------------------------------
    def _parse_primary(self):
        t = self.peek()
        k = t.kind
        if k == L.INT or k == L.FLOAT or k == L.DECIMAL:
            self.next()
            if k == L.INT and t.value > (1 << 63) - 1:
                raise self.err(
                    "Failed to parse number: number cannot fit within a "
                    "64bit signed integer"
                )
            return Literal(t.value)
        if k == L.DURATION:
            self.next()
            return Literal(t.value)
        if k == L.STRING:
            self.next()
            return Literal(t.value)
        if k == L.DATETIME_STR:
            self.next()
            try:
                return Literal(Datetime.parse(t.value))
            except ValueError as e:
                raise self.err(f"invalid datetime literal: {e}")
        if k == L.UUID_STR:
            self.next()
            import re as _re2

            # strict 8-4-4-4-12 shape: Python's uuid/int are lenient about
            # '_' (digit separators), the reference's lexer is not
            if not _re2.fullmatch(
                r"[0-9a-fA-F]{8}-[0-9a-fA-F]{4}-[0-9a-fA-F]{4}-"
                r"[0-9a-fA-F]{4}-[0-9a-fA-F]{12}", t.value
            ):
                raise self.err("invalid UUID literal")
            try:
                return Literal(Uuid(t.value))
            except ValueError:
                raise self.err("invalid UUID literal")
        if k == L.BYTES_LIT:
            self.next()
            return Literal(t.value)
        if k == L.FILE_STR:
            self.next()
            v = t.value
            # bucket grammar: alnum/_/-/. then `:/` (reference file lexer)
            if ":" not in v:
                raise self.err(
                    "Unexpected end of file string, missing bucket "
                    "seperator `:/`"
                )
            bucket, key = v.split(":", 1)
            for ch in bucket:
                if not (ch.isalnum() or ch in "_-."):
                    raise self.err(
                        f"Unexpected character `{ch}`, file strings "
                        "buckets only allow alpha numeric characters and "
                        "`_`, `-`, and `.`"
                    )
            if not key.startswith("/"):
                raise self.err(
                    f"Unexpected character `{key[:1] or ''}`, expected `/`"
                )
            return Literal(File(bucket, key))
        if k == L.RECORD_STR:
            self.next()
            return parse_record_literal(t.value)
        if k == L.REGEX:
            self.next()
            return RegexLit(t.value)
        if k == L.SCRIPT:
            self.next()
            return self._script_expr(t.value)
        if k == L.PARAM:
            self.next()
            return Param(t.value)
        if k == L.OP:
            if t.text == "(":
                return self._parse_paren()
            if t.text == "[":
                return ArrayExpr(self._parse_array_exprs())
            if t.text == "{":
                return self._parse_object_or_block_expr()
            if t.text == "*":
                self.next()
                return Idiom([PAll()])
            if t.text in ("->", "<-", "<->", "<~"):
                arrow = self.next().text
                return Idiom([self._parse_graph_part(arrow)])
            if t.text == "|":
                return self._parse_mock_or_closure()
            if t.text == "||":
                self.next()
                body = self._closure_body()
                return ClosureExpr([], body)
            if t.text == "$":
                # bare $ = current value? ($ alone not standard)
                self.next()
                return Param("this")
            if t.text == "..":
                # open range handled in _parse_range; reaching here means
                # a bare `..`
                self.next()
                return RangeExpr(None, None)
            if t.text == "@":
                self.next()
                parts = [PField("@")]
                if self.at_op("{"):
                    parts.append(self._parse_destructure_or_recurse())
                return Idiom(parts)
        if k == L.IDENT:
            return self._parse_ident_expr()
        raise self.err("expected expression")

    def _parse_array_exprs(self):
        self.expect_op("[")
        items = []
        while not self.at_op("]"):
            items.append(self.parse_expr())
            if not self.eat_op(","):
                break
        self.expect_op("]")
        return items

    def _parse_array(self):
        # literal array (for kind literals)
        items = self._parse_array_exprs()
        return ArrayExpr(items)

    def _parse_paren(self):
        self.expect_op("(")
        t = self.peek()
        if t.kind == L.IDENT and t.value.lower() in (
            "select", "create", "update", "upsert", "delete", "insert",
            "relate", "define", "remove", "if", "return", "live", "info",
            "let", "rebuild", "alter", "show", "explain",
        ):
            stmt = self.parse_stmt()
            self.expect_op(")")
            return Subquery(stmt)
        # geometry point: (1.0, 2.0)
        e = self.parse_expr()
        if self.at_op(","):
            self.next()
            e2 = self.parse_expr()
            self.expect_op(")")
            return FunctionCall("__point__", [e, e2])
        self.expect_op(")")
        if _is_stmt(e):
            return Subquery(e)
        if isinstance(e, Idiom):
            # `(a.b)[0]` indexes the parenthesized RESULT; mark the idiom
            # closed so postfix parts don't splice into its chain
            # (language/idiom/continuity.surql)
            e._paren = True
        return e

    def _parse_object_or_block_expr(self):
        # decide: object literal vs set literal vs block
        j = self.i + 1
        t1 = self.toks[j] if j < len(self.toks) else None
        if t1 is not None and t1.kind == L.OP and t1.text == "}":
            self.next()
            self.next()
            return ObjectExpr([])
        if t1 is not None and t1.kind == L.OP and t1.text == ",":
            # `{,}` — the empty set literal
            self.next()
            self.next()
            self.expect_op("}")
            return SetExpr([])
        if t1 is not None and t1.kind in (L.IDENT, L.STRING, L.INT):
            t2 = self.toks[j + 1] if j + 1 < len(self.toks) else None
            if t2 is not None and t2.kind == L.OP and t2.text == ":":
                # `ident:` could still be a record id inside a block... an
                # object key is followed by ':' then expr; a record literal in
                # block position is rare — prefer object.
                return self._parse_object()
        # try a set literal: `{ expr, ... }` (single expr without a trailing
        # comma is a block); rewind to block parsing on failure
        save = self.i
        try:
            self.next()  # '{'
            first = self.parse_expr()
            if self.at_op(","):
                items = [first]
                while self.eat_op(","):
                    if self.at_op("}"):
                        break
                    items.append(self.parse_expr())
                self.expect_op("}")
                return SetExpr(items)
        except ParseError:
            pass
        self.i = save
        return Subquery(self._parse_block())

    def _parse_object(self):
        self.expect_op("{")
        items = []
        while not self.at_op("}"):
            t = self.peek()
            if t.kind in (L.IDENT, L.STRING):
                key = self.next().value
            elif t.kind == L.INT:
                # numeric keys keep their raw lexeme ({ 00: 5 } keys "00")
                # but must still fit the reference's number type
                if t.value > (1 << 63) - 1:
                    raise self.err(
                        "Failed to parse number: number cannot fit within "
                        "a 64bit signed integer"
                    )
                key = self.next().text
            else:
                raise self.err("expected object key")
            self.expect_op(":")
            items.append((key, self.parse_expr()))
            if not self.eat_op(","):
                break
        self.expect_op("}")
        return ObjectExpr(items)

    def _parse_object_or_block(self):
        return self._parse_object_or_block_expr()

    def _parse_mock_or_closure(self):
        # at '|': mock |tb:n| / |tb:n..m|  vs closure |$a| expr
        t1 = self.peek(1)
        if t1.kind == L.IDENT and self.peek(2).kind == L.OP and \
                self.peek(2).text == ":":
            self.next()
            tb = self.ident()
            self.expect_op(":")
            beg = end = None
            beg_excl = end_incl = False
            is_range = False
            if self.peek().kind == L.INT or (
                self.at_op("-") and self.peek(1).kind == L.INT
            ):
                neg = self.eat_op("-")
                beg = self.next().value
                if neg:
                    beg = -beg
            if self.at_op(">"):
                self.next()
                beg_excl = True
                if self.at_op("..="):
                    end_incl = True
                    self.next()
                else:
                    self.expect_op("..")
                is_range = True
            elif self.at_op("..", "..="):
                end_incl = self.peek().text == "..="
                self.next()
                is_range = True
            else:
                is_range = False
            if is_range and (self.peek().kind == L.INT or (
                self.at_op("-") and self.peek(1).kind == L.INT
            )):
                neg = self.eat_op("-")
                end = self.next().value
                if neg:
                    end = -end
            if is_range and self.at_op("..="):
                # >..= combination: `1>..=4`
                self.next()
                end_incl = True
                neg = self.eat_op("-")
                end = self.next().value
                if neg:
                    end = -end
            self.expect_op("|")
            if not is_range and beg is None:
                raise self.err("expected mock count or range")
            return Mock(tb, beg, end, end_incl, beg_excl, is_range)
        # closure
        self.next()
        params = []
        while not self.at_op("|"):
            t = self.next()
            if t.kind != L.PARAM:
                raise self.err("expected $param in closure")
            kind = None
            if self.at_op(":"):
                self.next()
                # `|` terminates the param list, so kinds can't take unions
                # here (parenthesised kinds would, if needed)
                kind = self.parse_kind(no_union=True)
            params.append((t.value, kind))
            if not self.eat_op(","):
                break
        self.expect_op("|")
        returns = None
        if self.at_op("->"):
            self.next()
            returns = self.parse_kind()
        body = self._closure_body()
        return ClosureExpr(params, body, returns)

    def _closure_body(self):
        if self.at_op("{"):
            blk = self._parse_object_or_block_expr()
            return blk
        return self.parse_expr()

    def _parse_ident_expr(self):
        t = self.next()
        name = t.value
        low = name.lower()
        # literals
        if low == "true":
            return Literal(True)
        if low == "false":
            return Literal(False)
        if low == "null":
            return Literal(None)
        if low == "none":
            return Literal(NONE)
        if low == "nan":
            return Literal(float("nan"))
        if low == "infinity":
            return Literal(float("inf"))
        # IF expression
        if low == "if":
            self.i -= 1
            return self._parse_if()
        # statements in expression position: RETURN CREATE ..., LET $x = SELECT ...
        if low in ("select", "create", "update", "upsert", "delete", "insert",
                   "relate", "define", "remove", "rebuild", "info", "live",
                   "kill", "alter", "show", "explain") and self._stmt_follows(low):
            self.i -= 1
            return Subquery(self.parse_stmt())
        # function path  foo::bar(...)
        if self.at_op("::"):
            parts = [name]
            while self.eat_op("::"):
                parts.append(self.ident())
            full = "::".join(parts)
            version = None
            if full.lower().startswith("ml::") and self.at_op("<"):
                self.next()
                vparts = []
                while not self.at_op(">"):
                    vparts.append(str(self.next().value))
                self.expect_op(">")
                version = "".join(vparts)
            if self.at_op("("):
                self.next()
                args = []
                while not self.at_op(")"):
                    args.append(self.parse_expr())
                    if not self.eat_op(","):
                        break
                self.expect_op(")")
                self._check_function_path(full)
                return FunctionCall(full, args, version)
            if full.lower() in _CONSTANTS:
                return Constant(full.lower())
            return Constant(full.lower())
        # plain function call
        if self.at_op("(") and not self.peek().ws_before:
            self.next()
            args = []
            while not self.at_op(")"):
                args.append(self.parse_expr())
                if not self.eat_op(","):
                    break
            self.expect_op(")")
            return FunctionCall(low, args)
        # record id literal:  tb:key
        if self.at_op(":") and not self.peek().ws_before:
            nxt = self.peek(1)
            if nxt.kind in (L.INT, L.IDENT, L.UUID_STR, L.STRING,
                            L.DURATION) or (
                nxt.kind == L.OP and nxt.text in ("[", "{", "-", "..", "..=", "⟨", "`")
            ):
                self.next()  # ':'
                return self._parse_record_id(name)
        return Idiom([PField(name)])

    def _stmt_follows(self, kw: str) -> bool:
        """Heuristic: after a statement keyword in expression position, does
        statement-shaped content follow (vs. a field named 'create' etc.)?"""
        t = self.peek()
        if t.kind == L.EOF:
            return False
        if t.kind == L.OP:
            # `select,` / `select)` / `select.` etc. are idiom usage
            return t.text in ("*",) if kw == "select" else False
        if t.kind == L.IDENT:
            low = t.value.lower()
            # clause keywords that would follow an idiom, not start a target
            if low in ("from", "where", "group", "order", "limit", "start",
                       "as", "and", "or", "is", "in", "contains", "then",
                       "else", "end"):
                return False
            return True
        if kw == "explain":
            return t.kind in (L.PARAM, L.RECORD_STR, L.INT, L.STRING,
                              L.FLOAT, L.DECIMAL)
        return t.kind in (L.PARAM, L.RECORD_STR, L.INT, L.STRING)

    def _parse_record_id(self, tb: str):
        """Parse the key after `tb:`."""
        t = self.peek()
        neg = False
        if t.kind == L.OP and t.text == "-":
            self.next()
            neg = True
            t = self.peek()
        if t.kind in (L.INT, L.DURATION) or (
            t.kind == L.IDENT and self._key_adjacent(t)
        ):
            merged = self._merge_key_tokens(neg)
            if merged is not None:
                idexpr = Literal(merged)
            else:
                self.next()
                key = -t.value if neg else t.value
                if not (-(1 << 63) <= key < (1 << 63)):
                    key = str(key)  # beyond i64: string key
                idexpr = Literal(key)
        elif t.kind == L.IDENT:
            low = t.value.lower()
            if low in ("rand", "ulid", "uuid") and \
                    self.peek(1).kind == L.OP and self.peek(1).text == "(":
                self.next()
                self.next()
                self.expect_op(")")
                idexpr = Literal(f"__gen_{low}__")
            else:
                self.next()
                idexpr = Literal(t.value)
        elif t.kind == L.STRING:
            self.next()
            idexpr = Literal(t.value)
        elif t.kind == L.UUID_STR:
            self.next()
            idexpr = Literal(Uuid(t.value))
        elif t.kind == L.OP and t.text == "[":
            idexpr = ArrayExpr(self._parse_array_exprs())
        elif t.kind == L.OP and t.text == "{":
            idexpr = self._parse_object()
        elif t.kind == L.OP and t.text in ("..", "..="):
            idexpr = None  # open range below
        else:
            raise self.err("invalid record id key")
        # record range: tb:1..10 / tb:beg..=end
        beg_incl = True
        if self.at_op(">") and self.peek(1).kind == L.OP and \
                self.peek(1).text in ("..", "..="):
            self.next()
            beg_incl = False
        if self.at_op("..", "..="):
            incl = self.next().text == "..="
            end = None
            t2 = self.peek()
            # an identifier end-key must be glued to the `..` — a detached
            # word is the next clause (e.g. `<~(message:1>.. FIELD chat)`)
            if (t2.kind == L.IDENT and not t2.ws_before) or \
                    t2.kind in (L.INT, L.STRING, L.UUID_STR) or (
                t2.kind == L.OP and t2.text in ("[", "{", "-")
            ):
                end = self._record_key_expr()
            return RecordIdLit(tb, RangeExpr(idexpr, end, beg_incl, incl))
        return RecordIdLit(tb, idexpr)

    def _key_adjacent(self, t) -> bool:
        """Is the next token glued to this one (no whitespace)?"""
        nxt = self.toks[self.i + 1] if self.i + 1 < len(self.toks) else None
        return (
            nxt is not None
            and nxt.kind in (L.INT, L.IDENT, L.DURATION)
            and nxt.pos == t.pos + len(t.text)
        )

    def _merge_key_tokens(self, neg=False):
        """Merge glued INT/IDENT/DURATION tokens into one alnum record key
        (ulids like 01JDSK…, keys like 54d6j987… that mis-lex as durations).
        Returns the string key, or None when the key is a plain INT."""
        t = self.peek()
        parts = [t.text]
        kinds = [t.kind]
        j = self.i + 1
        end = t.pos + len(t.text)
        while j < len(self.toks):
            nxt = self.toks[j]
            if nxt.kind in (L.INT, L.IDENT, L.DURATION) and nxt.pos == end:
                parts.append(nxt.text)
                kinds.append(nxt.kind)
                end = nxt.pos + len(nxt.text)
                j += 1
            else:
                break
        if len(parts) == 1 and t.kind == L.INT:
            return None  # plain integer key
        self.i = j
        if len(parts) == 1 and t.kind == L.IDENT:
            return t.value
        if neg:
            raise self.err("invalid record id key")
        return "".join(parts)

    def _record_key_expr(self):
        t = self.peek()
        neg = False
        if t.kind == L.OP and t.text == "-":
            self.next()
            neg = True
            t = self.peek()
        if t.kind in (L.INT, L.DURATION) or (
            t.kind == L.IDENT and self._key_adjacent(t)
        ):
            merged = self._merge_key_tokens(neg)
            if merged is not None:
                return Literal(merged)
            self.next()
            return Literal(-t.value if neg else t.value)
        if t.kind == L.IDENT:
            self.next()
            return Literal(t.value)
        if t.kind == L.STRING:
            self.next()
            return Literal(t.value)
        if t.kind == L.UUID_STR:
            self.next()
            return Literal(Uuid(t.value))
        if t.kind == L.OP and t.text == "[":
            return ArrayExpr(self._parse_array_exprs())
        if t.kind == L.OP and t.text == "{":
            return self._parse_object()
        raise self.err("invalid record range key")


def _is_stmt(node) -> bool:
    return isinstance(
        node,
        (SelectStmt, CreateStmt, UpdateStmt, UpsertStmt, DeleteStmt,
         InsertStmt, RelateStmt, ReturnStmt, IfElse, LetStmt),
    )


def parse_record_literal(text: str):
    """Parse the content of r'...' — a record id or record range. The
    WHOLE text must be the id (trailing garbage is an error, so values
    routed through type::record can never smuggle extra syntax)."""
    p = Parser(text)
    tb = p.ident_or_str()
    p.expect_op(":")
    out = p._parse_record_id(tb)
    if p.peek().kind != L.EOF:
        raise p.err("unexpected trailing characters in record id")
    return out

