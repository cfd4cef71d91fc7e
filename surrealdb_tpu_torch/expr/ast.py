"""AST node definitions.

Reference shapes: core/src/expr/plan.rs (TopLevelExpr), expr/statements/*,
expr/part.rs (idiom parts), expr/lookup.rs (graph lookups),
sql/operator.rs (BinaryOperator incl. NearestNeighbor).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional


class Node:
    __slots__ = ()


# ---------------------------------------------------------------------------
# Expressions
# ---------------------------------------------------------------------------


@dataclass
class Literal(Node):
    value: Any


@dataclass
class Param(Node):
    name: str


@dataclass
class ArrayExpr(Node):
    items: list


@dataclass
class ObjectExpr(Node):
    items: list  # [(key:str, expr)]


@dataclass
class SetExpr(Node):
    items: list


@dataclass
class RecordIdLit(Node):
    tb: str
    id: Any  # expr | "id-gen:rand"/"id-gen:ulid"/"id-gen:uuid" marker


@dataclass
class RangeExpr(Node):
    beg: Optional[Node]  # None = unbounded
    end: Optional[Node]
    beg_incl: bool = True
    end_incl: bool = False


@dataclass
class Binary(Node):
    op: str
    lhs: Node
    rhs: Node


@dataclass
class Prefix(Node):
    op: str  # '-', '!', '+'
    expr: Node


@dataclass
class Matches(Node):
    """lhs @[ref][,AND|OR]@ rhs — full-text match with options."""

    lhs: Node
    rhs: Node
    ref: Optional[int] = None
    boolean: str = "AND"


@dataclass
class Knn(Node):
    """lhs <|k[,ef|DIST]|> rhs  (sql/operator.rs:206 NearestNeighbor)."""

    lhs: Node
    rhs: Node
    k: int
    ef: Optional[int] = None  # approximate (HNSW) when set
    dist: Optional[str] = None  # brute-force with explicit distance


@dataclass
class FunctionCall(Node):
    name: str  # e.g. "array::len", "fn::custom", "ml::model"
    args: list
    version: Optional[str] = None  # ml::name<version>


@dataclass
class Cast(Node):
    kind: "Kind"
    expr: Node


@dataclass
class Constant(Node):
    name: str  # math::pi, time::EPOCH, ...


@dataclass
class ScriptExpr(Node):
    """function($a, $b) { raw js } — embedded script (fnc/script)."""

    args: list  # SurrealQL arg expressions
    source: str  # full raw text `function(...) { ... }`


@dataclass
class ClosureExpr(Node):
    params: list  # [(name, Kind|None)]
    body: Node
    returns: Optional["Kind"] = None


@dataclass
class Subquery(Node):
    stmt: Node  # a statement used in expression position


@dataclass
class BlockExpr(Node):
    stmts: list


@dataclass
class IfElse(Node):
    branches: list  # [(cond, body)]
    otherwise: Optional[Node] = None


@dataclass
class RegexLit(Node):
    pattern: str


@dataclass
class Mock(Node):
    """|table:count| or |table:min..max| — generate mock records.
    `..` excludes the end id, `..=` includes it; `>..` excludes the
    begin; open bounds span the i64 range (reference TypedRange)."""

    tb: str
    beg: Optional[int]
    end: Optional[int] = None
    end_incl: bool = False
    beg_excl: bool = False
    is_range: bool = False


# --- idioms -----------------------------------------------------------------


@dataclass
class Idiom(Node):
    parts: list  # Part subclasses below


class Part(Node):
    __slots__ = ()


@dataclass
class PField(Part):
    name: str


@dataclass
class PAll(Part):  # .* / [*]
    pass


@dataclass
class PFlatten(Part):  # … / ...
    pass


@dataclass
class PLast(Part):  # [$]
    pass


@dataclass
class PIndex(Part):
    expr: Node


@dataclass
class PWhere(Part):  # [WHERE cond] / [? cond]
    cond: Node


@dataclass
class PMethod(Part):  # .method(args) — value method call or fn chaining
    name: str
    args: list


@dataclass
class PGraph(Part):
    """->edge-> traversal step (expr/lookup.rs:79)."""

    dir: str  # 'out' (->), 'in' (<-), 'both' (<->)
    what: list  # [(table, cond_expr|None)] ; empty = ? (any)
    cond: Optional[Node] = None
    alias: Optional[Node] = None
    expr: Optional[list] = None  # SELECT-style projection inside the step
    # recursion support: {min..max} bounds attached by parser
    rec_min: Optional[int] = None
    rec_max: Optional[int] = None


@dataclass
class PDestructure(Part):
    fields: list  # [(name, None | Idiom-parts for nested/aliased)]


@dataclass
class POptional(Part):  # ?. optional chaining
    pass


@dataclass
class PRecurse(Part):
    """.{min..max}(path) bounded recursion (exec/operators/recursion.rs)."""

    min: int
    max: Optional[int]
    parts: list
    instruction: Optional[str] = None  # path|collect|shortest=<rid>


# ---------------------------------------------------------------------------
# Kinds (type ascriptions for CAST / DEFINE FIELD TYPE)
# ---------------------------------------------------------------------------


@dataclass
class Kind(Node):
    name: str  # any,null,bool,bytes,datetime,decimal,duration,float,int,
    # number,object,point,string,uuid,record,geometry,option,either,set,array,
    # literal,regex,range,function,file
    inner: list = field(default_factory=list)  # nested kinds / record tables
    size: Optional[int] = None  # array<string, 10>
    literal: Any = None  # literal kinds


# ---------------------------------------------------------------------------
# Statements
# ---------------------------------------------------------------------------


@dataclass
class Query(Node):
    stmts: list


@dataclass
class UseStmt(Node):
    ns: Optional[str] = None
    db: Optional[str] = None


@dataclass
class LetStmt(Node):
    name: str
    what: Node
    kind: Optional[Kind] = None


@dataclass
class ReturnStmt(Node):
    what: Node
    fetch: list = field(default_factory=list)


@dataclass
class IfStmt(Node):
    branches: list
    otherwise: Optional[Node] = None


@dataclass
class ForStmt(Node):
    param: str
    range: Node
    body: Node


@dataclass
class BreakStmt(Node):
    pass


@dataclass
class ContinueStmt(Node):
    pass


@dataclass
class ThrowStmt(Node):
    what: Node


@dataclass
class BeginStmt(Node):
    pass


@dataclass
class CommitStmt(Node):
    pass


@dataclass
class CancelStmt(Node):
    pass


@dataclass
class OptionStmt(Node):
    name: str
    value: bool = True


@dataclass
class SleepStmt(Node):
    duration: Node


@dataclass
class OutputClause(Node):
    kind: str  # none|null|diff|before|after|fields
    fields: list = field(default_factory=list)  # [(expr, alias)]


@dataclass
class SelectStmt(Node):
    exprs: list  # [(expr, alias:str|None)] ; [] + value_expr for VALUE
    what: list  # from targets (exprs)
    value: Optional[Node] = None  # SELECT VALUE expr
    value_alias: Optional[str] = None  # SELECT VALUE expr AS alias
    omit: list = field(default_factory=list)
    only: bool = False
    with_index: Optional[list] = None  # WITH INDEX a,b | NOINDEX -> []
    cond: Optional[Node] = None
    split: list = field(default_factory=list)
    group: Optional[list] = None  # None = no GROUP; [] = GROUP ALL
    order: list = field(default_factory=list)  # [(expr, dir, collate, numeric)] | 'rand'
    limit: Optional[Node] = None
    start: Optional[Node] = None
    fetch: list = field(default_factory=list)
    version: Optional[Node] = None
    timeout: Optional[Node] = None
    parallel: bool = False
    tempfiles: bool = False
    explain: Optional[bool] = None  # True=EXPLAIN, 'full'=EXPLAIN FULL
    ref_field: Optional[str] = None  # FIELD clause inside <~(SELECT ...)
    # READ AT <duration>: bounded-staleness follower read — the
    # statement runs read-only and may be served by a replica that can
    # prove it is at most this stale (kvs/remote.py closed timestamps)
    read_at: Optional[Node] = None


@dataclass
class CreateStmt(Node):
    what: list
    data: Optional[Node] = None  # SetData | ContentData ...
    output: Optional[OutputClause] = None
    only: bool = False
    timeout: Optional[Node] = None
    parallel: bool = False
    version: Optional[Node] = None


@dataclass
class UpdateStmt(Node):
    what: list
    data: Optional[Node] = None
    cond: Optional[Node] = None
    output: Optional[OutputClause] = None
    only: bool = False
    timeout: Optional[Node] = None
    parallel: bool = False
    explain: Any = None


@dataclass
class UpsertStmt(Node):
    what: list
    data: Optional[Node] = None
    cond: Optional[Node] = None
    output: Optional[OutputClause] = None
    only: bool = False
    timeout: Optional[Node] = None
    parallel: bool = False
    explain: Any = None


@dataclass
class DeleteStmt(Node):
    what: list
    cond: Optional[Node] = None
    output: Optional[OutputClause] = None
    only: bool = False
    timeout: Optional[Node] = None
    parallel: bool = False
    explain: Any = None


@dataclass
class InsertStmt(Node):
    into: Optional[Node]
    data: Node  # values expr | (fields, values rows) tuple via InsertRows
    ignore: bool = False
    update: Optional[list] = None  # ON DUPLICATE KEY UPDATE assignments
    output: Optional[OutputClause] = None
    relation: bool = False
    version: Optional[Node] = None


@dataclass
class InsertRows(Node):
    fields: list
    rows: list  # list of list of exprs


@dataclass
class RelateStmt(Node):
    kind: Node  # edge table expr
    from_: Node
    to: Node
    uniq: bool = False
    data: Optional[Node] = None
    output: Optional[OutputClause] = None
    only: bool = False
    timeout: Optional[Node] = None
    parallel: bool = False


# --- data clauses ----------------------------------------------------------


@dataclass
class SetData(Node):
    items: list  # [(idiom, op, expr)] op in =,+=,-=,*=


@dataclass
class UnsetData(Node):
    fields: list


@dataclass
class ContentData(Node):
    expr: Node


@dataclass
class ReplaceData(Node):
    expr: Node


@dataclass
class MergeData(Node):
    expr: Node


@dataclass
class PatchData(Node):
    expr: Node


# --- DEFINE ----------------------------------------------------------------


@dataclass
class DefineNamespace(Node):
    name: str
    if_not_exists: bool = False
    overwrite: bool = False
    comment: Optional[str] = None


@dataclass
class DefineDatabase(Node):
    name: str
    if_not_exists: bool = False
    overwrite: bool = False
    comment: Optional[str] = None
    changefeed: Optional[Node] = None
    strict: bool = False


@dataclass
class DefineTable(Node):
    name: str
    if_not_exists: bool = False
    overwrite: bool = False
    drop: bool = False
    full: bool = False  # SCHEMAFULL
    view: Optional[Node] = None  # AS SELECT ... (materialized view)
    permissions: Optional[dict] = None
    changefeed: Optional[Node] = None
    comment: Optional[str] = None
    kind: Optional[str] = None  # None=infer | normal | relation | any
    relation_from: list = field(default_factory=list)
    relation_to: list = field(default_factory=list)
    enforced: bool = False


@dataclass
class DefineField(Node):
    name: list  # idiom parts
    tb: str
    if_not_exists: bool = False
    overwrite: bool = False
    flex: bool = False
    kind: Optional[Kind] = None
    readonly: bool = False
    value: Optional[Node] = None
    assert_: Optional[Node] = None
    default: Optional[Node] = None
    default_always: bool = False
    computed: Optional[Node] = None
    permissions: Optional[dict] = None
    reference: Optional[dict] = None
    comment: Optional[str] = None


@dataclass
class DefineIndex(Node):
    name: str
    tb: str
    cols: list  # idioms
    if_not_exists: bool = False
    overwrite: bool = False
    unique: bool = False
    hnsw: Optional[dict] = None  # HnswParams (catalog/schema/index.rs:352)
    fulltext: Optional[dict] = None  # {analyzer, bm25(k1,b), highlights}
    count: bool = False
    count_cond: Optional[Node] = None  # COUNT WHERE <expr>
    concurrently: bool = False
    comment: Optional[str] = None


@dataclass
class DefineEvent(Node):
    name: str
    tb: str
    when: Optional[Node]
    then: list
    if_not_exists: bool = False
    overwrite: bool = False
    comment: Optional[str] = None
    async_: bool = False
    retry: Optional[int] = None
    maxdepth: Optional[int] = None


@dataclass
class DefineParam(Node):
    name: str
    value: Node
    if_not_exists: bool = False
    overwrite: bool = False
    permissions: Optional[Any] = None
    comment: Optional[str] = None


@dataclass
class DefineFunction(Node):
    name: str
    args: list  # [(name, Kind)]
    block: Node
    returns: Optional[Kind] = None
    if_not_exists: bool = False
    overwrite: bool = False
    permissions: Optional[Any] = None
    comment: Optional[str] = None


@dataclass
class DefineAnalyzer(Node):
    name: str
    tokenizers: list = field(default_factory=list)
    filters: list = field(default_factory=list)
    function: Optional[str] = None
    if_not_exists: bool = False
    overwrite: bool = False
    comment: Optional[str] = None


@dataclass
class DefineUser(Node):
    name: str
    base: str  # ROOT | NAMESPACE | DATABASE
    password: Optional[str] = None
    passhash: Optional[str] = None
    roles: list = field(default_factory=lambda: ["Viewer"])
    duration: Optional[dict] = None
    if_not_exists: bool = False
    overwrite: bool = False
    comment: Optional[str] = None


@dataclass
class DefineModule(Node):
    """DEFINE MODULE [mod::name AS] <executable> (surrealism packages)."""

    name: Optional[str]
    executable: Any
    comment: Optional[str] = None
    if_not_exists: bool = False
    overwrite: bool = False


@dataclass
class DefineAccess(Node):
    name: str
    base: str
    kind: str  # jwt | record | bearer
    config: dict = field(default_factory=dict)
    duration: Optional[dict] = None
    if_not_exists: bool = False
    overwrite: bool = False
    comment: Optional[str] = None


@dataclass
class DefineSequence(Node):
    name: str
    batch: int = 1000
    start: int = 0
    timeout: Optional[Node] = None
    if_not_exists: bool = False
    overwrite: bool = False


@dataclass
class DefineConfig(Node):
    what: str  # GRAPHQL | API
    config: dict = field(default_factory=dict)
    if_not_exists: bool = False
    overwrite: bool = False


@dataclass
class RemoveStmt(Node):
    kind: str  # namespace|database|table|field|index|event|param|function|
    # analyzer|user|access|sequence
    name: Any
    tb: Optional[str] = None
    base: Optional[str] = None
    if_exists: bool = False
    expunge: bool = False


@dataclass
class AlterTable(Node):
    name: str
    if_exists: bool = False
    compact: bool = False
    full: Optional[bool] = None
    drop: Optional[bool] = None
    kind: Optional[str] = None
    relation_from: Optional[list] = None
    relation_to: Optional[list] = None
    permissions: Optional[dict] = None
    changefeed: Optional[Node] = None
    comment: Optional[str] = None


@dataclass
class ExplainStmt(Node):
    """EXPLAIN [ANALYZE] <non-select statement/expression>."""

    stmt: Any
    analyze: bool = False


@dataclass
class AlterStmt(Node):
    """Generalized ALTER for non-table targets: a list of clause edits
    applied to the stored definition."""

    kind: str  # field|index|event|param|function|analyzer|user|access|api|
    # bucket|config|system|sequence
    name: Any
    tb: Optional[str] = None
    base: Optional[str] = None
    if_exists: bool = False
    changes: list = field(default_factory=list)  # [(clause, value|"__drop__")]


@dataclass
class InfoStmt(Node):
    level: str  # root|ns|db|table|user|index
    target: Optional[str] = None
    target2: Optional[str] = None
    structure: bool = False
    version: Optional[Node] = None


@dataclass
class LiveStmt(Node):
    expr: Any  # 'diff' or [(expr, alias)]
    what: Node
    cond: Optional[Node] = None
    fetch: list = field(default_factory=list)


@dataclass
class KillStmt(Node):
    id: Node


@dataclass
class ShowStmt(Node):
    table: Optional[str]
    since: Node
    limit: Optional[int] = None


@dataclass
class RebuildIndex(Node):
    name: str
    tb: str
    if_exists: bool = False


@dataclass
class AccessStmt(Node):
    """ACCESS ... GRANT/SHOW/REVOKE/PURGE (bearer grants; reference
    expr/statements/access.rs)."""

    name: str
    base: Optional[str]
    op: str
    subject: Any = None  # grant: ("user", name) | ("record", expr)
    selector: Any = None  # show/revoke: ("all"|"grant"|"where", operand)
    purge: Any = None  # purge: (kinds-set, grace-duration-expr)
