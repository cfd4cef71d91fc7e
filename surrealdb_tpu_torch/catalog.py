"""Catalog — definition structs stored in the KV store.

Reference: core/src/catalog/ ("the only structs stored physically in the KV
store", catalog/mod.rs:1-7). Definitions are stored pickled under /!xx keys
(see surrealdb_tpu_torch.key) and carry the parsed ASTs for VALUE/ASSERT/PERMISSIONS
clauses, which the executor evaluates per document.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional


@dataclass
class NamespaceDef:
    name: str
    comment: Optional[str] = None


@dataclass
class DatabaseDef:
    name: str
    comment: Optional[str] = None
    changefeed: Optional[int] = None  # retention ns
    strict: bool = False  # tables must be DEFINEd before use


@dataclass
class TableDef:
    name: str
    table_id: int = 0  # catalog allocation id (INFO STRUCTURE `id`)
    drop: bool = False
    full: bool = False  # SCHEMAFULL
    kind: str = "any"  # any | normal | relation
    relation_from: list = field(default_factory=list)
    relation_to: list = field(default_factory=list)
    enforced: bool = False
    view: Any = None  # SelectStmt AST for materialized views
    permissions: Optional[dict] = None  # action -> bool | cond AST
    changefeed: Optional[int] = None
    changefeed_original: bool = False
    comment: Optional[str] = None


@dataclass
class FieldDef:
    name: list  # idiom parts
    name_str: str
    flex: bool = False
    kind: Any = None  # Kind AST
    readonly: bool = False
    value: Any = None
    assert_: Any = None
    default: Any = None
    default_always: bool = False
    computed: Any = None
    permissions: Optional[dict] = None
    reference: Optional[dict] = None
    comment: Optional[str] = None


@dataclass
class IndexDef:
    name: str
    tb: str
    cols: list  # idiom ASTs
    cols_str: list = field(default_factory=list)
    unique: bool = False
    hnsw: Optional[dict] = None
    fulltext: Optional[dict] = None
    count: bool = False
    count_cond: Any = None  # COUNT WHERE expr AST
    comment: Optional[str] = None
    # ALTER INDEX ... PREPARE REMOVE: writes still maintain the index but
    # the planner stops reading it (reference alter index decommission)
    prepare_remove: bool = False


@dataclass
class EventDef:
    name: str
    when: Any = None
    then: list = field(default_factory=list)
    comment: Optional[str] = None
    async_: bool = False
    retry: Any = None
    maxdepth: Any = None


@dataclass
class ParamDef:
    name: str
    value: Any = None  # computed value
    permissions: Any = True
    comment: Optional[str] = None


@dataclass
class FunctionDef:
    name: str
    args: list = field(default_factory=list)
    block: Any = None
    returns: Any = None
    permissions: Any = True
    comment: Optional[str] = None


@dataclass
class AnalyzerDef:
    name: str
    tokenizers: list = field(default_factory=list)
    filters: list = field(default_factory=list)
    function: Optional[str] = None
    comment: Optional[str] = None


@dataclass
class UserDef:
    name: str
    base: str
    passhash: str = ""
    roles: list = field(default_factory=lambda: ["Viewer"])
    duration: Optional[dict] = None
    comment: Optional[str] = None


@dataclass
class AccessDef:
    name: str
    base: str
    kind: str
    config: dict = field(default_factory=dict)
    duration: Optional[dict] = None
    comment: Optional[str] = None


@dataclass
class MlModelDef:
    """A stored ML model (reference catalog MlModelDefinition +
    surrealml hash-addressed storage)."""

    name: str
    version: str
    comment: Optional[str] = None
    permissions: Any = True
    hash: str = ""


@dataclass
class ModuleDef:
    """A stored WASM module (reference DEFINE MODULE / .surli packages)."""

    name: str
    comment: Optional[str] = None
    permissions: Any = True
    hash: str = ""
    exports: list = field(default_factory=list)


@dataclass
class SequenceDef:
    name: str
    batch: int = 1000
    start: int = 0
    timeout: Any = None  # Duration


@dataclass
class ApiActionDef:
    methods: list = field(default_factory=list)
    middleware: list = field(default_factory=list)  # [(name, [arg exprs])]
    permissions: Any = True
    then: Any = None


@dataclass
class ApiDef:
    path: str
    actions: list = field(default_factory=list)  # ApiActionDef
    fallback: Any = None
    comment: Any = None


@dataclass
class ConfigDef:
    what: str  # API | GRAPHQL
    middleware: list = field(default_factory=list)
    permissions: Any = True
    # GRAPHQL: "AUTO" | "NONE" | ("INCLUDE"|"EXCLUDE", [names])
    tables: Any = "NONE"
    functions: Any = "NONE"
    depth: Any = None
    complexity: Any = None
    introspection: Any = None  # "AUTO" (default, unrendered) | "NONE"
    # DEFAULT config (session namespace/database)
    namespace: Any = None
    database: Any = None


@dataclass
class BucketDef:
    name: str
    backend: Any = None
    readonly: bool = False
    permissions: Any = True
    comment: Any = None


@dataclass
class SubscriptionDef:
    """A LIVE query subscription (catalog/subscription.rs)."""

    id: str
    ns: str
    db: str
    tb: str
    expr: Any = None  # 'diff' | fields
    cond: Any = None
    fetch: list = field(default_factory=list)
    session_vars: dict = field(default_factory=dict)
    auth_level: str = "owner"
    rid: Any = None
    node: Any = None  # owning node id (dead-node GC, dbs/node.rs)
