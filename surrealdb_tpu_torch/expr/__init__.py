"""Computation tree (AST) for SurrealQL.

One expression tree evaluated by the batch executor — unlike the reference,
which carries two engines (streaming exec/ + legacy dbs/ compute), this build
keeps a single batched executor with per-node evaluation as the scalar
fallback (SURVEY.md §7 step 3). Node shapes mirror the reference's
core/src/expr/ (plan.rs, statements/) where semantics matter.
"""

from surrealdb_tpu_torch.expr.ast import *  # noqa: F401,F403
