"""SurrealQL frontend: lexer + recursive-descent parser.

Reference: surrealdb core/src/syn/ (hand-written lexer +
parser). This build parses directly into the computation tree
(surrealdb_tpu_torch.expr.ast) — no separate sql:: AST layer, since there is a
single execution engine.
"""

from surrealdb_tpu_torch.syn.parser import Parser


def parse(text: str, capabilities=None):
    """Parse a SurrealQL query into a list of statements."""
    p = Parser(text)
    if capabilities is not None:
        p.capabilities = capabilities
    return p.parse_query()

