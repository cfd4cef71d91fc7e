"""The builtin functions the port leaves out: the reference's
`fnc/misc_fns.py` families http::, api:: and file::. Each name stays in
the registry, in the reference's order, so the parser accepts it and its
"did you mean" hints read as the reference's; a call raises `NotPorted`
naming the function. `fnc/misc_fns.py` registers these names after its
search:: family, where the reference has them."""

from __future__ import annotations

from surrealdb_tpu_torch.err import NotPorted
from surrealdb_tpu_torch.fnc import register

UNPORTED_AFTER_SEARCH = (
    "http::head", "http::get", "http::put", "http::post", "http::patch",
    "http::delete", "api::invoke", "file::bucket", "file::key", "file::put",
    "file::put_if_not_exists", "file::get", "file::head", "file::exists",
    "file::delete", "file::copy", "file::copy_if_not_exists", "file::rename",
    "file::rename_if_not_exists", "file::list",
)


def _unported(name):
    def fn(args, ctx):
        raise NotPorted(f"function {name}() is not ported")

    return fn


def register_unported(names):
    for name in names:
        register(name)(_unported(name))
