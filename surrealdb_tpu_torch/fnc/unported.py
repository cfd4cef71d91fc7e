"""The builtin functions the port leaves out (the reference's
`fnc/misc_fns.py` families parse, encoding, bytes, geo, value, http, api
and file). Each name stays in the registry, in the reference's order, so
the parser accepts it and its "did you mean" hints read as the
reference's; a call raises `NotPorted` naming the function. The ported
families of `fnc/misc_fns.py` (crypto, session, sequence, search)
register these names between their own, where the reference has them."""

from __future__ import annotations

from surrealdb_tpu_torch.err import NotPorted
from surrealdb_tpu_torch.fnc import register

UNPORTED_AFTER_CRYPTO = (
    "parse::email::host", "parse::email::user",
    "parse::url::domain", "parse::url::host", "parse::url::fragment",
    "parse::url::path", "parse::url::port", "parse::url::query",
    "parse::url::scheme", "encoding::base64::encode",
    "encoding::json::encode", "encoding::json::decode",
    "encoding::cbor::encode", "encoding::cbor::decode",
    "encoding::base64::decode", "string::base64_encode", "bytes::len",
    "geo::distance", "geo::bearing", "geo::centroid", "geo::area",
    "geo::hash::encode", "geo::hash::decode", "geo::is::valid",
)
UNPORTED_AFTER_SEQUENCE = ("value::chain", "value::diff", "value::patch")
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
