"""The builtin functions the port leaves out (the reference's
`fnc/misc_fns.py` families but search: crypto, parse, encoding, bytes,
geo, session, sequence, value, http, api and file). Each name stays in
the registry, in the reference's order, so the parser accepts it and its
"did you mean" hints read as the reference's; a call raises `NotPorted`
naming the function. The ported search family (`fnc/misc_fns.py`)
registers at its place between value:: and http::."""

from __future__ import annotations

from surrealdb_tpu_torch.err import NotPorted
from surrealdb_tpu_torch.fnc import register

UNPORTED = (
    "crypto::md5", "crypto::sha1", "crypto::sha256", "crypto::joaat",
    "crypto::sha512", "crypto::blake3", "crypto::pbkdf2::generate",
    "crypto::pbkdf2::compare", "crypto::scrypt::generate",
    "crypto::scrypt::compare", "crypto::argon2::generate",
    "crypto::argon2::compare", "crypto::bcrypt::generate",
    "crypto::bcrypt::compare", "parse::email::host", "parse::email::user",
    "parse::url::domain", "parse::url::host", "parse::url::fragment",
    "parse::url::path", "parse::url::port", "parse::url::query",
    "parse::url::scheme", "encoding::base64::encode",
    "encoding::json::encode", "encoding::json::decode",
    "encoding::cbor::encode", "encoding::cbor::decode",
    "encoding::base64::decode", "string::base64_encode", "bytes::len",
    "geo::distance", "geo::bearing", "geo::centroid", "geo::area",
    "geo::hash::encode", "geo::hash::decode", "geo::is::valid",
    "session::ac", "session::db", "session::ns", "session::id",
    "session::ip", "session::origin", "session::rd", "session::token",
    "sequence::nextval", "value::chain", "value::diff", "value::patch",
)
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


for _name in UNPORTED:
    register(_name)(_unported(_name))

# the ported search family takes its place in the registry's order
from surrealdb_tpu_torch.fnc import misc_fns  # noqa: E402,F401

for _name in UNPORTED_AFTER_SEARCH:
    register(_name)(_unported(_name))
