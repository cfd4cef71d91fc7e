"""The crypto::, session::, sequence:: and search:: families of the
reference's `fnc/misc_fns.py`: hashes and password hashing, the session's
attributes, batch-allocated sequences, the full-text score, highlight,
offsets and analyze functions over `idx/fulltext.py`, and the rrf and
linear fusions of result lists. The module's other families are not
ported (`fnc/unported.py`); their names register here, at their place in
the reference's order, and raise `NotPorted`."""

from __future__ import annotations

import hashlib
import hmac as _hmac
import secrets

from decimal import Decimal

from surrealdb_tpu_torch.err import SdbError
from surrealdb_tpu_torch.fnc import _str, register
from surrealdb_tpu_torch.fnc.unported import (
    UNPORTED_AFTER_CRYPTO,
    UNPORTED_AFTER_SEARCH,
    UNPORTED_AFTER_SEQUENCE,
    register_unported,
)
from surrealdb_tpu_torch.val import NONE


# -- crypto -------------------------------------------------------------------


@register("crypto::md5")
def _md5(args, ctx):
    return hashlib.md5(_str(args[0], "crypto::md5", 1).encode()).hexdigest()


@register("crypto::sha1")
def _sha1(args, ctx):
    return hashlib.sha1(_str(args[0], "crypto::sha1", 1).encode()).hexdigest()


@register("crypto::sha256")
def _sha256(args, ctx):
    return hashlib.sha256(_str(args[0], "crypto::sha256", 1).encode()).hexdigest()


@register("crypto::joaat")
def _joaat(args, ctx):
    """Jenkins one-at-a-time hash (u32 decimal, reference fnc/crypto)."""
    data = _str(args[0], "crypto::joaat", 1).encode()
    h = 0
    for b in data:
        h = (h + b) & 0xFFFFFFFF
        h = (h + (h << 10)) & 0xFFFFFFFF
        h ^= h >> 6
    h = (h + (h << 3)) & 0xFFFFFFFF
    h ^= h >> 11
    h = (h + (h << 15)) & 0xFFFFFFFF
    return h


@register("crypto::sha512")
def _sha512(args, ctx):
    return hashlib.sha512(_str(args[0], "crypto::sha512", 1).encode()).hexdigest()


@register("crypto::blake3")
def _blake3(args, ctx):
    from surrealdb_tpu_torch.utils.blake3 import blake3_hex

    return blake3_hex(_str(args[0], "crypto::blake3", 1).encode())


# password hashing: argon2id (the reference's user passhashes) where the
# `argon2` package imports, pbkdf2 and scrypt; bcrypt takes the pbkdf2 route


def _pbkdf2_hash(pw: str, rounds=600_000) -> str:
    salt = secrets.token_bytes(16)
    dk = hashlib.pbkdf2_hmac("sha256", pw.encode(), salt, rounds)
    return f"$pbkdf2-sha256$i={rounds}${salt.hex()}${dk.hex()}"


def _pbkdf2_compare(h: str, pw: str) -> bool:
    try:
        _, alg, iters, salt, dk = h.split("$")
        rounds = int(iters.split("=")[1])
        got = hashlib.pbkdf2_hmac("sha256", pw.encode(), bytes.fromhex(salt), rounds)
        return _hmac.compare_digest(got.hex(), dk)
    except (ValueError, IndexError):
        return False


def _scrypt_hash(pw: str) -> str:
    salt = secrets.token_bytes(16)
    dk = hashlib.scrypt(pw.encode(), salt=salt, n=2**14, r=8, p=1)
    return f"$scrypt$n=16384,r=8,p=1${salt.hex()}${dk.hex()}"


def _scrypt_compare(h: str, pw: str) -> bool:
    try:
        parts = h.split("$")
        salt, dk = parts[3], parts[4]
        got = hashlib.scrypt(pw.encode(), salt=bytes.fromhex(salt), n=2**14, r=8, p=1)
        return _hmac.compare_digest(got.hex(), dk)
    except (ValueError, IndexError):
        return False


@register("crypto::pbkdf2::generate")
def _pbkdf2_gen(args, ctx):
    return _pbkdf2_hash(_str(args[0], "f", 1))


@register("crypto::pbkdf2::compare")
def _pbkdf2_cmp(args, ctx):
    return _pbkdf2_compare(_str(args[0], "f", 1), _str(args[1], "f", 2))


@register("crypto::scrypt::generate")
def _scrypt_gen(args, ctx):
    return _scrypt_hash(_str(args[0], "f", 1))


@register("crypto::scrypt::compare")
def _scrypt_cmp(args, ctx):
    return _scrypt_compare(_str(args[0], "f", 1), _str(args[1], "f", 2))


def _argon2():
    """The `argon2` package (argon2-cffi), or an error that names it: an
    argon2id hash is never quietly compared as false where it cannot be
    read."""
    try:
        import argon2
        import argon2.exceptions
    except ImportError:
        raise SdbError(
            "argon2id hashing needs the `argon2` package (argon2-cffi), "
            "which is not installed"
        )
    return argon2


def argon2_available() -> bool:
    try:
        _argon2()
    except SdbError:
        return False
    return True


def _argon2_hash(pw: str) -> str:
    return _argon2().PasswordHasher().hash(pw)


def _argon2_compare(h: str, pw: str) -> bool:
    a2 = _argon2()
    try:
        return a2.PasswordHasher().verify(h, pw)
    except (a2.exceptions.VerifyMismatchError,
            a2.exceptions.VerificationError,
            a2.exceptions.InvalidHashError):
        return False


@register("crypto::argon2::generate")
def _argon2_gen(args, ctx):
    return _argon2_hash(_str(args[0], "f", 1))


@register("crypto::argon2::compare")
def _argon2_cmp(args, ctx):
    return _argon2_compare(_str(args[0], "f", 1), _str(args[1], "f", 2))


@register("crypto::bcrypt::generate")
def _bcrypt_gen(args, ctx):
    return _pbkdf2_hash(_str(args[0], "f", 1))


@register("crypto::bcrypt::compare")
def _bcrypt_cmp(args, ctx):
    return _pbkdf2_compare(_str(args[0], "f", 1), _str(args[1], "f", 2))


def password_hash(pw: str) -> str:
    """A user's passhash: argon2id, as the reference's, where the
    `argon2` package imports; elsewhere the reference's own
    `$scrypt$n=16384,r=8,p=1$...` form, which the reference reads too."""
    if argon2_available():
        return _argon2_hash(pw)
    return _scrypt_hash(pw)


def password_compare(h: str, pw: str) -> bool:
    if h.startswith("$argon2"):
        return _argon2_compare(h, pw)
    if h.startswith("$pbkdf2"):
        return _pbkdf2_compare(h, pw)
    if h.startswith("$scrypt"):
        return _scrypt_compare(h, pw)
    return False


# parse::, encoding::, bytes::, geo:: (not ported)
register_unported(UNPORTED_AFTER_CRYPTO)


# -- session ------------------------------------------------------------------


@register("session::ac")
def _s_ac(args, ctx):
    return ctx.session.ac if ctx.session.ac else NONE


@register("session::db")
def _s_db(args, ctx):
    return ctx.session.db if ctx.session.db else NONE


@register("session::ns")
def _s_ns(args, ctx):
    return ctx.session.ns if ctx.session.ns else NONE


@register("session::id")
def _s_id(args, ctx):
    return NONE


@register("session::ip")
def _s_ip(args, ctx):
    return NONE


@register("session::origin")
def _s_origin(args, ctx):
    return NONE


@register("session::rd")
def _s_rd(args, ctx):
    return ctx.session.rid if ctx.session.rid else NONE


@register("session::token")
def _s_token(args, ctx):
    return ctx.vars.get("token", NONE)


# -- sequence -----------------------------------------------------------------


@register("sequence::nextval")
def _nextval(args, ctx):
    """Batch-allocated distributed sequences (kvs/sequences.rs:1-20):
    each node transactionally claims a BATCH-sized id range from the KV
    state row in its OWN transaction, then hands ids out locally — so
    concurrent nodes contend once per batch, not once per id, and ids
    survive the calling statement's rollback (reference semantics)."""
    from surrealdb_tpu_torch import key as K
    from surrealdb_tpu_torch.kvs.mem import CONFLICT_MSG

    name = _str(args[0], "sequence::nextval", 1)
    ns, db = ctx.need_ns_db()
    kdef = K.seq_state(ns, db, name)
    skey = (ns, db, name)
    with ctx.ds.lock:
        rng = ctx.ds.sequences.get(skey)
        if rng is not None and rng[0] < rng[1]:
            v = rng[0]
            rng[0] += 1
            return v
    st = ctx.txn.get_val(kdef)
    if st is None:
        raise SdbError(f"The sequence '{name}' does not exist")
    tmo = getattr(st[0], "timeout", None)
    deadline = None
    if tmo is not None and getattr(tmo, "ns", None) is not None:
        import time as _time

        # batch allocation respects the sequence's TIMEOUT (reference
        # kvs/sequences.rs; a 0ns timeout can never allocate)
        if tmo.ns == 0:
            raise SdbError(
                "The query was not executed because it exceeded the "
                f"timeout: {tmo.render()}"
            )
        deadline = _time.monotonic() + tmo.ns / 1e9
    for _ in range(16):
        if deadline is not None:
            import time as _time

            if _time.monotonic() > deadline:
                raise SdbError(
                    "The query was not executed because it exceeded the "
                    f"timeout: {tmo.render()}"
                )
        txn = ctx.ds.transaction(write=True)
        try:
            st2 = txn.get_val(kdef)
            if st2 is None:
                # defined inside the caller's still-uncommitted txn:
                # allocate through that txn (single-node bootstrap case)
                txn.cancel()
                sd, current = st
                ctx.txn.set_val(kdef, (sd, current + 1))
                return current
            sd, current = st2
            batch = max(int(getattr(sd, "batch", 1000) or 1), 1)
            txn.set_val(kdef, (sd, current + batch))
            txn.commit()
            with ctx.ds.lock:
                ctx.ds.sequences[skey] = [current + 1, current + batch]
            return current
        except SdbError as e:
            txn.cancel()
            if str(e) != CONFLICT_MSG:
                raise
    raise SdbError(f"sequence '{name}' allocation contention")


# value:: (not ported)
register_unported(UNPORTED_AFTER_SEQUENCE)


# -- search -------------------------------------------------------------------


@register("search::score")
def _search_score(args, ctx):
    from surrealdb_tpu_torch.idx.fulltext import search_score

    return search_score(int(args[0]) if args else 0, ctx)


@register("search::highlight")
def _search_highlight(args, ctx):
    from surrealdb_tpu_torch.idx.fulltext import search_highlight

    return search_highlight(args, ctx)


@register("search::offsets")
def _search_offsets(args, ctx):
    from surrealdb_tpu_torch.idx.fulltext import search_offsets

    return search_offsets(args, ctx)


@register("search::analyze")
def _search_analyze(args, ctx):
    from surrealdb_tpu_torch.idx.fulltext import analyze_text

    az = _str(args[0], "search::analyze", 1)
    return analyze_text(az, _str(args[1], "search::analyze", 2), ctx)


@register("search::rrf")
def _search_rrf(args, ctx):
    """Reciprocal-rank fusion of result-object arrays keyed on `id`
    (reference fnc search::rrf: merged fields + rrf_score)."""
    lists = args[0] if args else []
    limit = args[1] if len(args) > 1 else None
    k = args[2] if len(args) > 2 else 60
    if not isinstance(limit, int) or isinstance(limit, bool) or limit < 1:
        raise SdbError(
            "Incorrect arguments for function search::rrf(). "
            "limit must be at least 1"
        )
    if not isinstance(k, (int, float)) or isinstance(k, bool) or k < 0:
        raise SdbError(
            "Incorrect arguments for function search::rrf(). "
            "RRF constant must be at least 0"
        )
    from surrealdb_tpu_torch.val import hashable

    scores: dict = {}
    merged: dict = {}
    order: list = []
    for lst in lists or []:
        if not isinstance(lst, list):
            continue
        for rank, item in enumerate(lst):
            if not isinstance(item, dict):
                continue
            h = hashable(item.get("id", rank))
            if h not in merged:
                merged[h] = dict(item)
                order.append(h)
            else:
                merged[h].update(item)
            scores[h] = scores.get(h, 0.0) + 1.0 / (k + rank + 1)
    out = sorted(order, key=lambda h: -scores[h])[: int(limit)]
    res = []
    for h in out:
        row = merged[h]
        row["rrf_score"] = scores[h]
        res.append(row)
    return res


@register("search::linear")
def _search_linear(args, ctx):
    """Weighted linear fusion with per-list score normalization
    (reference fnc search::linear: minmax/zscore + linear_score)."""
    lists = args[0] if args else []
    weights = args[1] if len(args) > 1 else []
    limit = args[2] if len(args) > 2 else None
    norm = args[3] if len(args) > 3 else "minmax"
    if not isinstance(limit, int) or isinstance(limit, bool) or limit < 1:
        raise SdbError(
            "Incorrect arguments for function search::linear(). "
            "Limit must be at least 1"
        )
    if norm not in ("minmax", "zscore"):
        raise SdbError(
            "Incorrect arguments for function search::linear(). "
            "Norm must be 'minmax' or 'zscore'"
        )
    if not isinstance(lists, list) or not isinstance(weights, list) or \
            len(lists) != len(weights):
        raise SdbError(
            "Incorrect arguments for function search::linear(). "
            "The results and the weights array should have the same length"
        )
    for i, w in enumerate(weights):
        if isinstance(w, bool) or not isinstance(w, (int, float, Decimal)):
            raise SdbError(
                "Incorrect arguments for function search::linear(). "
                f"Weight at index {i} must be a number"
            )
    from surrealdb_tpu_torch.val import hashable

    # mirrors the reference's exact float op order (fnc/search.rs:380-537)
    # so normalized scores match bit-for-bit: per-doc raw score is
    # distance→1/(1+d) | ft_score | score | rank fallback 1/(1+count);
    # params per list, then weighted combination over score>0 entries
    n_lists = len(lists)
    documents: dict = {}  # h -> [scores_per_list, merged_obj]
    order: list = []
    count = 0
    for list_idx, lst in enumerate(lists):
        if not isinstance(lst, list):
            continue
        for item in lst:
            if not isinstance(item, dict) or "id" not in item:
                continue
            d = item.get("distance")
            fts = item.get("ft_score")
            sc = item.get("score")
            if isinstance(d, (int, float, Decimal)) and \
                    not isinstance(d, bool):
                score = 1.0 / (1.0 + float(d))
            elif isinstance(fts, (int, float, Decimal)) and \
                    not isinstance(fts, bool):
                score = float(fts)
            elif isinstance(sc, (int, float, Decimal)) and \
                    not isinstance(sc, bool):
                score = float(sc)
            else:
                score = 1.0 / (1.0 + count)
            h = hashable(item.get("id"))
            if h not in documents:
                documents[h] = [[0.0] * n_lists, dict(item)]
                order.append(h)
            else:
                documents[h][1].update(item)
            documents[h][0][list_idx] = score
            count += 1
    # per-list normalization params over scores > 0
    params = []
    for list_idx in range(n_lists):
        vals = [doc[0][list_idx] for doc in documents.values()
                if doc[0][list_idx] > 0.0]
        if not vals:
            params.append((0.0, 1.0))
            continue
        if norm == "minmax":
            lo = min(vals)
            rng = max(vals) - lo
            params.append((lo, rng if rng > 0.0 else 1.0))
        else:
            mean = sum(vals) / len(vals)
            var = sum((x - mean) ** 2 for x in vals) / len(vals)
            sd = var ** 0.5
            params.append((mean, sd if sd > 0.0 else 1.0))
    combined: dict = {}
    for h in order:
        scores_l, _obj = documents[h]
        total = 0.0
        for list_idx, score in enumerate(scores_l):
            if score > 0.0:
                w = weights[list_idx] if list_idx < len(weights) else 1.0
                a, b = params[list_idx]
                total += float(w) * ((score - a) / b)
        combined[h] = total
    out = sorted(order, key=lambda h: -combined[h])[: int(limit)]
    res = []
    for h in out:
        row = documents[h][1]
        row["linear_score"] = combined[h]
        res.append(row)
    return res


# http::, api::, file:: (not ported)
register_unported(UNPORTED_AFTER_SEARCH)
