"""Full-text search: analyzers + BM25 postings (reference: core/src/idx/ft/
fulltext.rs Bm25Params/Scorer, analyzer/ tokenizers+filters).

Postings live in KV under index-state keys: per-term doc maps with term
frequencies and offsets; doc lengths and corpus stats alongside. BM25 at
query time; hybrid rerank composes with the vector engine via search::rrf.
"""

from __future__ import annotations

import math
import re as _re
import time

from surrealdb_tpu_torch import key as K
from surrealdb_tpu_torch.catalog import AnalyzerDef
from surrealdb_tpu_torch.err import SdbError
from surrealdb_tpu_torch.val import NONE, RecordId, hashable, is_truthy

# ---------------------------------------------------------------------------
# analyzers
# ---------------------------------------------------------------------------

_CAMEL_RX = _re.compile(r"(?<=[a-z0-9])(?=[A-Z])")


def _tokenize(text: str, tokenizers: list) -> list[tuple[str, int, int]]:
    """Returns (token, start, end) triples."""
    if not tokenizers:
        tokenizers = ["blank"]
    spans = [(text, 0)]
    for tk in tokenizers:
        out = []
        for s, base in spans:
            if tk == "blank":
                for m in _re.finditer(r"\S+", s):
                    out.append((m.group(), base + m.start()))
            elif tk == "punct":
                # punctuation chars are tokens of their own (they count
                # toward BM25 doc length, like the reference tokenizer)
                for m in _re.finditer(r"\w+|[^\w\s]", s):
                    out.append((m.group(), base + m.start()))
            elif tk == "class":
                # split on unicode character-class changes (letter/digit/other)
                cur = []
                cstart = 0

                def _cls(ch):
                    if ch.isalpha():
                        return "a"
                    if ch.isdigit():
                        return "d"
                    if ch.isspace():
                        return "s"
                    return "p"

                prev = None
                for ci, ch in enumerate(s):
                    c = _cls(ch)
                    if c != prev and cur:
                        if prev != "s":
                            out.append(("".join(cur), base + cstart))
                        cur = []
                    if c != prev:
                        cstart = ci
                    prev = c
                    cur.append(ch)
                if cur and prev != "s":
                    out.append(("".join(cur), base + cstart))
            elif tk == "camel":
                pos = 0
                for part in _CAMEL_RX.split(s):
                    idx = s.find(part, pos)
                    out.append((part, base + idx))
                    pos = idx + len(part)
            else:
                out.append((s, base))
        spans = [(t, p) for t, p in out]
    return [(t, p, p + len(t), p, p + len(t)) for t, p in spans]


_STOP_SUFFIXES = [
    "ational", "tional", "iveness", "fulness", "ousness", "ization", "ement",
    "ments", "ment", "ings", "ing", "edly", "ed", "ies", "ly", "es", "s",
]


def _stem(word: str) -> str:
    """Lightweight english stemmer (snowball-lite)."""
    if len(word) <= 3:
        return word
    for suf in _STOP_SUFFIXES:
        if word.endswith(suf) and len(word) - len(suf) >= 3:
            return word[: -len(suf)]
    return word


def _apply_filters(tokens, filters, stage="index"):
    out = tokens
    for f in filters:
        name = f[0]
        # ngram family generates index-time grams only; query text keeps
        # its whole tokens (reference filter.rs is_stage FilteringStage)
        if stage == "query" and name in ("ngram", "edgengram"):
            continue
        nxt = []
        if name == "lowercase":
            nxt = [(t.lower(), a, b, oa, ob) for t, a, b, oa, ob in out]
        elif name == "uppercase":
            nxt = [(t.upper(), a, b, oa, ob) for t, a, b, oa, ob in out]
        elif name == "ascii":
            import unicodedata

            nxt = [
                (
                    unicodedata.normalize("NFKD", t)
                    .encode("ascii", "ignore")
                    .decode(),
                    a,
                    b,
                    oa,
                    ob,
                )
                for t, a, b, oa, ob in out
            ]
        elif name == "snowball":
            nxt = [(_stem(t.lower()), a, b, oa, ob) for t, a, b, oa, ob in out]
        elif name == "edgengram":
            lo, hi = int(f[1]), int(f[2])
            for t, a, b, oa, ob in out:
                for n in range(lo, min(hi, len(t)) + 1):
                    nxt.append((t[:n], a, a + n, oa, ob))
        elif name == "ngram":
            lo, hi = int(f[1]), int(f[2])
            for t, a, b, oa, ob in out:
                for n in range(lo, hi + 1):
                    for i in range(0, max(len(t) - n + 1, 0)):
                        nxt.append((t[i : i + n], a + i, a + i + n, oa, ob))
        else:
            nxt = out
        out = nxt
    return out


def get_analyzer(name, ctx) -> AnalyzerDef:
    if name is None:
        return AnalyzerDef("like", ["blank"], [("lowercase",)])
    ns, db = ctx.need_ns_db()
    az = ctx.txn.get_val(K.az_def(ns, db, name))
    if az is None:
        raise SdbError(f"The analyzer '{name}' does not exist")
    return az


def analyze(az: AnalyzerDef, text: str, ctx=None, stage="index"):
    # FUNCTION analyzers preprocess the text through a custom function
    # that must return a string (reference ft/analyzer mapper)
    if getattr(az, "function", None) and ctx is not None:
        from surrealdb_tpu_torch.fnc import call_custom

        name = az.function
        if name.startswith("fn::"):
            name = name[4:]
        out = call_custom(name, [text], ctx)
        if not isinstance(out, str):
            from surrealdb_tpu_torch.err import SdbError

            raise SdbError(
                f"There was a problem running the {name}() function. "
                f"The function should return a string."
            )
        text = out
    return _apply_filters(_tokenize(text, az.tokenizers), az.filters, stage)


def analyze_text(az_name, text, ctx):
    az = get_analyzer(az_name, ctx)
    return [tok[0] for tok in analyze(az, text, ctx)]


# ---------------------------------------------------------------------------
# index maintenance
# ---------------------------------------------------------------------------


def _flatten_strings(v):
    """All strings in a value, depth-first; objects iterate in sorted key
    order (the reference's Object is a BTreeMap, so the analyzer visits
    nested strings lexicographically by key)."""
    if isinstance(v, str):
        return [v]
    out = []
    if isinstance(v, list):
        for x in v:
            out.extend(_flatten_strings(x))
    elif isinstance(v, dict):
        for k in sorted(v):
            out.extend(_flatten_strings(v[k]))
    return out


def _doc_terms(idef, doc, ctx, rid):
    from surrealdb_tpu_torch.exec.eval import evaluate

    az = get_analyzer(idef.fulltext.get("analyzer"), ctx)
    c = ctx.with_doc(doc, rid)
    terms: dict = {}
    length = 0
    for col in idef.cols:
        v = evaluate(col, c)
        texts = _flatten_strings(v)
        for vi, text in enumerate(texts):
            for t, a, b, oa, ob in analyze(az, text):
                if not t:
                    continue
                length += 1
                tf, offs = terms.get(t, (0, []))
                terms[t] = (tf + 1, offs + [(vi, a, b, oa, ob)])
    return terms, length


def _post_key(ns, db, tb, ix, term):
    return K.ix_state(ns, db, tb, ix, b"bf", K.enc_str(term))


def _len_key(ns, db, tb, ix, rid_id):
    return K.ix_state(ns, db, tb, ix, b"bl", K.enc_value(rid_id))


def _stats_key(ns, db, tb, ix):
    return K.ix_state(ns, db, tb, ix, b"bs")


def _ver_key(ns, db, tb, ix):
    # monotone write counter: the search-result cache's invalidation
    # token (read through the caller's txn, so an uncommitted write in
    # the SAME txn already misses the cache)
    return K.ix_state(ns, db, tb, ix, b"bv")


def fulltext_index_update(idef, rid: RecordId, before, after, ctx):
    ns, db = ctx.need_ns_db()
    tb = rid.tb
    ix = idef.name
    ridk = K.enc_value(rid.id)
    old_terms = {}
    if isinstance(before, dict):
        old_terms, old_len = _doc_terms(idef, before, ctx, rid)
    new_terms, new_len = ({}, 0)
    if isinstance(after, dict):
        new_terms, new_len = _doc_terms(idef, after, ctx, rid)
    stats = ctx.txn.get_val(_stats_key(ns, db, tb, ix)) or {
        "docs": 0,
        "total_len": 0,
    }
    had = ctx.txn.get_val(_len_key(ns, db, tb, ix, rid.id))
    if had is not None:
        stats["docs"] -= 1
        stats["total_len"] -= had
        ctx.txn.delete(_len_key(ns, db, tb, ix, rid.id))
    for t in old_terms:
        pk = _post_key(ns, db, tb, ix, t)
        post = ctx.txn.get_val(pk) or {}
        post.pop(ridk, None)
        if post:
            ctx.txn.set_val(pk, post)
        else:
            ctx.txn.delete(pk)
    if new_terms:
        for t, (tf, offs) in new_terms.items():
            pk = _post_key(ns, db, tb, ix, t)
            post = ctx.txn.get_val(pk) or {}
            post[ridk] = (tf, offs, rid.id)
            ctx.txn.set_val(pk, post)
        ctx.txn.set_val(_len_key(ns, db, tb, ix, rid.id), new_len)
        stats["docs"] += 1
        stats["total_len"] += new_len
    ctx.txn.set_val(_stats_key(ns, db, tb, ix), stats)
    cur = ctx.txn.get_val(_ver_key(ns, db, tb, ix))
    if cur is None:
        # generation base, not 0: REMOVE INDEX + DEFINE INDEX wipes this
        # key, and a plain counter could climb back to a previously
        # cached value — a wall-clock base makes versions from different
        # index generations disjoint, on every node that shares the KV
        cur = time.time_ns()
    ctx.txn.set_val(_ver_key(ns, db, tb, ix), cur + 1)


# ---------------------------------------------------------------------------
# search (BM25)
# ---------------------------------------------------------------------------


class FtResult:
    """One search's shared, read-only result: hits/offsets plus lazily
    derived lookup structures (score map, rid map, ordered rid list)
    that the match planner and the score pseudo-functions reuse —
    consumers MUST NOT mutate any of these."""

    __slots__ = ("hits", "offsets", "_scores", "_rid_map", "_ordered")

    def __init__(self, hits, offsets):
        self.hits = hits
        self.offsets = offsets
        self._scores = None
        self._rid_map = None
        self._ordered = None

    @property
    def scores(self) -> dict:
        s = self._scores
        if s is None:
            s = self._scores = {hashable(r): sc for r, sc in self.hits}
        return s

    @property
    def rid_map(self) -> dict:
        m = self._rid_map
        if m is None:
            m = self._rid_map = {hashable(r): r for r, _s in self.hits}
        return m

    @property
    def ordered(self) -> list:
        o = self._ordered
        if o is None:
            o = self._ordered = [r for r, _s in self.hits]
        return o

    def cost_bytes(self) -> int:
        """Cheap cache-cost estimate (no object-graph traversal): each
        hit carries a rid + score + map slots across the three derived
        views; each offset tuple is a handful of small ints."""
        n_offs = sum(len(v) for v in self.offsets.values()) \
            if self.offsets else 0
        return 256 + 160 * len(self.hits) + 96 * n_offs


def _txn_wrote(txn, key: bytes) -> bool:
    """Whether this transaction's OWN write set touches `key`.

    Every FT index mutation writes the `bv` version key in the same
    call that writes the postings (fulltext_index_update), so an
    untouched `bv` proves the txn's view of this index is the
    committed snapshot — safe to share through the datastore cache. An
    engine whose write buffer we cannot see answers True
    (conservative: never populate from an unknowable view)."""
    btx = getattr(txn, "btx", None)
    w = getattr(btx, "writes", None)
    if w is not None:
        return key in w
    return True


def ft_result(idef, query: str, ctx, boolean: str = "AND") -> FtResult:
    """The memoized search. Two levels: per statement
    (ctx.record_cache) — the planner's match-context registration, the
    access-path analysis, and the scan itself all ask for the same
    search, one execution serves all three; and per datastore, keyed by
    the index's write-version counter plus the index definition's
    scoring fingerprint — repeated identical queries (the hybrid-RRF
    serving shape) skip the posting walk entirely until the next index
    write."""
    ck = ("__ft__", idef.tb, idef.name, query, boolean)
    hit = ctx.record_cache.get(ck)
    if hit is not None:
        return hit
    ns, db = ctx.need_ns_db()
    tb, ix = idef.tb, idef.name
    ver = ctx.txn.get_val(_ver_key(ns, db, tb, ix)) or 0
    # bounded LRU (entry count + byte cap), made and registered with
    # the memory accountant by Datastore.__init__: on a hot mixed
    # read/write table every write bumps `bv`, so an unbounded map keyed
    # by (query, version) would grow one dead entry per write forever
    cache = ctx.ds._ft_cache
    ftp = idef.fulltext or {}
    # fingerprint the analyzer DEFINITION, not its name: DEFINE
    # ANALYZER ... OVERWRITE changes tokenization without touching the
    # index write-version, and a name-keyed entry would serve the old
    # generation's hits
    az = get_analyzer(ftp.get("analyzer"), ctx)
    az_fp = (tuple(az.tokenizers or ()),
             tuple(tuple(f) if isinstance(f, (list, tuple)) else f
                   for f in (az.filters or ())),
             az.function)
    fp = (az_fp, tuple(ftp.get("bm25") or ()),
          tuple(idef.cols_str or ()))
    gk = (ns, db, tb, ix, query, boolean, fp)
    ent = cache.get(gk)
    if ent is not None and ent[0] == ver:
        res = ent[1]
    else:
        res = FtResult(*_ft_search_impl(idef, query, ctx, boolean))
        # never populate an UNCOMMITTED view: a write txn that touched
        # this index read `ver` from its own write set — a version it
        # might never commit, which a later committed writer could
        # alias. A write txn that did NOT touch the index saw exactly
        # the committed snapshot at `ver` (every index mutation bumps
        # `bv` in the same call as its postings), so its result is as
        # shareable as a read txn's — which matters, because the
        # embedded executor runs every statement in a write txn.
        if not getattr(ctx.txn, "write", False) \
                or not _txn_wrote(ctx.txn, _ver_key(ns, db, tb, ix)):
            cache.put(gk, (ver, res), cost=res.cost_bytes())
    ctx.record_cache[ck] = res
    return res


def ft_search(idef, query: str, ctx, boolean: str = "AND"):
    """Compatibility surface: ordered [(rid, score)] + match offsets."""
    res = ft_result(idef, query, ctx, boolean)
    return res.hits, res.offsets


def _doc_lengths(ctx, ns, db, tb, ix) -> dict:
    """enc(rid_id) -> BM25 doc length for the whole index, loaded with
    ONE prefix scan and memoized per statement (ctx.record_cache). The
    old per-(term, doc) `get_val` pattern dominated hybrid-query
    latency: a 300-match posting paid 300 key encodes + tree lookups
    per query."""
    ck = ("__ftdl__", tb, ix)
    hit = ctx.record_cache.get(ck)
    if hit is not None:
        return hit
    pre = K.ix_state(ns, db, tb, ix, b"bl")
    beg, end = K.prefix_range(pre)
    plen = len(pre)
    out = {bytes(k[plen:]): v for k, v in ctx.txn.scan_vals(beg, end)}
    ctx.record_cache[ck] = out
    return out


def _ft_search_impl(idef, query: str, ctx, boolean: str = "AND"):
    ns, db = ctx.need_ns_db()
    tb, ix = idef.tb, idef.name
    az = get_analyzer(idef.fulltext.get("analyzer"), ctx)
    terms = [tok[0] for tok in analyze(az, query, stage="query") if tok[0]]
    if not terms:
        return [], {}
    import numpy as _np

    k1, b = idef.fulltext.get("bm25", (1.2, 0.75))
    k1, b = float(_np.float32(k1)), float(_np.float32(b))
    stats = ctx.txn.get_val(_stats_key(ns, db, tb, ix)) or {
        "docs": 0,
        "total_len": 0,
    }
    n_docs = max(stats["docs"], 1)
    avg_len = stats["total_len"] / n_docs if n_docs else 1.0
    # peek: the posting maps are read-only here, and the fresh-copy
    # contract of get_val costs a full copy of every entry per query
    posts = {
        t: ctx.txn.peek_val(_post_key(ns, db, tb, ix, t)) or {}
        for t in dict.fromkeys(terms)
    }
    total_matches = sum(len(p) for p in posts.values())
    if total_matches >= 512 or total_matches * 8 >= n_docs:
        # broad result set: ONE prefix scan of the doc-length keyspace
        # amortizes across the matches
        dls = _doc_lengths(ctx, ns, db, tb, ix)

        def dl_get(ridk, rid_id):
            return dls.get(ridk) or 0
    else:
        # selective query (rare terms on a big index): O(matches)
        # point reads beat an O(n_docs) scan
        _dl_memo: dict = {}

        def dl_get(ridk, rid_id):
            v = _dl_memo.get(ridk)
            if v is None:
                v = _dl_memo[ridk] = (
                    ctx.txn.get_val(_len_key(ns, db, tb, ix, rid_id))
                    or 0
                )
            return v

    scores: dict = {}
    rids: dict = {}
    offsets: dict = {}
    matched_all: dict = {}
    for t, post in posts.items():
        df = len(post)
        if df == 0:
            continue
        # reference scorer (ft/fulltext.rs compute_bm25_score): clamped idf,
        # lower-bounded tf' = 1 + ln(tf)
        idf = max(math.log((n_docs - df + 0.5) / (df + 0.5)), 0.0)
        for ridk, (tf, offs, rid_id) in post.items():
            dl = dl_get(ridk, rid_id)
            if idf == 0.0 or tf <= 0:
                s = 0.0
            else:
                tf_prime = 1.0 + math.log(tf)
                length_norm = (1 - b) + (b / max(avg_len, 1e-9)) * dl
                s = idf * (k1 + 1) * tf_prime / (tf_prime + k1 * length_norm)
            scores[ridk] = scores.get(ridk, 0.0) + s
            rids[ridk] = RecordId(tb, rid_id)
            offsets.setdefault(ridk, []).extend(offs)
            matched_all.setdefault(ridk, set()).add(t)
    want = set(dict.fromkeys(terms))
    if boolean == "OR":
        hits = [(rids[rk], sc) for rk, sc in scores.items()]
    else:
        # AND semantics: docs must match every query term (reference MATCHES)
        hits = [
            (rids[rk], sc)
            for rk, sc in scores.items()
            if matched_all.get(rk) == want
        ]
    hits = [(r, float(_np.float32(sc))) for r, sc in hits]
    hits.sort(key=lambda p: -p[1])
    return hits, offsets


def plan_matches(tb, cond, mts, indexes, ctx, stmt):
    """Planner entry for one or more `field @ref@ query` predicates: each
    resolves to a full-text index; results intersect (AND across
    predicates); per-ref score/offset contexts feed search::score etc."""
    from surrealdb_tpu_torch.exec.eval import evaluate, fetch_record
    from surrealdb_tpu_torch.exec.statements import Source
    from surrealdb_tpu_torch.idx.planner import _field_path, _remove_node
    from surrealdb_tpu_torch.val import is_truthy

    # rebind a fresh dict: children share vars-dict values by reference, so
    # mutating in place would leak subquery match contexts into the parent
    ft_ctx = dict(ctx.vars.get("__ft__") or {})
    ctx.vars["__ft__"] = ft_ctx
    seen_refs = set()
    results = []
    rest = cond
    for mt in mts:
        path = _field_path(mt.lhs)
        idef = None
        for d in indexes:
            if d.fulltext is not None and d.cols_str and (
                path is None or d.cols_str[0] == path
            ):
                idef = d
                break
        if idef is None:
            raise SdbError(
                "Unable to perform the MATCHES operator without a full-text index"
            )
        q = evaluate(mt.rhs, ctx)
        pre = (ctx.vars.get("__ft__") or {}).get(("node", id(mt)))
        if pre is not None and pre["idef"].name == idef.name \
                and pre["query"] == str(q) and pre.get("res") is not None:
            # plan_scan pre-registered this node's search (planner
            # _register_match_contexts) — reuse instead of re-searching
            res = pre["res"]
        else:
            res = ft_result(idef, str(q), ctx, boolean=mt.boolean)
        ref = mt.ref if mt.ref is not None else 0
        if ref in seen_refs:
            raise SdbError(f"Duplicated Match reference: {ref}")
        seen_refs.add(ref)
        ft_ctx[ref] = {
            "scores": res.scores,
            "offsets": res.offsets,
            "idef": idef,
            "query": str(q),
            "res": res,
        }
        results.append(res)
        rest = _remove_node(rest, mt)
    if len(results) == 1:
        # the common case pays zero set/dict building: the shared
        # result's ordered rid list IS the scan order (score-desc)
        ordered = results[0].ordered
    else:
        common = None
        for res in results:
            common = (set(res.scores.keys()) if common is None
                      else common & res.scores.keys())
        ordered = []
        seen = set()
        # h ∈ common ⇒ present in every current result, so rid objects
        # always resolve through the first result's map
        rid_map = results[0].rid_map
        # node-keyed tuple entries are aliases for filter evaluation;
        # the ordered result union walks the numeric ref entries only
        for ref in sorted(k for k in ft_ctx if isinstance(k, int)):
            entry = ft_ctx[ref]
            for h in entry["scores"]:
                if h in common and h not in seen:
                    seen.add(h)
                    ordered.append(rid_map[h])

    if rest is None and _score_only_projection(stmt, ctx):
        # projection (and ORDER BY) touch only `id` + search::* pseudo-
        # functions, which read the match context, not the document:
        # skip the per-row record fetch entirely (keys-only FT scan —
        # the dominant host cost of the hybrid RRF shape, where a
        # 300-match leg paid 300 record fetches per query)
        lim = _ft_order_limit(stmt, mts, ctx)
        if lim is not None:
            # ORDER BY <that score> DESC LIMIT n over a single MATCHES
            # re-sorts the order the search already produced (hits are
            # score-descending, the scores dict preserves it): truncate
            # BEFORE projection so only n rows pay the pipeline, not
            # every match. The pipeline still sorts/limits the survivors
            # (a stable no-op).
            ordered = ordered[:lim]

        def gen_keys():
            for rid in ordered:
                yield Source(rid=rid, doc={"id": rid})

        ctx._cond_consumed = True
        return gen_keys()

    def gen():
        for rid in ordered:
            doc = fetch_record(ctx, rid)
            if doc is NONE:
                continue
            if rest is not None:
                c = ctx.with_doc(doc, rid)
                if not is_truthy(evaluate(rest, c)):
                    continue
            yield Source(rid=rid, doc=doc)

    ctx._cond_consumed = True
    return gen()


def _ft_order_limit(stmt, mts, ctx):
    """LIMIT value when `ORDER BY <score> DESC LIMIT n` (no START) can
    be absorbed into the single-MATCHES scan order, else None. Valid
    only when the one ORDER key is search::score(ref) — directly or via
    its projection alias — for the statement's single match predicate:
    the scan already yields score-descending rows, so the sort is a
    stable no-op and the limit can truncate before projection."""
    from surrealdb_tpu_torch.exec.eval import evaluate
    from surrealdb_tpu_torch.exec.statements import expr_name
    from surrealdb_tpu_torch.expr.ast import FunctionCall

    if (stmt is None or len(mts) != 1 or getattr(stmt, "start", None)
            is not None or getattr(stmt, "limit", None) is None):
        return None
    order = getattr(stmt, "order", None)
    if not order or order == "rand" or len(order) != 1:
        return None
    oexpr, d, collate, numeric = order[0]
    if d != "desc" or collate or numeric:
        return None
    target = oexpr
    if not isinstance(target, FunctionCall):
        # resolve a projection alias to its expression
        name = expr_name(oexpr)
        target = None
        for e, a in (stmt.exprs or []):
            if e != "*" and (a or expr_name(e)) == name:
                target = e
                break
        if stmt.value is not None and getattr(stmt, "value_alias", None) \
                == name:
            target = stmt.value
    if not (isinstance(target, FunctionCall)
            and target.name == "search::score"):
        return None
    try:
        ref = int(evaluate(target.args[0], ctx)) if target.args else 0
    except (SdbError, TypeError, ValueError, IndexError):
        return None
    if ref != (mts[0].ref if mts[0].ref is not None else 0):
        return None
    try:
        lim = evaluate(stmt.limit, ctx)
        lim = int(lim)
    except (SdbError, TypeError, ValueError):
        return None
    return lim if lim >= 0 else None


def _ft_safe_expr(expr) -> bool:
    """Projections derivable from the match context alone: `id` and the
    search::score pseudo-function (reads ctx __ft__, not the doc)."""
    from surrealdb_tpu_torch.expr.ast import FunctionCall
    from surrealdb_tpu_torch.idx.planner import _field_path

    if _field_path(expr) == "id":
        return True
    return isinstance(expr, FunctionCall) and expr.name == "search::score"


def _score_only_projection(stmt, ctx) -> bool:
    from surrealdb_tpu_torch.idx.planner import _pseudo_only_projection

    return _pseudo_only_projection(stmt, ctx, _ft_safe_expr,
                                   allow_order=True)


def matches_operator(n, ctx):
    """Row-wise matches evaluation (post-planner membership, or ad-hoc)."""
    ft_ctx = ctx.vars.get("__ft__")
    ref = n.ref if n.ref is not None else 0
    if ft_ctx is not None and ctx.doc_id is not None:
        # node-keyed entries disambiguate OR-union branches that share
        # the default ref (planner _ft_branch_scan)
        entry = ft_ctx.get(("node", id(n))) or ft_ctx.get(ref)
        if entry is not None:
            return hashable(ctx.doc_id) in entry["scores"]
    # ad-hoc: analyze both sides — with the field's full-text analyzer
    # when one is defined (so an index access path that outranked the
    # MATCHES keeps the index's stemming/ngram semantics in the filter),
    # else the default blank+lowercase analyzer
    from surrealdb_tpu_torch.exec.eval import evaluate

    lhs = evaluate(n.lhs, ctx)
    rhs = evaluate(n.rhs, ctx)
    if not isinstance(lhs, str) or not isinstance(rhs, str):
        return False
    az = None
    if ctx.doc_id is not None:
        from surrealdb_tpu_torch.idx.planner import _field_path, get_indexes_for

        path = _field_path(n.lhs)
        try:
            for d in get_indexes_for(ctx.doc_id.tb, ctx):
                if d.fulltext is not None and d.cols_str and (
                    path is None or d.cols_str[0] == path
                ):
                    az = get_analyzer(d.fulltext.get("analyzer"), ctx)
                    break
        except Exception:
            az = None
    if az is None:
        az = AnalyzerDef("like", ["blank"], [("lowercase",)])
    doc_terms = {tok[0] for tok in analyze(az, lhs)}
    q_terms = {tok[0] for tok in analyze(az, rhs, stage="query")}
    if not q_terms:
        return False
    if getattr(n, "boolean", "AND") == "OR":
        return bool(q_terms & doc_terms)
    return q_terms <= doc_terms


def _ft_entry(ctx, ref):
    ft_ctx = ctx.vars.get("__ft__")
    if ft_ctx is None:
        return None
    return ft_ctx.get(ref if ref is not None else 0)


def search_score(ref, ctx):
    entry = _ft_entry(ctx, ref or 0)
    if entry is None or ctx.doc_id is None:
        # matched without an index scoring context: score is 0 (reference
        # select_where_matches_without_complex_query)
        return 0.0 if ctx.doc_id is not None else NONE
    return entry["scores"].get(hashable(ctx.doc_id), 0.0)


def search_highlight(args, ctx):
    """search::highlight(open, close, ref[, partial]) — wrap matched spans;
    partial=true marks the matched grams, default marks whole tokens."""
    if len(args) < 3:
        raise SdbError("Incorrect arguments for function search::highlight()")
    open_t, close_t = str(args[0]), str(args[1])
    try:
        ref = int(args[2]) if not isinstance(args[2], bool) else 0
    except (TypeError, ValueError):
        raise SdbError("Incorrect arguments for function search::highlight()")
    partial = bool(args[3]) if len(args) > 3 else False
    entry = _ft_entry(ctx, ref)
    if entry is None or ctx.doc_id is None or ctx.doc is None:
        return NONE
    from surrealdb_tpu_torch import key as K2
    from surrealdb_tpu_torch.exec.eval import evaluate

    idef = entry["idef"]
    ridk = K2.enc_value(ctx.doc_id.id)
    spans = _spans_by_value(entry, ridk, partial)
    c = ctx.with_doc(ctx.doc, ctx.doc_id)
    text = evaluate(idef.cols[0], c)

    def mark(t, vi):
        if not isinstance(t, str):
            return t
        out = []
        last = 0
        for a, b in spans.get(vi, []):
            if a < last or b > len(t):
                continue
            out.append(t[last:a])
            out.append(open_t + t[a:b] + close_t)
            last = b
        out.append(t[last:])
        return "".join(out)

    if isinstance(text, dict):
        # object fields highlight their flattened strings (same value
        # order the indexer used)
        return [
            mark(t, vi) for vi, t in enumerate(_flatten_strings(text))
        ]
    if isinstance(text, list):
        return [mark(t, vi) for vi, t in enumerate(text)]
    return mark(text, 0)


def _spans_by_value(entry, ridk, partial):
    """vi -> merged sorted spans for this record's matches."""
    by_vi: dict = {}
    for off in (entry["offsets"] or {}).get(ridk, []):
        if len(off) == 5:
            vi, a, b, oa, ob = off
        else:  # legacy 2-tuple
            vi, (a, b, oa, ob) = 0, (*off, *off)
        span = (a, b) if partial else (oa, ob)
        by_vi.setdefault(vi, set()).add(span)
    out = {}
    for vi, spans in by_vi.items():
        merged = []
        for a, b in sorted(spans):
            if merged and a <= merged[-1][1]:
                merged[-1] = (merged[-1][0], max(b, merged[-1][1]))
            else:
                merged.append((a, b))
        out[vi] = merged
    return out


def search_offsets(args, ctx):
    """search::offsets(ref[, partial]) -> { "<value idx>": [{s, e}] }."""
    ref = 0
    if args and not isinstance(args[0], bool):
        try:
            ref = int(args[0])
        except (TypeError, ValueError):
            ref = 0
    partial = bool(args[1]) if len(args) > 1 else False
    entry = _ft_entry(ctx, ref)
    if entry is None or ctx.doc_id is None:
        return NONE
    from surrealdb_tpu_torch import key as K2

    ridk = K2.enc_value(ctx.doc_id.id)
    spans = _spans_by_value(entry, ridk, partial)
    return {
        str(vi): [{"e": b, "s": a} for a, b in merged]
        for vi, merged in sorted(spans.items())
    }
