"""Changefeeds (the reference package's `cf.py`; reference:
core/src/cf/) — mutation log under `#` keys, read back by SHOW CHANGES
FOR TABLE ... SINCE, and expired by `run_changefeed_gc`."""

from __future__ import annotations

from surrealdb_tpu_torch import key as K
from surrealdb_tpu_torch.err import SdbError
from surrealdb_tpu_torch.val import NONE, Datetime


def read_changes(stmt, ctx):
    ns, db = ctx.need_ns_db()
    since = None
    from surrealdb_tpu_torch.exec.eval import evaluate

    v = evaluate(stmt.since, ctx)
    if isinstance(v, int):
        since_vs = v
    elif isinstance(v, Datetime):
        since_vs = (v.epoch_ns() // 1_000_000) << 20
    else:
        raise SdbError("SHOW CHANGES SINCE requires a versionstamp or datetime")
    limit = stmt.limit
    if limit is not None:
        from surrealdb_tpu_torch.exec.eval import evaluate as _e

        limit = int(_e(limit, ctx)) if not isinstance(limit, int) else limit
    beg = K.changefeed_from(ns, db, since_vs)
    _pre, end = K.prefix_range(K.changefeed_prefix(ns, db))
    out = []
    current_vs = None
    current = None
    for k, entry in ctx.txn.scan_vals(beg, end):
        if stmt.table is not None:
            if entry["rid"].tb != stmt.table:
                continue
        vs = int.from_bytes(k[len(K.changefeed_prefix(ns, db)) : len(K.changefeed_prefix(ns, db)) + 8], "big")
        if vs != current_vs:
            if current is not None:
                out.append(current)
                if limit is not None and len(out) >= limit:
                    return out
            current_vs = vs
            current = {"versionstamp": vs, "changes": []}
        rid = entry["rid"]
        if entry["action"] == "DELETE":
            current["changes"].append({"delete_only": {"id": rid}})
        else:
            after = entry["after"]
            change = {"update": after}
            if entry.get("before") not in (NONE, None):
                change["current"] = after
            current["changes"].append(change)
    if current is not None:
        out.append(current)
    if limit is not None:
        out = out[:limit]
    return out


def gc_changefeeds(ds, ctx, retention_ns: int):
    """Drop changefeed entries older than the retention window."""
    ns, db = ctx.need_ns_db()
    from surrealdb_tpu_torch.kvs import net

    cutoff = ((int(net.wall() * 1000) - retention_ns // 1_000_000) << 20)
    beg = K.changefeed_prefix(ns, db)
    end = K.changefeed_from(ns, db, cutoff)
    ctx.txn.delete_range(beg, end)


def run_changefeed_gc(ds, batch: int = None) -> int:
    """One sweep over every (ns, db): drop changefeed entries older
    than their table's retention (the CHANGEFEED clause's duration; the
    database-level clause or SURREAL_CHANGEFEED_RETENTION_S when the
    table carries none). Work is bounded to `batch` examined entries
    per database per sweep. Returns entries purged; counted as
    `changefeed_gc_purged` telemetry."""
    from surrealdb_tpu_torch import cnf
    from surrealdb_tpu_torch.kvs import net

    if batch is None:
        batch = cnf.CHANGEFEED_GC_BATCH_SIZE
    default_ns = int(cnf.CHANGEFEED_RETENTION_S * 1e9)
    if default_ns <= 0:
        return 0
    now_ms = int(net.wall() * 1000)
    purged = 0
    txn = ds.transaction(write=True)
    committed = False
    try:
        pairs = []
        for nk, _nd in txn.scan_vals(*K.prefix_range(K.ns_prefix())):
            nsname, _ = K.dec_str(nk, len(K.ns_prefix()))
            for dk, _dd in txn.scan_vals(
                *K.prefix_range(K.db_prefix(nsname))
            ):
                dbname, _ = K.dec_str(dk, len(K.db_prefix(nsname)))
                pairs.append((nsname, dbname))
        for ns, db in pairs:
            dbdef = txn.get_val(K.db_def(ns, db))
            db_ret = getattr(dbdef, "changefeed", None) \
                if dbdef is not None else None
            tb_ret = {}
            for _tk, tdef in txn.scan_vals(
                *K.prefix_range(K.tb_prefix(ns, db))
            ):
                if getattr(tdef, "changefeed", None) is not None:
                    tb_ret[tdef.name] = tdef.changefeed
            # note: the scan below runs even when no changefeed is
            # currently DEFINEd — entries orphaned by a removed
            # CHANGEFEED clause still age out under the default
            # retention
            prefix = K.changefeed_prefix(ns, db)
            # entries older than EVERY retention can go unconditionally;
            # between horizons the entry's own table decides
            max_ret = max([default_ns, db_ret or 0,
                           *tb_ret.values()])
            horizon = K.changefeed_from(
                ns, db, (now_ms - max_ret // 1_000_000) << 20
            )
            # bounded work per sweep: only `batch` entries are ever
            # examined, so only that many get decoded — a days-deep
            # backlog must not balloon into one giant materialization
            for k, entry in list(txn.scan_vals(
                prefix, K.changefeed_from(ns, db, now_ms << 20),
                limit=batch,
            )):
                vs = int.from_bytes(k[len(prefix):len(prefix) + 8],
                                    "big")
                if k < horizon:
                    txn.delete(k)
                    purged += 1
                    continue
                try:
                    tb = entry["rid"].tb
                except (TypeError, KeyError, AttributeError):
                    continue
                ret = tb_ret.get(tb, db_ret
                                 if db_ret is not None else default_ns)
                if vs < ((now_ms - ret // 1_000_000) << 20):
                    txn.delete(k)
                    purged += 1
        txn.commit()
        committed = True
    except SdbError:
        return 0
    finally:
        # ANY exit without a commit (SdbError, a corrupt row raising
        # something else) must release the write transaction — the
        # background tick swallows errors, so a leak would repeat
        # every interval
        if not committed:
            try:
                txn.cancel()
            except SdbError:
                pass
    if purged:
        ds.telemetry.inc("changefeed_gc_purged", purged)
    return purged


def changefeed_gc_tick(ds) -> int:
    """Background-task entry (server/__init__.py serve loop, on the
    kvs/net.py Runtime seam): single cluster winner via TaskLease, then
    one bounded GC sweep."""
    from surrealdb_tpu_torch import cnf
    from surrealdb_tpu_torch.node import TaskLease

    lease = TaskLease(ds, "changefeed_gc",
                      ttl_s=cnf.CHANGEFEED_GC_INTERVAL_S / 2)
    if not lease.try_acquire():
        return 0
    return run_changefeed_gc(ds)
