"""CLI (the reference package's `__main__.py`; reference:
surrealdb/server/src/cli/ — start, sql REPL, isready, validate,
version, and the KV service's kv / kv-admin).

    python -m surrealdb_tpu_torch start [--bind 127.0.0.1:8000] [--path memory]
        [--user root --pass root] [--unauthenticated]
        [--device off|auto|require|inline]
    python -m surrealdb_tpu_torch sql [--path memory] [--ns t --db t]
        [--device off|auto|require|inline]
    python -m surrealdb_tpu_torch validate file.surql
    python -m surrealdb_tpu_torch isready [--conn http://127.0.0.1:8000]
    python -m surrealdb_tpu_torch ml import --ns t --db t [--path memory]
        [--name N --version V] model.surml
    python -m surrealdb_tpu_torch ml export --ns t --db t [--path memory]
        name version [file]
    python -m surrealdb_tpu_torch kv [--bind 127.0.0.1:8100] [--data-dir DIR]
        [--role primary|replica] [--peers h:p,h:p] [--peer-index N]
        [--failover-timeout S] [--lease-ttl S] [--no-fsync]
    python -m surrealdb_tpu_torch kv-admin init --groups 'h:p,h:p;h:p,h:p'
        [--shard-ranges KEY[,KEY...]]
    python -m surrealdb_tpu_torch kv-admin split KEY --meta h:p[,h:p]
        --to h:p[,h:p]
    python -m surrealdb_tpu_torch kv-admin topology --meta h:p[,h:p]
    python -m surrealdb_tpu_torch version

`start` serves on the card: its device supervisor starts a runner at
boot, in mode require unless `--device` or `SURREAL_DEVICE` says
otherwise (a query that cannot reach the card fails; `--device auto` is
the reference's degrade-to-host default); `--device off` keeps every
path on the host. `sql` takes the same `--device` and the same
default. `--user` / `--pass` define the root user at boot
(`define_root_user`: `DEFINE USER … ON ROOT PASSWORD … ROLES OWNER`);
clients sign in as it (rpc `signin`, POST /signin, `Basic` auth) and
without `--unauthenticated` anonymous connections get no access.
`ml import` stores a `.surml` or ONNX file in a datastore (`ml/__init__.py
import_model`, printing its name, version and hash) and `ml export` writes
a stored model's bytes to a file or stdout; `ml::` calls need the `ml`
experimental capability (`SURREAL_CAPS_ALLOW_EXPERIMENTAL=ml`).

`kv` runs one member of a replicated KV group (`kvs/remote.py
serve_kv`): a primary, or a replica that applies the primary's log and
promotes itself when the primary's lease lapses. `kv-admin init` cuts
the keyspace over running groups (group 0 holds the shard map), `split`
moves the upper half of a range onto a new group, and `topology` prints
the map. Databases reach a cluster as `Datastore("remote://h:p,h:p")`
(one group) or `Datastore("shard://h:p,h:p")` (the meta group's
addresses). Neither subcommand imports torch or numpy: a KV process
starts in well under a second.

The subcommands export, import, upgrade and fix are not ported: each
parses and exits non-zero with a `NotPorted` message naming itself.
"""

from __future__ import annotations

import argparse
import os
import sys


# parsed, then refused with a NotPorted message naming the subcommand;
# their options are not read, so none is declared
_NOT_PORTED = ("export", "import", "upgrade", "fix")


def _sql_ident(name: str) -> str:
    if name.isidentifier():
        return name
    return "`" + name.replace("\\", "\\\\").replace("`", "\\`") + "`"


def _sql_string(text: str) -> str:
    return "'" + text.replace("\\", "\\\\").replace("'", "\\'") + "'"


def define_root_user(ds, user: str, passwd: str) -> str:
    """Define the root user `start --user/--pass` names, as the
    reference's `start` does (`DEFINE USER … ON ROOT PASSWORD … ROLES
    OWNER`); a user that already exists (a restarted `file://` store)
    is kept. Returns the stored passhash's route: `argon2` where the
    `argon2` package imports, else `scrypt` (fnc/misc_fns.py
    password_hash)."""
    from surrealdb_tpu_torch import key as K
    from surrealdb_tpu_torch.err import SdbError

    res = ds.execute(f"DEFINE USER {_sql_ident(user)} ON ROOT PASSWORD "
                     f"{_sql_string(passwd)} ROLES OWNER")[0]
    if res.error is not None and "already exists" not in res.error:
        raise SdbError(res.error)
    txn = ds.transaction(write=False)
    try:
        ud = txn.get_val(K.us_def("root", None, None, user))
    finally:
        txn.cancel()
    return ud.passhash.split("$")[1].split("-")[0]


def main(argv=None):
    ap = argparse.ArgumentParser(prog="surrealdb-tpu")
    sub = ap.add_subparsers(dest="cmd", required=True)

    # shared by the two subcommands that open a datastore
    device = argparse.ArgumentParser(add_help=False)
    device.add_argument(
        "--device", default=None,
        choices=("off", "auto", "require", "inline"),
        help="accelerator execution mode (SURREAL_DEVICE): off = host "
             "paths only, auto = supervised runner subprocess with "
             "degrade-and-recover, require = a supervised runner whose "
             "failures surface as query errors (the default when "
             "SURREAL_DEVICE is unset), inline = in-process (debug; "
             "forfeits fault isolation)")

    p_start = sub.add_parser("start", parents=[device],
                             help="start the server")
    p_start.add_argument("--bind", default="127.0.0.1:8000")
    p_start.add_argument("--path", default="memory")
    p_start.add_argument("--user", default=None)
    p_start.add_argument("--pass", dest="passwd", default=None)
    p_start.add_argument("--web-crt", dest="web_crt", default=None,
                         help="TLS certificate (PEM) for HTTPS")
    p_start.add_argument("--web-key", dest="web_key", default=None,
                         help="TLS private key (PEM)")
    p_start.add_argument(
        "--unauthenticated", action="store_true",
        help="allow anonymous connections full access (dev mode)")
    p_start.add_argument("--max-inflight", type=int, default=None,
                         help="concurrent queries executing at once "
                              "(admission-control worker slots; 0 "
                              "disables admission control)")
    p_start.add_argument("--queue-depth", type=int, default=None,
                         help="requests allowed to wait for a worker "
                              "slot before the server sheds with 503")
    p_start.add_argument("--default-timeout", default=None,
                         help="server-side default query timeout "
                              "(e.g. 5s, 500ms) applied when the client "
                              "sends no X-Surreal-Timeout")
    p_start.add_argument("--drain-timeout", default=None,
                         help="SIGTERM drain budget (e.g. 10s): finish "
                              "in-flight queries this long, then cancel "
                              "and exit")

    p_sql = sub.add_parser("sql", parents=[device],
                           help="interactive REPL")
    p_sql.add_argument("--path", default="memory")
    p_sql.add_argument("--ns", default="test")
    p_sql.add_argument("--db", default="test")

    p_val = sub.add_parser("validate")
    p_val.add_argument("files", nargs="+")

    p_rdy = sub.add_parser("isready")
    p_rdy.add_argument("--conn", default="http://127.0.0.1:8000")

    p_ml = sub.add_parser("ml", help="import/export ML models (.surml)")
    ml_sub = p_ml.add_subparsers(dest="ml_cmd", required=True)
    p_mli = ml_sub.add_parser("import")
    p_mli.add_argument("--path", default="memory")
    p_mli.add_argument("--ns", required=True)
    p_mli.add_argument("--db", required=True)
    p_mli.add_argument("--name", default=None)
    p_mli.add_argument("--version", dest="model_version", default=None)
    p_mli.add_argument("file")
    p_mle = ml_sub.add_parser("export")
    p_mle.add_argument("--path", default="memory")
    p_mle.add_argument("--ns", required=True)
    p_mle.add_argument("--db", required=True)
    p_mle.add_argument("name")
    p_mle.add_argument("model_version")
    p_mle.add_argument("file", nargs="?", default="-")

    p_kv = sub.add_parser(
        "kv", help="run the shared transactional KV service (cluster mode)"
    )
    p_kv.add_argument("--bind", default="127.0.0.1:8100")
    p_kv.add_argument("--data-dir", default=None,
                      help="persist the keyspace (WAL + snapshot); "
                           "restarts recover committed state")
    p_kv.add_argument("--role", choices=("primary", "replica"),
                      default="primary",
                      help="replica processes apply the primary's commit "
                           "log and stand by for lease-based promotion")
    p_kv.add_argument("--peers", default=None,
                      help="comma-separated host:port of EVERY replica-set "
                           "member (including this one), in promotion-rank "
                           "order; enables replication + failover")
    p_kv.add_argument("--peer-index", type=int, default=None,
                      help="this server's index in --peers (inferred from "
                           "--bind when omitted)")
    p_kv.add_argument("--failover-timeout", type=float, default=None,
                      help="seconds without replication traffic before a "
                           "replica starts the promotion protocol")
    p_kv.add_argument("--lease-ttl", type=float, default=None,
                      help="primary lease TTL in seconds")
    p_kv.add_argument("--no-fsync", action="store_true",
                      help="skip fsync on WAL appends (replication still "
                           "guards acked writes; lose the single-node "
                           "power-failure guarantee)")

    p_adm = sub.add_parser(
        "kv-admin",
        help="administer a range-sharded KV cluster (init/split/topology)",
    )
    adm = p_adm.add_subparsers(dest="adm_cmd", required=True)
    a_init = adm.add_parser(
        "init", help="bootstrap shard topology onto running KV groups"
    )
    a_init.add_argument(
        "--groups", required=True,
        help="';'-separated replication groups in shard order, each a "
             "','-separated host:port list; group 0 is the meta shard")
    a_init.add_argument(
        "--shard-ranges", default="",
        help="','-separated split keys (N-1 keys for N groups), UTF-8; "
             "prefix a key with hex: for raw bytes")
    a_split = adm.add_parser(
        "split", help="split the range containing KEY at KEY onto a "
                      "new (running, empty) group")
    a_split.add_argument("key",
                         help="split key (UTF-8; hex: prefix for raw "
                              "bytes)")
    a_split.add_argument("--meta", required=True,
                         help="meta-shard addresses host:port[,host:port]")
    a_split.add_argument("--to", required=True,
                         help="','-separated addresses of the group "
                              "taking the upper range")
    a_top = adm.add_parser("topology", help="print the current shard map")
    a_top.add_argument("--meta", required=True,
                       help="meta-shard addresses host:port[,host:port]")

    sub.add_parser("version")
    for name in _NOT_PORTED:
        sub.add_parser(name)

    args, extra = ap.parse_known_args(argv)
    if extra and args.cmd not in _NOT_PORTED:
        ap.error(f"unrecognized arguments: {' '.join(extra)}")

    if args.cmd == "version":
        import surrealdb_tpu_torch

        print(f"surrealdb-tpu {surrealdb_tpu_torch.__version__}")
        return 0

    if args.cmd == "validate":
        from surrealdb_tpu_torch.syn import parse

        rc = 0
        for f in args.files:
            try:
                parse(open(f, encoding="utf-8").read())
                print(f"{f}: OK")
            except Exception as e:
                print(f"{f}: {e}")
                rc = 1
        return rc

    if args.cmd == "isready":
        import urllib.request

        try:
            with urllib.request.urlopen(args.conn + "/health", timeout=5) as r:
                if r.status == 200:
                    print("OK")
                    return 0
        except Exception:
            pass
        print("Not ready")
        return 1

    if args.cmd == "kv":
        from surrealdb_tpu_torch.kvs.remote import serve_kv

        host, _, port = args.bind.partition(":")
        peers = ([p.strip() for p in args.peers.split(",") if p.strip()]
                 if args.peers else None)
        serve_kv(host, int(port), block=True,
                 data_dir=args.data_dir,
                 fsync=not args.no_fsync,
                 role=args.role, peers=peers,
                 self_index=args.peer_index,
                 failover_timeout_s=args.failover_timeout,
                 lease_ttl_s=args.lease_ttl)
        return 0

    if args.cmd == "kv-admin":
        return _kv_admin(args)

    from surrealdb_tpu_torch.err import NotPorted

    if args.cmd in _NOT_PORTED:
        return _not_ported(NotPorted(
            f"the {args.cmd} subcommand is not ported"))

    if args.cmd == "ml":
        return _ml(args)

    # before the first get_supervisor(): the supervisor reads
    # SURREAL_DEVICE at construction. With neither the flag nor the
    # variable, `start` and `sql` run on the card with no host fallback
    # (`--device auto` is the reference's degrade-to-host default)
    if args.device:
        os.environ["SURREAL_DEVICE"] = args.device
    elif not os.environ.get("SURREAL_DEVICE"):
        os.environ["SURREAL_DEVICE"] = "require"

    from surrealdb_tpu_torch.kvs.ds import Datastore

    if args.cmd == "start":
        from surrealdb_tpu_torch.server import parse_timeout, serve

        host, _, port = args.bind.partition(":")
        try:
            ds = Datastore(args.path)
        except NotPorted as e:
            return _not_ported(e)
        if args.user and args.passwd:
            define_root_user(ds, args.user, args.passwd)
        elif not args.unauthenticated:
            print("no --user/--pass given and --unauthenticated not set: "
                  "anonymous connections have no access")
        default_timeout_s = (parse_timeout(args.default_timeout)
                             if args.default_timeout else None)
        drain_timeout_s = (parse_timeout(args.drain_timeout)
                           if args.drain_timeout else None)
        serve(ds, host or "127.0.0.1", int(port or 8000),
              unauthenticated=args.unauthenticated,
              tls_cert=args.web_crt, tls_key=args.web_key,
              max_inflight=args.max_inflight,
              queue_depth=args.queue_depth,
              default_timeout_s=default_timeout_s,
              drain_timeout_s=drain_timeout_s)
        return 0

    from surrealdb_tpu_torch.val import render

    try:
        ds = Datastore(args.path)
    except NotPorted as e:
        return _not_ported(e)
    ns, db = args.ns, args.db
    print(f"surrealdb-tpu sql — ns={ns} db={db} (Ctrl-D to exit)")
    while True:
        try:
            line = input(f"{ns}/{db}> ")
        except (EOFError, KeyboardInterrupt):
            print()
            break
        if not line.strip():
            continue
        for r in ds.execute(line, ns=ns, db=db):
            if r.error:
                print(f"ERR: {r.error}")
            else:
                print(render(r.result))
    ds.close()
    return 0


def _ml(args) -> int:
    """`ml import` / `ml export` over the datastore at `--path` (the
    reference's handler)."""
    from surrealdb_tpu_torch.err import NotPorted
    from surrealdb_tpu_torch.kvs.ds import Datastore

    try:
        ds = Datastore(args.path)
    except NotPorted as e:
        return _not_ported(e)
    if args.ml_cmd == "import":
        from surrealdb_tpu_torch.ml import import_model

        data = open(args.file, "rb").read()
        d = import_model(ds, args.ns, args.db, data,
                         name=args.name, version=args.model_version)
        print(f"imported ml::{d.name}<{d.version}> hash={d.hash}")
        return 0
    from surrealdb_tpu_torch.ml import export_model

    raw = export_model(ds, args.ns, args.db, args.name, args.model_version)
    if args.file == "-":
        sys.stdout.buffer.write(raw)
    else:
        open(args.file, "wb").write(raw)
    return 0


def _kv_admin(args) -> int:
    """`kv-admin init | split | topology` against running KV groups (the
    reference's handler: same arguments, same printed map)."""
    from surrealdb_tpu_torch.kvs import shard as shard_admin

    def _key(s: str) -> bytes:
        if s.startswith("hex:"):
            return bytes.fromhex(s[4:])
        return s.encode("utf-8")

    def _print_map(m):
        print(f"shard map epoch {m.epoch}: {len(m.shards)} range(s)")
        for s in m.shards:
            hi = "inf" if s.end is None else repr(s.end)
            print(f"  [{s.beg!r}, {hi}) epoch={s.epoch} "
                  f"group={','.join(s.addrs)}")

    if args.adm_cmd == "init":
        groups = [[a.strip() for a in g.split(",") if a.strip()]
                  for g in args.groups.split(";") if g.strip()]
        splits = [_key(s) for s in args.shard_ranges.split(",") if s]
        _print_map(shard_admin.init_topology(groups, splits))
    elif args.adm_cmd == "split":
        to = [a.strip() for a in args.to.split(",") if a.strip()]
        _print_map(shard_admin.split_shard(args.meta, _key(args.key), to))
    else:
        _print_map(shard_admin.read_topology(args.meta))
    return 0


def _not_ported(err) -> int:
    print(f"surrealdb-tpu: {err}", file=sys.stderr)
    return 1


if __name__ == "__main__":
    sys.exit(main())
