"""JSON-Patch style diff/apply over values (reference: val diff/patch for
UPDATE ... PATCH and RETURN DIFF)."""

from __future__ import annotations

from surrealdb_tpu_torch.err import SdbError
from surrealdb_tpu_torch.val import NONE, copy_value, value_eq


def _escape(seg: str) -> str:
    return seg.replace("~", "~0").replace("/", "~1")


def _unescape(seg: str) -> str:
    return seg.replace("~1", "/").replace("~0", "~")


def diff(a, b, path="") -> list:
    """RFC6902-ish operations turning a into b."""
    ops: list = []
    if isinstance(a, dict) and isinstance(b, dict):
        for k in a:
            if k not in b:
                ops.append({"op": "remove", "path": f"{path}/{_escape(k)}"})
            else:
                ops.extend(diff(a[k], b[k], f"{path}/{_escape(k)}"))
        for k in b:
            if k not in a:
                ops.append(
                    {"op": "add", "path": f"{path}/{_escape(k)}", "value": b[k]}
                )
        return ops
    if isinstance(a, list) and isinstance(b, list):
        n = min(len(a), len(b))
        for i in range(n):
            ops.extend(diff(a[i], b[i], f"{path}/{i}"))
        for i in range(len(a) - 1, n - 1, -1):
            ops.append({"op": "remove", "path": f"{path}/{i}"})
        for i in range(n, len(b)):
            ops.append({"op": "add", "path": f"{path}/{i}", "value": b[i]})
        return ops
    if isinstance(a, str) and isinstance(b, str) and a != b:
        ops.append({"op": "change", "path": path, "value": _str_change(a, b)})
        return ops
    if not value_eq(a, b):
        ops.append({"op": "replace", "path": path, "value": b})
    return ops


def _apply_str_change(payload: str) -> str:
    """New-string side of a _str_change unified-diff payload."""
    out = []
    for line in payload.split("\n"):
        if line.startswith("+"):
            out.append(line[1:])
    return "\n".join(out)


def _str_change(a: str, b: str) -> str:
    """Line-based unified diff payload (reference dmp-style text diff)."""
    al = a.split("\n")
    bl = b.split("\n")
    out = [f"@@ -1,{len(al)} +1,{len(bl)} @@"]
    for line in al:
        out.append(f"-{line}")
    for line in bl:
        out.append(f"+{line}")
    return "\n".join(out) + "\n"


def _walk_to(doc, segs):
    cur = doc
    for s in segs[:-1]:
        if isinstance(cur, dict):
            cur = cur.setdefault(_unescape(s), {})
        elif isinstance(cur, list):
            cur = cur[int(s)]
        else:
            raise SdbError(f"Cannot patch path")
    return cur


def apply_patch(doc, ops):
    doc = copy_value(doc)
    if not isinstance(ops, list):
        raise SdbError("Patch operations must be an array")
    for op in ops:
        if not isinstance(op, dict):
            raise SdbError("Invalid patch operation")
        kind = op.get("op")
        path = op.get("path", "")
        segs = [s for s in str(path).split("/") if s != ""]
        if not segs:
            if kind in ("replace", "add", "change"):
                doc = copy_value(op.get("value"))
            continue
        parent = _walk_to(doc, segs)
        last = _unescape(segs[-1])
        if kind in ("add",):
            if isinstance(parent, list):
                if last == "-":
                    parent.append(copy_value(op.get("value")))
                else:
                    parent.insert(int(last), copy_value(op.get("value")))
            elif isinstance(parent, dict) and isinstance(
                parent.get(last), list
            ):
                # add onto an array field appends (reference patch on arrays)
                parent[last].append(copy_value(op.get("value")))
            else:
                parent[last] = copy_value(op.get("value"))
        elif kind in ("replace", "change"):
            val = op.get("value")
            if kind == "change" and isinstance(val, str) and \
                    val.startswith("@@"):
                val = _apply_str_change(val)
            if isinstance(parent, list):
                parent[int(last)] = copy_value(val)
            else:
                parent[last] = copy_value(val)
        elif kind == "remove":
            if isinstance(parent, list):
                idx = int(last)
                if 0 <= idx < len(parent):
                    parent.pop(idx)
            else:
                parent.pop(last, None)
        elif kind == "copy":
            from_segs = [s for s in str(op.get("from", "")).split("/") if s]
            src_parent = _walk_to(doc, from_segs)
            src_last = _unescape(from_segs[-1])
            v = (
                src_parent[int(src_last)]
                if isinstance(src_parent, list)
                else src_parent.get(src_last, NONE)
            )
            if isinstance(parent, list):
                parent[int(last)] = copy_value(v)
            else:
                parent[last] = copy_value(v)
        elif kind == "move":
            from_segs = [s for s in str(op.get("from", "")).split("/") if s]
            src_parent = _walk_to(doc, from_segs)
            src_last = _unescape(from_segs[-1])
            if isinstance(src_parent, list):
                v = src_parent.pop(int(src_last))
            else:
                v = src_parent.pop(src_last, NONE)
            if isinstance(parent, list):
                parent.insert(int(last), v)
            else:
                parent[last] = v
        elif kind == "test":
            cur = (
                parent[int(last)]
                if isinstance(parent, list)
                else parent.get(last, NONE)
            )
            if not value_eq(cur, op.get("value")):
                raise SdbError("Patch test operation failed")
        else:
            raise SdbError(f"Invalid patch operation '{kind}'")
    return doc
