"""CAGRA-style quantized graph-ANN index: the host-side construction,
the numpy half of the search and the persisted artifacts (the reference
package's `idx/cagra.py`).

- `build_graph`: fixed-out-degree flat search graph `[N, D_out]` int32.
  A kNN-graph init (random-projection partition trees, exact kNN inside
  each leaf via one gemm, merged across trees, optional NN-descent
  refine), then CAGRA's rank-based reordering + reverse-edge merge
  (arXiv:2308.15136).
- `quantize_int8`: per-row int8 with an optional |x| quantile clip;
  cosine quantizes the pre-normalized rows.
- `entry_ids` / `probe_count`: the strided routing probe the device
  descent (`device/annstore.py`) scores to seed its frontier.
- `descend`: the fixed-iteration batched greedy descent in numpy, the
  index engine's fallback when the device cannot serve; with
  `int8_score_fn` it walks the landscape the device kernel walks.
- `AnnIndex` / `build_index`: one built index (graph, int8 rows,
  scales, dequantized squared norms) stamped with the engine's
  (version, epoch), as the engine ships it to the runner.
- `save_index` / `load_index`: one built index as an `SKVANN01` file
  (an 8-byte magic, then `>I` length + `>I` CRC32 frames: a JSON header
  with sorted keys, then one frame per array), byte-equal to the
  reference's file for the same index and header, so either package
  reads the other's. Any corruption raises ValueError.

Pure numpy, the same arrays byte for byte as the reference's builder
for the same inputs and seed.
"""

from __future__ import annotations

import time

import numpy as np

from surrealdb_tpu_torch import cnf

MXU_METRICS = ("euclidean", "cosine", "dot")


# ---------------------------------------------------------------------------
# quantization
# ---------------------------------------------------------------------------


def row_stats(xs: np.ndarray, block_elems: int = 16 << 20):
    """f64-accurate per-row stats as f32: (x2 squared norms, norms).
    Blockwise: never materializes an [N, D] copy."""
    n, dim = xs.shape
    x2 = np.empty(n, np.float32)
    step = max(1, block_elems // max(dim, 1))
    for s in range(0, n, step):
        blk = xs[s:s + step].astype(np.float64)
        x2[s:s + step] = (blk * blk).sum(axis=1).astype(np.float32)
    norms = np.sqrt(x2, dtype=np.float32)
    return x2, norms


def quantize_int8(xs: np.ndarray, metric: str = "euclidean",
                  clip_q: float = None, norms: np.ndarray = None):
    """Per-row int8: row r stores `round(clip(x_r, ±m_r) * 127 / m_r)`
    where `m_r` is the row's |x| quantile at `clip_q` (1.0 = the exact
    max). Cosine quantizes the pre-normalized rows. Returns
    (x8 [N, D] int8, arow [N] f32 dequant scale)."""
    if clip_q is None:
        clip_q = cnf.KNN_ANN_CLIP_Q
    n, dim = xs.shape
    x8 = np.empty((n, dim), np.int8)
    arow = np.empty(n, np.float32)
    kth = min(max(int(clip_q * (dim - 1)), 0), dim - 1)
    step = max(1, (64 << 20) // max(dim * 4, 1))
    for s in range(0, n, step):
        blk = xs[s:s + step].astype(np.float32)
        if metric == "cosine":
            nb = norms[s:s + step] if norms is not None else np.maximum(
                np.linalg.norm(blk.astype(np.float64), axis=1), 1e-30
            ).astype(np.float32)
            blk = blk / np.maximum(nb, 1e-30)[:, None]
        a = np.abs(blk)
        if kth >= dim - 1:
            m = a.max(axis=1)
        else:
            m = np.partition(a, kth, axis=1)[:, kth]
            # all-outlier rows (the quantile lands on 0 while the max
            # does not) fall back to the max
            zero = m <= 0
            if zero.any():
                m[zero] = a[zero].max(axis=1)
        m = np.maximum(m, 1e-30)
        x8[s:s + step] = np.clip(
            np.rint(blk * (127.0 / m)[:, None]), -127, 127
        ).astype(np.int8)
        arow[s:s + step] = m / 127.0
    return x8, arow


def dequantize(x8: np.ndarray, arow: np.ndarray) -> np.ndarray:
    """Round-trip helper (tests): the f32 rows the int8 store encodes."""
    return x8.astype(np.float32) * arow[:, None]


# ---------------------------------------------------------------------------
# graph construction
# ---------------------------------------------------------------------------


def pack_csr(rows: np.ndarray, cols: np.ndarray, n_nodes: int):
    """Stable-sorted CSR arrays from an edge list: returns
    (indptr [n+1] int64, sorted_cols [E], order [E]) where `order` is
    the stable row-sort permutation (per-row destinations keep their
    edge-list order)."""
    order = np.argsort(rows, kind="stable")
    sorted_cols = cols[order]
    indptr = np.zeros(n_nodes + 1, np.int64)
    np.add.at(indptr, rows + 1, 1)
    return np.cumsum(indptr), sorted_cols, order


class _Space:
    """Metric-transformed row access for the BUILD distance (squared
    euclidean in the transformed space, monotone with the metric).
    Gathers transform on the fly; no transformed [N, D] copy."""

    def __init__(self, xs, metric, x2, norms):
        self.xs = xs
        self.metric = metric
        self.dim = xs.shape[1] + (1 if metric == "dot" else 0)
        if metric == "cosine":
            self.inv = (1.0 / np.maximum(norms, 1e-30)).astype(np.float32)
            self.aug = None
        elif metric == "dot":
            # the MIPS -> L2 reduction: x' = [x, sqrt(M^2 - |x|^2)]
            self.inv = None
            m2 = float(x2.max()) if len(x2) else 0.0
            self.aug = np.sqrt(np.maximum(m2 - x2, 0.0)).astype(np.float32)
        else:
            self.inv = None
            self.aug = None

    def gather(self, ids) -> np.ndarray:
        """Transformed f32 rows for (possibly multi-dim) id arrays."""
        rows = self.xs[ids].astype(np.float32, copy=False)
        if self.inv is not None:
            rows = rows * self.inv[ids][..., None]
        elif self.aug is not None:
            rows = np.concatenate(
                [rows, self.aug[ids][..., None]], axis=-1
            )
        return rows

    def project(self, ids, r: np.ndarray) -> np.ndarray:
        """Projection of transformed rows onto direction r [dim]."""
        p = self.xs[ids].astype(np.float32, copy=False) @ r[:self.xs.shape[1]]
        if self.inv is not None:
            p = p * self.inv[ids]
        elif self.aug is not None:
            p = p + self.aug[ids] * r[-1]
        return p


def _merge_into(best_i, best_d, rows, new_i, new_d, keep: int):
    """Merge candidate (id, dist) lists into the running per-node best,
    deduping by id (min dist wins): one lexsort per block."""
    ci = np.concatenate([best_i[rows], new_i], axis=1)
    cd = np.concatenate([best_d[rows], new_d], axis=1)
    order = np.lexsort((cd, ci), axis=1)  # by id, then dist
    ci = np.take_along_axis(ci, order, 1)
    cd = np.take_along_axis(cd, order, 1)
    dup = np.zeros(ci.shape, bool)
    dup[:, 1:] = ci[:, 1:] == ci[:, :-1]
    cd[dup] = np.inf
    cd[ci < 0] = np.inf
    sel = np.argpartition(cd, keep - 1, axis=1)[:, :keep]
    best_i[rows] = np.take_along_axis(ci, sel, 1)
    best_d[rows] = np.take_along_axis(cd, sel, 1)


def _leaf_pass(space: _Space, best_i, best_d, keep, leaf, rng):
    """One random-projection partition tree: median-split on random
    directions until leaves <= `leaf`, then exact kNN inside each leaf
    via one gemm."""
    n = len(best_i)
    k = min(keep // 2, leaf - 1)
    stack = [np.arange(n, dtype=np.int64)]
    while stack:
        idx = stack.pop()
        if len(idx) > leaf:
            r = rng.standard_normal(space.dim).astype(np.float32)
            p = space.project(idx, r)
            med = np.median(p)
            left = idx[p < med]
            right = idx[p >= med]
            if len(left) == 0 or len(right) == 0:
                # degenerate projection (constant rows): random halves
                perm = rng.permutation(len(idx))
                half = len(idx) // 2
                left, right = idx[perm[:half]], idx[perm[half:]]
            stack.append(left)
            stack.append(right)
            continue
        if len(idx) < 2:
            continue
        rows = space.gather(idx)
        x2 = (rows * rows).sum(axis=1)
        g = x2[:, None] + x2[None, :] - 2.0 * (rows @ rows.T)
        np.fill_diagonal(g, np.inf)
        kk = min(k, len(idx) - 1)
        sel = np.argpartition(g, kk - 1, axis=1)[:, :kk]
        d = np.take_along_axis(g, sel, axis=1)
        _merge_into(best_i, best_d, idx, idx[sel], d, keep)


def _refine_pass(space: _Space, best_i, best_d, keep, d_out, rng):
    """One NN-descent round: each node scores its neighbors' neighbors
    (sampled), repairing partition-boundary misses of the tree init."""
    n = len(best_i)
    order = np.argsort(best_d, axis=1, kind="stable")[:, :d_out]
    fwd = np.take_along_axis(best_i, order, 1)
    fwd = np.where(fwd < 0, np.arange(n, dtype=np.int64)[:, None], fwd)
    s = min(4, d_out)
    step = max(1, (256 << 20) // max(s * d_out * space.dim * 4, 1))
    for lo in range(0, n, step):
        rows = np.arange(lo, min(lo + step, n), dtype=np.int64)
        cand = fwd[fwd[rows, :s]].reshape(len(rows), s * d_out)
        base = space.gather(rows)          # [B, D]
        crows = space.gather(cand)         # [B, C, D]
        d = (
            (base * base).sum(axis=1)[:, None]
            + (crows * crows).sum(axis=2)
            - 2.0 * np.einsum("bcd,bd->bc", crows, base)
        ).astype(np.float32)
        d[cand == rows[:, None]] = np.inf  # never link to self
        _merge_into(best_i, best_d, rows, cand, d, keep)


def build_graph(xs: np.ndarray, metric: str = "euclidean",
                d_out: int = None, leaf: int = None, trees: int = None,
                refine: int = None, seed: int = 7,
                x2: np.ndarray = None, norms: np.ndarray = None):
    """Fixed-out-degree search graph [N, d_out] int32: kNN-graph init
    (RP-trees + optional NN-descent), then CAGRA rank-based reordering
    with reverse-edge merge. Rows with fewer than d_out distinct
    neighbors pad with self-loops."""
    if d_out is None:
        d_out = cnf.KNN_ANN_DEGREE
    if leaf is None:
        leaf = cnf.KNN_ANN_LEAF
    if trees is None:
        trees = cnf.KNN_ANN_TREES
    if refine is None:
        refine = cnf.KNN_ANN_REFINE
    n = xs.shape[0]
    if refine < 0:
        refine = 1 if n <= 200_000 else 0
    if x2 is None or norms is None:
        x2, norms = row_stats(xs)
    space = _Space(xs, metric, x2, norms)
    rng = np.random.default_rng(seed)
    keep = 2 * d_out
    best_i = np.full((n, keep), -1, np.int64)
    best_d = np.full((n, keep), np.inf, np.float32)
    for _t in range(max(trees, 1)):
        _leaf_pass(space, best_i, best_d, keep, max(leaf, d_out + 1), rng)
    for _r in range(max(refine, 0)):
        _refine_pass(space, best_i, best_d, keep, d_out, rng)
    # forward edges in rank order (CAGRA "reordering": rank = closeness
    # position, which the merge below prefers over raw distance)
    order = np.argsort(best_d, axis=1, kind="stable")[:, :d_out]
    fwd = np.take_along_axis(best_i, order, 1)
    fwd_d = np.take_along_axis(best_d, order, 1)
    self_col = np.arange(n, dtype=np.int64)[:, None]
    fwd = np.where(np.isinf(fwd_d) | (fwd < 0), self_col, fwd)
    # reverse edges, rank-ordered per destination: the forward edge list
    # flattened RANK-major, so the CSR pack's stable sort keeps rank
    # order inside each destination's segment
    rev_rows = fwd.T.reshape(-1).astype(np.int64)   # destinations
    rev_cols = np.tile(np.arange(n, dtype=np.int64), d_out)  # sources
    indptr, rev_sorted, _ = pack_csr(rev_rows, rev_cols, n)
    # bounded gather of each node's first d_out reverse edges
    counts = np.minimum(indptr[1:] - indptr[:-1], d_out).astype(np.int64)
    rev = np.full((n, d_out), -1, np.int64)
    pos = np.nonzero(counts)[0]
    if len(pos):
        starts = indptr[:-1][pos]
        cts = counts[pos]
        # rank of each kept reverse edge within its destination segment
        rcol = (
            np.arange(cts.sum()) - np.repeat(np.cumsum(cts) - cts, cts)
        )
        flat = np.repeat(starts, cts) + rcol
        rev[np.repeat(pos, cts), rcol] = rev_sorted[flat]
    # merge: forward rank r at priority 2r, reverse rank r at 2r+1,
    # dedupe by id (min priority wins), truncate to d_out
    cand = np.concatenate([fwd, rev], axis=1)
    pri = np.empty((n, 2 * d_out), np.float32)
    pri[:, :d_out] = 2.0 * np.arange(d_out, dtype=np.float32)
    pri[:, d_out:] = 2.0 * np.arange(d_out, dtype=np.float32) + 1.0
    pri[cand < 0] = np.inf
    pri[cand == self_col] = np.inf
    order = np.lexsort((pri, cand), axis=1)
    ci = np.take_along_axis(cand, order, 1)
    cp = np.take_along_axis(pri, order, 1)
    dup = np.zeros(ci.shape, bool)
    dup[:, 1:] = ci[:, 1:] == ci[:, :-1]
    cp[dup] = np.inf
    sel = np.argsort(cp, axis=1, kind="stable")[:, :d_out]
    graph = np.take_along_axis(ci, sel, 1)
    gp = np.take_along_axis(cp, sel, 1)
    graph = np.where(np.isinf(gp), self_col, graph)
    return np.ascontiguousarray(graph, np.int32)


# ---------------------------------------------------------------------------
# the routing probe of the device descent
# ---------------------------------------------------------------------------


def entry_ids(n: int, width: int) -> np.ndarray:
    """Deterministic strided sample ids (byte-stable across restarts)."""
    return ((np.arange(width, dtype=np.int64) * n) // width)


def probe_count(n: int, width: int) -> int:
    """Size of the strided routing probe scored per query batch to seed
    the descent: an absolute floor (small stores: cover everything) and
    a fraction of n (large stores: a constant per-cluster miss rate)."""
    return min(n, max(4 * width, cnf.KNN_ANN_PROBE,
                      int(n * cnf.KNN_ANN_PROBE_FRAC)))


def descend(graph: np.ndarray, n: int, score_fn, batch: int,
            width: int, iters: int, expand: int, kc: int,
            probe_fn=None) -> np.ndarray:
    """Fixed-iteration batched greedy graph descent. `score_fn(ids)`
    maps an int64 id array [B, C] to f32 scores (lower = closer; any
    monotone transform of the metric works — the exact re-rank
    restores true distances). `probe_fn(ids [P]) -> [B, P]` scores the
    shared routing probe with ONE gemm — without it the probe would
    gather a [B, P, D] block (hundreds of MB at 1M×768). Returns
    candidate ids [B, kc], unique per row, best-first."""
    W = max(width, kc)
    probe = entry_ids(n, probe_count(n, W))
    if probe_fn is not None:
        pd = probe_fn(probe).astype(np.float32, copy=False)
    else:
        pd = score_fn(
            np.broadcast_to(probe[None, :], (batch, len(probe)))
        ).astype(np.float32, copy=False)
    sel0 = np.argpartition(pd, W - 1, axis=1)[:, :W]
    ids = probe[sel0]
    dist = np.take_along_axis(pd, sel0, 1).copy()
    expanded = np.zeros((batch, W), bool)
    for _it in range(iters):
        key = np.where(expanded, np.inf, dist)
        sel = np.argpartition(key, expand - 1, axis=1)[:, :expand]
        if not np.isfinite(
            np.take_along_axis(key, sel, 1)
        ).any():
            break  # every frontier slot expanded: converged
        np.put_along_axis(expanded, sel, True, axis=1)
        src = np.take_along_axis(ids, sel, 1)          # [B, E]
        nb = graph[src].reshape(batch, -1).astype(np.int64)  # [B, E*D]
        # drop duplicates: vs the current list, and inside nb itself
        dup = (nb[:, :, None] == ids[:, None, :]).any(axis=2)
        eq = nb[:, :, None] == nb[:, None, :]
        inner = (np.tril(eq, k=-1)).any(axis=2)
        nd = score_fn(nb).astype(np.float32, copy=False)
        nd = np.where(dup | inner, np.inf, nd)
        mi = np.concatenate([ids, nb], axis=1)
        md = np.concatenate([dist, nd], axis=1)
        me = np.concatenate([expanded, dup | inner], axis=1)
        keep = np.argpartition(md, W - 1, axis=1)[:, :W]
        ids = np.take_along_axis(mi, keep, 1)
        dist = np.take_along_axis(md, keep, 1)
        expanded = np.take_along_axis(me, keep, 1)
    order = np.argsort(dist, axis=1, kind="stable")[:, :kc]
    return np.take_along_axis(ids, order, 1)


# ---------------------------------------------------------------------------
# built artifact
# ---------------------------------------------------------------------------


class AnnIndex:
    """One built CAGRA index over a snapshot of the host rows: the flat
    graph + the int8 ranking arrays the device store ships, plus the
    (version, epoch) the snapshot was taken at — the device cache tag,
    so crash/reship and prewarm ride the existing block protocol."""

    __slots__ = ("metric", "graph", "x8", "arow", "x2", "d_out",
                 "built_n", "built_version", "built_epoch", "build_s",
                 "inv_norms")

    def __init__(self, metric, graph, x8, arow, x2, inv_norms,
                 built_n, built_version, built_epoch, build_s):
        self.metric = metric
        self.graph = graph
        self.x8 = x8
        self.arow = arow
        self.x2 = x2
        self.inv_norms = inv_norms
        self.d_out = int(graph.shape[1]) if graph.ndim == 2 else 0
        self.built_n = int(built_n)
        self.built_version = int(built_version)
        self.built_epoch = int(built_epoch)
        self.build_s = float(build_s)

    def nbytes(self) -> int:
        return int(self.graph.nbytes + self.x8.nbytes + self.arow.nbytes
                   + self.x2.nbytes)


def build_index(xs: np.ndarray, metric: str, version: int, epoch: int,
                seed: int = 7, **kw) -> AnnIndex:
    """Snapshot build: graph + int8 arrays from the f32/f64 host rows.
    `version`/`epoch` stamp the snapshot for the device cache tag."""
    t0 = time.perf_counter()
    n = xs.shape[0]
    x2, norms = row_stats(xs)
    graph = build_graph(xs, metric, seed=seed, x2=x2, norms=norms, **kw)
    from surrealdb_tpu_torch import resource

    resource.throttle("ann_build")  # before the int8 store allocates
    x8, arow = quantize_int8(xs, metric, norms=norms)
    if metric == "euclidean":
        # squared norms of the DEQUANTIZED rows: the int8 descent
        # (host mirror and device kernel alike) scores x2q - 2·q·x̂,
        # which is only monotone-consistent against x̂ = x8·arow.
        # Blockwise — never an [N, D] f32 copy of the int8 store.
        x2q = np.empty(n, np.float32)
        step = max(1, (64 << 20) // max(xs.shape[1] * 4, 1))
        for s in range(0, n, step):
            blk = x8[s:s + step].astype(np.float32)
            x2q[s:s + step] = (blk * blk).sum(axis=1)
        x2q *= arow * arow
    else:
        x2q = np.zeros(n, np.float32)
    inv_norms = (1.0 / np.maximum(norms, 1e-30)).astype(np.float32)
    return AnnIndex(
        metric, graph, x8, arow, x2q,
        inv_norms, n, version, epoch, time.perf_counter() - t0,
    )


def host_score_fn(xs: np.ndarray, metric: str, qs: np.ndarray,
                  x2: np.ndarray = None, inv_norms: np.ndarray = None):
    """Descent scoring against the full-precision host rows (the
    degraded/CPU path — strictly better than the int8 scores the device
    uses, same monotone-score contract). Returns (score_fn, probe_fn):
    per-candidate gather scoring and one-gemm probe scoring."""
    qs32 = np.ascontiguousarray(qs, np.float32)

    def fn(ids):
        rows = xs[ids].astype(np.float32, copy=False)  # [B, C, D]
        dots = np.einsum("bcd,bd->bc", rows, qs32)
        if metric == "euclidean":
            return x2[ids] - 2.0 * dots
        if metric == "cosine":
            return -(dots * inv_norms[ids])
        return -dots

    def probe(ids):
        rows = xs[ids].astype(np.float32, copy=False)  # [P, D]
        dots = qs32 @ rows.T                           # [B, P]
        if metric == "euclidean":
            return x2[ids][None, :] - 2.0 * dots
        if metric == "cosine":
            return -(dots * inv_norms[ids][None, :])
        return -dots

    return fn, probe


def int8_score_fn(ann: "AnnIndex", qs: np.ndarray):
    """Descent scoring against the DEQUANTIZED int8 ranking rows — the
    numpy mirror of the device kernel's scoring (same rows, f32 query,
    no query quantization), used by the degraded/CPU ANN path so host
    and device descents walk the same landscape. Returns
    (score_fn, probe_fn)."""
    qs32 = np.ascontiguousarray(qs, np.float32)
    x8, arow, x2q = ann.x8, ann.arow, ann.x2
    metric = ann.metric

    def fn(ids):
        rows = x8[ids].astype(np.float32)              # [B, C, D]
        dots = np.einsum("bcd,bd->bc", rows, qs32) * arow[ids]
        if metric == "euclidean":
            return x2q[ids] - 2.0 * dots
        return -dots  # cosine quantized pre-normalized rows; dot raw

    def probe(ids):
        rows = x8[ids].astype(np.float32)              # [P, D]
        dots = (qs32 @ rows.T) * arow[ids][None, :]    # [B, P]
        if metric == "euclidean":
            return x2q[ids][None, :] - 2.0 * dots
        return -dots

    return fn, probe


# ---------------------------------------------------------------------------
# persisted build artifacts
# ---------------------------------------------------------------------------
# A graph build is recomputation of state the KV rows already imply, so
# it persists beside a disk-backed datastore and a restart reloads it.
# The frame length is packed as `>I`, as the reference packs it: an
# array past 4 GiB raises struct.error (not an OSError) on save.

_SNAP_MAGIC = b"SKVANN01"
_SNAP_ARRAYS = ("graph", "x8", "arow", "x2", "inv_norms")


def _write_frame(f, body: bytes):
    import struct
    import zlib

    f.write(struct.pack(">I", len(body)))
    f.write(struct.pack(">I", zlib.crc32(body) & 0xFFFFFFFF))
    f.write(body)


def _read_frame(f) -> bytes:
    import struct
    import zlib

    hdr = f.read(8)
    if len(hdr) != 8:
        raise ValueError("ann snapshot: truncated frame header")
    (n,) = struct.unpack(">I", hdr[:4])
    (crc,) = struct.unpack(">I", hdr[4:])
    body = f.read(n)
    if len(body) != n:
        raise ValueError("ann snapshot: torn frame")
    if zlib.crc32(body) & 0xFFFFFFFF != crc:
        raise ValueError("ann snapshot: crc mismatch")
    return body


def save_index(ann: AnnIndex, path: str, extra: dict = None):
    """Persist a built index atomically (tmp + rename). `extra` lands in
    the header frame: the engine stamps the row-identity digest there so
    a reload can prove the row NUMBERING still matches."""
    import json
    import os

    meta = {
        "metric": ann.metric,
        "built_n": ann.built_n,
        "built_version": ann.built_version,
        "built_epoch": ann.built_epoch,
        "build_s": ann.build_s,
        "arrays": {
            name: [getattr(ann, name).dtype.str,
                   list(getattr(ann, name).shape)]
            for name in _SNAP_ARRAYS
        },
    }
    if extra:
        meta.update(extra)
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            f.write(_SNAP_MAGIC)
            _write_frame(f, json.dumps(meta, sort_keys=True).encode())
            for name in _SNAP_ARRAYS:
                _write_frame(
                    f, np.ascontiguousarray(getattr(ann, name)).tobytes()
                )
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.remove(tmp)
        except OSError:
            pass
        raise


def load_index(path: str) -> tuple[AnnIndex, dict]:
    """Load a persisted index -> (AnnIndex, header meta). Raises
    OSError when absent or unreadable and ValueError on any corruption:
    the caller decides between silence (no snapshot) and warn + rebuild
    (a corrupt one)."""
    import json

    with open(path, "rb") as f:
        if f.read(len(_SNAP_MAGIC)) != _SNAP_MAGIC:
            raise ValueError("ann snapshot: bad magic")
        meta = json.loads(_read_frame(f).decode())
        arrays = {}
        for name in _SNAP_ARRAYS:
            try:
                dt, shape = meta["arrays"][name]
            except (KeyError, TypeError, ValueError):
                raise ValueError(f"ann snapshot: header missing {name}")
            body = _read_frame(f)
            arr = np.frombuffer(body, dtype=np.dtype(dt))
            want = 1
            for s in shape:
                want *= int(s)
            if arr.size != want:
                raise ValueError(f"ann snapshot: {name} size mismatch")
            arrays[name] = arr.reshape([int(s) for s in shape])
    return AnnIndex(
        meta["metric"], arrays["graph"], arrays["x8"], arrays["arow"],
        arrays["x2"], arrays["inv_norms"], meta["built_n"],
        meta["built_version"], meta["built_epoch"],
        meta.get("build_s", 0.0),
    ), meta
