"""vector:: functions (reference: core/src/fnc/vector.rs:9-141,
fnc/util/math/vector.rs).

Scalar (per-call) forms using numpy. The batched forms used by index scans
live in surrealdb_tpu_torch.ops.distance (CUDA on the card); these must agree numerically
with those kernels — tests assert parity.
"""

from __future__ import annotations

import math

import numpy as np

from surrealdb_tpu_torch.err import SdbError
from surrealdb_tpu_torch.fnc import register
from surrealdb_tpu_torch.val import NONE


def _vec(v, fname):
    if not isinstance(v, (list, tuple)):
        raise SdbError(f"Incorrect arguments for function {fname}(). Expected a vector")
    try:
        return np.asarray(v, dtype=np.float64)
    except (TypeError, ValueError):
        raise SdbError(f"Incorrect arguments for function {fname}(). Expected a numeric vector")


def _pair(a, b, fname):
    va, vb = _vec(a, fname), _vec(b, fname)
    if va.shape != vb.shape:
        raise SdbError(f"Incorrect arguments for function {fname}(). The two vectors must be of the same dimension")
    return va, vb


def _out(arr):
    return [float(x) if not float(x).is_integer() else int(x) for x in arr]


def _outf(arr):
    return [float(x) for x in arr]


@register("vector::add")
def _add(args, ctx):
    a, b = _pair(args[0], args[1], "vector::add")
    return _out(a + b)


@register("vector::subtract")
def _subtract(args, ctx):
    a, b = _pair(args[0], args[1], "vector::subtract")
    return _out(a - b)


@register("vector::multiply")
def _multiply(args, ctx):
    a, b = _pair(args[0], args[1], "vector::multiply")
    return _out(a * b)


@register("vector::divide")
def _divide(args, ctx):
    a, b = _pair(args[0], args[1], "vector::divide")
    with np.errstate(divide="ignore", invalid="ignore"):
        return _outf(a / b)


@register("vector::scale")
def _scale(args, ctx):
    a = _vec(args[0], "vector::scale")
    return _out(a * float(args[1]))


@register("vector::dot")
def _dot(args, ctx):
    a, b = _pair(args[0], args[1], "vector::dot")
    v = float(np.dot(a, b))
    return int(v) if v.is_integer() else v


@register("vector::cross")
def _cross(args, ctx):
    a, b = _pair(args[0], args[1], "vector::cross")
    if a.shape != (3,):
        raise SdbError("Incorrect arguments for function vector::cross(). The two vectors must be of dimension 3")
    return _out(np.cross(a, b))


@register("vector::magnitude")
def _magnitude(args, ctx):
    a = _vec(args[0], "vector::magnitude")
    return float(np.linalg.norm(a))


@register("vector::normalize")
def _normalize(args, ctx):
    a = _vec(args[0], "vector::normalize")
    n = np.linalg.norm(a)
    if n == 0:
        return _outf(a)
    return _outf(a / n)


@register("vector::project")
def _project(args, ctx):
    a, b = _pair(args[0], args[1], "vector::project")
    denom = float(np.dot(b, b))
    if denom == 0:
        raise SdbError("Incorrect arguments for function vector::project(). Cannot project onto a zero vector")
    return _outf(b * (float(np.dot(a, b)) / denom))


@register("vector::angle")
def _angle(args, ctx):
    a, b = _pair(args[0], args[1], "vector::angle")
    na, nb = np.linalg.norm(a), np.linalg.norm(b)
    if na == 0 or nb == 0:
        raise SdbError("Incorrect arguments for function vector::angle(). Cannot compute the angle of a zero vector")
    c = float(np.dot(a, b) / (na * nb))
    return math.acos(max(-1.0, min(1.0, c)))


# -- distances ----------------------------------------------------------------


@register("vector::distance::euclidean")
def _euclidean(args, ctx):
    a, b = _pair(args[0], args[1], "vector::distance::euclidean")
    return float(np.linalg.norm(a - b))


@register("vector::distance::manhattan")
def _manhattan(args, ctx):
    a, b = _pair(args[0], args[1], "vector::distance::manhattan")
    v = float(np.abs(a - b).sum())
    return int(v) if v.is_integer() else v


@register("vector::distance::chebyshev")
def _chebyshev(args, ctx):
    a, b = _pair(args[0], args[1], "vector::distance::chebyshev")
    return float(np.abs(a - b).max()) if a.size else 0.0


@register("vector::distance::hamming")
def _hamming(args, ctx):
    a, b = _pair(args[0], args[1], "vector::distance::hamming")
    return int((a != b).sum())


@register("vector::distance::minkowski")
def _minkowski(args, ctx):
    a, b = _pair(args[0], args[1], "vector::distance::minkowski")
    p = float(args[2])
    if p <= 0:
        raise SdbError("Incorrect arguments for function vector::distance::minkowski(). The order must be positive")
    return float(np.power(np.power(np.abs(a - b), p).sum(), 1.0 / p))


@register("vector::distance::mahalanobis")
def _mahalanobis(args, ctx):
    raise SdbError("The function 'vector::distance::mahalanobis' is not yet implemented")


@register("vector::distance::knn")
def _knn_dist(args, ctx):
    """Distance computed by the KNN operator for the current record
    (reference: exec/function/index.rs:289 KnnContext)."""
    if ctx.knn is None or ctx.doc_id is None:
        return NONE
    from surrealdb_tpu_torch.val import hashable

    ref = int(args[0]) if args else 0
    d = ctx.knn.get(hashable(ctx.doc_id))
    return d if d is not None else NONE


# -- similarity ---------------------------------------------------------------


@register("vector::similarity::cosine")
def _cosine(args, ctx):
    a, b = _pair(args[0], args[1], "vector::similarity::cosine")
    na, nb = np.linalg.norm(a), np.linalg.norm(b)
    if na == 0 or nb == 0:
        return float("nan")
    return float(np.dot(a, b) / (na * nb))


@register("vector::distance::cosine")
def _cosine_dist(args, ctx):
    return 1.0 - _cosine(args, ctx)


@register("vector::similarity::jaccard")
def _jaccard(args, ctx):
    a = set(map(float, _vec(args[0], "f")))
    b = set(map(float, _vec(args[1], "f")))
    if not a and not b:
        return 1.0
    return len(a & b) / len(a | b)


@register("vector::similarity::pearson")
def _pearson(args, ctx):
    a, b = _pair(args[0], args[1], "vector::similarity::pearson")
    if a.size < 2:
        return float("nan")
    sa, sb = a.std(), b.std()
    if sa == 0 or sb == 0:
        return float("nan")
    return float(((a - a.mean()) * (b - b.mean())).mean() / (sa * sb))


@register("vector::similarity::spearman")
def _spearman(args, ctx):
    a, b = _pair(args[0], args[1], "vector::similarity::spearman")

    def rank(x):
        order = np.argsort(x)
        r = np.empty_like(order, dtype=np.float64)
        r[order] = np.arange(1, len(x) + 1)
        # average ties
        vals, inv, counts = np.unique(x, return_inverse=True, return_counts=True)
        sums = np.zeros(len(vals))
        np.add.at(sums, inv, r)
        return sums[inv] / counts[inv]

    ra, rb = rank(a), rank(b)
    return _pearson([list(ra), list(rb)], ctx)
