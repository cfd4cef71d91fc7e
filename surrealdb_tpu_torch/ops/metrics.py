"""Distance metric ids and catalog-spec normalisation (the reference's
`ops/metrics.py`). The ids double as the metric codes the CUDA distance
kernel takes (`METRIC_CODE`)."""

from __future__ import annotations

EUCLIDEAN = "euclidean"
COSINE = "cosine"
MANHATTAN = "manhattan"
CHEBYSHEV = "chebyshev"
HAMMING = "hamming"
MINKOWSKI = "minkowski"
DOT = "dot"
JACCARD = "jaccard"
PEARSON = "pearson"

# metric -> integer code of csrc/kernels.h (enum Metric)
METRIC_CODE = {
    EUCLIDEAN: 0, COSINE: 1, DOT: 2, MANHATTAN: 3, CHEBYSHEV: 4,
    HAMMING: 5, MINKOWSKI: 6, PEARSON: 7, JACCARD: 8,
}
# metrics whose distance is one product (the bf16 rank + rescore store)
GEMM_METRICS = (EUCLIDEAN, COSINE, DOT)


def normalize_metric(dist) -> tuple[str, float]:
    """Catalog distance spec -> (metric id, minkowski order)."""
    if isinstance(dist, tuple) and dist[0] == "minkowski":
        return MINKOWSKI, float(dist[1])
    name = str(dist).lower()
    # a bare "minkowski" carries no order: only the tuple form names it
    if name not in METRIC_CODE or name == MINKOWSKI:
        raise ValueError(f"unsupported distance {dist!r}")
    return name, 3.0
