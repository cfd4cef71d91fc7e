"""Batched execution engine.

Single engine (no legacy/streaming duality like the reference — SURVEY.md §7
step 3): a statement loop over a transaction, per-statement operator pipelines
for SELECT, and a document write pipeline mirroring the reference's
core/src/doc/ stage order. Vector / graph hot paths dispatch to the device
engines in surrealdb_tpu_torch.idx / surrealdb_tpu_torch.graph.
"""
