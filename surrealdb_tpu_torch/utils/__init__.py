"""Small host-side helpers: a reader-writer lock, sorted containers, the
JSON patch, and the stdlib-only RSA (JWT RS*) and BLAKE3 primitives."""
