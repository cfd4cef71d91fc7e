"""Small host-side helpers: a reader-writer lock and sorted containers."""
