"""Row-sharded KNN over the runner's device list (the reference's
`parallel/mesh.py`)."""
