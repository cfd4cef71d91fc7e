"""The torch device runner and its client.

- `runner.py`: the runner subprocess; owns torch/CUDA state behind the
  framed socket protocol of `proto.py`.
- `handlers.py`: `DeviceHost`, the op table (vector, graph-ANN and CSR
  stores, brute KNN, status), usable in-process as well.
- `supervisor.py`: the client that spawns a runner under an init
  watchdog, calls it with timeouts and ships stores.

Nothing is imported here: importing the package never initialises CUDA.
"""
