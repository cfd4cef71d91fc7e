"""Host-side index construction the serving side runs before it ships a
store to the device runner (no torch, no CUDA): `cagra.py`, the
CAGRA-style graph-ANN builder and its int8 quantiser."""
