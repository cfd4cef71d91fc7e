"""The CSR graph engine (`csr.py`)."""
