"""The KV layer the index engines read and write: the transaction
contract and storage encoding (`api.py`), the in-memory MVCC engine
(`mem.py`) and the trimmed datastore and context (`ds.py`)."""
