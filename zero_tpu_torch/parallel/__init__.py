"""Multi-device training of the port: data parallelism across processes,
one device a process (``distributed.py``)."""
