"""Multi-process helpers of the port (``distributed.py``)."""
