"""The RWKV6 WKV recurrence (B.7) and its backward (see ``kernel.py``)."""
