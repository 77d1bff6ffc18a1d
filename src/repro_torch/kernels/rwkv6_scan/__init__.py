"""The RWKV6 WKV recurrence of the serving prefill (see ``kernel.py``)."""
