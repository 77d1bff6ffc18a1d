"""Forward GQA flash attention of the serving prefill (see ``kernel.py``)."""
