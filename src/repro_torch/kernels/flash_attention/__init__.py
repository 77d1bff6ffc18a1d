"""GQA flash attention (B.6) and its backward (see ``kernel.py``)."""
