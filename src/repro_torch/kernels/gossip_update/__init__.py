"""The fused DR-DSGD update and neighbour combine (B.1; see ``kernel.py``)."""
