"""Blockwise int8 quantizer of the compressed consensus wire (see ``kernel.py``)."""
