"""Kernel bodies and their plain PyTorch versions
(``ops.paged_attention``)."""
