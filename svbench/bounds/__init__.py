"""Byte bounds of the kernels the cells drive, from the cells' shapes
alone, and the card's published peaks."""
