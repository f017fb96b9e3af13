"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, at the
full 700 W power limit; a run prints the card's limit beside its numbers).
"""

HBM_BPS = 3.35e12  # bytes/s of HBM3
