"""Multi-device runs: one torch.distributed rank per block of the grid
(distributed.py), the ring exchange (halo.py), the block layout and the
step's exchanges (seam.py), gathers and the writer gate (multihost.py)."""
