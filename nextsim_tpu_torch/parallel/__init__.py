"""Multi-device runs: one torch.distributed rank per block of the grid
(distributed.py), the ring exchange (halo.py), the block layout and the
step's exchanges and their adjoint (seam.py), gathers, member groups and the
writer gate (multihost.py)."""
