"""The plain reference that decides ``correct``.

``plain/`` is a frozen copy of the port's plain PyTorch and numpy code for
what the cells run: the configuration schema, the grid and the ETOPO
coastline, the dataset readers and their interpolation, the ice and ocean
initial state, thermodynamics, the momentum solve with its substep loop in
plain PyTorch (no CUDA kernel: ``plain/ops/momentum.py:substep_loop``),
transport and ridging. Its imports point into the copy; it imports nothing
of the program, of JAX or of the JAX package. Against the program it
differs in three places only: the substep loop is the plain one on every
device, the dataset planes keep the interpolation's float64 on their way
to the device, and the NetCDF reader maps a file and reads the records it
needs (the program's reads the whole file at every open: same values).
``model.py`` drives it in float64.

The reference follows the program from the program's own state: a whole
trajectory of a chaotic damage model cannot be held to another's, so the
check takes the state the window's last call started from and recomputes
that call's steps from it, each step's forcing from the raw input files;
the start (the initial state from the same inputs) is checked by itself.
"""
