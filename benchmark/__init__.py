"""The benchmark of ``nextsim_tpu_torch``, the PyTorch and CUDA port, on an
NVIDIA H100: ``python3 benchmark/run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>``. ``BENCHMARK.json`` at the checkout's root
lists the cells and metrics; ``harness.py`` runs one; PERF.md explains them.
"""
