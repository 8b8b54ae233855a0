"""The benchmark of ``repro_torch``, the PyTorch and CUDA port of the
clause-indexed Tsetlin Machine, on NVIDIA H100 cards.

``python3 -m tmbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` (see ``harness.py``
for how its files are found). Importing this package loads nothing.
"""
