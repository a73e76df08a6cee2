"""The benchmark of the PyTorch and CUDA port (``cause_tpu_torch``):
merge waves of document pairs and a converging fleet on one card.

``python -m weavebench --workload <name> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json``; ``run.py`` says
how. ``python -m weavebench.control`` runs the comparison's control.
"""
