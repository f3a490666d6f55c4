"""The benchmark of ``radar_slam_tpu_torch`` on one NVIDIA H100.

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one JSON
line (``run.py``).  Everything a cell names is found by name
(``registry.py``): configurations in ``configs/``, traffic mixes in
``traffic/`` with their drivers in ``drivers/``, scene makers in
``scenes/``, one reader per metric in ``end_to_end/`` and
``layer_metrics/``, the limits of ``correct`` in ``limits/``.  The plain
reference (``reference/``) and the roofline's work counts (``work/``) are
the yardstick and import nothing of the program.
"""
