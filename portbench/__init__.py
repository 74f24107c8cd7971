"""The benchmark of ``repro_torch``: one cell a run, driven by data.

``python3 portbench/run.py --workload <name> --seed <n> --seconds <s>
--trace <0|1>``; see ``portbench/README.md``.
"""
