"""Plain float32 reference of the benchmark's models (torch only).

It imports nothing of the program under test and takes nothing the program
made: its weights are drawn again from the run's seed (`weights.py`), its
shapes come from the configuration files under `benchmark/configs/`.
"""
