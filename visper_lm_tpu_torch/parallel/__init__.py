"""The multi-process runtime (counterpart of visper_lm_tpu/parallel/): the
process grid (`mesh.py`), process groups and the step's collectives
(`distributed.py`), and the ZeRO plans and placements (`sharding.py`).

Data parallelism and ZeRO-1/2/3 are ported (ROADMAP A10a); tensor,
sequence, pipeline and expert parallelism raise, naming the ROADMAP item
that brings each (A10b-d).
"""
