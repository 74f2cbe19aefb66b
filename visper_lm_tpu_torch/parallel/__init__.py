"""The multi-process runtime (counterpart of visper_lm_tpu/parallel/): the
process grid (`mesh.py`), process groups and the step's collectives
(`distributed.py`), the ZeRO plans and placements over the data and model
axes (`sharding.py`), and tensor parallelism (`tensor.py`: Megatron's
operators, which GSPMD writes for JAX).

Data parallelism and ZeRO-1/2/3 (ROADMAP A10a) and tensor parallelism
(A10b) are ported; sequence, pipeline and expert parallelism raise, naming
the ROADMAP item that brings each (A10c, A10d).
"""
