"""The multi-process runtime (counterpart of visper_lm_tpu/parallel/): the
process grid (`mesh.py`), process groups and the step's collectives
(`distributed.py`), the ZeRO plans and placements over the data and model
axes (`sharding.py`), tensor parallelism (`tensor.py`: Megatron's
operators, which GSPMD writes for JAX), sequence parallelism
(`sequence.py`: Ulysses and the ring) and pipeline parallelism
(`pipeline.py`: GPipe).

Data parallelism and ZeRO-1/2/3 (ROADMAP A10a), tensor parallelism with
serving and LoRA on it (A10b), sequence and pipeline parallelism with the
memory levers and LoRA on them (A10c) and expert parallelism with the MoE
decoder under every axis and the offloaded moments (A10d) are ported; a
MoE layer routes over the data x seq group (`distributed.routing_group`).
"""
