"""Parallel modes of the port over `torch.distributed` (`parallel/mesh.py`).

Data parallelism on the ('data', 'model') mesh is ported; tensor, sequence,
expert and pipeline parallelism, ZeRO-1 and FSDP are not (ROADMAP Queue 1).
"""
