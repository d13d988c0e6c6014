"""Data parallelism over ``torch.distributed`` (counterpart of
``rnad_tpu/parallel/``): the data axis (``mesh.py``), process-group set-up
and the global-stream train step (``runtime.py``), and the per-rank-stream
twin with a learner update on a fixed trajectory (``shard_map_step.py``).
"""
