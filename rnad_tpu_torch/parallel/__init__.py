"""Data and tensor parallelism over ``torch.distributed`` (counterpart of
``rnad_tpu/parallel/``): the (data, model) grid (``mesh.py``), the
tensor-parallel layouts and their operators (``tensor_parallel.py``),
process-group set-up and the global-stream train step (``runtime.py``),
the per-rank-stream twin with a learner update on a fixed trajectory
(``shard_map_step.py``), and ``dryrun_multichip``'s counterpart
(``dryrun.py``).
"""
