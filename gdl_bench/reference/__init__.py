"""Plain PyTorch references of the benchmark's model families.

Nothing here imports the program (``geo_deep_learning_tpu_torch``), the
JAX package or JAX: the references are the yardstick that the program's
outputs are judged by. Each family module gives ``forward(M, P, cfg, x,
train, ckpt)`` over a parameter dict named as the port names its state,
and ``buffers(cfg)``, the fixed tables that belong to the state.
"""
