"""PyTorch/CUDA port of the CCache system for one NVIDIA Hopper GPU.

A second package beside the JAX reference ``repro``: the sharded
commutative KV store with its merge engine on the stacked layout (every
shard on one device as a leading dim) and hand-written CUDA kernels for the
reference's Pallas kernels. It imports nothing of ``repro`` or ``jax``.
"""
