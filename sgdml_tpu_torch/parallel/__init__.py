"""Multi-GPU scaling: device meshes, sharded assembly, distributed solves.

One process per device over ``torch.distributed`` (NCCL for CUDA tensors,
gloo for CPU tensors): every rank calls the same API on the same inputs,
holds only its row strip of the kernel matrix and its batch shard, and gets
the whole result back. Counterpart of ``sgdml_tpu.parallel``, whose single
controller drives a ``jax.sharding.Mesh``.
"""
