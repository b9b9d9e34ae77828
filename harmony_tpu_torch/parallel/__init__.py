"""Process-group parallelism for the BLS pipeline.

The JAX package maps committee size and shard count onto a device mesh;
here the mesh is a ``torch.distributed`` process group, one rank per
device, NCCL between cards and gloo on the CPU:

- independent verifies (block replay, per-vote checks) shard over the
  batch axis, each rank checking its part, with no collective;
- committee aggregation (masked G1 sums over 1000+ validators) shards the
  committee axis: each rank sums its chunk, the partial sums are
  all_gathered, and every rank merges them in rank order;
- products of pairings shard the pair axis, combining per-rank Miller
  products before one replicated final exponentiation.
"""
