"""Domain decomposition of the solve over a process grid that splits any of
the four axes t, z, y, x (the reference's MPI layer; the JAX package's
ddalphaamg_tpu/parallel).

One process per rank with torch.distributed.  Fine and intermediate levels
are sharded into slabs, with half-spinor face exchange on the fine level
(soa_halo.py) and face exchange into kernel K5 on coarse levels
(shard_ops.py); the coarsest level is replicated on every rank, the
reference's "gathering".  mesh.py holds the process grid and the slab
helpers, comm.py the transports and collectives (face exchanges in a post
and a finish half, so that the kernels' interior work overlaps them),
peer.py kernel K8, the collectives over peer pointers that a CUDA graph's
loop body can hold (nccl grids), launch.py the ways to start ranks.
"""
