"""Acceleration structures: the BVH2 builder (`bvh`), the wide BVH
(`wide`), the BVH2 walk (`traverse`) and the packet-cluster backend
(`fcluster`).

The loop conditions that the plain-tensor backends read on the host are
counted in `tpu_restir_torch.tracing.COUNTS`, always: `sync.fcluster` one
a round of `fcluster`, `sync.bvh8` and `sync.bvh2` one a lockstep step
of the wide BVH and of the BVH2 walk, and `sync.cluster` one a cluster
the `cluster` backend may skip (`render/intersect.py`)."""
