"""Acceleration structures: the BVH2 builder (`bvh`), the wide BVH
(`wide`), the BVH2 walk (`traverse`) and the packet-cluster backend
(`fcluster`).

HOST_SYNCS counts the loop conditions that the plain-tensor backends
read on the host: one a round of `fcluster`, a lockstep step of the wide
BVH (`bvh8`) and of the BVH2 walk (`bvh2`), and a cluster the `cluster`
backend may skip (`render/intersect.py`)."""

HOST_SYNCS = {"fcluster": 0, "bvh8": 0, "bvh2": 0, "cluster": 0}
