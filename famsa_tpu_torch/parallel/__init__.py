"""Multi-device sharding of the row axis (the counterpart of the JAX
package's famsa_tpu/parallel/ "rows" half): a single-process mesh of
shards (mesh.py), the sharded Prim tree and the sharded distance rows
(dist_sharded.py)."""
