"""Multi-device sharding (the counterpart of the JAX package's
famsa_tpu/parallel/): a single-process mesh of shards and the routing
rules of both axes (mesh.py), the row axis's sharded Prim tree and
distance rows (dist_sharded.py), and the column axis's column-sharded
profile DP (dp_sharded.py)."""
