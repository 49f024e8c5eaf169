"""Device meshes and the engines over them (the JAX package's
``parallel/``): single-process meshes, the sharded ingest, the member-axis
population engines and the data-parallel MLP trainers; the multi-process
runtime (``distributed``), the partitioned pod ingest (``pod``,
``pod_worker``) and the streaming front end (``streaming``). The JAX
package's ``shardmap_compat`` is XLA's and has no counterpart."""
