"""Device meshes, data parallelism, row-band (spatial) parallelism and
multi-process GOP shards."""
