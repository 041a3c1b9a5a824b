"""Device-mesh parallelism: the mesh, its sharding rules and collectives."""
