"""The port's fault tolerance (``distributed.fault``) and elastic restore
onto one device (``distributed.elastic``); the reference's sharding rules
and meshes are the multi-GPU slice (ROADMAP A8)."""
