"""The multi-GPU layer over ``torch.distributed``: the rule table,
specs, shardings and collectives (``distributed.sharding``), fault
tolerance (``distributed.fault``) and elastic restore onto a mesh
(``distributed.elastic``)."""
