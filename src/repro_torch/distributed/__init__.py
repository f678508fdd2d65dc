"""The serving mesh over ``torch.distributed``: spec derivation
(``specs``), the process mesh (``mesh``), the rule table and this rank's
shards (``sharding``) and the packed wire-format gather (``compression``)."""
