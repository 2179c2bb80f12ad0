"""Mesh parallelism of the port on ``torch.distributed``: process meshes and
collectives (``mesh``), the coefficient- and client-sharded server round
(``sharded_scheme``), multi-host execution (``multihost``) and the
multi-rank dry run (``dryrun``). Twins of ``ppqsflhe_tpu.parallel``."""
