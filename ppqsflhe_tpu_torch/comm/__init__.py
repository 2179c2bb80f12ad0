"""Artifact exchange: the port's stdlib copy of ``ppqsflhe_tpu.comm`` (server
routes, transfer client, metrics CSVs, offline analysis). It imports neither
torch nor numpy; the copy keeps the port free of the JAX package."""

from .client import CommClient  # noqa: F401
from .server import ArtifactServer  # noqa: F401
