"""The server tools of the federated-learning round, in memory."""
