from .trainer import train_client, TrainResult  # noqa: F401
