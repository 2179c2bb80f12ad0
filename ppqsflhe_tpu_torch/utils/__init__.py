"""Utilities of the port (the twin of ``ppqsflhe_tpu.utils``)."""
