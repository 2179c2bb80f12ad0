"""The plain reference that decides ``correct``: the moduli chain, the
evaluation layout, decryption with the benchmark's secrets, canonical
decoding and the plain FedAvg, in plain PyTorch and NumPy. It imports
nothing of the program (``ppqsflhe_tpu_torch``) and reads nothing the
program made except the outputs it judges."""
