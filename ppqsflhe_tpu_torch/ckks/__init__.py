"""RNS-CKKS: params, keys, encrypt/decrypt, evaluation, PRE."""
