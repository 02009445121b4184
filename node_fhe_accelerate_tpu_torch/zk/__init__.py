"""ZK modules of the PyTorch port: fields, curves, hashes, Bulletproofs."""
