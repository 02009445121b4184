"""The public API of the PyTorch port: the engine, the contexts, the tally
stream, the audit trail, fraud detection, the ZK proof manager, the voting
system and public verification."""
