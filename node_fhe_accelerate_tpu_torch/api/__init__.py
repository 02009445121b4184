"""The public API of the PyTorch port: the engine, the contexts, the tally
stream, the audit trail and fraud detection."""
