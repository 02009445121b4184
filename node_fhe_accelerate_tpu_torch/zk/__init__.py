"""ZK modules of the PyTorch port: fields, curves (G1 and G2), hashes, the
Fr NTT, the BN254/BLS12-381 pairings, KZG/FRI commitments, Bulletproofs,
Groth16 with its circuits, and PLONK."""
