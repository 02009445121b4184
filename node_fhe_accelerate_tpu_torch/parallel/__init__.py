"""The multi-device layer: a single-controller mesh (``mesh.py``), its
collectives (``collectives.py``), the sharded bootstrap (``pbs.py``), the
distributed NTT and ring (``dist_ntt.py``, ``dist_ring.py``), the sharded
MSM (``msm.py``) and the multi-process layer (``multihost.py``)."""
