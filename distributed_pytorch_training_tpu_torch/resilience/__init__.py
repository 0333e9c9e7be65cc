"""Fault-tolerant training (the JAX package's resilience/): deterministic
fault injection (:mod:`.faults`) and the in-process restart supervisor
(:mod:`.supervisor`) at a fixed world size. The elastic pieces
(``elastic.py``, ``capacity.py``, ``fleet.py``) and the ``resilience
chaos`` CLI come with the elastic slice (ROADMAP.md, queue 1)."""
