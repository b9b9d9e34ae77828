"""Host-side FBFT consensus support around the device checks: the
participation bitmap (``mask.py``), signable payloads (``signature.py``),
vote-power rosters and quorum policies (``votepower.py``, ``quorum.py``),
the wire messages (``messages.py``), and the consumers of the device
checks: the FBFT round (``fbft.py``), view change (``view_change.py``)
and Handel aggregation (``aggregation.py``); the persisted vote records
(``safety.py``) and the retrying sender (``sender.py``).  The port's copy
of the JAX package's ``consensus/`` as far as it is ported."""
