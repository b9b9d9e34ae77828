"""Round forensics: causal phase attribution for committed rounds.

trace.py records *what happened* (spans with node attribution, a
traceparent crossing the consensus wire); this package answers *where
the time went*.  The port's copy of the JAX package's ``obs/`` as far as
it is ported:

- ``replay`` — stage attribution for the staged-sync insert path
  (wire_decode → seal_verify → execute → kv_commit), feeding
  ``harmony_replay_stage_seconds{stage}``.

Stdlib-only, like trace.py: importable from every layer.
"""

from __future__ import annotations

from .replay import REPLAY_STAGE_SECONDS, REPLAY_STAGES, stage  # noqa: F401
