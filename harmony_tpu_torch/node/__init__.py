"""Node-runtime pieces: wire envelope and pubsub ingress validation
(reference: api/proto/common.go + node/harmony/node.go:473-608 —
SURVEY.md §2.6).

The port's copy of the JAX package's ``node/__init__.py``.
"""
