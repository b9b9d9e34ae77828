"""Localhost sidecar: the process boundary between a host node (the Go
chain client in deployment) and the kernel server on the card.

The reference crosses from Go into herumi C++ via cgo in-process; the
device equivalent is a local socket hop into a persistent kernel server
holding the built kernels and epoch-keyed device-resident committee
tables (SURVEY.md §7.3).  The wire format is a compact length-prefixed
binary protocol (protocol.py) served over TCP/Unix sockets (server.py),
with a Python client (client.py).  The port's copy of the JAX package's
``sidecar/``, on the same wire: either package's client talks to either
package's server.
"""
