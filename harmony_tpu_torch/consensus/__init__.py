"""Host-side FBFT consensus support around the device checks: the
participation bitmap over a committee (``mask.py``).  The port's copy of
the JAX package's ``consensus/`` as far as it is ported."""
