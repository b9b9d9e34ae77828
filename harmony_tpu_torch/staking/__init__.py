"""Staking subsystem: EPoS effective-stake election math and double-sign
slashing (reference: staking/ — SURVEY.md §2.4).  The port's copy of the
JAX package's ``staking/`` as far as it is ported: ``effective.py`` and
``slash.py``."""
